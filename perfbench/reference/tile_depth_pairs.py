"""Plain reference and comparison of the per-frame sort of 3D Gaussian
Splatting, in PyTorch alone: u64 keys sorted stably by their low
``BIT_COUNT`` bits, each moving with its u32 payload.

The expected order is a stable sort of the int64 word ``key & (2^44 - 1)``;
keys come back whole, the bits above 44 included. Keys and values are
compared as bytes; the numbers are counts of positions that differ, and the
limit of each is 0.
"""
import torch

from perfbench.reference import mismatches
from perfbench.reference.flat_pairs import take

BIT_COUNT = 44  # the configuration's bit_count: 32 + the tile grid's 12 bits
LIMITS = {"key_mismatches": 0, "value_mismatches": 0}


def _low_bits(keys):
    return keys.contiguous().view(torch.int64) & ((1 << BIT_COUNT) - 1)


def _sorted_by(inputs, word):
    order = torch.sort(word, stable=True).indices
    return {"keys": take(inputs["keys"], order), "values": take(inputs["values"], order)}


def expected(inputs):
    return _sorted_by(inputs, _low_bits(inputs["keys"]))


def control(inputs):
    """The reference with one guarantee broken: keys ordered by their low
    44 bits shifted right by 8 (tile, then depth coarsened), stably, the
    renderer's visible fault. Ties of all 44 bits are rare among float
    depths, so a control that broke stability alone would not reliably fail."""
    return _sorted_by(inputs, _low_bits(inputs["keys"]) >> 8)


def judge(inputs, answer) -> dict:
    want = expected(inputs)
    return {"key_mismatches": mismatches(answer["keys"], want["keys"]),
            "value_mismatches": mismatches(answer["values"], want["values"])}
