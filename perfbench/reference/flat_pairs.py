"""Plain reference and comparison of a stable key + value sort of 32-bit
keys, in PyTorch alone.

The expected order sorts the int64 word ``(key - 2^31) << 32 | position``
(the key's unsigned value, then its position, so that equal keys keep
their order):
the words are distinct, so any sort gives the one stable order. Keys and
values are compared as bytes; the numbers are counts of positions that
differ, and the limit of each is 0.
"""
import torch

from perfbench.reference import mismatches

LIMITS = {"key_mismatches": 0, "value_mismatches": 0}


def _order(keys, tie):
    """The order of the words (key - 2^31) << 32 | tie, for a tie below 2^32:
    the key's sign bit flipped makes its int32 order its unsigned order."""
    biased = (keys.contiguous().view(torch.int32) ^ (-1 << 31)).to(torch.int64)
    return torch.sort((biased << 32) | tie).indices


def take(t, order):
    """``t[order]`` through a signed view of the same width (CUDA does not
    index unsigned 32-bit tensors)."""
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.contiguous().view(signed)[order].view(t.dtype)


def expected(inputs):
    keys, values = inputs["keys"], inputs["values"]
    pos = torch.arange(keys.numel(), device=keys.device)
    order = _order(keys, pos)
    return {"keys": take(keys, order), "values": take(values, order)}


def control(inputs):
    """The reference with one guarantee broken: not stable (equal keys in
    reverse order of position)."""
    keys, values = inputs["keys"], inputs["values"]
    pos = torch.arange(keys.numel(), device=keys.device)
    order = _order(keys, keys.numel() - 1 - pos)
    return {"keys": take(keys, order), "values": take(values, order)}


def judge(inputs, answer) -> dict:
    want = expected(inputs)
    return {"key_mismatches": mismatches(answer["keys"], want["keys"]),
            "value_mismatches": mismatches(answer["values"], want["values"])}
