"""Plain reference and comparison of a keys-only segmented sort of 32-bit
keys, in PyTorch alone.

Each key's segment id comes from the offsets; the expected answer sorts the
int64 word ``segment << 32 | key`` and keeps its low 32 bits, so that every
segment is sorted in place and no key leaves its segment. Keys are compared
as bytes; the number is a count of positions that differ, limit 0.
"""
import torch

from perfbench.reference import mismatches
from perfbench.reference.flat_pairs import take

LIMITS = {"key_mismatches": 0}


def _words(keys, offsets):
    sizes = offsets.diff()
    seg = torch.repeat_interleave(torch.arange(sizes.numel(), device=keys.device), sizes)
    return seg << 32, keys.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def expected(inputs):
    seg, key = _words(inputs["keys"], inputs["offsets"])
    out = torch.sort(seg | key).values & 0xFFFFFFFF
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)  # the u32 pattern as int32
    return {"keys": out.to(torch.int32).view(inputs["keys"].dtype)}


def control(inputs):
    """The reference with one guarantee broken: keys ordered by their high
    24 bits only (a radix sort one 8-bit digit short), stably."""
    keys = inputs["keys"]
    seg, key = _words(keys, inputs["offsets"])
    order = torch.sort(seg | (key >> 8), stable=True).indices
    return {"keys": take(keys, order)}


def judge(inputs, answer) -> dict:
    return {"key_mismatches": mismatches(answer["keys"], expected(inputs)["keys"])}
