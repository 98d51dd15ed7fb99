"""ms a call of the 64-bit key layer's own device work (``ops/sort64.py``):
the kernels, copies and memsets launched inside a ``sort64`` span and
outside both of the radix engine's word spans, matched to their launches by
correlation id (``metrics/launched.py``). Splitting the keys into words,
masking, the stacks of columns, joining the words back, the suffix copies."""
from perfbench.metrics.launched import device_ms_per_call

WORD_SPANS = ("radix.lo_word", "radix.hi_word")


def read(run):
    return device_ms_per_call(run, ("sort64",), WORD_SPANS)
