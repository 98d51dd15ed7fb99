"""ms a call of the radix engine's two word sorts of a 64-bit key: the
device work launched inside the ``radix.lo_word`` and ``radix.hi_word``
spans (``ops/sort.py`` ``_engine_sort``), matched to its launches by
correlation id (``metrics/launched.py``)."""
from perfbench.metrics.launched import device_ms_per_call
from perfbench.metrics.sort64_own_ms import WORD_SPANS


def read(run):
    return device_ms_per_call(run, WORD_SPANS)
