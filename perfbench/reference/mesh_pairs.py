"""The distributed key + value sort is judged on the global array, the
ranks' shards of the answer joined in rank order, against the flat
reference (``reference/flat_pairs.py``)."""
from perfbench.reference.flat_pairs import LIMITS, control, expected, judge  # noqa: F401
