"""The multi-device layer: distributed sorts over a ``DeviceMesh`` axis.

Counterpart of ``tpu_radix_sort/parallel/``, on ``torch.distributed``.
Every function is SPMD: each rank of the axis calls it with its own shard
(1-D for the flat ops, a block of rows for the batched sort); the global
array is the concatenation of the shards in rank order; `count`,
`offsets` and `bit_count` are global; each rank gets back its shard of the
global result. The collectives are in ``comm.py``.

- :func:`mesh_sort`: bitonic compare-split network (fixed-size exchanges,
  log2(D)(log2(D)+1)/2 rounds; a power-of-two D);
- :func:`exchange_sort`: exact-splitter radix exchange (one ragged
  all-to-all; any D);
- :func:`mesh_prefix_sum`: a K4 scan a shard + one all_gather of totals;
- :func:`mesh_is_sorted`, :func:`mesh_disorder_count`: K2/K3 a shard + one
  all_gather of the shards' edges;
- :func:`mesh_sort_segments`: distributed segment ids + the composite
  (segment, key, idx) tuple over the compare-split network;
- :func:`mesh_sort_batched`: rows sharded, no collective;
- :func:`sharded`: this rank's shard of a global array.
"""
from .batched import mesh_sort_batched
from .check import mesh_disorder_count, mesh_is_sorted
from .mesh_sort import mesh_sort, sharded
from .radix_exchange import exchange_sort
from .scan import mesh_prefix_sum
from .segmented import mesh_sort_segments

__all__ = [
    "mesh_sort",
    "exchange_sort",
    "mesh_prefix_sum",
    "mesh_is_sorted",
    "mesh_disorder_count",
    "mesh_sort_batched",
    "mesh_sort_segments",
    "sharded",
]
