"""Card counterparts of the Pallas probes under ``benchmarks/``.

- ``explore_ce``: P1, the compare-exchange stage per column count and
  formulation (``benchmarks/explore_ce.py:200``);
- ``explore_blocksort``: P2, the primitive check, and P3, the resident
  stage rate (``benchmarks/explore_blocksort.py:60,88``), beside
  ``torch.sort(dim=1)`` and ``sort_batched``;
- ``explore_scan``: P4-P7, block sums, the block-local add-back, a copy
  through the grid and a one-pass scan with its carry chained from tile to
  tile (``benchmarks/explore_scan.py:92,107,131,145``), beside K4;
- ``explore_keys16``: P8, the running max that emits a 16-bit keys-only
  counting sort (``benchmarks/explore_keys16.py:80``), with the probe's
  sort lines; P9, the min/max stage rate per lane type (:163).

The host-side probes, which launch no kernel of their own:

- ``crossover``: the default engine against the native CPU sort, 2^10-2^24;
- ``explore_stages``: K1's tile kernel taken apart (loads and stores,
  register stages, window changes, direction) and its global stage;
- ``explore_segmented``: a row-local path for near-equal segments;
- ``explore_blockrows``: the tile sweep against ``choose_tile``;
- ``explore_msd``, ``explore_primitives``: ``torch.sort``, gathers,
  scatters and the radix passes, the primitives of a radix engine.

Each runs on the card as ``python -m tpu_radix_sort_torch.benchmarks.<name>``
(its ``check``, then its ``main``).
"""

# The card's rates that the bounds of the probes and of chip_smoke.py use.
# HBM3 bytes a second (H100 SXM data sheet). 32-bit integer operations a
# second, the rate of what the probes count (a min, a compare, a select: one
# instruction each on the integer lanes): SMS SMs x 64 INT32 lanes an SM
# (Hopper architecture white paper) x SM_CLOCK_HZ, the card's maximum SM
# clock (`nvidia-smi --query-gpu=clocks.max.sm`: 1980 MHz; chip_smoke.py
# prints both and fails on a card where either differs). The float32 rate
# of the data sheet, 67e12, counts a fused multiply-add as two operations
# on 128 lanes an SM, and is no rate of these instructions.
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 1.98e9
ALU_OPS_PER_S = SMS * 64 * SM_CLOCK_HZ
