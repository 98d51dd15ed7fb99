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

Each runs on the card as ``python -m tpu_radix_sort_torch.benchmarks.<name>``.
"""

# The card's rates that the bounds of the probes and of chip_smoke.py use
# (H100 SXM data sheet): HBM3 bytes a second; no 32-bit integer rate is in
# the data sheet's table, so its float32 rate outside the tensor cores
# stands for the card's 32-bit ALU peak.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
