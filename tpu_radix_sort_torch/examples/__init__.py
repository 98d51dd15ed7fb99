"""Command-line demos of the port: ``python -m tpu_radix_sort_torch.examples.demo``
(one card against the native CPU sort) and ``...examples.demo_mesh`` (the
distributed sorts over a spawned world of ranks)."""
