"""The JAX package's numpy golden as the reference of the port's tests.

``golden_sort`` is the JAX package's ``golden_sort``. That one has no
total order, so with ``total_order=True`` the keys go through the JAX
golden's own bijection mirror (``_total_order_u16_widened``,
``_total_order_u32`` or ``_total_order_u64``), and its ``golden_sort`` of
those patterns (mask, flip, stable order) gives the permutation.
bfloat16 keys come as ``ml_dtypes.bfloat16`` arrays, which the JAX golden
reads as 16-bit floats.
"""
import numpy as np

from tpu_radix_sort.models import golden as jax_golden


def total_order_pattern(keys):
    """The JAX golden's total-order bijection of keys of any width."""
    if jax_golden._is_64bit(keys):
        return jax_golden._total_order_u64(keys)
    if jax_golden._is_16bit(keys):
        return jax_golden._total_order_u16_widened(keys)
    return jax_golden._total_order_u32(keys)


def golden_sort(keys, values=None, *, total_order=False, bit_count=None, **kw):
    """``jax_golden.golden_sort`` with ``total_order`` added (see above)."""
    if not total_order:
        return jax_golden.golden_sort(keys, values, bit_count=bit_count, **kw)
    if bit_count is None and jax_golden._is_16bit(keys):
        bit_count = 16  # the widened pattern is a u32; the key is 16 bits
    n = keys.shape[0]
    _, perm = jax_golden.golden_sort(total_order_pattern(keys), np.arange(n),
                                     bit_count=bit_count, **kw)
    out = keys[perm]
    return out if values is None else (out, np.asarray(values)[perm])
