"""Port parity of the batched (per-row) sorts (`sort_batched`,
`argsort_batched`; ``ops/batched.py``, kernel K1's row-local schedule
through its plain version on the CPU), byte-exact (tolerance 0, integer
work) against the JAX package and its numpy golden.

The JAX package is called three times, in interpret mode as its own tests
run it: a key+value sort of 5 rows shorter than the kernel's 1,024-element
chunk, a masked descending keys-only sort of 3 rows of 1,500 (rows longer
than the tile: global calls and the final round from stride row_len/2), and
an argsort of float32 keys in total order. Everything else is held against
a per-row oracle, the JAX package's numpy golden (``torch_golden_ref``)
applied to each row."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch.ops import bitonic
from torch_golden_ref import golden_sort


def _u32(rng, shape, hi=2**32):
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _eq(got, want):
    """Byte equality of a result (tensor, array or pair) with numpy arrays."""
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_eq(g, w) for g, w in zip(got, want))
    if isinstance(got, torch.Tensor):
        got = (got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
               else got.numpy())
    g, w = (a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a for a in (got, want))
    return g.shape == w.shape and np.array_equal(g.view(np.uint8), w.view(np.uint8))


def _rows_golden(k, v=None, **kw):
    """The golden sort of each row (keys, or (keys, values))."""
    rows = [golden_sort(k[b], None if v is None else v[b], **kw) for b in range(k.shape[0])]
    if v is None:
        return np.stack(rows)
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def _port_keys(k):
    if k.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(k.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(k)


def test_matches_jax_key_value_rows_under_one_chunk():
    rng = np.random.default_rng(0)
    B, n = 5, 300  # B not a power of two; 5 rows of 512 share one chunk
    k = _u32(rng, (B, n))
    k[2] %= 5  # a duplicate-heavy row: stability
    k[3, :40] = 0xFFFFFFFF  # real max keys beside the sentinel pads
    v = _u32(rng, (B, n))
    want = tuple(np.asarray(a) for a in jtrs.sort_batched(jnp.asarray(k), jnp.asarray(v)))
    assert _eq(want, _rows_golden(k, v))
    for tile in (None, 128, 2):
        assert _eq(trt.sort_batched(k, v, device="cpu", tile=tile), want), tile
    # the pads make 8 rows: 5 real, 3 of sentinels, cut off
    assert bitonic.rows_layout(B, 512, 3) == (4096, 8)


def test_matches_jax_rows_longer_than_the_tile():
    rng = np.random.default_rng(1)
    B, n = 3, 1500  # row_pad 2048
    k = _u32(rng, (B, n))
    want = np.asarray(jtrs.sort_batched(jnp.asarray(k), bit_count=20, descending=True,
                                        block_rows=2))
    assert _eq(want, _rows_golden(k, bit_count=20, descending=True))
    for tile in (None, 256, 1024):
        got = trt.sort_batched(k, bit_count=20, descending=True, device="cpu", tile=tile)
        assert _eq(got, want), tile
    calls = bitonic.row_schedule(2048, 256)
    up = bitonic.ROW_UP
    assert calls[-4:] == [("global", up, 1024), ("global", up, 512), ("global", up, 256),
                          ("tile", [(up, j) for j in (128, 64, 32, 16, 8, 4, 2, 1)])]


def test_matches_jax_argsort_total_order_f32():
    rng = np.random.default_rng(2)
    B, n = 6, 200
    k = rng.standard_normal((B, n)).astype(np.float32)
    k[:, ::17] = -0.0
    k[1, ::5] = np.inf
    k[4] = k[4, 0]  # one all-equal row: ranks in order
    want = np.asarray(jtrs.argsort_batched(jnp.asarray(k), total_order=True))
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(want, np.argsort(k, axis=1, kind="stable"))
    got = trt.argsort_batched(k, total_order=True, device="cpu")
    assert got.dtype == torch.uint32 and _eq(got, want)


@pytest.mark.parametrize("case", [
    dict(dtype=np.uint32, kw=dict(bit_count=12)),
    dict(dtype=np.uint32, kw=dict(descending=True), values=np.uint32),
    dict(dtype=np.int32, kw=dict(total_order=True), values=np.float64),
    dict(dtype=np.uint32, kw=dict(values_are_ranks=True), values="ranks"),
    dict(dtype=np.uint16, kw=dict(bit_count=12, descending=True), values=np.uint32),
    dict(dtype=ml_dtypes.bfloat16, kw=dict(total_order=True)),
    dict(dtype=np.uint64, kw=dict(bit_count=40), values=np.uint64),
    dict(dtype=np.float64, kw=dict(total_order=True, descending=True, values_are_ranks=True),
         values="ranks"),
], ids=lambda c: "-".join([np.dtype(c["dtype"]).name, *c["kw"],
                           str(c.get("values", "keys-only")).split(".")[-1].strip("'>")]))
def test_options_and_dtypes_match_golden(case):
    rng = np.random.default_rng(3)
    B, n = 3, 700  # rows longer than a tile of 256
    bits = 8 * np.dtype(case["dtype"]).itemsize
    raw = rng.integers(0, 2**bits, (B, n), dtype=np.uint64)
    raw[1] %= 9  # duplicate keys: stability
    k = raw.astype(f"u{bits // 8}").view(case["dtype"])
    vals = case.get("values")
    if vals == "ranks":
        v = np.tile(np.arange(n, dtype=np.uint32), (B, 1))
    elif vals is not None:
        v = rng.integers(0, 2**63, (B, n), dtype=np.int64).astype(vals)
    else:
        v = None
    kw = case["kw"]
    gkw = {a: b for a, b in kw.items() if a != "values_are_ranks"}
    want = _rows_golden(k, v, **gkw)
    args = (_port_keys(k),) if v is None else (_port_keys(k), torch.from_numpy(v))
    for tile in (None, 256):
        assert _eq(trt.sort_batched(*args, tile=tile, **kw), want), tile
    # the baseline engine gives the same bytes
    assert _eq(trt.sort_batched(*args, method="xla", **kw), want)


def test_short_rows_and_empty_batches():
    k = np.array([[3], [1]], dtype=np.uint32)
    assert _eq(trt.sort_batched(k, device="cpu"), k)
    assert _eq(trt.argsort_batched(k, device="cpu"), np.zeros((2, 1), np.uint32))
    e = np.zeros((0, 5), dtype=np.uint32)
    assert _eq(trt.sort_batched(e, e, device="cpu"), (e, e))
    k = np.array([[2, 1], [1, 2]], dtype=np.uint32)
    assert _eq(trt.sort_batched(k, device="cpu"), np.array([[1, 2], [1, 2]], np.uint32))


def test_validation_matches_jax():
    z = torch.zeros((2, 8), dtype=torch.uint32)
    with pytest.raises(ValueError):
        trt.sort_batched(torch.zeros(8, dtype=torch.uint32))  # 1-D
    with pytest.raises(ValueError):
        trt.argsort_batched(torch.zeros(8, dtype=torch.uint32))
    with pytest.raises(ValueError):
        trt.sort_batched(z, method="radix")
    with pytest.raises(TypeError):
        trt.sort_batched(torch.zeros((2, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        trt.sort_batched(z, torch.zeros((2, 4), dtype=torch.uint32))
    with pytest.raises(ValueError):
        trt.sort_batched(z, bit_count=36)
    with pytest.raises(ValueError):
        trt.sort_batched(z, torch.zeros((2, 8), dtype=torch.uint64), values_are_ranks=True)
    with pytest.raises(TypeError):
        trt.sort_batched(z, torch.zeros((2, 8), dtype=torch.uint16))
    with pytest.raises(TypeError):
        trt.sort_batched(z, mesh=object())
    with pytest.raises(TypeError):
        trt.argsort_batched(z, mesh=object())
