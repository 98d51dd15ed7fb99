"""Port parity of the bitonic engine (kernel K1's plain version on the CPU):
`sort_padded` / `merge_padded` byte-exact against the JAX package (Pallas in
interpret mode, small `block_rows` so merge rounds run) and against numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_radix_sort.ops import bitonic as jbitonic
from tpu_radix_sort_torch.ops import bitonic
from tpu_radix_sort_torch.utils import interop


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _port(cols, fn, **kw):
    out = fn(tuple(interop.from_numpy(c, "cpu") for c in cols), **kw)
    return [interop.to_numpy(o) for o in out]


def _jax(cols, fn, **kw):
    return [np.asarray(o) for o in fn(tuple(jnp.asarray(c) for c in cols), **kw)]


def test_sort_padded_keys_only_matches_jax():
    rng = np.random.default_rng(0)
    k = _u32(rng, 512, 300)
    k[rng.integers(0, 512, 40)] = 0xFFFFFFFF  # real max keys among the data
    want = _jax([k], jbitonic.sort_padded, stable=False, block_rows=1)  # T = 128
    for tile in (128, 32):
        got = _port([k], bitonic.sort_padded, stable=False, tile=tile)
        assert np.array_equal(got[0], want[0]), tile


def test_sort_padded_stable_with_payload_matches_jax():
    rng = np.random.default_rng(1)
    n = 256
    k = _u32(rng, n, 20)
    k[-40:] = 0xFFFFFFFF  # sentinel pads: identical (key, tie, payload) tuples
    tie = np.arange(n, dtype=np.uint32)
    tie[-40:] = 0xFFFFFFFF
    p = _u32(rng, n)
    p[-40:] = 0
    cols = [k, tie, p]
    want = _jax(cols, jbitonic.sort_padded, stable=True, block_rows=1)  # T = 128
    got = _port(cols, bitonic.sort_padded, stable=True, tile=64)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_merge_padded_matches_jax():
    rng = np.random.default_rng(2)
    a = np.sort(_u32(rng, 512, 1000))
    b = np.sort(_u32(rng, 512, 1000))[::-1]
    k = np.concatenate([a, b])  # bitonic: ascending ++ descending
    want = _jax([k], jbitonic.merge_padded, stable=False, block_rows=2)
    got = _port([k], bitonic.merge_padded, stable=False, tile=256)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], np.sort(k))


@pytest.mark.parametrize("n_arr,n_keys", [
    (1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (4, 1), (4, 2), (4, 3),
    (5, 1), (5, 2), (5, 3), (6, 1), (6, 2), (6, 3), (7, 1), (7, 2), (7, 3),
    (4, 4), (5, 4), (6, 4), (7, 4), (8, 1), (8, 2), (8, 3), (8, 4),
])
def test_column_configs_match_numpy(n_arr, n_keys):
    rng = np.random.default_rng(10 * n_arr + n_keys)
    n = 1024
    cols = [_u32(rng, n) for _ in range(n_arr)]
    cols[0] = _u32(rng, n, 8)  # heavy duplicates in the leading key
    # distinct key tuples: the last key column is unique (a shuffled index),
    # or, with one key column and payloads, the key itself
    cols[n_keys - 1] = rng.permutation(n).astype(np.uint32) * np.uint32(4099)
    got = _port(cols, bitonic.sort_padded, stable=n_keys > 1, tile=64,
                n_keys=n_keys)
    order = np.lexsort(cols[:n_keys][::-1])
    for g, c in zip(got, cols):
        assert np.array_equal(g, c[order])


def test_output_does_not_depend_on_tile():
    rng = np.random.default_rng(3)
    n = 2048
    cols = [_u32(rng, n, 50), np.arange(n, dtype=np.uint32), _u32(rng, n)]
    outs = [_port(cols, bitonic.sort_padded, stable=True, tile=t)
            for t in (2, 16, 256, 2048)]
    for o in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(o, outs[0]))
    # every tile runs the same network: the schedule's stages, in order,
    # are the full bitonic stage list
    for t in (2, 16, 256, 2048):
        flat = []
        for call in bitonic.sort_schedule(n, t):
            flat += call[1] if call[0] == "tile" else [call[1:]]
        assert flat == bitonic._block_stages(2, n)
        assert all(j >= t for c in bitonic.sort_schedule(n, t) if c[0] == "global"
                   for j in [c[2]])


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        bitonic.tile_stages(x, [(256, 128)], n_keys=1, tile=128)  # j >= tile
    with pytest.raises(ValueError):
        bitonic.tile_stages(x, [(4, 1)] * 129, n_keys=1, tile=128)
    with pytest.raises(TypeError):
        bitonic.tile_stages(x.to(torch.int64), [(2, 1)], n_keys=1, tile=128)
    with pytest.raises(ValueError):
        bitonic.global_stage(x.t(), 4, 2, n_keys=1)  # not contiguous
    with pytest.raises(ValueError):
        bitonic.global_stage(x, 4, 256, n_keys=1)  # 2j > n
    with pytest.raises(ValueError):
        bitonic.global_stage(torch.zeros((9, 256), dtype=torch.int32), 4, 2, n_keys=1)
    with pytest.raises(ValueError):
        bitonic.global_stage(x, 4, 2, n_keys=3)
    with pytest.raises(ValueError):
        bitonic.global_stage(torch.zeros((5, 256), dtype=torch.int32), 4, 2, n_keys=5)
    with pytest.raises(ValueError):  # 2j does not divide the length
        bitonic.global_stage(torch.zeros((1, 384), dtype=torch.int32), 512, 256, n_keys=1)
    with pytest.raises(ValueError):  # 3,072 is not a multiple of the 2,048 chunk
        bitonic.tile_stages(torch.zeros((1, 3072), dtype=torch.int32), [(2, 1)], n_keys=1,
                            tile=2048)
    with pytest.raises(ValueError):  # nor of the 1,024 chunk of any smaller tile
        bitonic.sort_rows_padded_cols(torch.zeros((1, 1536), dtype=torch.int32), row_len=512,
                                      n_keys=1, tile=512)
    with pytest.raises(ValueError):
        bitonic.sort_rows_padded_cols(torch.zeros((1, 2048), dtype=torch.int32), row_len=384,
                                      n_keys=1, tile=512)
    with pytest.raises(ValueError):
        bitonic.sort_padded((torch.zeros(96, dtype=torch.int32),), stable=False)
    with pytest.raises(ValueError):
        bitonic.sort_padded((torch.zeros(256, dtype=torch.int32),), stable=False,
                            tile=3)
    with pytest.raises(ValueError):  # 5 columns of a 2^14 tile overflow 227 KB
        bitonic.resolve_tile(1 << 20, 5, 1 << 14)


@pytest.mark.parametrize("tile", [1 << e for e in range(1, 16)])
def test_tile_plan_covers_the_stages_in_order(tile):
    """The window plan of the tile kernel: its runs, concatenated, are the
    stage list; every stride bit lies in its run's window; the plan makes
    few window changes (the kernel loads and stores in a window s >= 5: a
    plan that starts or ends in window 0 counts one change more)."""
    bits = bitonic.chunk_bits(tile)
    wins = bitonic.windows(bits)
    assert wins[0] == 0 and all(5 <= w <= bits - 5 for w in wins[1:])
    assert set(range(bits)) == {b for w in wins for b in range(w, w + 5)}
    phase1 = bitonic._block_stages(2, tile)
    tail = [(2 * tile, j) for j in bitonic._halving(tile // 2)]
    # phase 1: a change out of window 0 and back per round above 5, a third
    # per round above 10; a merge tail: three windows at most
    rounds = max(0, tile.bit_length() - 6)
    for stages, most in ((phase1, 2 + 2 * rounds + max(0, rounds - 5)), (tail, 3)):
        runs = bitonic.tile_plan(stages, tile)
        assert [s for _, run in runs for s in run] == stages
        assert all(w in wins and w <= j.bit_length() - 1 <= w + 4
                   for w, run in runs for _, j in run)
        changes = len(runs) - 1 + (runs[0][0] == 0) + (runs[-1][0] == 0)
        assert changes <= most, (changes, most)


def test_row_network_matches_jax_sort_rows_padded():
    """The row-local network of the batched sorts: 8 rows of 256, key + tie
    + payload, against the JAX package's (tile 128 there: the merge-round
    path; here tiles below, at and above the row)."""
    rng = np.random.default_rng(4)
    rows, row_len = 8, 256
    n = rows * row_len
    k = _u32(rng, n, 40)
    k[300:420] = 0xFFFFFFFF  # sentinel pads of a short row
    tie = np.arange(n, dtype=np.uint32)
    p = _u32(rng, n)
    p[300:420] = 0
    cols = [k, tie, p]
    want = _jax(cols, jbitonic.sort_rows_padded, row_len=row_len, stable=True, block_rows=1)
    order = np.lexsort((tie, k, np.arange(n) // row_len))
    assert all(np.array_equal(w, c[order]) for w, c in zip(want, cols))
    for tile in (None, 64, 256, 1024):
        x = torch.from_numpy(np.stack(cols).view(np.int32))
        bitonic.sort_rows_padded_cols(x, row_len=row_len, n_keys=2, tile=tile)
        assert all(np.array_equal(g, w) for g, w in zip(x.numpy().view(np.uint32), want)), tile


@pytest.mark.parametrize("row_len,tile", [(128, 2048), (512, 128), (1024, 64)])
def test_row_schedule_four_keys_eight_columns_match_numpy(row_len, tile):
    """The plain version of K1 on a length that is no power of two (3 chunks
    of 2,048), 4 key words and 8 columns, through the row-local schedule:
    each row ends in lexicographic order of its key tuples."""
    rng = np.random.default_rng(row_len + tile)
    n = 3 * 2048
    cols = [_u32(rng, n) for _ in range(8)]
    cols[0] = _u32(rng, n, 3)
    cols[1] = _u32(rng, n, 2)
    cols[2] = _u32(rng, n, 3)  # heavy duplicates in the leading three words
    cols[3] = rng.permutation(n).astype(np.uint32)  # a unique tie
    x = torch.from_numpy(np.stack(cols).view(np.int32))
    calls = bitonic.row_schedule(row_len, tile)
    assert (calls[0][0] == "tile") and any(c[0] == "global" for c in calls) == (row_len > tile)
    bitonic.run_schedule(x, calls, n_keys=4, tile=tile)
    order = np.lexsort([c for c in cols[3::-1]] + [np.arange(n) // row_len])
    assert all(np.array_equal(g, c[order]) for g, c in zip(x.numpy().view(np.uint32), cols))


@pytest.mark.parametrize("run", [1, 64, 256, 512, 2048, 4096])
def test_merge_tree_schedule_matches_jax_rounds(monkeypatch, run):
    """`merge_tree_schedule` runs the rounds that JAX `merge_tree_padded`
    runs (n = 4,096 at a tile of 512 there and here): one tile call of the
    rounds 2*run..T when they fit a tile, then one merge round a k up to
    n; run >= n runs nothing. Its stages are the network's rounds k =
    2*run..n, in order. JAX's kernel calls are recorded, not run."""
    n, tile = 4096, 512
    phase, rounds = [], []

    def record_network(x, stable, stages, **kw):
        phase.append(list(stages))
        return x

    def record_round(x, k, **kw):
        rounds.append(k)
        return x

    monkeypatch.setattr(jbitonic, "_run_network", record_network)
    monkeypatch.setattr(jbitonic, "_merge_round", record_round)
    jbitonic.merge_tree_padded((jnp.zeros(n, jnp.uint32),), run=run, stable=False,
                               block_rows=tile // 128, interpret=True)
    calls = bitonic.merge_tree_schedule(n, run, tile)
    port_phase = [c[1] for c in calls[:1] if c[0] == "tile" and 2 * run <= tile]
    assert port_phase == phase
    ks = []
    for c in calls[len(port_phase):]:
        k = c[1] if c[0] == "global" else c[1][0][0]
        if not ks or ks[-1] != k:
            ks.append(k)
    assert ks == rounds
    flat = [s for c in calls for s in ([(c[1], c[2])] if c[0] == "global" else c[1])]
    want, k = [], 2 * run
    while k <= n:
        want += [(k, j) for j in bitonic._halving(k // 2)]
        k *= 2
    assert flat == want


def _runs_alternating(rng, n, run, n_cols=3):
    """Columns (key, unique tie, payload) whose runs of `run` are sorted by
    (key, tie), ascending in even runs and descending in odd ones: the
    state of a bitonic sort after round k = run."""
    k = _u32(rng, n, 50)
    tie = rng.permutation(n).astype(np.uint32)
    p = _u32(rng, n)
    cols = np.stack([k, tie, p][:n_cols])
    for r in range(n // run):
        sl = slice(r * run, (r + 1) * run)
        order = np.lexsort((cols[1, sl], cols[0, sl]))
        cols[:, sl] = cols[:, sl][:, order if r % 2 == 0 else order[::-1]]
    return cols


@pytest.mark.parametrize("run,tile", [(16, 256), (128, 256), (256, 256), (512, 128),
                                      (1024, 64)])
def test_merge_tree_padded_matches_sort_padded(run, tile):
    """Runs below, at and above the tile: the merge tree ends where a full
    sort of the same columns ends."""
    rng = np.random.default_rng(run + tile)
    n = 4096
    cols = _runs_alternating(rng, n, run)
    got = _port(list(cols), bitonic.merge_tree_padded, run=run, stable=True, tile=tile)
    want = _port(list(cols), bitonic.sort_padded, stable=True, tile=tile)
    order = np.lexsort((cols[1], cols[0]))
    for g, w, c in zip(got, want, cols):
        assert np.array_equal(g, w) and np.array_equal(g, c[order])


def test_merge_tree_padded_half_is_merge_padded():
    """run == n/2: [A ascending ++ B descending], one bitonic merge."""
    rng = np.random.default_rng(9)
    cols = _runs_alternating(rng, 2048, 1024)
    got = _port(list(cols), bitonic.merge_tree_padded, run=1024, stable=True, tile=128)
    want = _port(list(cols), bitonic.merge_padded, stable=True, tile=128)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert bitonic.merge_tree_schedule(2048, 1024, 128) == bitonic.merge_schedule(2048, 128)
    assert bitonic.merge_tree_schedule(2048, 2048, 128) == []
