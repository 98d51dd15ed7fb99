"""The general generator: inputs deterministic by seed, segment layouts."""
import numpy as np
import pytest
import torch

from perfbench.harness import generate, registry

CPU = torch.device("cpu")
CFG = {"n": 1 << 14, "key_dtype": "uint32", "value_dtype": "uint32", "values": "index"}
ZIPF = {"layout": "zipf", "count": 64, "exponent": 1.3, "sizes_seed": 0}


def _inputs(seed, slot=0, traffic=None, cfg=CFG):
    return generate.global_inputs(cfg, traffic or {"keys": {"distribution": "uniform"}},
                                  seed, slot, CPU)


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8))
                                        for k in a)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, -5, 2**70 + 3])
def test_inputs_are_deterministic_by_seed(seed):
    a, b = _inputs(seed), _inputs(seed)
    assert _same(a, b)
    assert not torch.equal(a["keys"].view(torch.int32), _inputs(seed + 1)["keys"].view(torch.int32))
    assert not torch.equal(a["keys"].view(torch.int32), _inputs(seed, 1)["keys"].view(torch.int32))
    assert a["keys"].dtype == torch.uint32 and a["keys"].numel() == CFG["n"]
    assert torch.equal(a["values"].view(torch.int32), torch.arange(CFG["n"], dtype=torch.int32))


def test_uniform_keys_cover_all_32_bits():
    k = _inputs(3)["keys"].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert int(k.max()) >= 1 << 31 and int(k.min()) < 1 << 28


def test_zipf_segments_sum_to_n_each_at_least_one_same_set_every_seed():
    n = CFG["n"]
    sizes = [generate.segment_sizes(n, ZIPF, seed, 0) for seed in (1, 2, 2**40)]
    for s in sizes:
        assert s.sum() == n and s.min() >= 1 and s.size == 64
        assert np.array_equal(np.sort(s), np.sort(sizes[0]))
    assert not np.array_equal(sizes[0], sizes[1])
    assert sizes[0].max() > 10 * np.median(sizes[0])  # a heavy head, as Zipf(1.3) gives
    tr = {"keys": {"distribution": "uniform"}, "segments": ZIPF}
    off = _inputs(1, traffic=tr)["offsets"]
    assert off.dtype == torch.int64 and int(off[0]) == 0 and int(off[-1]) == n
    assert np.array_equal(np.diff(off.numpy()), sizes[0])


def test_equal_segments():
    s = generate.segment_sizes(1 << 14, {"layout": "equal", "count": 16}, 5, 0)
    assert (s == 1024).all() and s.size == 16
    with pytest.raises(ValueError):
        generate.segment_sizes(1000, {"layout": "equal", "count": 3}, 5, 0)


def test_shards_join_to_the_whole():
    whole = _inputs(9, traffic={"keys": {"distribution": "uniform"}, "segments": ZIPF})
    parts = [generate.shard(whole, r, 4) for r in range(4)]
    for k in ("keys", "values"):
        assert torch.equal(torch.cat([p[k].view(torch.int32) for p in parts]),
                           whole[k].view(torch.int32))
    assert all(torch.equal(p["offsets"], whole["offsets"]) for p in parts)


def test_sub_seeds_differ_by_purpose_and_fit_63_bits():
    seeds = {generate.sub_seed(s, purpose, slot) for s in (0, 1, 2**33)
             for purpose in ("keys", "segments") for slot in (0, 1)}
    assert len(seeds) == 12 and all(0 <= s < 2**63 for s in seeds)


def test_every_traffic_file_generates(tmp_path):
    for path in sorted((registry.BENCH_DIR / "traffic").glob("*.json")):
        tr = registry.traffic(path.stem)
        cfg = dict(CFG, n=1 << 14)
        if tr.get("segments", {}).get("layout") == "zipf":
            tr = dict(tr, segments=dict(tr["segments"], count=64))
        assert generate.pool_size(tr) >= 1
        assert _inputs(4, traffic=tr, cfg=cfg)["keys"].numel() == 1 << 14
