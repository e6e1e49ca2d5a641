"""The frozen yardstick on made-up shapes and timelines."""

import pytest

from portbench import yardstick as ys
from portbench.timeline import Op, Timeline


def test_percentile_is_of_all_values_and_moves_with_one_stall():
    lat = [0.1 + 0.001 * i for i in range(100)]
    p = ys.percentile(lat, 95)
    assert p == pytest.approx(0.1 + 0.001 * 94.05)
    # One stall delays the request behind it and every one after it in an
    # open loop: the tail moves.
    stalled = lat[:90] + [x + 2.0 for x in lat[90:]]
    assert ys.percentile(stalled, 95) > p + 1.9
    assert ys.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        ys.percentile([], 95)


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert ys.bound_s(3.35e12, 0, "int8") == pytest.approx(1.0)
    assert ys.bound_s(0, 989e12, "bf16") == pytest.approx(1.0)
    assert ys.bound_s(3.35e9, 1979e12, "int8") == pytest.approx(1.0)


def test_gemm_counts_each_operand_once():
    ops, nbytes = ys.gemm_w8a8(256, 4096, 4096)
    assert ops == 2 * 256 * 4096 * 4096
    assert nbytes == 256 * 4096 + 4 * 256 + 4096 * 4096 + 4 * 4096 + 2 * 256 * 4096


def test_attention_counts_pairs_heads_and_cache_bytes():
    ops, nbytes = ys.attention(2, 10, heads=4, kv_heads=2, head_dim=8, kv_bytes_per_elem=1,
                               kv_scale_bytes=4)
    assert ops == 4 * 2 * 10 * 4 * 8
    assert nbytes == 2 * 2 * 2 * 4 * 8 + 4 * 2 * 4 + 2 * 10 * 2 * (8 + 4)
    causal, _ = ys.attention(5, 5, 1, 1, 8, 2, pairs=ys.causal_pairs(5))
    assert causal == 4 * 15 * 8


CFG = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 3,
       "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 100}


def test_generate_work_counts_launches_and_grows_with_history():
    m = ys.Model(CFG)
    assert m.projections() == [(64, 64), (32, 64), (32, 64), (64, 64), (128, 64), (128, 64),
                               (64, 128)]
    w = ys.generate_work(m, shared=16, rows=4, suffix=8, new=5)
    assert [w[p]["k1"] for p in ("shared", "unique", "decode")] == [21, 21, 84]
    per_token = sum(2 * N * K for N, K in m.projections()) * m.L
    assert w["decode"]["gemm"].ops["int8"] == pytest.approx(4 * 4 * per_token)
    assert w["shared"]["gemm"].ops["int8"] == pytest.approx(16 * per_token)
    # Decode attention: each step reads the level (16 keys) and the row's
    # unique history (suffix + tokens before + its own).
    hist = sum(8 + i + 1 for i in range(4))
    want = 4 * 4 * (4 * 16) * 4 * 16 + 4 * (4 * hist) * 4 * 16  # 4 steps, 4 rows
    assert w["decode"]["attn"].ops["bf16"] == pytest.approx(want * m.L)
    t = ys.decode_token_work(m, 30)
    assert t.ops["int8"] == pytest.approx(per_token)
    assert t.ops["bf16"] == pytest.approx(4 * 30 * 4 * 16 * m.L + 2 * 64 * 100)


def test_names_fold_and_group():
    assert ys.fold_name("void (anonymous namespace)::flash_kernel<128, true>(Params)") \
        == "flash_kernel"
    assert ys.group_of("void w8a8_kernel<2, 128, __nv_bfloat16, float>(CUtensorMap)") \
        == "w8a8_kernel"
    assert ys.group_of("void at::native::vectorized_elementwise_kernel<4>(int)") == "other"


def test_union_busy_and_idle():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert ys.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert ys.busy_s(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert ys.idle_gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert ys.idle_share(iv, 0.0, 4.0) == pytest.approx(0.25)


def test_timeline_breakdown_names_gaps_by_the_host():
    dev = [Op("void w8a8_kernel<1>(x)", 1.0, 2.0), Op("void flash_kernel<2>(y)", 3.0, 3.5),
           Op("void w8a8_kernel<1>(x)", 4.0, 4.2)]
    host = [Op("aten::copy_", 2.1, 2.9), Op("pb.call", 0.5, 4.5)]
    tl = Timeline(dev, [Op("pb.call", 0.5, 4.5)], host, Op("pb.window", 0.5, 5.0))
    assert tl.busy_s() == pytest.approx(1.7)
    b = tl.breakdown()
    assert b["device_ops"][0] == ["w8a8_kernel", pytest.approx(1.2)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(1.0)
    assert gaps["pb.call"] == pytest.approx(0.5 + 0.5)  # 0.5-1.0 and 3.5-4.0
    assert tl.device_extent(Op("pb.call", 0.5, 4.5)) == ("pb.call", 1.0, 4.2)
    assert [o.start for o in tl.ops_in(2.5, 4.0)] == [3.0]


def test_lognormal_lengths_are_clipped_quantiles_and_the_same_for_every_seed():
    from pathlib import Path

    import numpy as np

    from portbench import run

    serve = run.load_module(Path(run.__file__).parent / "drivers" / "serve.py", "serve_lengths")
    spec = {"median": 100, "sigma": 1.0, "min": 8, "max": 400}
    x = serve.lengths(spec, 1001)
    assert x.min() >= 8 and x.max() == 400 and np.median(x) == 100
    # The share clipped at the top: P(z > ln 4) = 8.3 %.
    assert (x == 400).mean() == pytest.approx(0.0829, abs=0.002)
    assert serve.length_range(spec) == (8, 400)
    assert list(serve.lengths([4, 7], 4)) == [4, 5, 6, 7]
    mix = {"rate_per_s": 5.0, "suffix_tokens": spec, "new_tokens": [8, 64]}
    a, b = (serve.requests(mix, s, 20.0, 1000) for s in (1, 2**31 + 7))
    assert sorted(len(q.ids) for q in a) == sorted(len(q.ids) for q in b)
    assert [len(q.ids) for q in a] != [len(q.ids) for q in b]
