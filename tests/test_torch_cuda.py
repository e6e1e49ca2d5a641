"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present (decided in
a fixture, at run time). On the card, run them with
``python -m pytest tests/test_torch_cuda.py -m gpu``. Shapes are small and
ragged, to reach every tail of the kernels. Tolerances are for bf16: the
kernels round P to bf16 before the second product (flash) and the outputs
to bf16, where the plain versions compute in fp32 from the same bf16 inputs.
"""

import pytest
import torch

from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops import decode as tdecode
from hydragen_torch.ops import flash as tflash
from hydragen_torch.ops import gemm as tgemm

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _gen(seed=0):
    return torch.Generator(device="cuda").manual_seed(seed)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("M,N,K", [(5, 130, 96), (256, 512, 4096), (70, 11264, 256)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w8a8_kernel_matches_plain(dev, M, N, K, out_dtype):
    g = _gen(1)
    a = torch.randn(M, K, device=dev, generator=g)
    a_q, a_s = tgemm.quantize_rows(a)
    w = torch.randint(-127, 128, (3, N, K), dtype=torch.int8, device=dev, generator=g)
    ws = (torch.rand(3, N, device=dev, generator=g) * 0.01 + 1e-3).to(torch.bfloat16)
    before = cuda_lib.LAUNCHES["w8a8_matmul_cached"]
    out = tgemm.w8a8_matmul_cached(2, a_q, a_s, w, ws, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["w8a8_matmul_cached"] == before + 1
    ref = tgemm.w8a8_cached_plain(2, a_q, a_s, w, ws, out_dtype=torch.float32)
    tol = 1e-2 if out_dtype == torch.bfloat16 else 1e-5
    assert _rel(out, ref) < tol


def _w8a8_oracle(a_q, a_s, w, ws, out_dtype):
    """The kernel's function in its order, from an exact i32 product:
    ``torch._int_mm`` where it takes the shape, else an f64 product (every
    partial sum is an integer below 2^31, exact in f64)."""
    M, K = a_q.shape
    N = w.shape[0]
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        acc = torch._int_mm(a_q, w.t())
    else:
        acc = (a_q.double() @ w.double().t()).to(torch.int32)
    return (acc.float() * a_s * ws.float()[None, :]).to(out_dtype)


def _w8a8_plans(M, N, K):
    """gemm_plan's own choice and every (bm, bn, split) the kernel takes at
    this shape."""
    auto = tgemm.gemm_plan(M, N, K, cuda_lib.sm_count(torch.device("cuda")))
    steps = -(-K // tgemm.GEMM_BK)
    plans = {auto}
    for bm in (128, 256):
        for bn in (64, 128):
            for s in tgemm.GEMM_SPLITS:
                per = -(-steps // s)
                if -(-steps // per) == s:
                    plans.add(tgemm.GemmPlan(bm, bn, s, per))
    return sorted(plans)


W8A8_EXACT_SHAPES = [(5, 130, 96), (70, 11264, 256), (300, 1026, 4112), (256, 1024, 4096)]


@pytest.mark.parametrize("M,N,K", W8A8_EXACT_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w8a8_kernel_is_bit_exact_at_every_split(dev, M, N, K, out_dtype):
    """K1 and K1' equal the scaled exact product bit for bit at every plan
    the kernel takes (integer sums do not depend on the split), into an
    output pre-filled with NaN."""
    g = _gen(11)
    a_q, a_s = tgemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
    w = torch.randint(-128, 128, (3, N, K), dtype=torch.int8, device=dev, generator=g)
    ws = (torch.rand(3, N, device=dev, generator=g) * 0.01 + 1e-3).to(torch.bfloat16)
    ref = _w8a8_oracle(a_q, a_s, w[1], ws[1], out_dtype)
    for plan in _w8a8_plans(M, N, K):
        out = torch.full((M, N), float("nan"), dtype=out_dtype, device=dev)
        tgemm._launch_w8a8("w8a8_matmul_cached", a_q, a_s, w, ws, 1, out_dtype, plan=plan,
                           out=out)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), plan
    assert torch.equal(tgemm.w8a8_matmul_cached(1, a_q, a_s, w, ws, out_dtype), ref)
    assert torch.equal(tgemm.w8a8_matmul(a_q, a_s, w[1].clone(), ws[1].clone(), out_dtype), ref)


def test_w8a8_kernel_graph_replays_give_the_same_bits(dev):
    """Two replays of a captured K1 launch (a split plan) give the same
    bits: the launch keeps no state between calls."""
    g = _gen(12)
    M, N, K = 256, 1024, 4096
    a_q, a_s = tgemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
    w = torch.randint(-128, 128, (2, N, K), dtype=torch.int8, device=dev, generator=g)
    ws = (torch.rand(2, N, device=dev, generator=g) * 0.01 + 1e-3).to(torch.bfloat16)
    assert tgemm.gemm_plan(M, N, K, cuda_lib.sm_count(dev)).splits > 1
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    tgemm._launch_w8a8("w8a8_matmul_cached", a_q, a_s, w, ws, 1, torch.bfloat16, out=out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tgemm._launch_w8a8("w8a8_matmul_cached", a_q, a_s, w, ws, 1, torch.bfloat16, out=out)
    runs = []
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        runs.append(out.clone())
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], _w8a8_oracle(a_q, a_s, w[1], ws[1], torch.bfloat16))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,int8,lens", [
    (True, False, None), (False, True, [70, 0]), (True, True, [100, 37]),
    (False, False, [1, 100]),
])
def test_flash_kernel_matches_plain(dev, d, causal, int8, lens):
    """K2's kernel (K4 when causal): M = 134 or 80 folded rows, both above
    K5's 32, so the non-causal cases reach K2 too."""
    g = _gen(2)
    b, hq, hkv, m, s = 2, 4, 2, 67 if causal else 40, 100
    q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
    if int8:
        k = torch.randint(-127, 128, (b, hkv, s, d), dtype=torch.int8, device=dev, generator=g)
        v = torch.randint(-127, 128, (b, hkv, s, d), dtype=torch.int8, device=dev, generator=g)
        ks = torch.rand(b, hkv, s, device=dev, generator=g) * 0.02 + 1e-3
        vs = torch.rand(b, hkv, s, device=dev, generator=g) * 0.02 + 1e-3
    else:
        k = torch.randn(b, hkv, s, d, device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn(b, hkv, s, d, device=dev, generator=g).to(torch.bfloat16)
        ks = vs = None
    kw = dict(causal=causal, k_scale=ks, v_scale=vs,
              kv_seq_lens=None if lens is None else torch.tensor(lens, device=dev))
    before = dict(cuda_lib.LAUNCHES)
    o, l = tflash.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention_bhsd"] == before["flash_attention_bhsd"] + 1
    assert cuda_lib.LAUNCHES["flash_decode_bhsd"] == before["flash_decode_bhsd"]
    po, pl = tflash.flash_attention_bhsd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)


def _kv(dev, g, shape, int8):
    """Random k, v (and f32 scales for int8) of ``shape`` on the card."""
    if int8:
        k, v = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
                for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 1e-3
                  for _ in range(2))
        return k, v, ks, vs
    k, v = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
    return k, v, None, None


def _poison_tails(k, v, ks, vs, lens):
    """Every key and value row at or past its row's length (dim 0 is the
    batch, dim -2 or -1 the token): NaN for bf16; +127 / -128 payloads with
    huge k scales and NaN v scales for int8."""
    for i, n in enumerate(lens):
        if ks is None:
            k[i, ..., n:, :] = float("nan")
            v[i, ..., n:, :] = float("nan")
        else:
            k[i, ..., n:, :] = 127
            v[i, ..., n:, :] = -128
            ks[i, ..., n:] = 1e30
            vs[i, ..., n:] = float("nan")


# name: (b, hq, hkv, m, S, lens, causal)
FLASH_CASES = {
    # M = 148 (not a multiple of the block's 128 rows), S = 300 (not of the
    # 64-key tile), a row of length 0; 2 KV splits.
    "ragged_len0_split2": (2, 8, 2, 37, 300, [300, 0], False),
    # GQA group 4 with q_len 50 < 128: causal blocks straddle query heads.
    "gqa4_causal_straddle": (2, 8, 2, 50, 70, [70, 61], True),
    # 8 KV splits, one of them past a row's length, one row of length 0.
    "split8": (4, 8, 2, 40, 1000, [1000, 999, 0, 513], False),
    # 69 blocks of 128 rows x 2 heads fill the card: no split.
    "no_split": (1, 8, 2, 2200, 100, [97], False),
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel_tails_splits_and_poisoned_rows(dev, d, int8, case):
    """K2/K4 against its plain version on ragged shapes, GQA, KV splits and
    rows of length 0 (out 0, lse -inf); then the same call with NaN (or
    extreme int8 values and scales) in every key and value row past each
    row's length gives the same output, bit for bit."""
    b, hq, hkv, m, S, lens, causal = FLASH_CASES[case]
    g = _gen(24)
    k, v, ks, vs = _kv(dev, g, (b, hkv, S, d), int8)
    q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(causal=causal, kv_seq_lens=torch.tensor(lens, device=dev), k_scale=ks,
              v_scale=vs)
    before = cuda_lib.LAUNCHES["flash_attention_bhsd"]
    o, l = tflash.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention_bhsd"] == before + 1
    po, pl = tflash.flash_attention_bhsd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(torch.isneginf(l), torch.isneginf(pl))
    fin = torch.isfinite(pl)
    torch.testing.assert_close(l[fin], pl[fin], atol=1e-3, rtol=1e-3)
    for i, n in enumerate(lens):
        if n == 0:
            assert (o[i] == 0).all() and torch.isneginf(l[i]).all()
    _poison_tails(k, v, ks, vs, lens)
    kw.update(k_scale=ks, v_scale=vs)
    o2, l2 = tflash.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(l2, l)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_flash_cached_kernel_last_layer_poisoned_rows(dev, d, int8):
    """K2 reading the last layer of stacked level buffers in place (b < SB,
    M = 132): against its plain version, then unchanged, bit for bit, with
    every row past its length poisoned in every layer."""
    g = _gen(25)
    L, SB, hkv, S, b, hq, m = 3, 3, 2, 150, 2, 8, 33
    k, v, ks, vs = _kv(dev, g, (L, SB, hkv, S, d), int8)
    q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
    lens = [150, 77]
    kw = dict(kv_seq_lens=torch.tensor(lens, device=dev, dtype=torch.int32), k_scale_all=ks,
              v_scale_all=vs)
    before = cuda_lib.LAUNCHES["flash_attention_cached_bhsd"]
    o, l = tflash.flash_attention_cached_bhsd(L - 1, q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention_cached_bhsd"] == before + 1
    po, pl = tflash.flash_attention_cached_plain(L - 1, q, k, v, **kw)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)
    perm = (1, 0, 2, 3, 4)  # batch first, for _poison_tails
    _poison_tails(k.permute(perm), v.permute(perm), None if ks is None else ks.permute(perm[:4]),
                  None if vs is None else vs.permute(perm[:4]), lens)
    o2, l2 = tflash.flash_attention_cached_bhsd(L - 1, q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(l2, l)


def test_flash_cached_kernel_matches_plain(dev):
    g = _gen(3)
    L, SB, hkv, S, d, b, hq, m = 3, 3, 2, 150, 128, 2, 4, 33
    k = torch.randint(-127, 128, (L, SB, hkv, S, d), dtype=torch.int8, device=dev, generator=g)
    v = torch.randint(-127, 128, (L, SB, hkv, S, d), dtype=torch.int8, device=dev, generator=g)
    ks = torch.rand(L, SB, hkv, S, device=dev, generator=g) * 0.02 + 1e-3
    vs = torch.rand(L, SB, hkv, S, device=dev, generator=g) * 0.02 + 1e-3
    q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
    lens = torch.tensor([150, 77], device=dev, dtype=torch.int32)
    for layer in (0, 2):
        kw = dict(kv_seq_lens=lens, k_scale_all=ks, v_scale_all=vs)
        o, l = tflash.flash_attention_cached_bhsd(layer, q, k, v, **kw)
        po, pl = tflash.flash_attention_cached_plain(layer, q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("own,shared", [(False, False), (True, True)])
def test_decode_kernel_matches_plain(dev, group, own, shared):
    g = _gen(4)
    L, B, S, hkv, d, b = 2, 6, 40, 2, 128, 5
    hq = hkv * group
    k = torch.randint(-127, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev, generator=g)
    v = torch.randint(-127, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev, generator=g)
    ks = torch.rand(L, B, S * hkv, device=dev, generator=g) * 0.02 + 1e-3
    vs = torch.rand(L, B, S * hkv, device=dev, generator=g) * 0.02 + 1e-3
    q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    lens = torch.tensor([40, 0, 13, 1, 99], device=dev, dtype=torch.int32)
    kw = dict(kv_seq_lens=lens, k_scale_all=ks, v_scale_all=vs)
    if own:
        kw["own_kv"] = tuple(torch.randn(b, hkv, 1, d, device=dev, generator=g)
                             .to(torch.bfloat16) for _ in range(2))
    if shared:
        kw["shared_partial"] = (
            torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16),
            torch.randn(b, hq, 1, device=dev, generator=g) * 2,
        )
    o, l = tdecode.decode_attention_cached(1, q, k, v, **kw)
    po, pl = tdecode.decode_attention_cached_plain(1, q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)


def test_engine_kernel_path_matches_plain_path(dev):
    """A small bf16 w8a8 + int8-KV engine: the kernel path (default) and the
    plain path (impl="torch") give close logits along one forced token
    stream, and the kernel path launches every kernel. The unique cache is
    BSHD, the layout the decode kernel reads (at 7B widths it is the
    default)."""
    from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
    from hydragen_torch.models.llama import init_params

    cfg = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)
    params = init_params(cfg, _gen(5), quantized="w8a8", device=dev)
    prompt = torch.randint(1, 512, (1, 200), generator=_gen(6), device=dev)
    forced = torch.randint(1, 512, (8, 3), generator=_gen(7), device=dev)
    logits = {}
    for impl in ("kernel", "torch"):
        e = HydragenLlama(cfg, params, impl=impl, quantization="w8a8")
        e.setup_caches(8, 16, [1], [256], kv_quant="int8", unique_bshd=True)
        cuda_lib.reset_launches()
        _, lg = e.generate(input_ids=[prompt], num_return_sequences=8, max_new_tokens=3,
                           temperature=0.0, shared_cache_op=SharedCacheOp.WIPE,
                           return_logits=True, token_overrides=forced)
        logits[impl] = lg
        counts = dict(cuda_lib.LAUNCHES)
        if impl == "kernel":
            on_path = ("w8a8_matmul_cached", "flash_attention_cached_bhsd",
                       "decode_attention_cached", "flash_attention_bhsd")
            assert all(counts[n] > 0 for n in on_path), counts
        else:
            assert not any(counts.values()), counts
    for a, b in zip(logits["kernel"], logits["torch"]):
        assert _rel(a, b) < 5e-2
        assert torch.isfinite(a).all()


@pytest.mark.parametrize("case", ["fp32", "head_dim_32"])
def test_engine_kernel_path_raises_where_a_kernel_does_not_take(dev, case):
    """On the card, impl="kernel" never falls back to a plain version: an
    fp32 model (the flash kernel reads bf16 queries) or a head size the
    kernels lack raises in the flash kernel's wrapper at the first prefill."""
    from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
    from hydragen_torch.models.llama import init_params

    cfg = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2)
    if case == "fp32":
        cfg["dtype"] = "float32"
    else:
        cfg.update(num_attention_heads=8, num_key_value_heads=8)
    cfg = ModelConfig(**cfg)
    e = HydragenLlama(cfg, init_params(cfg, _gen(8), device=dev), impl="kernel")
    e.setup_caches(4, 8, [1], [32])
    prompt = torch.randint(1, 256, (1, 20), generator=_gen(9), device=dev)
    with pytest.raises(ValueError, match="flash kernel"):
        e.generate(input_ids=[prompt], num_return_sequences=4, max_new_tokens=2,
                   temperature=0.0, shared_cache_op=SharedCacheOp.WIPE)


def test_w8a8_stacked_raises_on_a_shape_the_kernel_does_not_take(dev):
    """A w8a8 projection whose K the kernel does not take raises on the card
    instead of running weight-only dq."""
    from hydragen_torch.ops.quant import QuantizedTensor, qmatmul_stacked

    g = _gen(10)
    w = QuantizedTensor(
        torch.randint(-127, 128, (2, 64, 40), dtype=torch.int8, device=dev, generator=g),
        torch.full((2, 64), 1e-2, dtype=torch.bfloat16, device=dev),
    )
    x = torch.randn(1, 3, 40, device=dev, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="w8a8 kernel"):
        qmatmul_stacked(x, w, 1, "bth,hd->btd", impl="w8a8")


# Ragged M (1, 129, 257), N off the 64-row weight tile (130, 258, 1026),
# groups of 64, 128 and 256, K/2 shorter than one 128-byte stage (64) and
# ending half-way through one (320); a group of 1,024, longer than one
# 128-byte stage, so a flush takes the sums of several stages; M = 4,353,
# more M tiles than one raster group at both tiles (35 and 18), the last
# group short.
W4A8_SHAPES = [(5, 130, 256, 128), (256, 512, 4096, 128), (70, 11264, 512, 64),
               (33, 256, 1024, 256), (1, 130, 128, 64), (129, 258, 640, 64),
               (257, 1026, 1536, 256), (129, 130, 1024, 128), (33, 130, 2048, 1024),
               (4353, 130, 1024, 128)]


@pytest.mark.parametrize("M,N,K,group", W4A8_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4a8_kernel_matches_plain(dev, M, N, K, group, out_dtype):
    """K6 against w4a8_reference: only the f32 order of the scaled group
    sums differs, so fp32 output agrees to 1e-5 of the largest value."""
    g = _gen(11)
    a_q, a_s = tgemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
    qp = torch.randint(-128, 128, (3, N, K // 2), dtype=torch.int8, device=dev, generator=g)
    gs = (torch.rand(3, K // group, N, device=dev, generator=g) * 0.01 + 1e-3).to(torch.bfloat16)
    before = cuda_lib.LAUNCHES["w4a8_matmul_cached"]
    out = tgemm.w4a8_matmul_cached(2, a_q, a_s, qp, gs, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["w4a8_matmul_cached"] == before + 1
    ref = tgemm.w4a8_cached_plain(2, a_q, a_s, qp, gs, out_dtype=torch.float32)
    tol = 1e-2 if out_dtype == torch.bfloat16 else 1e-5
    assert _rel(out, ref) < tol


def _w4a8_case(dev, M, N, K, group, seed, L=3):
    g = _gen(seed)
    a_q, a_s = tgemm.quantize_rows(torch.randn(M, K, device=dev, generator=g))
    qp = torch.randint(-128, 128, (L, N, K // 2), dtype=torch.int8, device=dev, generator=g)
    gs = (torch.rand(L, K // group, N, device=dev, generator=g) * 0.01 + 1e-3
          ).to(torch.bfloat16)
    return a_q, a_s, qp, gs


@pytest.mark.parametrize("M,N,K,group", W4A8_SHAPES)
def test_w4a8_kernel_every_tile_into_nan(dev, M, N, K, group):
    """K6 at each activation tile it takes, into an output pre-filled with
    NaN (a tile left unstored shows), held to the f32 oracle; the 2-D entry
    gives the bits of the stacked one."""
    a_q, a_s, qp, gs = _w4a8_case(dev, M, N, K, group, 14)
    ref = tgemm.w4a8_cached_plain(1, a_q, a_s, qp, gs, out_dtype=torch.float32)
    for ba in tgemm.W4A8_TILES:
        out = torch.full((M, N), float("nan"), dtype=torch.float32, device=dev)
        tgemm._launch_w4a8("w4a8_matmul_cached", a_q, a_s, qp, gs, 1, torch.float32, ba=ba,
                           out=out)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), ba
        assert _rel(out, ref) < 1e-5, ba
    cached = tgemm.w4a8_matmul_cached(1, a_q, a_s, qp, gs, torch.bfloat16)
    flat = tgemm.w4a8_matmul(a_q, a_s, qp[1].clone(), gs[1].clone(), torch.bfloat16)
    assert torch.equal(flat, cached)


def test_w4a8_kernel_graph_replays_give_the_same_bits(dev):
    """Two replays of a captured K6 launch give the same bits: the launch
    keeps no state between calls."""
    M, N, K, group = 256, 1024, 4096, 128
    a_q, a_s, qp, gs = _w4a8_case(dev, M, N, K, group, 15, L=2)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    tgemm._launch_w4a8("w4a8_matmul_cached", a_q, a_s, qp, gs, 1, torch.bfloat16, out=out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tgemm._launch_w4a8("w4a8_matmul_cached", a_q, a_s, qp, gs, 1, torch.bfloat16,
                           out=out)
    runs = []
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        runs.append(out.clone())
    assert torch.equal(runs[0], runs[1])
    ref = tgemm.w4a8_cached_plain(1, a_q, a_s, qp, gs, out_dtype=torch.float32)
    assert _rel(runs[0], ref) < 1e-2


@pytest.mark.parametrize("impl", ["w8a8", "w4a8"])
def test_qmatmul_2d_launches_the_s8_kernel(dev, impl):
    """A 2-D weight under w8a8 or w4a8 runs its GEMM's 2-D entry on the card
    (one launch), never weight-only dq, and matches the plain version."""
    from hydragen_torch.ops import quant as tquant

    g = _gen(12)
    w = torch.randn(256, 384, device=dev, generator=g) * 0.05
    wq = tquant.quantize(w) if impl == "w8a8" else tquant.quantize4(w)
    x = torch.randn(2, 3, 256, device=dev, generator=g).to(torch.bfloat16)
    name = "w8a8_matmul" if impl == "w8a8" else "w4a8_matmul"
    before = dict(cuda_lib.LAUNCHES)
    y = tquant.qmatmul(x, wq, "bth,hd->btd", impl=impl)
    torch.cuda.synchronize()
    after = dict(cuda_lib.LAUNCHES)
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    ref = tquant.qmatmul(x.cpu(), type(wq)(*(t.cpu() for t in wq)), "bth,hd->btd", impl=impl)
    assert y.shape == (2, 3, 384) and _rel(y.cpu(), ref) < 2e-2


@pytest.mark.parametrize("case", ["w4a8_group32", "w4a8_fp32_scale", "write_fp32_kv",
                                  "decode_int4_scales"])
def test_int4_wrappers_raise_on_operands_their_kernels_do_not_take(dev, case):
    g = _gen(13)
    if case.startswith("w4a8"):
        a_q, a_s = tgemm.quantize_rows(torch.randn(4, 128, device=dev, generator=g))
        qp = torch.zeros(2, 64, 64, dtype=torch.int8, device=dev)
        G = 4 if case == "w4a8_group32" else 1
        gs = torch.ones(2, G, 64, device=dev,
                        dtype=torch.float32 if case == "w4a8_fp32_scale" else torch.bfloat16)
        with pytest.raises(ValueError, match="w4a8 kernel"):
            tgemm.w4a8_matmul_cached(1, a_q, a_s, qp, gs)
        return
    L, B, S, hkv, d = 2, 3, 4, 2, 64
    k_all = torch.zeros(L, B, S, hkv, d, dtype=torch.int8, device=dev)
    if case == "write_fp32_kv":
        sc = torch.zeros(L, B, 2 * S * hkv, device=dev)
        k = torch.randn(B, hkv, 1, d, device=dev, generator=g)
        with pytest.raises(ValueError, match="int4 write kernel"):
            tdecode.write_token_int4_cached(0, k, k, k_all, k_all.clone(), sc, sc.clone(), 5)
        return
    sc = torch.zeros(L, B, S * hkv, device=dev)  # int8-sized scales under kv_bits=4
    q = torch.randn(B, hkv, 1, d, device=dev, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="decode kernel"):
        tdecode.decode_attention_cached(0, q, k_all, k_all, kv_seq_lens=torch.full(
            (B,), 3, device=dev), k_scale_all=sc, v_scale_all=sc, kv_bits=4)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("own,shared", [(False, False), (True, True)])
def test_decode_int4_kernel_matches_plain(dev, d, own, shared):
    """K3 at kv_bits=4 over S = 20 byte rows: the lengths (40, 0, 13, 21, 99,
    33) read the high plane in four rows, so an off-by-plane error shows."""
    g = _gen(14)
    L, B, S, hkv, b, group = 2, 7, 20, 2, 6, 4
    hq = hkv * group
    k = torch.randint(-128, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev, generator=g)
    v = torch.randint(-128, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev, generator=g)
    ks = torch.rand(L, B, 2 * S * hkv, device=dev, generator=g) * 0.2 + 1e-2
    vs = torch.rand(L, B, 2 * S * hkv, device=dev, generator=g) * 0.2 + 1e-2
    q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    lens = torch.tensor([40, 0, 13, 21, 99, 33], device=dev, dtype=torch.int32)
    kw = dict(kv_seq_lens=lens, k_scale_all=ks, v_scale_all=vs, kv_bits=4)
    if own:
        kw["own_kv"] = tuple(torch.randn(b, hkv, 1, d, device=dev, generator=g)
                             .to(torch.bfloat16) for _ in range(2))
    if shared:
        kw["shared_partial"] = (
            torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16),
            torch.randn(b, hq, 1, device=dev, generator=g) * 2,
        )
    before = cuda_lib.LAUNCHES["decode_attention_cached_int4"]
    o, l = tdecode.decode_attention_cached(1, q, k, v, **kw)
    po, pl = tdecode.decode_attention_cached_plain(1, q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["decode_attention_cached_int4"] == before + 1
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)


# K3 cases: name -> (kv bits, byte rows S, lengths). The lengths cross the
# 32-row tiles' edges and, at int4, the plane edge (S - 1, S, S + 1, S + 33,
# 2S); the shared partial's lse is -inf on row 0 and on every other head.
K3_LENGTHS = {
    "int8": (8, 70, [0, 1, 31, 32, 33, 70]),
    "int4": (4, 40, [0, 39, 40, 41, 73, 80]),
}
K3_MERGES = {"none": (False, False), "own": (True, False), "shared": (False, True),
             "both": (True, True)}


def _k3_inputs(dev, g, bits, S, lens, d, group, own, shared, L=2, hkv=2, spare_rows=2):
    """K3's operands for len(lens) rows of a cache with ``spare_rows`` more."""
    b, B, planes = len(lens), len(lens) + spare_rows, 2 if bits == 4 else 1
    hq = hkv * group
    k, v = (torch.randint(-128, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev,
                          generator=g) for _ in range(2))
    ks, vs = (torch.rand(L, B, planes * S * hkv, device=dev, generator=g) * 0.2 + 1e-2
              for _ in range(2))
    q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(kv_seq_lens=torch.tensor(lens, device=dev, dtype=torch.int32), k_scale_all=ks,
              v_scale_all=vs, kv_bits=bits)
    if own:
        kw["own_kv"] = tuple(torch.randn(b, hkv, 1, d, device=dev, generator=g)
                             .to(torch.bfloat16) for _ in range(2))
    if shared:
        lse_sh = torch.randn(b, hq, 1, device=dev, generator=g) * 2
        lse_sh[0] = float("-inf")
        lse_sh[:, ::2] = float("-inf")
        kw["shared_partial"] = (
            torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16), lse_sh)
    return q, k, v, kw


def _k3_poison(k, v, ks, vs, lens, bits):
    """Every byte and scale K3 must not use: payload byte rows at or past
    each row's length +127 / -128, at int4 the high nibbles whose token is
    past the length -8, scales past the length NaN; batch rows past
    len(lens) all of these."""
    S, hkv = k.shape[2], k.shape[3]
    for i in range(k.shape[1]):
        n = lens[i] if i < len(lens) else 0
        lim = min(n, S)
        k[:, i, lim:] = 127
        v[:, i, lim:] = -128
        if bits == 4:
            dead = slice(max(n - S, 0), lim)  # byte rows whose high token is past n
            for buf in (k, v):
                buf[:, i, dead] = ((buf[:, i, dead].to(torch.int32) & 0xF) - 128).to(torch.int8)
        ks[:, i, n * hkv:] = float("nan")
        vs[:, i, n * hkv:] = float("nan")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(K3_LENGTHS))
@pytest.mark.parametrize("merge", list(K3_MERGES))
def test_decode_kernel_lengths_groups_merges_and_poisoned_tails(dev, d, group, case, merge):
    """K3 against its plain version, one launch a call, at lengths on and
    around its tile and plane edges, every GQA group it takes, with and
    without the own token and the shared partial (whose lse is -inf on some
    rows); then, with every byte and scale it must not read poisoned, the
    same output bit for bit."""
    bits, S, lens = K3_LENGTHS[case]
    own, shared = K3_MERGES[merge]
    q, k, v, kw = _k3_inputs(dev, _gen(30), bits, S, lens, d, group, own, shared)
    key = "decode_attention_cached" if bits == 8 else "decode_attention_cached_int4"
    before = cuda_lib.LAUNCHES[key]
    o, l = tdecode.decode_attention_cached(1, q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[key] == before + 1
    po, pl = tdecode.decode_attention_cached_plain(1, q, k, v, **kw)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(torch.isneginf(l), torch.isneginf(pl))
    fin = torch.isfinite(pl)
    torch.testing.assert_close(l[fin], pl[fin], atol=1e-3, rtol=1e-3)
    assert (o[~fin[..., 0]] == 0).all()
    _k3_poison(k, v, kw["k_scale_all"], kw["v_scale_all"], lens, bits)
    o2, l2 = tdecode.decode_attention_cached(1, q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(l2, l)


@pytest.mark.parametrize("operand", ["q", "own_kv", "shared_partial"])
def test_decode_wrapper_raises_on_a_misaligned_operand(dev, operand):
    """K3 reads q, the own token and the shared partial as 16-byte vectors:
    a contiguous view that starts off a 16-byte boundary is refused."""
    q, k, v, kw = _k3_inputs(dev, _gen(32), 8, 40, [5, 40], 64, 2, True, True)

    def shifted(t):  # the same values, 2 bytes past a 16-byte boundary
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return out.copy_(t)

    if operand == "q":
        q = shifted(q)
    else:
        kw[operand] = (shifted(kw[operand][0]), kw[operand][1])
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        tdecode.decode_attention_cached(1, q, k, v, **kw)


@pytest.mark.parametrize("case", list(K3_LENGTHS))
def test_decode_kernel_graph_replays_give_the_same_bits(dev, case):
    """Two replays of a captured K3 launch give the same bits: the launch
    keeps no state between calls."""
    bits, S, lens = K3_LENGTHS[case]
    q, k, v, kw = _k3_inputs(dev, _gen(31), bits, S, lens, 128, 4, True, True)
    tdecode.decode_attention_cached(1, q, k, v, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, l = tdecode.decode_attention_cached(1, q, k, v, **kw)
    runs = []
    for _ in range(2):
        o.fill_(float("nan"))
        l.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        runs.append((o.clone(), l.clone()))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    po, _ = tdecode.decode_attention_cached_plain(1, q, k, v, **kw)
    torch.testing.assert_close(runs[0][0].float(), po.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [64, 128])
def test_write_int4_kernel_is_bit_exact(dev, d):
    """K7 against its plain version, byte for byte: low-plane slots (the stale
    high nibble cleared), high-plane slots over live low tokens, and a row
    count below the cache's."""
    g = _gen(15)
    L, B, S, hkv = 3, 5, 6, 4
    bufs = [torch.randint(-128, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev,
                          generator=g) for _ in range(2)]
    scales = [torch.rand(L, B, 2 * S * hkv, device=dev, generator=g) for _ in range(2)]
    plain = [t.clone() for t in bufs + scales]
    for layer, slot, b in ((2, 1, 5), (0, 7, 5), (2, 11, 4), (1, 0, 3), (1, 6, 5)):
        k, v = (torch.randn(b, hkv, 1, d, device=dev, generator=g).mul(3).to(torch.bfloat16)
                for _ in range(2))
        tdecode.write_token_int4_cached(layer, k, v, *bufs, *scales, slot)
        tdecode.write_token_int4_cached_plain(layer, k, v, *plain, slot)
    torch.cuda.synchronize()
    for got, want in zip(bufs + scales, plain):
        assert torch.equal(got, want)


def test_engine_int4_kernel_path_matches_plain_path(dev):
    """A small bf16 w4a8 + int4-KV engine along one forced token stream: the
    kernel path launches K6, K2, K3-int4, K4 and K7 (the plain path nothing),
    and its logits are as close to an fp32 plain run as the plain bf16 path's
    are. The unique window is 16 logical tokens (8 byte rows), so the 11
    decode steps cross into the high plane.

    Not a bound between the two bf16 paths: on this small random int4 model
    each int4 re-quantization of K and V turns a last-bit difference into a
    whole code, so the plain bf16 path itself strays far from fp32 at single
    steps, and the flash kernel's bf16 rounding of P moves the kernel path
    by as much. Averaged over the steps, both stay as close."""
    from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
    from hydragen_torch.models.llama import init_params

    kw = dict(vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4)
    params = init_params(ModelConfig(**kw), _gen(16), quantized="w4a8", device=dev)
    prompt = torch.randint(1, 512, (1, 200), generator=_gen(17), device=dev)
    forced = torch.randint(1, 512, (8, 12), generator=_gen(18), device=dev)
    on_path = ("w4a8_matmul_cached", "flash_attention_cached_bhsd",
               "decode_attention_cached_int4", "flash_attention_bhsd", "write_token_int4_cached")

    def fp32(tree):  # quantized payloads and their bf16 scales stay as they are
        if isinstance(tree, dict):
            return {k: fp32(v) for k, v in tree.items()}
        return tree if isinstance(tree, tuple) else tree.float()

    logits = {}
    for name, dtype, p, impl in (("fp32", "float32", fp32(params), "torch"),
                                 ("plain", "bfloat16", params, "torch"),
                                 ("kernel", "bfloat16", params, "kernel")):
        e = HydragenLlama(ModelConfig(**kw, dtype=dtype), p, impl=impl, quantization="w4a8")
        e.setup_caches(8, 16, [1], [256], kv_quant="int4", unique_bshd=True)
        cuda_lib.reset_launches()
        _, lg = e.generate(input_ids=[prompt], num_return_sequences=8, max_new_tokens=12,
                           temperature=0.0, shared_cache_op=SharedCacheOp.WIPE,
                           return_logits=True, token_overrides=forced)
        logits[name] = [x.float() for x in lg]
        counts = dict(cuda_lib.LAUNCHES)
        if impl == "kernel":
            assert all(counts[n] > 0 for n in on_path), counts
        else:
            assert not any(counts.values()), counts

    def mean_rms(run):
        return sum(float((a - r).norm() / r.norm()) for a, r in zip(logits[run], logits["fp32"])
                   ) / len(logits["fp32"])

    assert all(torch.isfinite(x).all() for x in logits["kernel"])
    assert mean_rms("kernel") <= 1.25 * mean_rms("plain"), (mean_rms("kernel"),
                                                              mean_rms("plain"))


def test_timing_helpers_time_device_work(dev):
    from hydragen_torch.utils.timing import cuda_time_ms, timed

    x = torch.randn(1024, 1024, device=dev)
    assert cuda_time_ms(lambda: x @ x, iters=3, warmup=1) > 0
    times, warm = timed(lambda: x @ x, num_iters=3, num_warmup=2,
                        between_fn=lambda: x.zero_().add_(1))
    assert len(times) == 3 and len(warm) == 2 and min(times) > 0


# K5's tile and ring: lengths on both sides of a tile, of a full ring of
# either dtype's stages, and (at S = 2,000, 4 splits of 512) of a split.
_T = tflash.DECODE_TILE
_EDGES = [0, 1, _T - 1, _T, _T + 1, 3 * _T - 1, 3 * _T + 1, 4 * _T - 1, 4 * _T + 1]
# name: (S, lens)
DECODE_LENGTHS = {
    "one_split": (300, [300] + _EDGES + [211, 299]),
    "four_splits": (2000, [2000] + _EDGES + [511, 512, 513, 1500, 1999]),
}
# M = group * m folded rows: 1, 4 and 16 (one m16 tile), 17 and 32 (two).
DECODE_ROWS = {"M1": (2, 2, 1), "M4": (8, 2, 1), "M16": (16, 1, 1), "M17": (1, 1, 17),
               "M32": (16, 1, 2)}


def _decode_case(dev, g, d, int8, S, b, hkv, layout):
    """k, v and scales as views of a larger cache (more rows, layers and
    slots than read): BHSD [L, B, hkv, U, d] (token stride d), or a BHSD
    view of BSHD [L, B, U, hkv, d] (token stride hkv * d)."""
    L, extra = 3, 16
    shape = (L, b + 2, hkv, S + extra, d) if layout == "bhsd" else (L, b + 2, S + extra, hkv, d)
    k_all, v_all, ks_all, vs_all = _kv(dev, g, shape, int8)

    def view(x):
        x = x[1, :b]
        return x[:, :, :S] if layout == "bhsd" else x[:, :S].transpose(1, 2)

    k, v = view(k_all), view(v_all)
    assert not k.is_contiguous() and k.stride(2) == (d if layout == "bhsd" else hkv * d)
    sc = {} if not int8 else dict(k_scale=view(ks_all), v_scale=view(vs_all))
    return k, v, sc


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("lengths", list(DECODE_LENGTHS))
@pytest.mark.parametrize("rows", list(DECODE_ROWS))
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_decode_kernel_matches_plain(dev, d, int8, lengths, rows, layout):
    """K5 against its plain version on strided views of a larger cache, with
    lengths across its tile, ring and split boundaries and a row of length 0
    (out 0, lse -inf): one split (S <= 512) and four (the rows cannot fill the
    card), M from 1 to 32 folded rows, token stride d or hkv * d."""
    S, lens = DECODE_LENGTHS[lengths]
    hq, hkv, m = DECODE_ROWS[rows]
    g = _gen(19)
    b = len(lens)
    k, v, sc = _decode_case(dev, g, d, int8, S, b, hkv, layout)
    q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(kv_seq_lens=torch.tensor(lens, device=dev), **sc)
    before = dict(cuda_lib.LAUNCHES)
    o, l = tflash.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_decode_bhsd"] == before["flash_decode_bhsd"] + 1
    assert cuda_lib.LAUNCHES["flash_attention_bhsd"] == before["flash_attention_bhsd"]
    po, pl = tflash.flash_attention_bhsd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)
    assert torch.isneginf(l[1]).all() and (o[1] == 0).all()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("lengths", list(DECODE_LENGTHS))
def test_flash_decode_kernel_poisoned_rows(dev, d, int8, lengths):
    """K5 with NaN (bf16) or +127 / -128 payloads under huge k scales and NaN
    v scales (int8) in every key and value row at or past each row's length:
    out and lse unchanged, bit for bit (M = 4, token stride d)."""
    S, lens = DECODE_LENGTHS[lengths]
    g = _gen(26)
    b = len(lens)
    k, v, sc = _decode_case(dev, g, d, int8, S, b, 2, "bhsd")
    q = torch.randn(b, 8, 1, d, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(kv_seq_lens=torch.tensor(lens, device=dev), **sc)
    o, l = tflash.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    _poison_tails(k, v, sc.get("k_scale"), sc.get("v_scale"), lens)
    o2, l2 = tflash.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(l2, l)
    assert torch.isfinite(o2).all()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_flash_decode_kernel_many_rows_random_lengths(dev, d, int8):
    """More (row, split) items than the card holds warps at once (2,048
    rows), with random lengths from 0 to S (many rows of 0-3 tiles).
    Against the plain version, then unchanged, bit for bit, with every row
    past its length poisoned."""
    g = _gen(27)
    b, hq, hkv, S = 1024, 8, 2, 80
    lens = torch.randint(0, S + 1, (b,), device=dev, generator=g)
    lens[:7] = torch.tensor([0, 1, 31, 32, 33, 79, 80])
    k, v, sc = _decode_case(dev, g, d, int8, S, b, hkv, "bhsd")
    q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(kv_seq_lens=lens, **sc)
    o, l = tflash.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    po, pl = tflash.flash_attention_bhsd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(torch.isneginf(l), torch.isneginf(pl))
    fin = torch.isfinite(pl)
    torch.testing.assert_close(l[fin], pl[fin], atol=1e-3, rtol=1e-3)
    _poison_tails(k, v, sc.get("k_scale"), sc.get("v_scale"), lens.tolist())
    o2, l2 = tflash.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(l2, l)


@pytest.mark.parametrize("case", ["fp32_q", "head_dim_32", "token_stride_misaligned",
                                  "int8_without_scales", "M40"])
def test_flash_decode_wrapper_raises_on_operands_its_kernel_does_not_take(dev, case):
    """On a CUDA tensor a small-M non-causal call launches K5 or raises; it
    never falls back to K2's kernel or the plain version."""
    g = _gen(20)
    b, hq, hkv, m, S, d = 2, 8, 2, 1, 40, 128
    if case == "head_dim_32":
        d = 32
    q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(b, hkv, S, d, device=dev, generator=g).to(torch.bfloat16)
    v = k.clone()
    kw = {}
    if case == "fp32_q":
        q = q.float()
    elif case == "token_stride_misaligned":
        k = torch.randn(b, hkv, S, d + 4, device=dev, generator=g).to(torch.bfloat16)[..., :d]
    elif case == "int8_without_scales":
        k = v = torch.zeros(b, hkv, S, d, dtype=torch.int8, device=dev)
    before = dict(cuda_lib.LAUNCHES)
    with pytest.raises(ValueError, match="flash kernel"):
        if case == "M40":
            q = torch.randn(b, hq, 20, d, device=dev, generator=g).to(torch.bfloat16)
            tflash._flash_decode_bhsd(q, k, v, causal=False, kv_seq_lens=None, scale=None,
                                      k_scale=None, v_scale=None)
        else:
            tflash.flash_attention_bhsd(q, k, v, **kw)
    assert dict(cuda_lib.LAUNCHES) == before


@pytest.mark.parametrize("no_sharing", [False, True], ids=["hydragen", "no_sharing"])
def test_engine_gqa_kernel_path_matches_plain_path(dev, no_sharing):
    """A 2-layer GQA engine (hq 4, hkv 1, head_dim 128: a BHSD unique cache),
    w8a8 + int8 KV, along one forced token stream: the kernel path reads the
    unique cache with K5 and never with K3, and its logits are as close to an
    fp32 plain run as the plain bf16 path's are (mean RMS distance within
    1.25x). With ``disable_hydragen`` the prompt is copied into every unique
    row and K5 reads the whole history."""
    from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
    from hydragen_torch.models.llama import init_params

    kw = dict(vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=1, rope_theta=500000.0)
    params = init_params(ModelConfig(**kw), _gen(21), quantized="w8a8", device=dev)
    prompt = torch.randint(1, 512, (1, 200), generator=_gen(22), device=dev)
    forced = torch.randint(1, 512, (8, 6), generator=_gen(23), device=dev)

    def fp32(tree):  # quantized payloads and their bf16 scales stay as they are
        if isinstance(tree, dict):
            return {k: fp32(v) for k, v in tree.items()}
        return tree if isinstance(tree, tuple) else tree.float()

    logits = {}
    for name, dtype, p, impl in (("fp32", "float32", fp32(params), "torch"),
                                 ("plain", "bfloat16", params, "torch"),
                                 ("kernel", "bfloat16", params, "kernel")):
        e = HydragenLlama(ModelConfig(**kw, dtype=dtype), p, impl=impl, quantization="w8a8")
        e.setup_caches(8, 16 + (208 if no_sharing else 0), [1], [256], kv_quant="int8")
        assert not e.cache.unique_bshd
        cuda_lib.reset_launches()
        _, lg = e.generate(input_ids=[prompt], num_return_sequences=8, max_new_tokens=6,
                           temperature=0.0, shared_cache_op=SharedCacheOp.WIPE,
                           return_logits=True, token_overrides=forced,
                           disable_hydragen=no_sharing)
        logits[name] = [x.float() for x in lg]
        counts = dict(cuda_lib.LAUNCHES)
        if impl == "kernel":
            assert counts["flash_decode_bhsd"] == 2 * 5 and counts["decode_attention_cached"] == 0
            assert (counts["flash_attention_cached_bhsd"] == 0) == no_sharing, counts
        else:
            assert not any(counts.values()), counts

    def mean_rms(run):
        return sum(float((a - r).norm() / r.norm()) for a, r in zip(logits[run], logits["fp32"])
                   ) / len(logits["fp32"])

    assert all(torch.isfinite(x).all() for x in logits["kernel"])
    assert mean_rms("kernel") <= 1.25 * mean_rms("plain"), (mean_rms("kernel"),
                                                              mean_rms("plain"))
