"""K8 (``ops/act.py``, ``csrc/act.cu``): the s8 activations of K1 and K6.

On the CPU: each entry's plain version against the unfused chain it
replaces, written out here, bit for bit; the launch plan; which entries a
decoder layer routes through under each mode; and ``chip_smoke``'s check of
the norm's codes. Marked ``gpu`` (skipped without a card): each kernel
against its plain version at the cells' shapes, on the card with
``python -m pytest tests/test_torch_act.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hydragen_torch import HydragenLlama, SharedCacheOp
from hydragen_torch.core import engine as tengine
from hydragen_torch.models.config import ModelConfig
from hydragen_torch.models.llama import init_params
from hydragen_torch.ops import act, cuda_lib, gemm
from hydragen_torch.ops.quant import RECIP_127

# The hidden width, the MLP's (11,008 as loaded, 11,264 padded to _I_PAD) and
# a tp=2 rank's slice of it.
WIDTHS = (4096, 11008, 11264, 5504)
ROWS = (1, 7, 256)
EPS = 1e-5


def _bf16(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(torch.bfloat16)


def _quantize_chain(y):
    """quantize_rows as the layer ran it: amax, clamp, the f32 reciprocal of
    127, an IEEE division, round half to even."""
    yf = y.reshape(-1, y.shape[-1]).float()
    scale = torch.clamp(yf.abs().amax(dim=-1, keepdim=True), min=1e-20) * RECIP_127
    return torch.round(yf / scale).to(torch.int8), scale


def _equal(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("delta", [False, True], ids=["input_norm", "post_attn_norm"])
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K", WIDTHS)
def test_rms_norm_quant_plain_is_the_unfused_chain(K, M, delta):
    x = _bf16((M, K), 0)
    d = _bf16((M, K), 1, 0.5) if delta else None
    w = (1 + 0.1 * torch.randn(K, generator=torch.Generator().manual_seed(2))).to(torch.bfloat16)
    h = x + d if delta else x
    hf = h.float()
    y = (hf * torch.rsqrt((hf * hf).mean(dim=-1, keepdim=True) + EPS) * w.float()).to(h.dtype)
    want = _quantize_chain(y)
    for fn in (act.rms_norm_quant_plain, act.rms_norm_quant):
        pair, h_out = fn(x, w, EPS, d)
        assert _equal(pair, want) and torch.equal(h_out, h)
        assert pair[0].shape == (M, K) and pair[1].shape == (M, 1)


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K", WIDTHS)
def test_silu_mul_quant_plain_is_the_unfused_chain(K, M):
    g, u = _bf16((M, K), 3, 3.0), _bf16((M, K), 4)
    want = _quantize_chain(torch.nn.functional.silu(g.float()).to(u.dtype) * u)
    assert _equal(act.silu_mul_quant_plain(g, u), want)
    assert _equal(act.silu_mul_quant(g, u), want)


@pytest.mark.parametrize("K,plan,silu", [
    (16, (32, 1), (32, 1)), (4096, (256, 1), (256, 1)), (11008, (192, 4), (352, 2)),
    (11264, (192, 4), (352, 2)), (5504, (192, 2), (352, 1)), (32768, (256, 8), (256, 8))])
def test_act_plan_covers_the_row(K, plan, silu):
    assert act.act_plan(K) == plan and act.act_plan(K, "silu_mul_quant") == silu
    for threads, nu in act.act_plans(K):
        assert threads % 32 == 0 and threads <= act.ACT_MAX_THREADS[nu]
        assert threads * nu * act.ACT_UNIT >= K > threads * nu * act.ACT_UNIT - 32 * nu * 16


@pytest.mark.parametrize("K", [4100, 32784])
def test_act_plan_refuses_what_the_kernel_does_not_take(K):
    with pytest.raises(ValueError):
        act.act_plan(K)
    with pytest.raises(ValueError):
        act.act_plan(K, "silu_mul_quant") if K % 16 else act.act_plan(2 * K, "silu_mul_quant")


def test_mean_factor_is_torch_means():
    """The factor f32(M) / f32(M K) that ``torch.mean`` scales a row sum by
    on the card: 1/K wherever M K is exact in f32."""
    assert act.mean_factor(7, 4096) == 2.0 ** -12
    assert act.mean_factor(65536, 4096) == 2.0 ** -12
    assert act.mean_factor(3, 5120) == float(np.float32(3) / np.float32(15360))


# --- where a decoder layer takes K8 --------------------------------------------

TINY = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=256)


def _routes(monkeypatch, quantization, impl=None):
    """Calls of K8's three entries over one generate call (a shared prefill
    and its decode steps), and the forwards it ran."""
    params = init_params(TINY, torch.Generator().manual_seed(0))
    eng = HydragenLlama(TINY, params, quantization=quantization, impl=impl, device="cpu")
    eng.setup_caches(2, 16, [1], [16])
    calls = dict.fromkeys(("rms_norm_quant", "silu_mul_quant", "quantize_rows", "forwards"), 0)

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(act, "rms_norm_quant", counted("rms_norm_quant", act.rms_norm_quant))
    monkeypatch.setattr(act, "silu_mul_quant", counted("silu_mul_quant", act.silu_mul_quant))
    monkeypatch.setattr(gemm, "quantize_rows", counted("quantize_rows", gemm.quantize_rows))
    monkeypatch.setattr(tengine, "model_forward", counted("forwards", tengine.model_forward))
    toks = eng.generate(input_ids=[torch.randint(1, 256, (1, 10))], num_return_sequences=2,
                        max_new_tokens=4, temperature=0.0, shared_cache_op=SharedCacheOp.WIPE)
    assert tuple(toks.shape) == (2, 4)
    return calls


@pytest.mark.parametrize("quantization", ["w8a8", "w4a8", "mixed"])
def test_layer_routes_through_k8(monkeypatch, quantization):
    """Every reader of both norms, of the SiLU product and of o's input is
    an s8 GEMM: a layer makes its s8 activations through rms_norm_quant
    twice, silu_mul_quant and quantize_rows once each."""
    calls = _routes(monkeypatch, quantization)
    L, n = TINY.num_hidden_layers, calls.pop("forwards")
    assert n == 4
    assert calls == {"rms_norm_quant": 2 * L * n, "silu_mul_quant": L * n,
                     "quantize_rows": L * n}


@pytest.mark.parametrize("quantization,impl", [("int8", None), ("w8a8", "torch")],
                         ids=["dq", "impl_torch"])
def test_layer_routes_through_none_of_k8(monkeypatch, quantization, impl):
    """Weight-only products read the bf16 activation; ``impl="torch"`` runs
    every op's plain version: neither goes through K8's entries."""
    calls = _routes(monkeypatch, quantization, impl)
    assert calls.pop("forwards") == 4
    assert calls == {"rms_norm_quant": 0, "silu_mul_quant": 0, "quantize_rows": 0}


# --- chip_smoke's check of the norm's codes -------------------------------------


def _norm_at(x, w, d, steps):
    """The plain chain's result with each row's mean of squares moved by
    ``steps[row]`` f32 steps: what a kernel summing in another order gives."""
    h = x + d
    hf = h.float()
    var = (hf * hf).mean(dim=-1, keepdim=True)
    var = (var.view(torch.int32) + steps[:, None]).view(torch.float32)
    y = (hf * torch.rsqrt(var + EPS) * w.float()).to(x.dtype)
    return gemm.quantize_rows_plain(y), h


def test_k8_norm_match_takes_a_neighbouring_mean():
    M, K = 512, 4096
    x, d = _bf16((M, K), 5), _bf16((M, K), 6, 0.5)
    w = (1 + 0.1 * torch.randn(K, generator=torch.Generator().manual_seed(7))).to(torch.bfloat16)
    steps = torch.randint(-3, 4, (M,), generator=torch.Generator().manual_seed(8),
                          dtype=torch.int32)
    pair, h = _norm_at(x, w, d, steps)
    m = chip_smoke.k8_norm_match(x, w, EPS, d, pair, h)
    assert m["ok"] and m["rows"] == M and m["rows_unmatched"] == 0
    assert 0 < m["rows_moved"] and 1 <= m["widest_ulps"] <= 3


@pytest.mark.parametrize("fault", ["scale", "code", "far_mean", "residual"])
def test_k8_norm_match_refuses_a_fault(fault):
    M, K = 64, 4096
    x, d = _bf16((M, K), 9), _bf16((M, K), 10, 0.5)
    w = torch.ones(K, dtype=torch.bfloat16)
    steps = torch.full((M,), 4 * chip_smoke.K8_MEAN_ULPS if fault == "far_mean" else 0,
                       dtype=torch.int32)
    (q, s), h = _norm_at(x, w, d, steps)
    q, s, h = q.clone(), s.clone(), h.clone()
    if fault == "scale":
        s[3] *= 1.01
    elif fault == "code":
        q[5, 17] += 1 if q[5, 17] < 127 else -1
    elif fault == "residual":
        h[2, 0] += 1
    assert not chip_smoke.k8_norm_match(x, w, EPS, d, (q, s), h)["ok"]


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K8 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 256, 32768])
@pytest.mark.parametrize("K", [4096, 11008, 11264])
def test_k8_kernels_match_plain(dev, M, K):
    """Each entry against its plain version on the card: quantize_rows (bf16
    and f32 in) and silu_mul_quant bit for bit, rms_norm_quant with and
    without its residual add by chip_smoke's check; one launch each."""
    g = torch.Generator(device=dev).manual_seed(M + K)
    x = torch.randn(M, K, device=dev, generator=g)
    xb = x.to(torch.bfloat16)
    d = (0.5 * torch.randn(M, K, device=dev, generator=g)).to(torch.bfloat16)
    gate = (3 * torch.randn(M, K, device=dev, generator=g)).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(K, device=dev, generator=g)).to(torch.bfloat16)
    before = dict(cuda_lib.LAUNCHES)
    for a in (x, xb):
        assert _equal(gemm.quantize_rows(a), gemm.quantize_rows_plain(a))
    assert _equal(act.silu_mul_quant(gate, d), act.silu_mul_quant_plain(gate, d))
    for delta in (None, d):
        res = act.rms_norm_quant(xb, w, EPS, delta)
        m = chip_smoke.k8_norm_match(xb, w, EPS, delta, *res)
        assert m["ok"], m
    torch.cuda.synchronize()
    launched = {k: cuda_lib.LAUNCHES[k] - before[k] for k in
                ("quantize_rows", "silu_mul_quant", "rms_norm_quant")}
    assert launched == {"quantize_rows": 2, "silu_mul_quant": 1, "rms_norm_quant": 2}


@pytest.mark.gpu
def test_k8_refuses_what_it_does_not_take(dev):
    x = torch.randn(4, 4096, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gemm.quantize_rows(x[:, 8:4096 - 8])  # a column slice: not contiguous
    with pytest.raises(ValueError):
        act.silu_mul_quant(x, x.float())
    with pytest.raises(ValueError):
        gemm.quantize_rows(torch.randn(4, 4100, device=dev, dtype=torch.bfloat16))
