"""The port's ops (hydragen_torch.ops) against the JAX package's, on the CPU.

Every input is made with numpy from a seed and handed to both packages. On
a CPU tensor each kernel wrapper runs its plain PyTorch version, so these
tests hold the plain versions (and the shape logic around them) against the
JAX oracle and, at one tiny shape each, against the JAX Pallas kernels in
interpret mode. The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax.numpy as jnp
import torch

from hydragen_tpu.ops import combine as jcombine
from hydragen_tpu.ops import decode as jdecode
from hydragen_tpu.ops import flash as jflash
from hydragen_tpu.ops import gemm as jgemm
from hydragen_tpu.ops import hydragen as jhydragen
from hydragen_tpu.ops import quant as jquant
from hydragen_tpu.ops import reference as jref

from hydragen_torch.ops import combine as tcombine
from hydragen_torch.ops import decode as tdecode
from hydragen_torch.ops import flash as tflash
from hydragen_torch.ops import gemm as tgemm
from hydragen_torch.ops import hydragen as thydragen
from hydragen_torch.ops import quant as tquant
from hydragen_torch.ops import reference as tref

torch.set_num_threads(1)

# fp32 on both sides; the two frameworks sum in different orders.
ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def J(a):
    return jnp.asarray(np.asarray(a))


def close(t, j, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=rtol)


def _attn_inputs(rng, b, hq, hkv, m, s, d, int8, bshd):
    q = rng.randn(b, hq, m, d).astype(np.float32)
    shape = (b, s, hkv, d) if bshd else (b, hkv, s, d)
    sshape = shape[:-1]
    if int8:
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        ks = (rng.rand(*sshape) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(*sshape) * 0.02 + 1e-3).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return q, k, v, None, None


ATTN_CASES = {
    # name: (b, hq, hkv, m, s, causal, lens, int8, bshd, kv_mask)
    "plain": (2, 2, 2, 5, 9, False, None, False, False, False),
    "causal": (2, 2, 2, 7, 7, True, None, False, False, False),
    "causal_end_aligned": (1, 4, 2, 3, 11, True, None, False, False, False),
    "lens": (3, 2, 2, 4, 10, False, [10, 3, 7], False, False, False),
    "int8": (2, 4, 2, 4, 12, False, [12, 5], True, False, False),
    "gqa_causal_lens_int8": (2, 4, 1, 6, 6, True, [6, 4], True, False, False),
    "bshd_int8": (3, 2, 2, 1, 8, False, [8, 2, 5], True, True, False),
    "rows_all_masked": (3, 2, 2, 2, 6, False, [0, 6, 0], True, False, False),
    "kv_mask": (2, 2, 2, 3, 8, False, None, False, False, True),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_bhsd_matches_jax(case):
    b, hq, hkv, m, s, causal, lens, int8, bshd, use_mask = ATTN_CASES[case]
    rng = np.random.RandomState(len(case))
    q, k, v, ks, vs = _attn_inputs(rng, b, hq, hkv, m, s, 128 // 4, int8, bshd)
    kw = dict(causal=causal, kv_bshd=bshd)
    tkw, jkw = dict(kw), dict(kw)
    if lens is not None:
        tkw["kv_seq_lens"] = T(np.asarray(lens, np.int32))
        jkw["kv_seq_lens"] = J(np.asarray(lens, np.int32))
    if use_mask:
        mask = rng.rand(b, s) > 0.4
        mask[:, 0] = True
        tkw["kv_mask"], jkw["kv_mask"] = T(mask), J(mask)
    if int8:
        tkw.update(k_scale=T(ks), v_scale=T(vs))
        jkw.update(k_scale=J(ks), v_scale=J(vs))
    to, tl = tref.attention_bhsd(T(q), T(k), T(v), **tkw)
    jo, jl = jref.attention_bhsd(J(q), J(k), J(v), **jkw)
    close(to, jo)
    close(tl, jl)
    if lens is not None and 0 in lens:
        empty = np.asarray(lens) == 0
        assert np.all(np.isneginf(tl.numpy()[empty])), "empty rows must give lse -inf"
        assert np.all(tl.numpy()[~empty] > -1e30)
        assert np.all(np.isfinite(to.numpy())) and np.all(to.numpy()[empty] == 0)


def test_attention_with_lse_bshd_wrapper_matches_jax():
    rng = np.random.RandomState(1)
    q = rng.randn(2, 5, 4, 32).astype(np.float32)
    k = rng.randn(2, 7, 2, 32).astype(np.float32)
    v = rng.randn(2, 7, 2, 32).astype(np.float32)
    to, tl = tref.attention_with_lse(T(q), T(k), T(v), causal=True)
    jo, jl = jref.attention_with_lse(J(q), J(k), J(v), causal=True)
    close(to, jo)
    close(tl, jl)


@pytest.mark.parametrize("with_stats", [False, True])
def test_combine_lse_matches_jax(with_stats):
    rng = np.random.RandomState(2)
    outs = [rng.randn(3, 2, 4, 16).astype(np.float32) for _ in range(3)]
    lses = [rng.randn(3, 2, 4).astype(np.float32) * 3 for _ in range(3)]
    for l in lses:  # a row that one partial does not see, and one none see
        l[0, 0, 0] = -np.inf
    for l in lses:
        l[1, 1, 2] = -np.inf
    if with_stats:
        to, tl = tcombine.combine_lse_with_stats([T(o) for o in outs], [T(l) for l in lses])
        jo, jl = jcombine.combine_lse_with_stats([J(o) for o in outs], [J(l) for l in lses])
        close(tl, jl)
        assert np.isneginf(tl.numpy()[1, 1, 2])
    else:
        to = tcombine.combine_lse([T(o) for o in outs], [T(l) for l in lses])
        jo = jcombine.combine_lse([J(o) for o in outs], [J(l) for l in lses])
    close(to, jo)
    assert np.all(np.isfinite(to.numpy()))


# --- quantization: int8 payloads bit-equal, scales equal ---------------------


def test_quantize_rows_bit_equal():
    x = np.random.RandomState(3).randn(37, 256).astype(np.float32) * 3
    tq, ts = tgemm.quantize_rows(T(x))
    jq, js = jgemm.quantize_rows(J(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_kv_bit_equal():
    x = np.random.RandomState(4).randn(2, 3, 17, 128).astype(np.float32)
    tq, ts = tquant.quantize_kv(T(x))
    jq, js = jquant.quantize_kv(J(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    close(tquant.dequantize_kv(tq, ts, torch.float32), jquant.dequantize_kv(jq, js, jnp.float32))


def test_quantize_weights_bit_equal():
    w = np.random.RandomState(5).randn(2, 256, 384).astype(np.float32) * 0.05
    t = tquant.quantize(T(w))
    j = jquant.quantize(J(w))
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(
        t.scale.float().numpy(), np.asarray(j.scale.astype(jnp.float32))
    )
    close(tquant.dequantize(t, torch.float32), jquant.dequantize(j, jnp.float32))


def test_pad_intermediate_and_quantize_params_match_jax():
    rng = np.random.RandomState(6)
    layers = {
        "gate": rng.randn(2, 64, 600).astype(np.float32),
        "up": rng.randn(2, 64, 600).astype(np.float32),
        "down": rng.randn(2, 600, 64).astype(np.float32),
    }
    tp = tquant.pad_intermediate({k: T(v) for k, v in layers.items()})
    jp = jquant.pad_intermediate({k: J(v) for k, v in layers.items()})
    for k in layers:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert tp["gate"].shape == (2, 64, 1024) and tp["down"].shape == (2, 1024, 64)
    assert tquant.is_quantized_weight(tquant.quantize(tp["down"]))
    assert not tquant.is_quantized_weight(tp["down"])


# --- K1: the w8a8 GEMM's plain version ---------------------------------------


def _gemm_inputs(rng, M, N, K, L=3):
    a = rng.randn(M, K).astype(np.float32)
    w_all = rng.randint(-127, 128, (L, N, K)).astype(np.int8)
    ws = (rng.rand(L, N) * 0.01 + 1e-3).astype(np.float32)
    ws_bf16 = np.asarray(jnp.asarray(ws, jnp.bfloat16).astype(jnp.float32))
    return a, w_all, ws_bf16


def test_w8a8_plain_matches_reference():
    """fp32, 1e-6 relative: the int8 products are exact in f32 at K=256."""
    rng = np.random.RandomState(7)
    a, w_all, ws = _gemm_inputs(rng, 19, 384, 256)
    tq, ts = tgemm.quantize_rows(T(a))
    layer = 1
    tw = T(w_all)
    tws = T(ws).to(torch.bfloat16)
    out = tgemm.w8a8_matmul_cached(layer, tq, ts, tw, tws, out_dtype=torch.float32)
    ref = jgemm.w8a8_reference(J(tq.numpy()), J(ts.numpy()), J(w_all[layer]),
                               J(ws[layer]), out_dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    assert out.shape == (19, 384) and out.dtype == torch.float32


def test_w8a8_plain_matches_pallas_interpret():
    rng = np.random.RandomState(8)
    a, w_all, ws = _gemm_inputs(rng, 8, 128, 128, L=2)
    tq, ts = tgemm.quantize_rows(T(a))
    out = tgemm.w8a8_matmul_cached(1, tq, ts, T(w_all), T(ws).to(torch.bfloat16),
                                   out_dtype=torch.float32)
    jout = jgemm.w8a8_matmul_cached(
        jnp.int32(1), J(tq.numpy()), J(ts.numpy()), J(w_all),
        J(ws).astype(jnp.bfloat16), block_n=128, block_k=128, out_dtype=jnp.float32,
        interpret=True,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=0)


def test_qmatmul_stacked_w8a8_and_dq_match_jax(monkeypatch):
    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    rng = np.random.RandomState(9)
    w = rng.randn(2, 128, 256).astype(np.float32) * 0.05
    x = rng.randn(2, 3, 128).astype(np.float32)
    tw, jw = tquant.quantize(T(w)), jquant.quantize(J(w))
    for impl in ("dq", "w8a8"):
        t = tquant.qmatmul_stacked(T(x), tw, 1, "bth,hd->btd", impl=impl)
        j = jquant.qmatmul_stacked(J(x), jw, jnp.int32(1), "bth,hd->btd", impl=impl)
        close(t, j, atol=1e-5, rtol=1e-5)


# --- K2/K4: flash attention's plain versions ---------------------------------


@pytest.mark.parametrize("causal,int8", [(True, False), (False, True), (True, True)])
def test_flash_bhsd_plain_matches_oracle(causal, int8):
    rng = np.random.RandomState(10)
    b, hq, hkv, m, s = 2, 4, 2, 6, 9
    q, k, v, ks, vs = _attn_inputs(rng, b, hq, hkv, m, s, 128, int8, False)
    lens = np.asarray([9, 4], np.int32)
    tkw = dict(causal=causal, kv_seq_lens=T(lens))
    jkw = dict(causal=causal, kv_seq_lens=J(lens))
    if int8:
        tkw.update(k_scale=T(ks), v_scale=T(vs))
        jkw.update(k_scale=J(ks), v_scale=J(vs))
    to, tl = tflash.flash_attention_bhsd(T(q), T(k), T(v), **tkw)
    jo, jl = jref.attention_bhsd(J(q), J(k), J(v), **jkw)
    close(to, jo)
    close(tl, jl)
    # The BSHD public wrapper is the same function.
    bo, bl = tflash.flash_attention(T(q).transpose(1, 2), T(k).transpose(1, 2),
                                    T(v).transpose(1, 2), causal=causal,
                                    kv_seq_lens=T(lens)) if not int8 else (None, None)
    if bo is not None:
        close(bo.transpose(1, 2), jo)


def test_flash_bhsd_plain_matches_pallas_interpret():
    rng = np.random.RandomState(11)
    q, k, v, _, _ = _attn_inputs(rng, 1, 2, 1, 40, 40, 128, False, False)
    to, tl = tflash.flash_attention_bhsd(T(q), T(k), T(v), causal=True)
    jo, jl = jflash.flash_attention_bhsd(J(q), J(k), J(v), causal=True, interpret=True)
    # The Pallas kernel rounds q * scale * log2(e) to q's dtype (f32 here):
    # within fp32 round-off.
    close(to, jo, atol=2e-5, rtol=2e-5)
    close(tl, jl, atol=2e-5, rtol=2e-5)


def _level_inputs(rng, L, SB, hkv, S, d, int8):
    shape = (L, SB, hkv, S, d)
    if int8:
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        ks = (rng.rand(*shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(*shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
        return k, v, ks, vs
    return (rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32),
            None, None)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_cached_plain_matches_oracle(int8):
    rng = np.random.RandomState(12)
    L, SB, hkv, S, d, b, hq, m = 3, 3, 2, 10, 128, 2, 4, 5
    k, v, ks, vs = _level_inputs(rng, L, SB, hkv, S, d, int8)
    q = rng.randn(b, hq, m, d).astype(np.float32)
    lens = np.asarray([10, 6], np.int32)
    layer = 2
    to, tl = tflash.flash_attention_cached_bhsd(
        layer, T(q), T(k), T(v), kv_seq_lens=T(lens),
        k_scale_all=None if ks is None else T(ks), v_scale_all=None if vs is None else T(vs),
    )
    jo, jl = jref.attention_bhsd(
        J(q), J(k[layer, :b]), J(v[layer, :b]), kv_seq_lens=J(lens),
        k_scale=None if ks is None else J(ks[layer, :b]),
        v_scale=None if vs is None else J(vs[layer, :b]),
    )
    close(to, jo)
    close(tl, jl)


def test_flash_cached_plain_matches_pallas_interpret():
    rng = np.random.RandomState(13)
    # L * SB * hkv not a multiple of 8: the Pallas kernel's 2D scale blocks
    # use pl.program_id, which interpret mode cannot lower on the CPU.
    L, SB, hkv, S, d, b, hq, m = 3, 3, 2, 16, 128, 2, 2, 3
    k, v, ks, vs = _level_inputs(rng, L, SB, hkv, S, d, True)
    q = rng.randn(b, hq, m, d).astype(np.float32)
    lens = np.asarray([16, 9], np.int32)
    to, tl = tflash.flash_attention_cached_bhsd(1, T(q), T(k), T(v), kv_seq_lens=T(lens),
                                                k_scale_all=T(ks), v_scale_all=T(vs))
    jo, jl = jflash.flash_attention_cached_bhsd(
        jnp.int32(1), J(q), J(k), J(v), kv_seq_lens=J(lens), k_scale_all=J(ks),
        v_scale_all=J(vs), interpret=True,
    )
    close(to, jo, atol=2e-5, rtol=2e-5)
    close(tl, jl, atol=2e-5, rtol=2e-5)


# --- K3: the decode read's plain version -------------------------------------


def _decode_inputs(rng, L, B, S, hkv, d, b, hq, lens):
    k = rng.randint(-127, 128, (L, B, S, hkv, d)).astype(np.int8)
    v = rng.randint(-127, 128, (L, B, S, hkv, d)).astype(np.int8)
    ks = (rng.rand(L, B, S * hkv) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(L, B, S * hkv) * 0.02 + 1e-3).astype(np.float32)
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    k1 = rng.randn(b, hkv, 1, d).astype(np.float32)
    v1 = rng.randn(b, hkv, 1, d).astype(np.float32)
    o_sh = rng.randn(b, hq, 1, d).astype(np.float32)
    lse_sh = (rng.randn(b, hq, 1) * 2).astype(np.float32)
    return k, v, ks, vs, q, k1, v1, o_sh, lse_sh, np.asarray(lens, np.int32)


@pytest.mark.parametrize("own,shared", [(False, False), (True, False), (True, True)])
def test_decode_plain_matches_oracle(own, shared):
    """fp32, 1e-5: the exact attention over the layer's cache slice, plus the
    own-token column and the shared partial merged by combine_lse."""
    rng = np.random.RandomState(14)
    L, B, S, hkv, d, b, hq = 2, 4, 8, 2, 128, 3, 4
    k, v, ks, vs, q, k1, v1, o_sh, lse_sh, lens = _decode_inputs(
        rng, L, B, S, hkv, d, b, hq, [8, 0, 3])
    layer = 1
    to, tl = tdecode.decode_attention_cached(
        layer, T(q), T(k), T(v), kv_seq_lens=T(lens), k_scale_all=T(ks),
        v_scale_all=T(vs), own_kv=(T(k1), T(v1)) if own else None,
        shared_partial=(T(o_sh), T(lse_sh)) if shared else None,
    )
    outs, lses = [], []
    if shared:
        outs.append(J(o_sh))
        lses.append(J(lse_sh))
    uo, ul = jref.attention_bhsd(
        J(q), J(k[layer, :b]), J(v[layer, :b]), kv_seq_lens=J(lens),
        k_scale=J(ks[layer, :b].reshape(b, S, hkv)), v_scale=J(vs[layer, :b].reshape(b, S, hkv)),
        kv_bshd=True,
    )
    outs.append(uo)
    lses.append(ul)
    if own:
        group = hq // hkv
        qg = J(q).reshape(b, hkv, group, 1, d)
        lses.append((jnp.einsum("bkgmd,bkmd->bkgm", qg, J(k1)) / math.sqrt(d)).reshape(b, hq, 1))
        outs.append(jnp.broadcast_to(J(v1)[:, :, None], (b, hkv, group, 1, d)).reshape(b, hq, 1, d))
    jo, jl = jcombine.combine_lse_with_stats(outs, lses)
    close(to, jo)
    close(tl, jl)
    if not (own or shared):
        assert np.isneginf(tl.numpy()[1]).all()  # row with no history


def test_decode_plain_matches_pallas_interpret():
    """Loose: the TPU kernel re-quantizes q and p to s8 for its matrix unit
    (decode.py:48-51, ~0.5 % RMS), which the port does not copy; the port
    is the exact path. 2 % relative RMS bounds that noise."""
    rng = np.random.RandomState(15)
    L, B, S, hkv, d, b, hq = 2, 2, 16, 2, 128, 2, 2
    k, v, ks, vs, q, k1, v1, o_sh, lse_sh, lens = _decode_inputs(
        rng, L, B, S, hkv, d, b, hq, [16, 7])
    to, tl = tdecode.decode_attention_cached(
        1, T(q), T(k), T(v), kv_seq_lens=T(lens), k_scale_all=T(ks), v_scale_all=T(vs),
        own_kv=(T(k1), T(v1)), shared_partial=(T(o_sh), T(lse_sh)),
    )
    jo, jl = jdecode.decode_attention_cached(
        jnp.int32(1), J(q), J(k), J(v), kv_seq_lens=J(lens), k_scale_all=J(ks),
        v_scale_all=J(vs), own_kv=(J(k1), J(v1)), shared_partial=(J(o_sh), J(lse_sh)),
        interpret=True,
    )
    jo = np.asarray(jo)
    rms = np.sqrt(np.mean((to.numpy() - jo) ** 2)) / np.sqrt(np.mean(jo ** 2))
    assert rms < 2e-2, rms
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2)


# --- the Hydragen op -----------------------------------------------------------


@pytest.mark.parametrize("decode", [False, True])
def test_hydragen_attention_matches_jax(decode):
    """2 shared levels plus a unique suffix (causal at prefill, length-masked
    over a cache at decode), public BSHD layout."""
    rng = np.random.RandomState(16)
    b, hq, hkv, d = 4, 4, 2, 128
    nq = 1 if decode else 5
    q = rng.randn(b, nq, hq, d).astype(np.float32)
    lv = [rng.randn(1, 12, hkv, d).astype(np.float32) for _ in range(2)]
    lv2 = [rng.randn(2, 7, hkv, d).astype(np.float32) for _ in range(2)]
    slens = [np.asarray([12], np.int32), np.asarray([7, 4], np.int32)]
    ulen = 6 if decode else nq
    uk = rng.randn(b, ulen, hkv, d).astype(np.float32)
    uv = rng.randn(b, ulen, hkv, d).astype(np.float32)
    seq = np.asarray([6, 2, 0, 5], np.int32) if decode else None
    to = thydragen.hydragen_attention(
        T(q), T(uk), T(uv), [T(lv[0]), T(lv2[0])], [T(lv[1]), T(lv2[1])],
        [T(x) for x in slens], None if seq is None else T(seq),
    )
    jo = jhydragen.hydragen_attention(
        J(q), J(uk), J(uv), [J(lv[0]), J(lv2[0])], [J(lv[1]), J(lv2[1])],
        [J(x) for x in slens], None if seq is None else J(seq), impl="xla",
    )
    close(to, jo)
    assert to.shape == (b, nq, hq, d)


def test_fold_unfold_match_jax():
    x = np.random.RandomState(17).randn(6, 2, 3, 4).astype(np.float32)
    tf = thydragen.fold_queries_for_shared(T(x), 2)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jhydragen.fold_queries_for_shared(J(x), 2)))
    np.testing.assert_array_equal(thydragen.unfold_shared_out(tf, 6, 3).numpy(), x)
    lse = np.random.RandomState(18).randn(2, 2, 9).astype(np.float32)
    np.testing.assert_array_equal(
        thydragen.unfold_shared_lse(T(lse), 6, 3).numpy(),
        np.asarray(jhydragen.unfold_shared_lse(J(lse), 6, 3)),
    )


def test_gate_sends_structural_exclusions_to_the_plain_path():
    q = torch.zeros(1, 2, 3, 128)
    k = torch.zeros(1, 2, 4, 128)
    assert thydragen.use_flash_kernel("kernel", q, k)
    assert not thydragen.use_flash_kernel("torch", q, k)
    assert not thydragen.use_flash_kernel("kernel", q, k, kv_bshd=True)
    assert not thydragen.use_flash_kernel("kernel", q, k, kv_mask=torch.ones(1, 4, dtype=bool))
    with pytest.raises(ValueError):
        thydragen.pick_impl("xla")
