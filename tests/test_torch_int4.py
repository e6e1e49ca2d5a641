"""The port's int4 path against the JAX package's, on the CPU.

Covers int4 weights (``Quantized4Tensor``, the w4a8 GEMM, the weight-only
dq4 product, the "mixed" mode) and the token-planar int4 unique KV cache
(``quantize_kv4``, the int4 attention dots, the decode read, the nibble
writes), module by module and then the engine end to end. Inputs are made
with numpy from a seed and handed to both packages; fp32 wherever a float
is computed. Integer payloads (packed weights, packed KV) and the f32 KV
scales that the cache writers compute from the same inputs must be
bit-equal (the port scales amax by the f32 reciprocal of 7, as jitted JAX
does, and both divide x by the same scale). The JAX side of a w4a8 or w8a8 case runs its Pallas GEMM in
interpret mode (``HYDRAGEN_W8A8_INTERPRET=1``); without it, JAX runs the
weight-only path on the CPU.

Every int4 attention case has lengths above the byte-row count S as well as
below it: an error that swaps or drops the high nibble plane shows only
there.
"""

import math

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax
import jax.numpy as jnp
import torch

from hydragen_tpu.core import cache as jcache
from hydragen_tpu.core.engine import HydragenLlama as JEngine
from hydragen_tpu.core.engine import SharedCacheOp as JOp
from hydragen_tpu.models import llama as jllama
from hydragen_tpu.models.config import ModelConfig as JConfig
from hydragen_tpu.ops import combine as jcombine
from hydragen_tpu.ops import decode as jdecode
from hydragen_tpu.ops import gemm as jgemm
from hydragen_tpu.ops import quant as jquant
from hydragen_tpu.ops import reference as jref

from hydragen_torch import HydragenLlama as TEngine
from hydragen_torch import ModelConfig as TConfig
from hydragen_torch import SharedCacheOp as TOp
from hydragen_torch.core import cache as tcache
from hydragen_torch.models import llama as tllama
from hydragen_torch.models.convert import params_from_numpy
from hydragen_torch.ops import decode as tdecode
from hydragen_torch.ops import gemm as tgemm
from hydragen_torch.ops import quant as tquant
from hydragen_torch.ops import reference as tref

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def J(a):
    return jnp.asarray(np.asarray(a))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _bf16_round(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# --- quant: packing and int4 quantization -------------------------------------


def test_pack_unpack_every_byte_bit_equal():
    """Every byte value, -128 (the nibble -8 that random init writes) included:
    unpack4 gives JAX's planes and pack4 inverts it."""
    qp = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    tlo, thi = tquant.unpack4(T(qp))
    jlo, jhi = jquant.unpack4(J(qp))
    np.testing.assert_array_equal(_np(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_np(thi), np.asarray(jhi))
    both = torch.cat([tlo, thi], dim=-1)
    np.testing.assert_array_equal(_np(tquant.pack4(both)), qp)
    np.testing.assert_array_equal(_np(tquant.pack4(both)),
                                  np.asarray(jquant.pack4(J(_np(both)))))


@pytest.mark.parametrize("K,group", [(256, 128), (512, 128), (384, 128), (96, 32)])
def test_quantize4_dequantize4_bit_equal(K, group):
    rng = np.random.RandomState(K)
    w = (rng.randn(2, K, 48) * 0.05).astype(np.float32)
    tq, jq = tquant.quantize4(T(w), group), jquant.quantize4(J(w), group)
    assert tquant.pick_group4(K, group) == jquant.pick_group4(K, group)
    np.testing.assert_array_equal(_np(tq.qp), np.asarray(jq.qp))
    np.testing.assert_array_equal(_np(tq.gscale.float()),
                                  np.asarray(jq.gscale.astype(jnp.float32)))
    assert tq.group_size == jq.group_size and tq.in_features == jq.in_features == K
    np.testing.assert_array_equal(_np(tquant.dequantize4(tq, torch.float32)),
                                  np.asarray(jquant.dequantize4(jq, jnp.float32)))


def _kv4_held_to_jit(x, dtype):
    """``quantize_kv4`` equals ``jax.jit`` of the JAX function (the one its
    engine runs: XLA multiplies amax by the f32 reciprocal of 7 where eager
    JAX divides) bit for bit, on inputs where eager JAX's scales differ."""
    tq, ts = tquant.quantize_kv4(T(x).to(getattr(torch, dtype)))
    xj = J(x).astype(dtype)
    jq, js = jax.jit(jquant.quantize_kv4)(xj)
    assert np.any(np.asarray(jquant.quantize_kv4(xj)[1]) != np.asarray(js)), \
        "eager and jitted JAX agree here"
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert _np(tq).min() >= -7 and _np(tq).max() <= 7


def test_quantize_kv4_bit_equal():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 2, 5, 128).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # amax 0: the 1e-8 floor
    _kv4_held_to_jit(x, "float32")


def test_quantize_kv4_bit_equal_bf16():
    x = np.random.RandomState(2).randn(3, 2, 5, 128).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    _kv4_held_to_jit(x, "bfloat16")


@pytest.mark.parametrize("families", [(), ("down",)])
def test_quantize_params_int4_matches_jax(families):
    """``bits=4`` and the "mixed" int4 ``down``: every leaf's class and bytes;
    the LM head stays int8."""
    cfg = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2, dtype="float32")
    jp = jllama.init_params(JConfig(**cfg), jax.random.PRNGKey(0))
    bits = 8 if families else 4
    jq = jquant.quantize_params(jp, bits=bits, bits4_families=families, pad_mlp=True)
    tq = tquant.quantize_params(params_from_numpy(jax.tree.map(np.asarray, jp)),
                                bits=bits, bits4_families=families, pad_mlp=True)
    assert isinstance(tq["lm_head"], tquant.QuantizedTensor)
    for name, jw in jq["layers"].items():
        tw = tq["layers"][name]
        if isinstance(jw, tuple):
            assert type(tw).__name__ == type(jw).__name__, name
        for t, j in zip(tw if isinstance(tw, tuple) else (tw,),
                        jw if isinstance(jw, tuple) else (jw,)):
            np.testing.assert_array_equal(_np(t.float()), np.asarray(j.astype(jnp.float32)))


# --- the w4a8 GEMM's plain version and the dq4 path ---------------------------


def _w4_inputs(rng, M, N, K, L=3, group=128):
    a = rng.randn(M, K).astype(np.float32)
    qp = rng.randint(-128, 128, (L, N, K // 2)).astype(np.int8)
    gs = _bf16_round(rng.rand(L, K // group, N) * 0.01 + 1e-3)
    return a, qp, gs


def test_w4a8_plain_matches_reference():
    """fp32, 1e-6 of the largest output: both sum the same exact products in
    f32, in orders that differ."""
    rng = np.random.RandomState(7)
    a, qp, gs = _w4_inputs(rng, 19, 256, 512)
    tq, ts = tgemm.quantize_rows(T(a))
    layer = 2
    out = tgemm.w4a8_matmul_cached(layer, tq, ts, T(qp), T(gs).to(torch.bfloat16),
                                   out_dtype=torch.float32)
    ref = np.asarray(jgemm.w4a8_reference(J(_np(tq)), J(_np(ts)), J(qp[layer]), J(gs[layer]),
                                          out_dtype=jnp.float32))
    assert out.shape == (19, 256) and out.dtype == torch.float32
    assert np.abs(_np(out) - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("stacked", [True, False])
def test_w4a8_plain_matches_pallas_interpret(stacked):
    """N=256, K=512, group 128 against the TPU kernel in interpret mode, which
    sums the scaled groups in f32 in its own order: 1e-5 of the largest
    output."""
    rng = np.random.RandomState(8)
    a, qp, gs = _w4_inputs(rng, 8, 256, 512, L=2)
    tq, ts = tgemm.quantize_rows(T(a))
    kw = dict(block_n=128, block_kp=128, out_dtype=jnp.float32, interpret=True)
    if stacked:
        out = tgemm.w4a8_matmul_cached(1, tq, ts, T(qp), T(gs).to(torch.bfloat16),
                                       out_dtype=torch.float32)
        jout = jgemm.w4a8_matmul_cached(jnp.int32(1), J(_np(tq)), J(_np(ts)), J(qp),
                                        J(gs).astype(jnp.bfloat16), **kw)
    else:
        out = tgemm.w4a8_matmul(tq, ts, T(qp[1]), T(gs[1]).to(torch.bfloat16),
                                out_dtype=torch.float32)
        jout = jgemm.w4a8_matmul(J(_np(tq)), J(_np(ts)), J(qp[1]),
                                 J(gs[1]).astype(jnp.bfloat16), **kw)
    jout = np.asarray(jout)
    assert np.abs(_np(out) - jout).max() <= 1e-5 * np.abs(jout).max()


@pytest.mark.parametrize("impl", ["dq", "w4a8"])
@pytest.mark.parametrize("stacked", [True, False])
def test_qmatmul_int4_matches_jax(monkeypatch, impl, stacked):
    """Weight-only dq4 (plane by plane) and w4a8, through the stacked and the
    2-D entries of both packages."""
    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    rng = np.random.RandomState(9)
    w = rng.randn(2, 256, 128).astype(np.float32) * 0.05
    x = rng.randn(2, 3, 256).astype(np.float32)
    tw, jw = tquant.quantize4(T(w)), jquant.quantize4(J(w))
    if stacked:
        t = tquant.qmatmul_stacked(T(x), tw, 1, "bth,hd->btd", impl=impl)
        j = jquant.qmatmul_stacked(J(x), jw, jnp.int32(1), "bth,hd->btd", impl=impl)
    else:
        t = tquant.qmatmul(T(x), tquant.Quantized4Tensor(tw.qp[1], tw.gscale[1]),
                           "bth,hd->btd", impl=impl)
        j = jquant.qmatmul(J(x), jquant.Quantized4Tensor(jw.qp[1], jw.gscale[1]),
                           "bth,hd->btd", impl=impl)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_qmatmul_w8a8_2d_matches_jax(monkeypatch):
    """A 2-D int8 weight under w8a8 takes the s8 GEMM's 2-D entry in both
    packages (the JAX side's Pallas kernel in interpret mode), not dq."""
    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    rng = np.random.RandomState(10)
    w = rng.randn(128, 256).astype(np.float32) * 0.05
    x = rng.randn(2, 3, 128).astype(np.float32)
    tw, jw = tquant.quantize(T(w)), jquant.quantize(J(w))
    t = tquant.qmatmul(T(x), tw, "bth,hd->btd", impl="w8a8")
    j = jquant.qmatmul(J(x), jw, "bth,hd->btd", impl="w8a8")
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5, rtol=1e-5)
    dq = tquant.qmatmul(T(x), tw, "bth,hd->btd", impl="dq")
    assert np.abs(_np(dq) - _np(t)).max() > 1e-4  # the activations were quantized


# --- int4 attention: the reference dots and the decode read -------------------


def _kv4_inputs(rng, b, hkv, sp, d, bshd, L=None):
    lead = () if L is None else (L,)
    shape = lead + ((b, sp, hkv, d) if bshd else (b, hkv, sp, d))
    k = rng.randint(-128, 128, shape).astype(np.int8)
    v = rng.randint(-128, 128, shape).astype(np.int8)
    sshape = lead + ((b, 2 * sp, hkv) if bshd else (b, hkv, 2 * sp))
    ks = (rng.rand(*sshape) * 0.2 + 0.01).astype(np.float32)
    vs = (rng.rand(*sshape) * 0.2 + 0.01).astype(np.float32)
    return k, v, ks, vs


@pytest.mark.parametrize("bshd", [False, True])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 1)])
def test_attention_bhsd_int4_matches_jax(bshd, hq, hkv):
    """Byte rows S=6 (12 logical tokens); lengths 12, 9, 6, 2 and 0 sit on
    both sides of S."""
    rng = np.random.RandomState(11)
    b, sp, d, m = 5, 6, 128, 2
    k, v, ks, vs = _kv4_inputs(rng, b, hkv, sp, d, bshd)
    q = rng.randn(b, hq, m, d).astype(np.float32)
    lens = np.asarray([12, 9, 6, 2, 0], np.int32)
    kw = dict(kv_bshd=bshd, kv_bits=4)
    to, tl = tref.attention_bhsd(T(q), T(k), T(v), kv_seq_lens=T(lens), k_scale=T(ks),
                                 v_scale=T(vs), **kw)
    jo, jl = jref.attention_bhsd(J(q), J(k), J(v), kv_seq_lens=J(lens), k_scale=J(ks),
                                 v_scale=J(vs), **kw)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-5)
    assert np.isneginf(_np(tl)[4]).all()


@pytest.mark.parametrize("own,shared", [(False, False), (True, False), (True, True)])
def test_decode_int4_plain_matches_jax(own, shared):
    """The int4 decode read over one layer of the stacked BSHD cache (S=8
    byte rows, 16 logical tokens; lengths 16, 11, 8, 3, 0), with the own
    token and the shared partial, against JAX's attention_bhsd(kv_bits=4,
    kv_bshd=True) plus combine_lse: fp32, 1e-5."""
    rng = np.random.RandomState(12)
    L, B, sp, hkv, d, b, hq = 2, 6, 8, 2, 128, 5, 4
    k, v, ks, vs = _kv4_inputs(rng, B, hkv, sp, d, True, L=L)
    ksf, vsf = ks.reshape(L, B, -1), vs.reshape(L, B, -1)
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    k1 = rng.randn(b, hkv, 1, d).astype(np.float32)
    v1 = rng.randn(b, hkv, 1, d).astype(np.float32)
    o_sh = rng.randn(b, hq, 1, d).astype(np.float32)
    lse_sh = (rng.randn(b, hq, 1) * 2).astype(np.float32)
    lens = np.asarray([16, 11, 8, 3, 0], np.int32)
    layer = 1
    to, tl = tdecode.decode_attention_cached(
        layer, T(q), T(k), T(v), kv_seq_lens=T(lens), k_scale_all=T(ksf), v_scale_all=T(vsf),
        own_kv=(T(k1), T(v1)) if own else None,
        shared_partial=(T(o_sh), T(lse_sh)) if shared else None, kv_bits=4,
    )
    outs, lses = [], []
    if shared:
        outs.append(J(o_sh))
        lses.append(J(lse_sh))
    uo, ul = jref.attention_bhsd(
        J(q), J(k[layer, :b]), J(v[layer, :b]), kv_seq_lens=J(lens),
        k_scale=J(ks[layer, :b]), v_scale=J(vs[layer, :b]), kv_bshd=True, kv_bits=4,
    )
    outs.append(uo)
    lses.append(ul)
    if own:
        group = hq // hkv
        qg = J(q).reshape(b, hkv, group, 1, d)
        lses.append((jnp.einsum("bkgmd,bkmd->bkgm", qg, J(k1)) / math.sqrt(d)).reshape(b, hq, 1))
        outs.append(jnp.broadcast_to(J(v1)[:, :, None], (b, hkv, group, 1, d)).reshape(b, hq, 1, d))
    jo, jl = jcombine.combine_lse_with_stats(outs, lses)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-5)


# --- int4 cache writes ----------------------------------------------------------


def _same_cache(tc, jc):
    """Every buffer bit-equal: payloads, f32 scales and level lengths."""
    bufs = [(name, getattr(tc, name), getattr(jc, name))
            for name in ("unique_k", "unique_v", "unique_k_scale", "unique_v_scale")]
    for i, (tl, jl) in enumerate(zip(tc.shared, jc.shared)):
        bufs += [(f"level {i} {name}", getattr(tl, name), getattr(jl, name))
                 for name in ("k", "v", "k_scale", "v_scale", "seq_lens")]
    for name, t, j in bufs:
        if t is not None:
            t, j = _np(t), np.asarray(j)
            assert t.shape == j.shape and t.dtype == j.dtype, (name, t.shape, j.shape)
            np.testing.assert_array_equal(t, j, err_msg=name)


# The JAX engine runs its cache writes under jax.jit, where XLA multiplies
# amax by the f32 reciprocal of 7 (quantize_kv4); the writes below are held to
# those jitted functions.
_jit_prefill = jax.jit(jcache.update_unique_prefill)
_jit_write_layer = jax.jit(jcache.write_decode_token_layer, static_argnames=("layer",))
_jit_decode = jax.jit(jcache.update_unique_decode, static_argnames=("uniform",))
_jit_repeat = jax.jit(jcache.repeat_unique_for_samples,
                      static_argnames=("current_size", "num_samples"))


@pytest.mark.parametrize("layout", ["bshd_flat", "bshd", "bhsd"])
def test_int4_cache_writes_match_jax(layout):
    """A unique prefill of 11 tokens into 8 byte rows (rows 0-2 get a high
    token, rows 3-7 a cleared high nibble), the per-layer decode write at a
    low-plane slot (5) and a high-plane slot (12, over the live token 4), the
    slot write of ``KVWrite`` at slots 6 (low) and 14 (high) against JAX's
    batched write, and the sample repeat: payloads and scales bit-equal to
    JAX's functions under jax.jit."""
    bshd = layout.startswith("bshd")
    flat = layout == "bshd_flat"
    Lc, Bc, U, hkv, hd = 2, 4, 16, 2, 128
    kw = dict(quantized=True, unique_bshd=bshd, flat_scales=flat, unique_bits=4)
    jc = jcache.allocate_cache(Lc, Bc, U, [1], [8], hkv, hd, dtype=jnp.float32, **kw)
    tc = tcache.allocate_cache(Lc, Bc, U, [1], [8], hkv, hd, dtype=torch.float32, **kw)
    assert tc.max_unique_seq_len == jc.max_unique_seq_len == U
    assert tc.unique_k.shape == jc.unique_k.shape and tc.flat_scales == flat
    rng = np.random.RandomState(13)

    def kv(*shape):
        return [rng.randn(*shape).astype(np.float32) for _ in range(2)]

    k, v = kv(Lc, 2, hkv, 11, hd)
    jc = _jit_prefill(jc, J(k), J(v))
    tcache.update_unique_prefill(tc, T(k), T(v))
    _same_cache(tc, jc)
    for slot in (5, 12):
        k, v = kv(3, hkv, 1, hd)
        for li in range(Lc):
            jc = _jit_write_layer(jc, layer=li, k=J(k), v=J(v), slot=jnp.int32(slot))
            tcache.write_decode_token_layer(tc, li, T(k), T(v), slot)
        _same_cache(tc, jc)
    for slot in (6, 14):
        k, v = kv(Lc, 4, hkv, 1, hd)
        pos = np.full(4, slot, np.int32)
        jc = _jit_decode(jc, J(pos), J(k), J(v), uniform=True)
        write = tcache.KVWrite.slot(tc, 4, slot)
        for li in range(Lc):
            write.put(li, T(k[li]), T(v[li]))
        _same_cache(tc, jc)
    jc = _jit_repeat(jc, current_size=2, num_samples=2)
    tcache.repeat_unique_for_samples(tc, 2, 2)
    _same_cache(tc, jc)


def test_int4_ragged_decode_write_raises_like_jax():
    kw = dict(quantized=True, unique_bshd=True, unique_bits=4)
    jc = jcache.allocate_cache(1, 2, 8, [], [], 2, 128, dtype=jnp.float32, **kw)
    tc = tcache.allocate_cache(1, 2, 8, [], [], 2, 128, dtype=torch.float32, **kw)
    k = np.ones((1, 2, 2, 1, 128), np.float32)
    pos = np.asarray([1, 3], np.int32)
    with pytest.raises(AssertionError):
        jcache.update_unique_decode(jc, J(pos), J(k), J(k))
    with pytest.raises(ValueError, match="uniform"):
        tcache.KVWrite.rows(tc, T(pos))


@pytest.mark.parametrize("layer", [1, None])
def test_gather_token_row_matches_jax(layer):
    """The byte-row read of the int4 write (the TPU's K7 in interpret mode)."""
    rng = np.random.RandomState(14)
    buf = rng.randint(-128, 128, (2, 3, 5, 2, 128)).astype(np.int8)
    t = tdecode.gather_token_row_cached(layer, 3, T(buf))
    j = jdecode.gather_token_row_cached(None if layer is None else jnp.int32(layer),
                                        jnp.int32(3), J(buf), interpret=True)
    np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_write_token_int4_plain_is_the_cache_write():
    """The K7 wrapper's plain version (the kernel's yardstick on the card) is
    byte for byte JAX's jitted per-layer int4 write into a flat-scaled BSHD
    cache, low plane and high plane."""
    rng = np.random.RandomState(15)
    kw = dict(quantized=True, unique_bshd=True, flat_scales=True, unique_bits=4)
    jc = jcache.allocate_cache(2, 3, 12, [], [], 2, 64, dtype=jnp.float32, **kw)
    tc = tcache.allocate_cache(2, 3, 12, [], [], 2, 64, dtype=torch.float32, **kw)
    for slot in (2, 8, 3, 11):
        k, v = (rng.randn(3, 2, 1, 64).astype(np.float32) for _ in range(2))
        jc = _jit_write_layer(jc, layer=1, k=J(k), v=J(v), slot=jnp.int32(slot))
        tdecode.write_token_int4_cached_plain(1, T(k), T(v), tc.unique_k, tc.unique_v,
                                              tc.unique_k_scale, tc.unique_v_scale, slot)
    _same_cache(tc, jc)


# --- parameters, bridge and capacity --------------------------------------------


def test_bridge_carries_int4_weights():
    """A JAX ``init_params(quantized="w4a8")`` tree converts leaf by leaf:
    Quantized4Tensor stays Quantized4Tensor (not an int8 QuantizedTensor),
    with every shape, dtype and byte."""
    cfg = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2)
    jp = jllama.init_params(JConfig(**cfg), jax.random.PRNGKey(3), quantized="w4a8")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))

    def walk(j, t, path):
        if isinstance(j, dict):
            assert sorted(j) == sorted(t), path
            for key in j:
                walk(j[key], t[key], f"{path}/{key}")
            return
        if isinstance(j, tuple):
            assert type(t).__name__ == type(j).__name__ and t._fields == j._fields, path
            for jj, tt in zip(j, t):
                walk(jj, tt, path)
            return
        a = np.asarray(j)
        assert tuple(t.shape) == a.shape and str(t.dtype).split(".")[-1] == str(a.dtype), path
        np.testing.assert_array_equal(_np(t.view(torch.int16) if t.dtype == torch.bfloat16
                                          else t), a.view(np.int16) if a.dtype.name ==
                                      "bfloat16" else a, err_msg=path)

    walk(jp, tp, "")
    assert isinstance(tp["layers"]["down"], tquant.Quantized4Tensor)
    assert isinstance(tp["lm_head"], tquant.QuantizedTensor)


@pytest.mark.parametrize("quant", ["int4", "w4a8"])
def test_init_params_int4_shapes_match_jax(quant):
    cfg = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=1)
    jp = jllama.init_params(JConfig(**cfg), jax.random.PRNGKey(0), quantized=quant)
    tp = tllama.init_params(TConfig(**cfg), torch.Generator().manual_seed(0), quantized=quant)
    jl, tl = jax.tree.leaves(jp), []

    def walk(x):
        if isinstance(x, dict):
            for key in sorted(x):
                walk(x[key])
        elif isinstance(x, tuple):
            tl.extend(x)
        else:
            tl.append(x)

    walk(tp)
    assert [tuple(t.shape) for t in tl] == [a.shape for a in jl]
    assert [str(t.dtype).split(".")[-1] for t in tl] == [str(a.dtype) for a in jl]
    qp = tp["layers"]["wq"].qp
    assert int(qp.min()) == -128  # the nibble -8 in the high plane


@pytest.mark.parametrize("quant", ["int4", "w4a8"])
def test_param_bytes_int4_match_jax(quant):
    from hydragen_tpu.models.config import PRESETS as JPRESETS
    from hydragen_tpu.utils.capacity import param_bytes as jparam_bytes

    from hydragen_torch.models.config import PRESETS as TPRESETS
    from hydragen_torch.utils.capacity import param_bytes as tparam_bytes

    for name, jcfg in JPRESETS.items():
        assert tparam_bytes(TPRESETS[name], quant) == jparam_bytes(jcfg, quant), name


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_kv_cache_bytes_count_the_buffers(kv_quant):
    from hydragen_torch.utils.capacity import kv_cache_bytes

    cfg = TConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=2)
    e = TEngine(cfg, tllama.init_params(cfg, torch.Generator().manual_seed(0)), device="cpu")
    e.setup_caches(4, 20, [1, 2], [16, 8], kv_quant=kv_quant)
    c = e.cache
    bufs = [c.unique_k, c.unique_v, c.unique_k_scale, c.unique_v_scale]
    for lv in c.shared:
        bufs += [lv.k, lv.v, lv.k_scale, lv.v_scale, lv.seq_lens]
    got = sum(x.numel() * x.element_size() for x in bufs if x is not None)
    assert kv_cache_bytes(cfg, 4, 20, [1, 2], [16, 8], kv_quant) == got


# --- the engine end to end ------------------------------------------------------

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=2, num_key_value_heads=2, dtype="float32")
# name: (quantization, kv_quant, unique_bshd, seed of the prompt and suffixes)
ENGINE_MODES = {
    "w4a8_kv4_bshd": ("w4a8", "int4", True, 21),
    "w4a8_kv4_bhsd": ("w4a8", "int4", False, 21),
    "mixed_kv4": ("mixed", "int4", True, 21),
    "int4_kv4": ("int4", "int4", True, 21),
    "w4a8_kv4_bshd_preserve": ("w4a8", "int4", True, 5),
}


@pytest.fixture(scope="module")
def fp_params():
    p = jllama.init_params(JConfig(**CFG), jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


def _requests(seed):
    """The two requests of the engine tests: a 12-token shared prompt with 4
    samples of 11 greedy tokens (WIPE), then 4 suffixes of 5 tokens over the
    kept prompt (PRESERVE)."""
    rng = np.random.RandomState(seed)
    prompt = rng.randint(1, 256, (1, 12)).astype(np.int32)
    suffixes = rng.randint(1, 256, (4, 5)).astype(np.int32)
    return ((dict(input_ids=[prompt], num_return_sequences=4, max_new_tokens=11), "WIPE"),
            (dict(input_ids=[suffixes], num_return_sequences=1, max_new_tokens=5), "PRESERVE"))


def _run_requests(eng, op_cls, requests, snap):
    """Both requests on one engine: (tokens, logits, cache snapshot) each."""
    out = []
    for kw, op in requests:
        toks, logits = eng.generate(shared_cache_op=getattr(op_cls, op), temperature=0.0,
                                    return_logits=True, **kw)
        out.append((_np(toks), [_np(x) for x in logits], snap(eng.cache)))
    return out


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_int4_matches_jax(fp_params, mode, monkeypatch):
    """Two requests on both engines (each quantizes the same fp32 weights
    itself): a 12-token shared prompt with 4 samples of 11 greedy tokens
    (WIPE; the decode crosses from the low plane to the high plane at slot
    8), then 4 suffixes of 5 tokens over the kept prompt (PRESERVE; the
    suffix prefill pads to the 16-token window, so the pack fills both
    planes, and decode writes slots 5-9). Greedy tokens identical, per-step
    logits within 1e-3 and the caches equal tensor by tensor after each
    request, every forward pass held.

    Both engines quantize activations and KV with the same functions, but
    their inputs differ in the last bits of XLA's and PyTorch's float sums
    upstream, and a value within those bits of a half code lands one code
    apart (``tests/test_torch_ties.py``). The JAX engine runs first with
    every quantization recorded; the port then runs with each of its
    quantizations held to its JAX counterpart: a differing code must be a
    tie (the rule of ``test_torch_ties.py``), and the port goes on from
    JAX's codes there, so no request is cut short at a tie."""
    from tests.test_torch_ties import Resolver, assert_resolved, jax_recorded, port_resolved

    quant, kv, bshd, seed = ENGINE_MODES[mode]
    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    jp, tp = fp_params
    je = JEngine(JConfig(**CFG), jp, quantization=quant)
    te = TEngine(TConfig(**CFG), tp, quantization=quant, device="cpu")
    for e in (je, te):
        e.setup_caches(4, 16, [1], [16], kv_quant=kv, unique_bshd=bshd)
    assert te.cache.unique_k.shape == je.cache.unique_k.shape
    requests = _requests(seed)
    records = []
    with jax_recorded(records):
        jax_out = _run_requests(je, JOp, requests, lambda c: _snapshot(c, np.asarray))
    with port_resolved(Resolver(records)) as res:
        port_out = _run_requests(te, TOp, requests, lambda c: _snapshot(
            c, lambda x: _np(x).copy()))
    assert_resolved(res.report(), mode)
    for (kw, op), (jt, jl, jc), (tt, tl, tc) in zip(requests, jax_out, port_out):
        np.testing.assert_array_equal(tt, jt, err_msg=op)
        assert len(tl) == len(jl) == kw["max_new_tokens"]
        for step, (t, j) in enumerate(zip(tl, jl)):
            d = np.abs(t - j).max()
            assert d <= 1e-3, (quant, op, step, d)
        _same_engine_caches(tc, jc)


def _snapshot(c, conv):
    """A copy of one engine's cache as numpy arrays (the next request writes
    it in place)."""
    out = {n: conv(getattr(c, n)) for n in ("unique_k", "unique_v", "unique_k_scale",
                                             "unique_v_scale")}
    out["shared"] = [(conv(lv.seq_lens), conv(lv.k)) for lv in c.shared]
    out["bits"] = c.unique_bits
    out["levels_quantized"] = [lv.quantized for lv in c.shared]
    return out


def _same_engine_caches(tc, jc):
    assert tc["bits"] == jc["bits"] == 4
    # int8 levels under "follow".
    assert all(tc["levels_quantized"]) and all(jc["levels_quantized"])
    for name in ("unique_k", "unique_v"):
        t, j = tc[name], jc[name]
        assert t.shape == j.shape and t.dtype == j.dtype
        lo_t, hi_t = tquant.unpack4(T(t))
        lo_j, hi_j = jquant.unpack4(J(j))
        for pt, pj in ((lo_t, lo_j), (hi_t, hi_j)):
            diff = np.abs(_np(pt).astype(np.int32) - np.asarray(pj).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (name, diff.max())
    for name in ("unique_k_scale", "unique_v_scale"):
        np.testing.assert_allclose(tc[name], jc[name], rtol=1e-4, atol=1e-6, err_msg=name)
    for (tl, tk), (jl, jk) in zip(tc["shared"], jc["shared"]):
        np.testing.assert_array_equal(tl, jl)
        diff = np.abs(tk.astype(np.int32) - jk.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


# Prompt seeds (params key 0, mode w4a8_kv4_bshd) at which, on some host, the
# first code to differ between the engines was an int8 KV code of the shared
# level or an activation code. Which quantizer ties first, and whether any
# does, depends on the host's float sums; the test asserts neither.
SPY_SEEDS = (4, 7, 31, 38, 39)


@pytest.mark.parametrize("seed", SPY_SEEDS)
def test_first_differing_code_of_any_quantizer_is_a_tie(fp_params, seed, monkeypatch):
    """Both w4a8 + int4-KV requests of ``test_engine_int4_matches_jax`` with
    every quantizer of both engines spied (activation rows and KV), the port
    NOT handed JAX's codes: the first call, in the port's order, whose codes
    differ from its JAX counterpart's is a tie (``tests/test_torch_ties.py``),
    and no call before it differs or lacks a counterpart. Where no code
    differs at all, everything is held equal: tokens identical and every
    step's logits within 1e-3."""
    from tests.test_torch_ties import Resolver, jax_recorded, port_resolved

    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    jp, tp = fp_params
    je = JEngine(JConfig(**CFG), jp, quantization="w4a8")
    te = TEngine(TConfig(**CFG), tp, quantization="w4a8", device="cpu")
    for e in (je, te):
        e.setup_caches(4, 16, [1], [16], kv_quant="int4", unique_bshd=True)
    requests = _requests(seed)
    records = []
    with jax_recorded(records):
        jax_out = _run_requests(je, JOp, requests, lambda c: None)
    with port_resolved(Resolver(records, substitute=False)) as res:
        port_out = _run_requests(te, TOp, requests, lambda c: None)
    rep = res.report()
    first = rep["first_diff"]
    print(f"[ties] seed {seed}: first differing call {first}, noise {rep['noise_ulps']:.3f}")
    assert rep["calls"] > 0
    if first is None:
        assert not rep["faults"], rep["faults"][:3]
        for (jt, jl, _), (tt, tl, _) in zip(jax_out, port_out):
            np.testing.assert_array_equal(tt, jt)
            assert max(np.abs(t - j).max() for t, j in zip(tl, jl)) <= 1e-3
        return
    call, check = first
    assert check["ok"], (seed, check)
    assert all(f[0] > call for f in rep["faults"]), (call, rep["faults"][:3])


def test_engine_int4_ragged_suffixes_raise(fp_params):
    """Ragged suffix lengths with int4 KV: the decode write refuses the
    sub-byte scatter, as the JAX engine does."""
    _, tp = fp_params
    te = TEngine(TConfig(**CFG), tp, quantization="int4", device="cpu")
    te.setup_caches(2, 16, [], [], kv_quant="int4")
    ids = np.ones((2, 4), np.int32)
    with pytest.raises(ValueError, match="uniform"):
        te.generate(input_ids=[ids], seq_lens=np.asarray([4, 2], np.int32),
                    max_new_tokens=3, temperature=0.0)
