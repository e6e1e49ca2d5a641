"""``model_forward`` of the port against the JAX package's, mode by mode.

One random parameter set is made by the JAX package, taken to numpy and
carried into the port with ``params_from_numpy``; both packages then run the
same forward over caches of the same layout, and the hidden states and the
caches are compared tensor by tensor: hidden states to 1e-4 (fp32), f32
scales to 1e-6, float payloads to 1e-5, and int8 payloads bit-equal where
the values quantized are bit-equal. That holds under w8a8, whose integer
GEMM is exact in both packages. With fp32 weights the float products of XLA
and PyTorch differ in the last bit, so a value on a rounding boundary may
land one code apart: there at most 1 code in 1,000 may differ, by 1. After
each mode the port's cache is set from the JAX cache, so that every mode
starts from the same state and such a code cannot carry into the next one.
The JAX side of a w8a8 case runs its Pallas s8 GEMM in interpret mode
(``HYDRAGEN_W8A8_INTERPRET=1``); without it, JAX runs weight-only int8 on
the CPU.
"""

import dataclasses

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax
import jax.numpy as jnp
import torch

from hydragen_tpu.core import cache as jcache
from hydragen_tpu.models import llama as jllama
from hydragen_tpu.models.config import ModelConfig as JConfig
from hydragen_tpu.ops.quant import quantize_params as jquantize_params

from hydragen_torch.core import cache as tcache
from hydragen_torch.models import llama as tllama
from hydragen_torch.models.config import ModelConfig as TConfig
from hydragen_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
           num_attention_heads=2, num_key_value_heads=2, dtype="float32")
L, B, U, SHARED = 2, 4, 16, 16


def _params(quant):
    p = jllama.init_params(JConfig(**CFG), jax.random.PRNGKey(0))
    if quant:
        p = jquantize_params(p, pad_mlp=True)
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


def _jspec(mode, levels, filled, history, quant, level_batch=()):
    return jllama.ForwardSpec(
        mode=mode, num_used_levels=levels, level_filled=filled, unique_history=history,
        unique_filled=U if history else 0, disable_hydragen=False,
        disable_attention=False, impl="xla", matmul="w8a8" if quant else "dq",
        level_batch=level_batch,
    )


def _tspec(mode, levels, filled, history, quant, level_batch=()):
    return tllama.ForwardSpec(
        mode=mode, num_used_levels=levels, level_filled=filled, unique_history=history,
        unique_filled=U if history else 0, disable_hydragen=False,
        disable_attention=False, matmul="w8a8" if quant else "dq",
        level_batch=level_batch,
    )


def _caches(kv):
    kw = dict(quantized=kv, unique_bshd=True)
    hkv, hd = CFG["num_key_value_heads"], CFG["hidden_size"] // CFG["num_attention_heads"]
    jc = jcache.allocate_cache(L, B, U, [1], [SHARED], hkv, hd, dtype=jnp.float32, **kw)
    tc = tcache.allocate_cache(L, B, U, [1], [SHARED], hkv, hd, dtype=torch.float32, **kw)
    return jc, tc


def _same_buffer(t, j, what, exact_codes):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (what, t.shape, j.shape)
    if t.dtype == np.int8:
        if exact_codes:
            np.testing.assert_array_equal(t, j, err_msg=what)
        else:
            diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (what, diff.max())
    elif t.dtype == np.int32:
        np.testing.assert_array_equal(t, j, err_msg=what)
    elif "scale" in what:
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5, err_msg=what)


def _same_cache(tc, jc, exact_codes):
    for name in ("unique_k", "unique_v", "unique_k_scale", "unique_v_scale"):
        t, j = getattr(tc, name), getattr(jc, name)
        assert (t is None) == (j is None), name
        if t is not None:
            _same_buffer(t, j, name, exact_codes)
    for i, (tl, jl) in enumerate(zip(tc.shared, jc.shared)):
        for name in ("k", "v", "k_scale", "v_scale", "seq_lens"):
            t, j = getattr(tl, name), getattr(jl, name)
            if t is not None:
                _same_buffer(t, j, f"level {i} {name}", exact_codes)


def _sync_from_jax(tc, jc):
    for name in ("unique_k", "unique_v", "unique_k_scale", "unique_v_scale"):
        if getattr(tc, name) is not None:
            getattr(tc, name).copy_(T(getattr(jc, name)))
    for tl, jl in zip(tc.shared, jc.shared):
        for name in ("k", "v", "k_scale", "v_scale", "seq_lens"):
            if getattr(tl, name) is not None:
                getattr(tl, name).copy_(T(getattr(jl, name)))


def _hidden_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant", [None, "w8a8"])
@pytest.mark.parametrize("kv", [False, True])
def test_model_forward_modes_match_jax(monkeypatch, quant, kv):
    if quant:
        monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    jp, tp = _params(quant)
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jc, tc = _caches(kv)
    rng = np.random.RandomState(1)
    qbits = 8 if kv else None

    # 1. Shared prefill of one prefix, written into level 0 in place.
    ids = rng.randint(1, 256, (1, 12)).astype(np.int32)
    pos = np.arange(12, dtype=np.int32)[None]
    jh, bufs = jllama.model_forward(
        jp, jcfg, jc, J(ids), J(pos), J(pos), _jspec("shared_prefill", 0, (), False, quant),
        quantize_new_kv=qbits, fill_level=0,
    )
    jc = jcache.set_shared_level_buffers(jc, 0, *bufs, J(np.asarray([12], np.int32)))
    th = tllama.model_forward(
        tp, tcfg, tc, T(ids), T(pos), T(pos), _tspec("shared_prefill", 0, (), False, quant),
        write=tcache.KVWrite.level(tc, 0, 1, 12),
    )
    tcache.set_shared_level_buffers(tc, 0, T(np.asarray([12], np.int32)))
    _hidden_close(th, jh)
    _same_cache(tc, jc, exact_codes=quant is not None)
    _sync_from_jax(tc, jc)

    # 2. Unique prefill of two suffixes over the level, then two samples each.
    ids = rng.randint(1, 256, (2, 5)).astype(np.int32)
    upos = np.broadcast_to(np.arange(5, dtype=np.int32)[None], (2, 5))
    gpos = upos + 12
    jh, nk, nv = jllama.model_forward(
        jp, jcfg, jc, J(ids), J(gpos), J(upos),
        _jspec("unique_prefill", 1, (12,), False, quant, (1,)), quantize_new_kv=qbits,
    )
    jc = jcache.repeat_unique_for_samples(jcache.update_unique_prefill(jc, nk, nv), 2, 2)
    th = tllama.model_forward(
        tp, tcfg, tc, T(ids), T(gpos), T(upos),
        _tspec("unique_prefill", 1, (12,), False, quant, (1,)),
        write=tcache.KVWrite.block(tc, 2, 5),
    )
    tcache.repeat_unique_for_samples(tc, 2, 2)
    _hidden_close(th, jh)
    _same_cache(tc, jc, exact_codes=quant is not None)
    _sync_from_jax(tc, jc)

    # 3. One decode step of all four rows, written in place at slot 5.
    ids = rng.randint(1, 256, (4, 1)).astype(np.int32)
    hist = np.full((4,), 5, np.int32)
    jh, jc = jllama.model_forward(
        jp, jcfg, jc, J(ids), J(hist[:, None] + 12), J(hist[:, None]),
        _jspec("decode", 1, (12,), True, quant, (1,)), history_lens=J(hist),
        inplace_slot=jnp.int32(5),
    )
    th = tllama.model_forward(
        tp, tcfg, tc, T(ids), T(hist[:, None] + 12), T(hist[:, None]),
        _tspec("decode", 1, (12,), True, quant, (1,)), history_lens=T(hist),
        write=tcache.KVWrite.slot(tc, 4, 5),
    )
    _hidden_close(th, jh)
    _same_cache(tc, jc, exact_codes=quant is not None)

    # The LM head stays weight-only under w8a8 in both packages.
    np.testing.assert_allclose(
        tllama.logits_from_hidden(tp, tcfg, th).numpy(),
        np.asarray(jllama.logits_from_hidden(jp, jcfg, jh)), rtol=1e-4, atol=1e-4,
    )


def test_rope_and_rms_norm_match_jax():
    rng = np.random.RandomState(2)
    pos = rng.randint(0, 4000, (2, 7)).astype(np.int32)
    for scaling in (None, ("linear", 2.0), ("dynamic", 2.0), ("llama3", 8.0, 1.0, 4.0, 64)):
        kw = dict(CFG, rope_scaling=scaling, max_position_embeddings=512)
        tc, ts = tllama.rope_cos_sin(TConfig(**kw), T(pos))
        jc, js = jllama.rope_cos_sin(JConfig(**kw), J(pos))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-4)
    x = rng.randn(2, 3, 7, 128).astype(np.float32)
    cos, sin = tllama.rope_cos_sin(TConfig(**CFG), T(pos[:, :7] % 100))
    jcos, jsin = jllama.rope_cos_sin(JConfig(**CFG), J(pos[:, :7] % 100))
    np.testing.assert_allclose(tllama.apply_rope(T(x), cos, sin).numpy(),
                               np.asarray(jllama.apply_rope(J(x), jcos, jsin)), atol=1e-5)
    h = rng.randn(3, 5, 256).astype(np.float32)
    w = rng.rand(256).astype(np.float32)
    np.testing.assert_allclose(tllama.rms_norm(T(h), T(w), 1e-5).numpy(),
                               np.asarray(jllama.rms_norm(J(h), J(w), 1e-5)),
                               rtol=1e-6, atol=1e-6)


def test_init_params_shapes_match_jax():
    """The port's own random init (from a torch.Generator) has the JAX
    package's tree, shapes and dtypes, w8a8 intermediate padding included."""
    cfg = dict(CFG, intermediate_size=600)
    g = torch.Generator().manual_seed(0)
    for quant in (False, "w8a8"):
        tp = tllama.init_params(TConfig(**cfg), g, quantized=quant)
        jp = jllama.init_params(JConfig(**cfg), jax.random.PRNGKey(0), quantized=quant)
        tl = jax.tree.leaves(jax.tree.map(np.asarray, jp))
        flat = []

        def walk(x):
            if isinstance(x, dict):
                for k in sorted(x):
                    walk(x[k])
            elif isinstance(x, tuple):
                flat.extend(x)
            else:
                flat.append(x)

        walk(tp)
        assert [tuple(t.shape) for t in flat] == [a.shape for a in tl]
        assert [str(t.dtype).split(".")[-1] for t in flat] == [str(a.dtype) for a in tl]


def _put(write, k, v):
    """The chain's write of stacked ``[L, ...]`` numpy KV, layer by layer."""
    for li in range(k.shape[0]):
        write.put(li, T(k[li]), T(v[li]))


@pytest.mark.parametrize("layout", ["bshd_flat_int8", "bhsd_int8", "bhsd_float"])
def test_cache_writers_match_jax(layout):
    """Each cache writer on both packages, buffer by buffer: a level fill,
    a unique prefill at an offset, a ragged per-row decode write, a uniform
    decode write, the sample repeat, and the summed shared lengths. The
    port's level and decode writes are its ``KVWrite``'s, layer by layer."""
    quant = layout.endswith("int8")
    bshd = layout.startswith("bshd")
    Lc, Bc, Uc, hkv, hd = 2, 6, 8, 2, 16
    kw = dict(dtype=jnp.float32, quantized=quant, unique_bshd=bshd)
    jc = jcache.allocate_cache(Lc, Bc, Uc, [1, 2], [8, 4], hkv, hd, **kw)
    tc = tcache.allocate_cache(Lc, Bc, Uc, [1, 2], [8, 4], hkv, hd,
                               **dict(kw, dtype=torch.float32))
    assert tc.flat_scales == jc.flat_scales == (bshd and quant)
    rng = np.random.RandomState(3)

    def kv(*shape):
        return [rng.randn(*shape).astype(np.float32) for _ in range(2)]

    k, v = kv(Lc, 2, hkv, 3, hd)
    lens = np.asarray([3, 2], np.int32)
    jc = jcache.fill_shared_level(jc, 1, J(k), J(v), J(lens))
    _put(tcache.KVWrite.level(tc, 1, 2, 3), k, v)
    tcache.set_shared_level_buffers(tc, 1, T(lens))
    k, v = kv(Lc, 3, hkv, 4, hd)
    jc = jcache.update_unique_prefill(jc, J(k), J(v), start=1, row_start=2)
    tcache.update_unique_prefill(tc, T(k), T(v), start=1, row_start=2)
    k, v = kv(Lc, 5, hkv, 1, hd)
    pos = np.asarray([5, 0, 7, 2, 6], np.int32)
    jc = jcache.update_unique_decode(jc, J(pos), J(k), J(v))
    _put(tcache.KVWrite.rows(tc, T(pos)), k, v)
    k, v = kv(Lc, 5, hkv, 1, hd)
    jc = jcache.update_unique_decode(jc, J(np.full(5, 4, np.int32)), J(k), J(v), uniform=True)
    _put(tcache.KVWrite.slot(tc, 5, 4), k, v)
    jc = jcache.repeat_unique_for_samples(jc, 3, 2)
    tcache.repeat_unique_for_samples(tc, 3, 2)
    _same_cache(tc, jc, exact_codes=True)
    np.testing.assert_array_equal(
        tcache.shared_len_for_batch(tc, 2, 6, (1, 2)).numpy(),
        np.asarray(jcache.shared_len_for_batch(jc, 2, 6, (1, 2))),
    )


@pytest.mark.parametrize("quant", [None, "int8", "w8a8"])
def test_presets_and_param_bytes_match_jax(quant):
    """The port's own copy of the configs and of the capacity estimate."""
    import dataclasses

    from hydragen_tpu.models.config import PRESETS as JPRESETS
    from hydragen_tpu.utils.capacity import param_bytes as jparam_bytes

    from hydragen_torch.models.config import PRESETS as TPRESETS
    from hydragen_torch.utils.capacity import param_bytes as tparam_bytes

    assert sorted(TPRESETS) == sorted(JPRESETS)
    for name, jcfg in JPRESETS.items():
        tcfg = TPRESETS[name]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert tcfg.head_dim == jcfg.head_dim
        assert tparam_bytes(tcfg, quant) == jparam_bytes(jcfg, quant), name


# --- every destination of the one write seam -------------------------------------

WCFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, dtype="float32")
WB, WU, WSB, WS = 4, 16, 2, 8  # unique rows and tokens (int4: 8 byte rows); level 0's
# The destinations and the caches each takes: an int4 unique cache keeps an
# int8 level and refuses per-row positions (rows, ring).
WRITE_CASES = [(d, kv, lay) for d in ("level", "block", "slot", "rows", "ring")
               for kv in ("int8", "int4", "bf16") for lay in ("bshd", "bhsd")
               if not (kv == "int4" and d in ("rows", "ring"))]


def _wparams():
    p = jllama.init_params(JConfig(**WCFG), jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


class _Kept:
    """A write that keeps each layer's new KV and writes nothing."""

    def __init__(self):
        self.k, self.v = [], []

    def bind(self, x, impl, masked):
        return self

    def dest(self, li):
        return None

    def put(self, li, k, v):
        self.k.append(k)
        self.v.append(v)

    def stacked(self):
        return [J(torch.stack(x).numpy()) for x in (self.k, self.v)]


def _random_caches(kv, layout):
    """Both packages' caches of ``kv`` and ``layout``, every buffer holding
    the same random values, so that a stray or missing write shows."""
    hkv, hd = WCFG["num_key_value_heads"], WCFG["hidden_size"] // WCFG["num_attention_heads"]
    kw = dict(quantized=kv != "bf16", unique_bshd=layout == "bshd",
              unique_bits=4 if kv == "int4" else 8)
    tc = tcache.allocate_cache(L, WB, WU, [WSB], [WS], hkv, hd, dtype=torch.bfloat16, **kw)
    jc = jcache.allocate_cache(L, WB, WU, [WSB], [WS], hkv, hd, dtype=jnp.bfloat16, **kw)
    g = torch.Generator().manual_seed(7)
    jlevel = {}
    for name, t in _buffers(tc):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-128, 128, t.shape, generator=g, dtype=torch.int8))
        elif t.dtype != torch.int32:
            t.copy_(torch.rand(t.shape, generator=g).to(t.dtype))
        x = jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())
        jlevel[name] = x.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else x
    lv = jc.shared[0]
    jc = jc._replace(
        **{n: jlevel[n] for n in ("unique_k", "unique_v", "unique_k_scale", "unique_v_scale")
           if n in jlevel},
        shared=(lv._replace(**{f: jlevel["level " + f] for f in ("k", "v", "k_scale",
                                                                 "v_scale", "seq_lens")
                               if "level " + f in jlevel}),))
    return tc, jc


def _buffers(tc):
    out = [(n, getattr(tc, n)) for n in ("unique_k", "unique_v", "unique_k_scale",
                                         "unique_v_scale")]
    lv = tc.shared[0]
    out += [("level " + f, getattr(lv, f)) for f in ("k", "v", "k_scale", "v_scale",
                                                      "seq_lens")]
    return [(n, t) for n, t in out if t is not None]


def _write_case(dest, tc, rng):
    """The forward's inputs, spec and write at ``dest``, and the JAX writer
    that takes the stacked KV, ``(jc, nk, nv) -> jc``."""
    spec = _tspec("decode", 0, (), False, None)
    one = np.zeros((WB, 1), np.int32)
    if dest == "level":
        ids = rng.randint(1, 128, (WSB, 6)).astype(np.int32)
        lens = np.full(WSB, 6, np.int32)
        tcache.set_shared_level_buffers(tc, 0, T(lens))
        return ids, spec, tcache.KVWrite.level(tc, 0, WSB, 6), \
            lambda jc, k, v: jcache.fill_shared_level(jc, 0, k, v, J(lens))
    if dest == "block":
        start = 0 if tc.unique_bits == 4 else 4
        ids = rng.randint(1, 128, (3, 5)).astype(np.int32)
        return ids, spec, tcache.KVWrite.block(tc, 3, 5, start), \
            lambda jc, k, v: jcache.update_unique_prefill(jc, k, v, start=start)
    ids = rng.randint(1, 128, (WB, 1)).astype(np.int32)
    if dest == "slot":  # a device slot, as a decode step passes it; int4's high plane
        return ids, spec, tcache.KVWrite.slot(tc, WB, torch.tensor(9, dtype=torch.int32)), \
            lambda jc, k, v: jcache.update_unique_decode(jc, J(one[:, 0] + 9), k, v,
                                                         uniform=True)
    if dest == "rows":
        pos = np.asarray([5, 0, 15, 2], np.int32)
        return ids, spec, tcache.KVWrite.rows(tc, T(pos)), \
            lambda jc, k, v: jcache.update_unique_decode(jc, J(pos), k, v)
    # The ring: two members in pool rows 2 and 0, 5 and 3 tokens right-padded
    # to 6, right-aligned before the cursor, which wraps them past slot 15.
    rows, lens, tb, cursor = np.asarray([2, 0]), np.asarray([5, 3], np.int32), 6, WU + 3
    ids = rng.randint(1, 128, (2, tb)).astype(np.int32)
    ki, ji = np.nonzero(np.arange(tb)[None, :] < lens[:, None])
    slots = (cursor - lens[ki] + ji) % WU
    write = tcache.KVWrite.ring(tc, T(rows[ki]).long(), T(slots).long(),
                                (T(ki).long(), T(ji).long()))

    from hydragen_tpu.core import batching as jbatching

    p, _ = _wparams()

    def jax_ring(jc, k, v):
        state = jbatching.BatchState(
            cur_token=jnp.zeros((WB, 1), jnp.int32), pos=jnp.zeros(WB, jnp.int32),
            start=jnp.zeros(WB, jnp.int32), remaining=jnp.zeros(WB, jnp.int32),
            active=jnp.zeros(WB, bool), cursor=jnp.int32(cursor))
        hidden = jnp.zeros((2, tb, WCFG["hidden_size"]), jnp.float32)
        forward = jbatching.model_forward
        jbatching.model_forward = lambda *a, **kw: (hidden, k, v)
        try:  # the JAX batcher's admission, its ring scatter fed this KV
            _, jc = jbatching._admit_step.__wrapped__(
                p, jc, state, J(ids), J(lens), J(rows.astype(np.int32)),
                J(np.full(2, 4, np.int32)), jax.random.PRNGKey(0), JConfig(**WCFG),
                _jspec("unique_prefill", 0, (), False, None), 0.0, None)
        finally:
            jbatching.model_forward = forward
        return jc

    return ids, spec, write, jax_ring


@pytest.mark.parametrize("dest,kv,layout", WRITE_CASES)
def test_every_write_destination_matches_the_jax_writers(dest, kv, layout):
    """``model_forward(write=...)`` at each destination, into each cache: the
    cache after the forward, tensor by tensor and bit for bit, is the one
    the JAX package's writer makes from the same new KV (each layer's, as
    the chain receives it). K9 (its plain version on the CPU) writes the
    8-bit destinations it addresses; the chain writes the rest."""
    _, tp = _wparams()
    cfg = TConfig(**WCFG)
    tc, jc = _random_caches(kv, layout)
    rng = np.random.RandomState(8)
    ids, spec, write, jax_write = _write_case(dest, tc, rng)
    b, t = ids.shape
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)) + 3
    kept = _Kept()
    tllama.model_forward(tp, cfg, tc, T(ids), T(pos), T(pos), spec, write=kept)
    assert write.bind(T(ids), "kernel", masked=False).fused == (
        dest in ("level", "block", "slot") and (kv == "int8" or kv == "int4" and dest == "level"))
    tllama.model_forward(tp, cfg, tc, T(ids), T(pos), T(pos), spec, write=write)
    # Jitted, as the JAX package runs them (its eager quantizer rounds a
    # scale differently).
    jc = jax.jit(jax_write)(jc, *kept.stacked())
    jbufs = dict(_buffers(jc))
    for name, t in _buffers(tc):
        j = np.asarray(jbufs[name].astype(jnp.float32) if t.dtype == torch.bfloat16
                       else jbufs[name])
        np.testing.assert_array_equal(t.float().numpy() if t.dtype == torch.bfloat16
                                      else t.numpy(), j, err_msg=name)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_a_slot_write_under_a_ring_mask_follows_the_read(layout):
    """A decode step over a ring (``history_mask``) whose mask still counts
    the written slot's old token as valid: K9 does not take the write, which
    comes after the layer's read, so the step reads the old token. Its
    hidden states are those of the same step writing nothing, and its cache
    is the chain's slot write of that step's KV."""
    _, tp = _wparams()
    cfg = TConfig(**WCFG)
    tc, _ = _random_caches("int8", layout)
    ref = dataclasses.replace(tc, **{n: t.clone() for n, t in vars(tc).items()
                                     if torch.is_tensor(t)})
    ids = T(np.random.RandomState(9).randint(1, 128, (WB, 1)).astype(np.int32))
    pos = torch.full((WB, 1), WU + 2, dtype=torch.int32)
    spec = _tspec("decode", 0, (), True, None)
    mask = torch.ones((WB, WU), dtype=torch.bool)  # slot 9's old token among the valid
    write = tcache.KVWrite.slot(tc, WB, torch.tensor(9, dtype=torch.int32))
    assert write.bind(ids, "kernel", masked=False).fused
    assert not write.bind(ids, "kernel", masked=True).fused
    kept = _Kept()
    h0 = tllama.model_forward(tp, cfg, ref, ids, pos, pos, spec, history_mask=mask, write=kept)
    h = tllama.model_forward(tp, cfg, tc, ids, pos, pos, spec, history_mask=mask, write=write)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)
    chain = tcache.KVWrite.slot(ref, WB, 9)
    for li in range(WCFG["num_hidden_layers"]):
        chain.put(li, kept.k[li], kept.v[li])
    for (name, t), (_, r) in zip(_buffers(tc), _buffers(ref)):
        assert torch.equal(t, r), name


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def J(a):
    return jnp.asarray(np.asarray(a))
