"""The port's GQA path and no-sharing baseline against the JAX package's, on
the CPU.

A GQA model (fewer kv heads than query heads) gets a BHSD unique cache at
its widths (``hkv * head_dim`` bytes a token is not a multiple of 4 KiB), so
a decode step's unique read is ``flash_attention_bhsd`` at ``M = group * m``
folded query rows: the small-M read (K5, ``_decode_kernel`` on the TPU).
Here its plain version is held to the JAX function in interpret mode, at
shapes that reach ``_flash_decode_call`` (even ``b * hkv``: the JAX side
needs a row batch > 1, or it runs its generic kernel). Then a 2-layer GQA
engine and the no-sharing baseline (``disable_hydragen``, which copies the
shared level into every unique row) run on both engines from the same
parameters and prompts. Inputs come from numpy seeds; every float is fp32.
"""

import contextlib
import types

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
from hydragen_tpu.models.config import PRESETS as JPRESETS
from hydragen_tpu.models.config import ModelConfig as JConfig
from hydragen_tpu.ops import flash as jflash

from hydragen_torch import HydragenLlama as TEngine
from hydragen_torch import ModelConfig as TConfig
from hydragen_torch import SharedCacheOp as TOp
from hydragen_torch.core import cache as tcache
from hydragen_torch.models import llama as tllama
from hydragen_torch.models.config import PRESETS as TPRESETS
from hydragen_torch.models.convert import params_from_numpy
from hydragen_torch.ops import flash as tflash

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def J(a):
    return jnp.asarray(np.asarray(a))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --- K5: the small-M read's plain version against the JAX decode kernel -------

# name: (b, hq, hkv, m, S, lens, int8, strided): every case has a row of
# length 0 or lengths below S; "strided" reads k/v and the scales as views of
# a larger [L, B, hkv, U, d] cache, as the engine passes them.
K5_CASES = {
    "float_len0": (2, 8, 2, 1, 40, [0, 23], False, False),
    "int8_len0": (2, 8, 2, 1, 40, [23, 0], True, False),
    "int8_strided": (4, 4, 1, 1, 24, [24, 9, 0, 17], True, True),
    "float_strided_m3": (2, 4, 2, 3, 33, [33, 12], False, True),
    "int8_group16_m2": (2, 32, 2, 2, 70, [70, 5], True, False),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_small_m_read_plain_matches_jax_decode_kernel(case, monkeypatch):
    b, hq, hkv, m, S, lens, int8, strided = K5_CASES[case]
    d = 128
    rng = np.random.RandomState(sum(map(ord, case)))
    q = rng.randn(b, hq, m, d).astype(np.float32)
    L, B, U = (3, b + 1, S + 7) if strided else (1, b, S)
    shape = (L, B, hkv, U, d)
    if int8:
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        ks = (rng.rand(*shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(*shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
    else:
        k, v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
        ks = vs = None
    li = L - 1
    lens = np.asarray(lens, np.int32)

    def views(conv):
        """Layer li's first b rows and S tokens: strided views on the port's
        side (the buffers are larger), contiguous slices on the JAX side."""
        kv = [conv(x)[li, :b, :, :S] for x in (k, v)]
        sc = [None if x is None else conv(x)[li, :b, :, :S] for x in (ks, vs)]
        return kv, sc

    (tk, tv), (tks, tvs) = views(T)
    if strided:
        assert not tk.is_contiguous() and (tks is None or not tks.is_contiguous())
    to, tl = tflash.flash_attention_bhsd(T(q), tk, tv, kv_seq_lens=T(lens), k_scale=tks,
                                         v_scale=tvs)

    reached = []
    orig = jflash._flash_decode_call
    monkeypatch.setattr(jflash, "_flash_decode_call",
                        lambda *a, **kw: reached.append(kw["rows"]) or orig(*a, **kw))
    (jk, jv), (jks, jvs) = views(lambda x: np.ascontiguousarray(x))
    jo, jl = jflash.flash_attention_bhsd.__wrapped__(
        J(q), J(jk), J(jv), kv_seq_lens=J(lens), k_scale=None if jks is None else J(jks),
        v_scale=None if jvs is None else J(jvs), interpret=True)
    assert reached and reached[0] > 1, "the JAX side must run its decode kernel"
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-5)
    empty = lens == 0
    assert np.isneginf(_np(tl)[empty]).all() and (_np(to)[empty] == 0).all()
    assert np.isfinite(_np(tl)[~empty]).all()


def test_small_m_read_splits_fill_the_card():
    """One split when b * hkv rows give every SM the dtype's
    DECODE_WARPS_PER_SM items (the gqa and no-sharing reads: 2,048 rows);
    otherwise enough splits for that many items, no more than one a
    DECODE_CHUNK keys (the chip's split shapes: 8 rows over 32,768 keys, int8
    and bf16; 256 rows over as many keys)."""
    per_sm = tflash.DECODE_WARPS_PER_SM
    i8, bf16 = per_sm[torch.int8], per_sm[torch.bfloat16]
    assert (i8, bf16) == (4, 2)
    assert tflash.decode_splits(2048, 2128, 132, i8) == (1, 2128)
    assert tflash.decode_splits(2048, 192, 132, i8) == (1, 192)
    assert tflash.decode_splits(8, 32768, 132, i8) == (64, tflash.DECODE_CHUNK)
    assert tflash.decode_splits(8, 32768, 132, bf16) == (32, 2 * tflash.DECODE_CHUNK)
    assert tflash.decode_splits(256, 32768, 132, i8) == (3, 10944)
    assert tflash.decode_splits(256, 32768, 132, bf16) == (2, 16384)
    assert tflash.decode_splits(528, 32768, 132, i8) == (1, 32768)
    assert tflash.decode_splits(264, 32768, 132, bf16) == (1, 32768)
    assert tflash.decode_splits(8, 300, 132, i8) == (1, 300)
    assert tflash.decode_splits(8, 0, 132, bf16) == (1, 1)


# --- a 2-layer GQA engine -------------------------------------------------------

# hq 4, hkv 1, head_dim 128: one kv head of 128 int8 bytes a token, so the
# unique cache is BHSD; rope theta as Llama-3's.
GQA = dict(vocab_size=256, hidden_size=512, intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=1, rope_theta=500000.0,
           dtype="float32")
MODES = {"fp32": (None, None), "w8a8_kv8": ("w8a8", "int8")}
# The parameter key. Under w8a8 + int8 KV each per-row activation and KV
# quantization rounds at half-code boundaries, and a last-bit difference in
# the float sums upstream (XLA's and PyTorch's reductions, rsqrt, exp) can
# land a code one apart, which moves a logit by up to ~7e-2. The quantized
# runs hold each of the port's quantizations to JAX's by the tie rule and go
# on with JAX's codes (``tests/test_torch_ties.py``), so the key pins
# nothing.
PARAM_KEY = 0


@pytest.fixture(scope="module")
def gqa_params():
    p = jllama.init_params(JConfig(**GQA), jax.random.PRNGKey(PARAM_KEY))
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


def _engines(params, mode, monkeypatch, batch=4, unique_len=16, shared=(1,), shared_len=(16,),
             **setup):
    quant, kv = MODES[mode]
    if quant:
        monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    jp, tp = params
    je = JEngine(JConfig(**GQA), jp, quantization=quant)
    te = TEngine(TConfig(**GQA), tp, quantization=quant, device="cpu")
    for e in (je, te):
        e.setup_caches(batch, unique_len, list(shared), list(shared_len), kv_quant=kv, **setup)
    return je, te


def _prompts(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, 256, (1, 12)).astype(np.int32),
            rng.randint(1, 256, (4, 5)).astype(np.int32))


def _same_logits(tl, jl, what):
    assert len(tl) == len(jl)
    for step, (t, j) in enumerate(zip(tl, jl)):
        d = np.abs(_np(t) - _np(j)).max()
        assert d <= 1e-3, (what, step, d)


@contextlib.contextmanager
def _resolved(mode):
    """``(jax, port)`` context managers for a test's JAX and port runs: under
    a quantized mode JAX records every quantization and the port's are held
    to them by the tie rule (``tests/test_torch_ties.py``), checked on exit;
    fp32 quantizes nothing."""
    from tests.test_torch_ties import Resolver, assert_resolved, jax_recorded, port_resolved

    if MODES[mode][0] is None:
        yield contextlib.nullcontext, contextlib.nullcontext
        return
    records = []
    res = {}

    @contextlib.contextmanager
    def port():
        with port_resolved(Resolver(records)) as r:
            res["r"] = r
            yield

    yield (lambda: jax_recorded(records)), port
    assert_resolved(res["r"].report(), mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gqa_engine_matches_jax(gqa_params, mode, monkeypatch):
    """Two requests: a 12-token prompt with 4 greedy samples (WIPE), then 4
    suffixes over the kept prompt (PRESERVE), each also on a forced stream.
    The unique cache is BHSD and every decode step's unique read is the
    small-M read (M = 4). Greedy tokens identical; the forced stream's
    logits within 1e-3. Each engine runs its four calls in turn, JAX's
    first, so that the port's quantizations are held to JAX's."""
    je, te = _engines(gqa_params, mode, monkeypatch)
    assert not te.cache.unique_bshd and not je.cache.unique_bshd
    prompt, suffixes = _prompts(7)
    forced = np.random.RandomState(8).randint(1, 256, (4, 6)).astype(np.int32)
    calls = []
    for ids, nrs, op in (([prompt], 4, "WIPE"), ([suffixes], 1, "PRESERVE")):
        kw = dict(input_ids=ids, num_return_sequences=nrs, max_new_tokens=6, temperature=0.0)
        calls += [(op, kw), (op, dict(kw, token_overrides=forced, return_logits=True))]
    with _resolved(mode) as (jax_side, port_side):
        with jax_side():
            jout = [je.generate(shared_cache_op=getattr(JOp, op), **kw) for op, kw in calls]
        with port_side():
            tout = [te.generate(shared_cache_op=getattr(TOp, op), **kw) for op, kw in calls]
    for i in (0, 2):
        np.testing.assert_array_equal(_np(tout[i]), _np(jout[i]), err_msg=calls[i][0])
        _same_logits(tout[i + 1][1], jout[i + 1][1], (mode, calls[i][0]))


# --- the no-sharing baseline ------------------------------------------------------


def _unique_buffers(cache, copy):
    """A copy of a cache's unique buffers, under their names."""
    return types.SimpleNamespace(**{
        n: None if getattr(cache, n) is None else copy(getattr(cache, n))
        for n in ("unique_k", "unique_v", "unique_k_scale", "unique_v_scale")})


def _compare_unique_caches(tc, jc):
    for name in ("unique_k", "unique_v", "unique_k_scale", "unique_v_scale"):
        t, j = getattr(tc, name), getattr(jc, name)
        assert (t is None) == (j is None), name
        if t is None:
            continue
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, name
        if t.dtype == torch.int8:
            diff = np.abs(_np(t).astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (name, diff.max())
        else:
            np.testing.assert_allclose(_np(t), j, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("pattern", ["prompt_x_n", "prompt_and_suffixes"])
def test_no_sharing_matches_jax(gqa_params, mode, pattern, monkeypatch):
    """``disable_hydragen`` under both call patterns of the JAX engine:
    ``[prompt]`` with 4 samples (the prompt is the unique rows' prefill,
    repeated per sample) and ``[prompt, suffixes]`` (the prompt is a level,
    copied into every unique row; the suffixes follow it). Greedy tokens
    and forced-stream logits as JAX's, the unique caches equal tensor by
    tensor, and the tokens equal the Hydragen run of the same inputs."""
    prompt, suffixes = _prompts(9)
    ids, nrs = ([prompt], 4) if pattern == "prompt_x_n" else ([prompt, suffixes], 1)
    je, te = _engines(gqa_params, mode, monkeypatch, unique_len=12 + 6 + 5 + 8)
    kw = dict(input_ids=ids, num_return_sequences=nrs, max_new_tokens=6, temperature=0.0,
              shared_cache_op="wipe")
    forced = np.random.RandomState(10).randint(1, 256, (4, 6)).astype(np.int32)
    fkw = dict(kw, token_overrides=forced, return_logits=True)
    with _resolved(mode) as (jax_side, port_side):
        with jax_side():
            jt = je.generate(disable_hydragen=True, **kw)
            jc = _unique_buffers(je.cache, np.asarray)  # the next call donates them
            _, jl = je.generate(disable_hydragen=True, **fkw)
        with port_side():
            tt = te.generate(disable_hydragen=True, **kw)
            tc = _unique_buffers(te.cache, torch.clone)  # the next call writes them
            assert not te._disable_hydragen
            hydragen = te.generate(**kw)
            _, tl = te.generate(disable_hydragen=True, **fkw)
    np.testing.assert_array_equal(_np(tt), _np(jt))
    _compare_unique_caches(tc, jc)
    np.testing.assert_array_equal(_np(tt), _np(hydragen))
    _same_logits(tl, jl, (mode, pattern))


# (kv_quant, shared_kv_quant, unique_bshd): the level int8 into an int8 unique
# cache in both layouts, a float level quantized on the copy, an int8 level
# dequantized on the copy.
COPY_CASES = {
    "int8_bhsd": ("int8", "follow", False),
    "int8_bshd_flat_scales": ("int8", "follow", True),
    "float_level_to_int8": ("int8", "none", False),
    "int8_level_to_float": (None, "int8", False),
}


@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_copy_shared_to_unique_matches_jax(gqa_params, case):
    """The level of 2 prefixes (lengths 12 and 9) copied into 6 unique rows:
    every unique buffer as JAX's, tensor by tensor."""
    kv, shared_kv, bshd = COPY_CASES[case]
    jp, tp = gqa_params
    je = JEngine(JConfig(**GQA), jp)
    te = TEngine(TConfig(**GQA), tp, device="cpu")
    rng = np.random.RandomState(11)
    prompts = rng.randint(1, 256, (2, 12)).astype(np.int32)
    lens = np.asarray([12, 9], np.int32)
    for e in (je, te):
        e.setup_caches(6, 32, [2], [16], kv_quant=kv, shared_kv_quant=shared_kv,
                       unique_bshd=bshd)
        e.append_shared(prompts, seq_lens=lens)
    jc = jcache.copy_shared_to_unique(je.cache, 6, 2)
    tc = tcache.copy_shared_to_unique(te.cache, 6, 2)
    assert tc.unique_bshd == bshd and tc.flat_scales == (bshd and kv is not None)
    _compare_unique_caches(tc, jc)


def test_no_sharing_refuses_int4_kv(gqa_params):
    jp, tp = gqa_params
    je = JEngine(JConfig(**GQA), jp)
    te = TEngine(TConfig(**GQA), tp, device="cpu")
    prompt, _ = _prompts(12)
    for e in (je, te):
        e.setup_caches(4, 32, [1], [16], kv_quant="int4")
        with pytest.raises(ValueError, match="int4"):
            e.generate(input_ids=[prompt], num_return_sequences=4, max_new_tokens=2,
                       temperature=0.0, disable_hydragen=True)


def test_no_sharing_needs_two_levels(gqa_params):
    _, tp = gqa_params
    te = TEngine(TConfig(**GQA), tp, device="cpu")
    te.setup_caches(4, 32, [1], [16])
    prompt, _ = _prompts(13)
    with pytest.raises(AssertionError, match="exactly 2 levels"):
        te.generate(input_ids=[prompt], num_return_sequences=1, max_new_tokens=2,
                    disable_hydragen=True)


# --- Llama-3-8B's widths: the parameter tree and the cache bytes -------------------


def test_llama3_8b_parameter_tree_matches_jax():
    """The w8a8 tree of ``llama-3-8b`` (wk/wv N = 1,024, MLP 14,336, vocab
    128,256): every leaf's shape and dtype as the JAX package's, read from
    ``jax.eval_shape`` and the meta device (nothing is allocated), so the
    bridge carries it leaf by leaf."""
    jtree = jax.eval_shape(lambda k: jllama.init_params(JPRESETS["llama-3-8b"], k,
                                                        quantized="w8a8"),
                           jax.random.PRNGKey(0))
    ttree = tllama.init_params(TPRESETS["llama-3-8b"], quantized="w8a8", device="meta")

    def walk(j, t, path):
        if isinstance(j, dict):
            assert sorted(j) == sorted(t), path
            for key in j:
                walk(j[key], t[key], f"{path}/{key}")
            return
        if isinstance(j, tuple):
            assert t._fields == j._fields, path
            for jj, tt in zip(j, t):
                walk(jj, tt, path)
            return
        assert tuple(t.shape) == j.shape, (path, tuple(t.shape), j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path

    walk(jtree, ttree, "")
    assert ttree["layers"]["wk"].q.shape == (32, 1024, 4096)
    assert ttree["layers"]["down"].q.shape == (32, 4096, 14336)
    assert ttree["embed_tokens"].shape == (128256, 4096)


def test_kv_cache_bytes_gqa_and_no_sharing_match_jax():
    """``kv_cache_bytes`` against the JAX package's pricing (``bench.py``'s
    ``cache_bytes``, which leaves out the levels' int32 lengths and does not
    round the unique length to 16) at Llama-3-8B's widths: the GQA path's
    cache and the no-sharing baseline's (64 new + 2,048 copied + 8 tokens a
    row), and the buffers a small GQA BHSD engine allocates."""
    import bench

    from hydragen_torch.utils.capacity import kv_cache_bytes

    tcfg, jcfg = TPRESETS["llama-3-8b"], JPRESETS["llama-3-8b"]
    for unique_len in (128 + 64, 64 + 2048 + 8):
        rounded = -(-unique_len // 16) * 16
        got = kv_cache_bytes(tcfg, 256, unique_len, [1], [2048], "int8")
        assert got == bench.cache_bytes(jcfg, 256, rounded, 2048, "int8") + 4, unique_len
    assert kv_cache_bytes(tcfg, 256, 2120, [1], [2048], "int8") == 36_956_012_548

    cfg = TConfig(**GQA)
    e = TEngine(cfg, tllama.init_params(cfg, torch.Generator().manual_seed(0)), device="cpu")
    e.setup_caches(4, 20, [1, 2], [16, 8], kv_quant="int8")
    c = e.cache
    assert not c.unique_bshd
    bufs = [c.unique_k, c.unique_v, c.unique_k_scale, c.unique_v_scale]
    for lv in c.shared:
        bufs += [lv.k, lv.v, lv.k_scale, lv.v_scale, lv.seq_lens]
    assert kv_cache_bytes(cfg, 4, 20, [1, 2], [16, 8], "int8") == sum(
        x.numel() * x.element_size() for x in bufs)
