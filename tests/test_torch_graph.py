"""The port's decode step, the body of its CUDA graphs, against the JAX engine.

The JAX engine compiles its decode loop into one ``lax.scan`` whose step
passes a traced unique slot; the port runs one step body over static buffers
that reads its slot from device memory, eagerly on the CPU and as a replayed
CUDA graph on the card. On the CPU (fp32, 2 layers, narrow widths):
- the writes that take the slot as a device scalar give JAX's jitted writes
  bit for bit, tensor by tensor, in every layout a decode step writes: int8
  BSHD with flat scales (the in-place write of the main path), int8 BHSD
  (the GQA layout), int4 BSHD across the low-to-high plane edge (K7's plain
  version) and the no-sharing baseline's batched write;
- the eager loop over the step body gives the JAX engine's greedy tokens,
  per-step logits and caches, on each write path, with overrides, EOS
  chunks and ``return_logits``. The weights are int8 and weight-only
  (``quantization="int8"``), so no activation is quantized per row and no
  half-code tie between XLA's and PyTorch's float sums moves a code; the
  KV quantizers equal the jitted JAX functions bit for bit;
- a graph's key changes with each static field, with the cache and with the
  parameters.

The ``gpu`` cases run on the card (skipped elsewhere): graph against eager,
bit for bit, on each write path and when sampling; K7 with a device slot;
launch counts; ``setup_caches`` dropping the graphs; a capture that fails.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax
import jax.numpy as jnp
import torch

from hydragen_tpu.core import cache as jcache
from hydragen_tpu.core.engine import HydragenLlama as JEngine
from hydragen_tpu.core.engine import SharedCacheOp as JOp
from hydragen_tpu.models.config import ModelConfig as JConfig
from hydragen_tpu.models.llama import init_params as jinit

from hydragen_torch import HydragenLlama as TEngine
from hydragen_torch import ModelConfig as TConfig
from hydragen_torch import SharedCacheOp as TOp
from hydragen_torch.core import cache as tcache
from hydragen_torch.core.engine import DecodeKey
from hydragen_torch.models.convert import params_from_numpy
from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops import decode as tdecode

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def J(a):
    return jnp.asarray(np.asarray(a))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_cache(tc, jc, exact=True):
    """Every unique buffer bit-equal: payloads and f32 scales. ``exact=False``
    (two engines' caches, whose KV differ in the last bits of XLA's and
    PyTorch's float sums): the int4 engine test's bounds, a code at most one
    apart on at most 1e-3 of the elements (per nibble plane at int4) and
    the scales within rtol 1e-4; an unquantized cache within 1e-5."""
    from hydragen_torch.ops.quant import unpack4

    for name in ("unique_k", "unique_v", "unique_k_scale", "unique_v_scale"):
        t, j = getattr(tc, name), getattr(jc, name)
        if t is None:
            continue
        t, j = _np(t), np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, (name, t.shape, j.shape)
        if exact:
            np.testing.assert_array_equal(t, j, err_msg=name)
        elif t.dtype == np.int8:
            planes = zip(unpack4(T(t)), unpack4(T(j))) if tc.unique_bits == 4 else [(t, j)]
            for pt, pj in planes:
                diff = np.abs(_np(pt).astype(np.int32) - _np(pj).astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (name, diff.max())
        else:
            tol = dict(rtol=1e-4, atol=1e-6) if tc.quantized else dict(rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(t, j, err_msg=name, **tol)


# --- the device-slot writes -----------------------------------------------------

_jit_prefill = jax.jit(jcache.update_unique_prefill)
_jit_write_layer = jax.jit(jcache.write_decode_token_layer, static_argnames=("layer",))
_jit_decode = jax.jit(jcache.update_unique_decode, static_argnames=("uniform",))

# name: (unique_bits, unique_bshd, flat_scales, the batched no-sharing write?)
WRITES = {
    "int8_bshd_flat": (8, True, True, False),
    "int8_bhsd": (8, False, False, False),
    "int4_bshd_flat": (4, True, True, False),
    "no_sharing_bhsd": (8, False, False, True),
}


@pytest.mark.parametrize("layout", sorted(WRITES))
def test_device_slot_writes_match_jax(layout):
    """A 7-token unique prefill, then one decode token a step at slots 6-9
    (the int4 cache's 16 tokens are 8 byte rows: slots 6 and 7 write the low
    plane, 8 and 9 the high plane over the live tokens 0 and 1), each slot
    a device int32 scalar as the decode step passes it: every buffer
    bit-equal to JAX's jitted write at the same slot after every step."""
    bits, bshd, flat, batched = WRITES[layout]
    Lc, Bc, U, hkv, hd = 2, 3, 16, 2, 64
    kw = dict(quantized=True, unique_bshd=bshd, flat_scales=flat, unique_bits=bits)
    jc = jcache.allocate_cache(Lc, Bc, U, [], [], hkv, hd, dtype=jnp.float32, **kw)
    tc = tcache.allocate_cache(Lc, Bc, U, [], [], hkv, hd, dtype=torch.float32, **kw)
    assert tc.unique_bshd == bshd and tc.flat_scales == flat and tc.unique_bits == bits
    rng = np.random.RandomState(31)
    k, v = (rng.randn(Lc, Bc, hkv, 7, hd).astype(np.float32) for _ in range(2))
    jc = _jit_prefill(jc, J(k), J(v))
    tcache.update_unique_prefill(tc, T(k), T(v))
    _same_cache(tc, jc)
    for slot in (6, 7, 8, 9):
        dslot = torch.tensor(slot, dtype=torch.int32)  # a device scalar, as upos[0]
        if batched:
            k, v = (rng.randn(Lc, Bc, hkv, 1, hd).astype(np.float32) for _ in range(2))
            pos = np.full(Bc, slot, np.int32)
            jc = _jit_decode(jc, J(pos), J(k), J(v), uniform=True)
            tcache.update_unique_decode(tc, T(pos), T(k), T(v), uniform=dslot)
        else:
            for li in range(Lc):
                k, v = (rng.randn(Bc, hkv, 1, hd).astype(np.float32) for _ in range(2))
                jc = _jit_write_layer(jc, layer=li, k=J(k), v=J(v), slot=jnp.int32(slot))
                tcache.write_decode_token_layer(tc, li, T(k), T(v), dslot)
        _same_cache(tc, jc)


def test_k7_plain_takes_a_device_slot():
    """K7's plain version at a device slot equals itself at the host int,
    byte for byte, at both planes (the kernel's yardstick on the card)."""
    rng = np.random.RandomState(32)
    L, B, S, hkv, d = 2, 3, 4, 2, 64
    bufs = [torch.zeros(L, B, S, hkv, d, dtype=torch.int8) for _ in range(2)]
    scales = [torch.zeros(L, B, 2 * S * hkv) for _ in range(2)]
    host = [x.clone() for x in bufs + scales]
    for slot in (1, 3, 4, 7, 5):
        k, v = (T(rng.randn(B, hkv, 1, d).astype(np.float32)) for _ in range(2))
        tdecode.write_token_int4_cached_plain(1, k, v, *bufs, *scales,
                                              torch.tensor(slot, dtype=torch.int32))
        tdecode.write_token_int4_cached_plain(1, k, v, *host, slot)
        for a, b in zip(bufs + scales, host):
            assert torch.equal(a, b), slot


# --- the eager step loop against the JAX engine ---------------------------------

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
           num_attention_heads=2, num_key_value_heads=2, dtype="float32")


@pytest.fixture(scope="module")
def params():
    p = jinit(JConfig(**CFG), jax.random.PRNGKey(3))
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


def _engines(params, kv, bshd=True, eos_chunk=32, unique_len=16):
    jp, tp = params
    je = JEngine(JConfig(**CFG), jp, quantization="int8", eos_chunk=eos_chunk)
    te = TEngine(TConfig(**CFG), tp, quantization="int8", eos_chunk=eos_chunk, device="cpu")
    for e in (je, te):
        e.setup_caches(4, unique_len, [1], [16], kv_quant=kv, unique_bshd=bshd)
    return je, te


def _prompt(seed):
    return np.random.RandomState(seed).randint(1, 256, (1, 9)).astype(np.int32)


# case: (kv_quant, unique_bshd, the engine's write path, generate's arguments)
LOOPS = {
    # The main path's in-place int8 write, 4 samples of a shared prompt.
    "inplace_int8": ("int8", True, "inplace", dict(num_return_sequences=4,
                                                   max_new_tokens=7)),
    # Forced tokens from the device buffer, on the GQA layout's write.
    "overrides_bhsd": ("int8", False, "inplace", dict(num_return_sequences=4,
                                                      max_new_tokens=6, overrides=True)),
    # The in-place int4 write across the plane edge: 16 tokens are 8 byte
    # rows, and 11 new tokens write slots 0-9.
    "inplace_int4": ("int4", True, "inplace", dict(num_return_sequences=4,
                                                   max_new_tokens=11)),
    # EOS chunks of 2 steps with a host check between them.
    "eos_chunks": ("int8", True, "inplace", dict(num_return_sequences=4, max_new_tokens=8,
                                                 eos=True)),
    # The no-sharing baseline's batched write at one slot.
    "no_sharing": ("int8", False, "uniform", dict(num_return_sequences=4, max_new_tokens=6,
                                                  disable_hydragen=True)),
    # Ragged suffixes: the per-row scatter, into an unquantized cache (an int8
    # one at these inputs moves a KV code at a half-code tie of the two
    # engines' float sums, and a logit by 1.1e-3).
    "ragged_rows": (None, True, "rows", dict(max_new_tokens=6, ragged=True)),
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_eager_step_loop_matches_jax(params, case):
    """Greedy tokens equal, every step's logits within 1e-3 (they agree to
    about 1e-5: fp32, weight-only int8) and, where the tokens are the same,
    the unique cache bit for bit after the call."""
    kv, bshd, write, kw = LOOPS[case]
    kw = dict(kw)
    eos = kw.pop("eos", False)
    nohydra = kw.get("disable_hydragen", False)
    je, te = _engines(params, kv, bshd, eos_chunk=2 if eos else 32,
                      unique_len=32 if nohydra else 16)
    prompt = _prompt(40)
    if kw.pop("ragged", False):
        suffixes = np.random.RandomState(41).randint(1, 256, (4, 5)).astype(np.int32)
        lens = np.asarray([5, 3, 4, 2], np.int32)
        for e, op in ((je, JOp), (te, TOp)):
            e.generate(input_ids=[prompt], num_return_sequences=4, max_new_tokens=1,
                       temperature=0.0, shared_cache_op=op.WIPE)
        kw.update(input_ids=[suffixes], seq_lens=[lens])
        jop, top = JOp.PRESERVE, TOp.PRESERVE
    else:
        kw.update(input_ids=[prompt])
        jop, top = JOp.WIPE, TOp.WIPE
    if kw.pop("overrides", False):
        kw["token_overrides"] = np.random.RandomState(42).randint(
            1, 256, (4, kw["max_new_tokens"])).astype(np.int32)
    if eos:
        je.generate(temperature=0.0, shared_cache_op=jop, **kw)
        full = _np(te.generate(temperature=0.0, shared_cache_op=top, **kw))
        kw["eos_token_id"] = int(full[1, 4])
    jt, jl = je.generate(temperature=0.0, return_logits=True, shared_cache_op=jop, **kw)
    tt, tl = te.generate(temperature=0.0, return_logits=True, shared_cache_op=top, **kw)
    assert [st.key.write for st in te._decode.values()] == [write] * len(te._decode)
    np.testing.assert_array_equal(_np(tt), _np(jt))
    assert len(tl) == len(jl) == _np(tt).shape[1]
    for step, (t, j) in enumerate(zip(tl, jl)):
        d = np.abs(_np(t) - np.asarray(j)).max()
        assert d <= 1e-3, (case, step, d)
    _same_cache(te.cache, je.cache, exact=False)


# --- the graph key --------------------------------------------------------------


def test_decode_key_changes_with_each_static_field(params):
    """Pure Python, no capture: each of the JAX engine's static arguments, the
    write path each give a new key; a new cache from ``setup_caches`` and new
    parameters drop every state, so no graph outlives what it reads."""
    _, te = _engines(params, "int8")
    te.generate(input_ids=[_prompt(43)], num_return_sequences=4, max_new_tokens=3,
                temperature=0.0, shared_cache_op=TOp.PRESERVE)
    (base,) = te._decode
    assert base.write == "inplace" and base.batch == 4
    variants = [
        base._replace(spec=base.spec._replace(num_used_levels=0)),
        base._replace(spec=base.spec._replace(level_filled=(32,))),
        base._replace(spec=base.spec._replace(disable_hydragen=True)),
        base._replace(batch=8),
        base._replace(temperature=0.5),
        base._replace(top_p=0.9),
        base._replace(use_overrides=True),
        base._replace(return_logits=True),
        base._replace(write="uniform"),
    ]
    assert len({base, *variants}) == len(variants) + 1
    assert all(isinstance(k, DecodeKey) for k in variants)
    old_cache = te.cache
    te.setup_caches(4, 16, [1], [16], kv_quant="int8", unique_bshd=True)
    assert not te._decode and te.cache is not old_cache
    te.generate(input_ids=[_prompt(43)], num_return_sequences=4, max_new_tokens=3,
                temperature=0.0, shared_cache_op=TOp.WIPE)
    (renewed,) = te._decode.values()
    te.params = dict(te.params)
    te.generate(input_ids=[_prompt(43)], num_return_sequences=4, max_new_tokens=3,
                temperature=0.0, shared_cache_op=TOp.WIPE)
    (newest,) = te._decode.values()
    assert newest is not renewed and te._decode_params is te.params


def test_decode_past_the_unique_cache_raises(params):
    """Every step's slot is checked on the host once a call: decode that
    would write past the unique cache raises before a step runs."""
    _, te = _engines(params, "int8")
    with pytest.raises(ValueError, match="past the unique cache"):
        te.generate(input_ids=[_prompt(44)], num_return_sequences=4, max_new_tokens=18,
                    temperature=0.0, shared_cache_op=TOp.WIPE)


# --- on the card ----------------------------------------------------------------

GPU_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2, dtype="bfloat16")
# path: (quantization, kv_quant, unique_bshd, unique length, the write path,
# generate's extra arguments). The BSHD caches are the layout K3 reads (the
# main and int4 paths'); the int4 window of 16 tokens is 8 byte rows, so 12
# new tokens cross into the high plane; the BHSD no-sharing cache is the GQA
# layout, read by K5, after a 64-token level copy.
GPU_PATHS = {
    "inplace_int8": ("w8a8", "int8", True, 48, "inplace", {}),
    "inplace_int4": ("w4a8", "int4", True, 16, "inplace", {}),
    "uniform_no_sharing": ("w8a8", "int8", False, 64 + 48, "uniform",
                           dict(disable_hydragen=True)),
    "rows_ragged": ("w8a8", "int8", True, 48, "rows", dict(ragged=True)),
    "sampled": ("w8a8", "int8", True, 48, "inplace", dict(temperature=0.8, top_p=0.9)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graphs and the kernels run only there")
    return torch.device("cuda")


def _card_engine(quant, kv, graphs, bshd=True, unique_len=48):
    from hydragen_torch.models.llama import init_params

    cfg = TConfig(**GPU_CFG)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(5), quantized=quant,
                         device="cuda")
    eng = TEngine(cfg, params, quantization=quant).graph(graphs)
    eng.setup_caches(8, unique_len, [1], [64], kv_quant=kv, unique_bshd=bshd)
    return eng


def _card_request(eng, extra, max_new_tokens=12, seed=0):
    """One request on the card: 8 samples of a 40-token prompt (WIPE), or 8
    ragged suffixes over it (PRESERVE). Returns tokens, logits and the
    launches the request made."""
    g = torch.Generator(device="cuda").manual_seed(6)
    prompt = torch.randint(1, 512, (1, 40), generator=g, device="cuda")
    extra = dict(extra)
    kw = dict(temperature=extra.pop("temperature", 0.0), top_p=extra.pop("top_p", None),
              return_logits=True, max_new_tokens=max_new_tokens, seed=seed, **extra)
    if kw.pop("ragged", False):
        eng.generate(input_ids=[prompt], num_return_sequences=8, max_new_tokens=1,
                     temperature=0.0, shared_cache_op=TOp.WIPE)
        suffixes = torch.randint(1, 512, (8, 6), generator=g, device="cuda")
        kw.update(input_ids=[suffixes], seq_lens=torch.tensor([6, 3, 5, 4, 6, 2, 1, 5]),
                  shared_cache_op=TOp.PRESERVE)
    else:
        kw.update(input_ids=[prompt], num_return_sequences=8, shared_cache_op=TOp.WIPE)
    cuda_lib.reset_launches()
    toks, logits = eng.generate(**kw)
    torch.cuda.synchronize()
    return toks, logits, {k: n for k, n in cuda_lib.LAUNCHES.items() if n}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(GPU_PATHS))
def test_graph_decode_equals_eager(dev, path):
    """The same request through the eager loop and through replayed graphs:
    tokens equal, every step's logits equal bit for bit, the same launches.
    The graph engine captured a graph for its key and replayed it."""
    quant, kv, bshd, unique_len, write, extra = GPU_PATHS[path]
    runs = {}
    for graphs in (False, True):
        eng = _card_engine(quant, kv, graphs, bshd, unique_len)
        runs[graphs] = _card_request(eng, extra, seed=7)
        states = list(eng._decode.values())
        assert [st.key.write for st in states][-1] == write
        assert (states[-1].graph is not None) == graphs
        del eng
    (te, le, ne), (tg, lg, ng) = runs[False], runs[True]
    assert torch.equal(te, tg)
    assert len(le) == len(lg)
    for step, (a, b) in enumerate(zip(le, lg)):
        assert torch.equal(a, b), (path, step, float((a - b).abs().max()))
    assert ne == ng


@pytest.mark.gpu
def test_k7_device_slot_is_byte_exact_and_a_graph_crosses_the_plane(dev):
    """K7 reading its slot from device memory equals its plain version byte
    for byte at a low- and a high-plane slot; then one captured graph of the
    write and a slot increment, replayed over slots S-2 .. S+1, writes what
    the plain version writes at each host slot."""
    L, B, S, hkv, d = 2, 5, 6, 4, 128
    g = torch.Generator(device="cuda").manual_seed(8)

    def fresh():
        bufs = [torch.randint(-128, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev,
                              generator=g) for _ in range(2)]
        scales = [torch.rand(L, B, 2 * S * hkv, device=dev, generator=g) for _ in range(2)]
        return bufs + scales

    def token():
        return [torch.randn(4, hkv, 1, d, device=dev, generator=g).to(torch.bfloat16)
                for _ in range(2)]

    state = fresh()
    plain = [x.clone() for x in state]
    for slot in (2, S + 3):
        k, v = token()
        before = cuda_lib.LAUNCHES["write_token_int4_cached"]
        tdecode.write_token_int4_cached(1, k, v, *state,
                                        torch.tensor([slot], dtype=torch.int32, device=dev))
        assert cuda_lib.LAUNCHES["write_token_int4_cached"] == before + 1
        tdecode.write_token_int4_cached_plain(1, k, v, *plain, slot)
        torch.cuda.synchronize()
        for a, b in zip(state, plain):
            assert torch.equal(a, b), slot
    k, v = token()
    slot = torch.tensor(S - 2, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdecode.write_token_int4_cached(0, k, v, *state, slot)
        slot.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    tdecode.write_token_int4_cached_plain(0, k, v, *plain, S - 2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        tdecode.write_token_int4_cached(0, k, v, *state, slot)
        slot.add_(1)
    for s in (S - 1, S, S + 1):
        graph.replay()
        tdecode.write_token_int4_cached_plain(0, k, v, *plain, s)
        torch.cuda.synchronize()
        for a, b in zip(state, plain):
            assert torch.equal(a, b), s


@pytest.mark.gpu
def test_setup_caches_drops_the_graphs(dev):
    """A graph engine's second request after ``setup_caches`` (a new cache)
    captures anew and gives the eager engine's tokens and logits."""
    eager = _card_engine("w8a8", "int8", False)
    graphs = _card_engine("w8a8", "int8", True)
    _card_request(graphs, {})
    assert any(st.graph is not None for st in graphs._decode.values())
    graphs.setup_caches(8, 48, [1], [64], kv_quant="int8", unique_bshd=True)
    assert not graphs._decode
    te, le, ne = _card_request(eager, {}, seed=9)
    tg, lg, ng = _card_request(graphs, {}, seed=9)
    assert torch.equal(te, tg) and ne == ng
    assert all(torch.equal(a, b) for a, b in zip(le, lg))


@pytest.mark.gpu
def test_a_step_that_cannot_be_captured_raises(dev, monkeypatch):
    """A host sync inside the step fails its capture: ``generate`` raises and
    does not fall back to the eager loop."""
    from hydragen_torch.core import engine as tengine

    sample = tengine.sample_from_logits

    def syncing(logits, *a, **kw):
        out = sample(logits, *a, **kw)
        int(out[0, 0])  # a host read of a device value
        return out

    eng = _card_engine("w8a8", "int8", True)
    monkeypatch.setattr(tengine, "sample_from_logits", syncing)
    with pytest.raises(RuntimeError, match="capture failed"):
        _card_request(eng, {})
    assert all(st.graph is None for st in eng._decode.values())
