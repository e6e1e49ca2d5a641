"""The port's continuous batcher against the JAX package's, on the CPU.

``hydragen_torch.core.batching.ContinuousBatcher`` and
``hydragen_tpu.core.batching.ContinuousBatcher`` get one parameter set (made
by the JAX package, carried over with ``params_from_numpy``), one shared
prefix and the same stream of requests, at ``tests/test_batching.py``'s tiny
configuration in fp32 (2 layers, hidden 64, 4 query heads over 2 kv heads).
Each greedy case asserts, request by request, that the port's tokens equal
JAX's and equal the port's own one-request ``generate`` over the kept
prefix (``PRESERVE``), truncated after the first eos or completed stop
sequence as the batcher ends a request. The weights are fp32 or int8
weight-only (``quantization="int8"``): no activation is quantized per row,
so no half-code tie between XLA's and PyTorch's float sums moves a code.
Sampled cases cannot match JAX's PRNG: they assert lengths, budgets and
that a seed gives the same tokens twice.

The ``gpu`` cases run on the card (skipped elsewhere): a stream through the
decode graphs against the same stream through the eager loop, tokens equal
and launches equal, with deep lookaheads and grouped prefixes; and the
shared-level read at a prefix-row offset against its plain version.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax
import jax.numpy as jnp
import torch

from hydragen_tpu.core.batching import ContinuousBatcher as JBatcher
from hydragen_tpu.core.batching import ring_mask as jring_mask
from hydragen_tpu.core.engine import HydragenLlama as JEngine
from hydragen_tpu.models.config import ModelConfig as JConfig
from hydragen_tpu.models.llama import init_params as jinit

from hydragen_torch import ContinuousBatcher as TBatcher
from hydragen_torch import HydragenLlama as TEngine
from hydragen_torch import ModelConfig as TConfig
from hydragen_torch import SharedCacheOp as TOp
from hydragen_torch.core.batching import ring_mask as tring_mask
from hydragen_torch.models.convert import params_from_numpy
from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops import flash as tflash

torch.set_num_threads(1)

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, dtype="float32")


@pytest.fixture(scope="module")
def setup():
    p = jinit(JConfig(**CFG), jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 128, (1, 8)).astype(np.int32)
    prompts = [rng.randint(1, 128, (n,)).astype(np.int32) for n in (3, 5, 2, 4, 6, 3)]
    shared2 = np.random.RandomState(9).randint(1, 128, (2, 8)).astype(np.int32)
    return (p, params_from_numpy(jax.tree.map(np.asarray, p))), shared, shared2, prompts


@pytest.mark.parametrize("U", [5, 16, 32])
def test_ring_mask_matches_jax(U):
    """Random starts (never-written slots included: starts at and above the
    cursor, negative ones) and cursors on both sides of the first lap, bit
    for bit."""
    rng = np.random.RandomState(U)
    for cursor in (U, U + 1, 2 * U - 1, 2 * U, 3 * U + 2, 7 * U + 3):
        start = rng.randint(-2, cursor + 3, (9,)).astype(np.int32)
        want = np.asarray(jring_mask(jnp.asarray(start), jnp.int32(cursor), U))
        got = tring_mask(torch.from_numpy(start), torch.tensor(cursor, dtype=torch.int32), U)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"cursor {cursor}")


# case: (pool rows, engine quantization, setup_caches arguments, batcher
# arguments, budgets, what else the stream does). Budgets apply to the six
# prompts in turn (a short list submits fewer requests).
CASES = {
    # A pool of 2 rows for 6 requests: queueing, admission into freed rows,
    # rows at mixed progress.
    "fifo": (2, None, {}, dict(chunk=3, bucket=4), [7] * 6, {}),
    # LPT reorders the mixed budgets; a chunk of 16 against budgets of 2-9
    # walks the tail-shrink ladder.
    "lpt_tail_shrink": (2, None, {}, dict(chunk=16, bucket=4, admit_policy="lpt"),
                        [3, 9, 2, 8, 4, 6], {}),
    # eos is the 3rd greedy token of request 0.
    "eos": (2, None, {}, dict(chunk=4, bucket=4), [8] * 6, dict(eos=True)),
    # The 7B main path's cache: int8, BSHD, flat scales.
    "int8_kv_bshd_flat": (2, None, dict(kv_quant="int8", unique_bshd=True),
                          dict(chunk=3, bucket=4), [7] * 6, {}),
    # A budget of 1 (retired on its first token) beside longer ones.
    "varied_budgets": (3, None, {}, dict(chunk=2, bucket=4), [1, 4, 9], {}),
    # Quantized weights take the in-place decode write.
    "inplace_int8_weights": (4, "int8", dict(kv_quant="int8"), dict(chunk=4, bucket=8),
                             [3, 7, 10, 5, 2, 6], {}),
    # Two prefixes (sb = 2): each request decodes under its group's prefix.
    "grouped_sb2": (4, None, {}, dict(chunk=3, bucket=4), [6] * 6, dict(groups=2)),
    # Request 0 stops on a 2-gram of its own stream, request 1 on one it
    # never emits, 2 and 3 have none.
    "stop_sequences": (2, None, {}, dict(chunk=3, bucket=4), [10] * 4, dict(stops=True)),
    "lookahead_2": (2, None, {}, dict(chunk=3, bucket=4, lookahead=2), [7] * 6, {}),
    "lookahead_3": (2, None, {}, dict(chunk=3, bucket=4, lookahead=3), [7] * 6, {}),
    # The same stream over a BHSD and a BSHD unique cache (int8): equal
    # tokens, each equal to JAX's on its layout.
    "bhsd_vs_bshd": (4, None, dict(kv_quant="int8", unique_bshd=False),
                     dict(chunk=4, bucket=8), [6] * 6, dict(bshd_twin=True)),
}


def _engine(kind, params, quant, pool, levels, cache_kw):
    jp, tp = params
    if kind == "jax":
        eng = JEngine(JConfig(**CFG), jp, quantization=quant)
    else:
        eng = TEngine(TConfig(**CFG), tp, quantization=quant, device="cpu")
    eng.setup_caches(pool, 32, [levels.shape[0]], [16], **cache_kw)
    eng.append_shared(levels)
    return eng


def _stream(kind, params, quant, pool, levels, cache_kw, cb_kw, requests):
    """Run ``requests`` [(prompt, budget, group, stops)] through one
    engine's batcher; returns the tokens in submission order."""
    eng = _engine(kind, params, quant, pool, levels, cache_kw)
    cb = (JBatcher if kind == "jax" else TBatcher)(eng, temperature=0.0, **cb_kw)
    rids = [cb.submit(p, max_new_tokens=n, group=g, stop_sequences=s)
            for p, n, g, s in requests]
    out = cb.run()
    assert set(out) == set(rids)
    return [out[r] for r in rids], cb


def _one_shot(params, quant, cache_kw, prefix, prompt, budget):
    """The port's one-request greedy ``generate`` over a kept prefix."""
    eng = _engine("torch", params, quant, 1, prefix, cache_kw)
    out = eng.generate(input_ids=[prompt[None]], max_new_tokens=budget, temperature=0.0,
                       shared_cache_op=TOp.PRESERVE)
    return out[0].tolist()


def _ended(stream, eos, stops):
    """``stream`` cut after the first eos or completed stop sequence."""
    for i in range(len(stream)):
        if stream[i] == eos or any(
                len(s) <= i + 1 and stream[i + 1 - len(s):i + 1] == list(s) for s in stops):
            return stream[:i + 1]
    return stream


@pytest.mark.parametrize("case", sorted(CASES))
def test_batcher_matches_jax(setup, case):
    params, shared, shared2, prompts = setup
    pool, quant, cache_kw, cb_kw, budgets, extra = CASES[case]
    levels = shared2 if extra.get("groups") else shared
    groups = [i % 2 if extra.get("groups") else 0 for i in range(len(budgets))]
    prefix = [levels[g][None] for g in groups]
    oracle = [_one_shot(params, quant, cache_kw, prefix[i], prompts[i], n)
              for i, n in enumerate(budgets)]
    stops = [()] * len(budgets)
    cb_kw = dict(cb_kw)
    eos = None
    if extra.get("eos"):
        eos = oracle[0][2]
        cb_kw["eos_token_id"] = eos
    if extra.get("stops"):
        stops = [[oracle[0][2:4]], [[127, 126]], (), ()]
    want = [_ended(o, eos, s) for o, s in zip(oracle, stops)]
    requests = list(zip(prompts, budgets, groups, stops))
    jt, _ = _stream("jax", params, quant, pool, levels, cache_kw, cb_kw, requests)
    tt, cb = _stream("torch", params, quant, pool, levels, cache_kw, cb_kw, requests)
    for i, (t, j, w) in enumerate(zip(tt, jt, want)):
        assert t == j, (case, i, t, j)
        assert t == w, (case, i, t, w)
    if extra.get("eos"):
        assert tt[0] == oracle[0][:3]
    if extra.get("stops"):
        assert tt[0][-2:] == oracle[0][2:4] and len(tt[0]) == 4 and tt[1] == oracle[1]
    assert cb.stats["admitted"] == len(budgets)
    if extra.get("bshd_twin"):
        twin = dict(cache_kw, unique_bshd=True)
        bt, bcb = _stream("torch", params, quant, pool, levels, twin, cb_kw, requests)
        assert not cb.engine.cache.unique_bshd and bcb.engine.cache.unique_bshd
        assert bcb.engine.cache.flat_scales
        jbt, _ = _stream("jax", params, quant, pool, levels, twin, cb_kw, requests)
        assert bt == tt == jbt


def test_batcher_state_after_a_stream(setup):
    """After a stream every row is inactive, the cursor has advanced by the
    steps dispatched, and the pool's rows are free; the dispatch counts add
    up (one admission a bucket and group, steps = the chunks' lengths)."""
    params, shared, _, prompts = setup
    eng = _engine("torch", params, None, 2, shared, {})
    cb = TBatcher(eng, chunk=3, bucket=4)
    for p in prompts:
        cb.submit(p, max_new_tokens=5)
    cb.run()
    assert not bool(cb.state.active.any())
    assert int(cb.state.cursor) == cb.U + cb.stats["decode_steps"]
    assert cb.stats["decode_steps"] == 3 * cb.stats["chunks"]
    assert cb.stats["admitted"] == 6 and cb.stats["admit_dispatches"] >= 3
    assert all(req is None for req in cb._rows.values())


@pytest.mark.parametrize("lookahead", [1, 2])
def test_batcher_sampled(setup, lookahead):
    """Temperature 0.8, top-p 0.9, int8 KV: every request comes back with its
    full budget of in-range tokens, and a seed gives the same tokens twice."""
    params, shared, _, prompts = setup
    budgets = [6, 3, 8, 5]
    runs = []
    for _ in range(2):
        eng = _engine("torch", params, None, 2, shared, dict(kv_quant="int8"))
        cb = TBatcher(eng, chunk=3, bucket=4, temperature=0.8, top_p=0.9, seed=7,
                      lookahead=lookahead)
        rids = [cb.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
        out = cb.run()
        runs.append([out[r] for r in rids])
    for toks, n in zip(runs[0], budgets):
        assert len(toks) == n and all(0 <= t < CFG["vocab_size"] for t in toks)
    assert runs[0] == runs[1]


def test_batcher_refuses_int4_kv(setup):
    params, shared, _, _ = setup
    eng = _engine("torch", params, None, 2, shared, dict(kv_quant="int4"))
    with pytest.raises(AssertionError, match="sub-byte"):
        TBatcher(eng)


def test_cached_read_at_a_row_offset_is_the_rows_read():
    """The shared-level read at ``row_start`` reads prefix row ``row_start
    + i`` for query row ``i`` (the plain version on the CPU; the kernel's
    own check is the ``gpu`` case below)."""
    g = torch.Generator().manual_seed(3)
    L, SB, hkv, S, d = 3, 4, 2, 24, 16
    k, v = (torch.randn(L, SB, hkv, S, d, generator=g) for _ in range(2))
    q = torch.randn(1, 4, 5, d, generator=g)
    lens = torch.tensor([17], dtype=torch.int32)
    out, lse = tflash.flash_attention_cached_bhsd(1, q, k, v, kv_seq_lens=lens, row_start=2)
    ref, rlse = tflash.flash_attention_bhsd(q, k[1, 2:3], v[1, 2:3], kv_seq_lens=lens)
    assert torch.equal(out, ref) and torch.equal(lse, rlse)


# --- on the card ----------------------------------------------------------------

GPU_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2, dtype="bfloat16")
# stream: (prefixes in the level, batcher arguments, stop sequences on some
# requests). The BSHD int8 cache with flat scales is the 7B serving layout.
GPU_STREAMS = {
    "lookahead_2": (1, dict(lookahead=2), False),
    "lookahead_3_stops": (1, dict(lookahead=3), True),
    "grouped_sb2_lpt": (2, dict(admit_policy="lpt", lookahead=2), True),
    "sampled": (1, dict(temperature=0.8, top_p=0.9), False),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graphs and the kernels run only there")
    return torch.device("cuda")


def _card_stream(sb, cb_kw, stops, graphs):
    """24 requests over a 16-row w8a8 + int8-KV pool on the card, through
    the graphs or the eager loop; returns tokens, launches, stats and the
    batcher's graph holder."""
    from hydragen_torch.models.llama import init_params

    cfg = TConfig(**GPU_CFG)
    g = torch.Generator(device="cuda").manual_seed(5)
    params = init_params(cfg, g, quantized="w8a8", device="cuda")
    eng = TEngine(cfg, params, quantization="w8a8").graph(graphs)
    eng.setup_caches(16, 32 + 16 + 8, [sb], [64], kv_quant="int8", unique_bshd=True)
    eng.append_shared(torch.randint(1, 512, (sb, 40), generator=g, device="cuda"))
    rng = np.random.RandomState(6)
    cb = TBatcher(eng, chunk=4, bucket=16, seed=3, **cb_kw)
    cuda_lib.reset_launches()
    rids = []
    for i in range(24):
        prompt = rng.randint(1, 512, (rng.randint(3, 33),))
        stop = [[int(rng.randint(1, 512))]] if stops and i % 3 == 0 else None
        rids.append(cb.submit(prompt, max_new_tokens=int(rng.randint(2, 17)), group=i % sb,
                              stop_sequences=stop))
    out = cb.run()
    torch.cuda.synchronize()
    launches = {k: n for k, n in cuda_lib.LAUNCHES.items() if n}
    return [out[r] for r in rids], launches, dict(cb.stats), cb._chunk


@pytest.mark.gpu
@pytest.mark.parametrize("stream", sorted(GPU_STREAMS))
def test_graph_stream_equals_eager(dev, stream):
    """The same stream through replayed graphs and through the eager loop:
    tokens equal request by request, the same dispatches and launches (one
    decode-step graph captured, none in the eager run), and the launches
    exactly what the dispatches imply: 7 s8 GEMMs, one level read (and one
    causal suffix read at admission) a layer, K8's activations
    (``chip_smoke.expected_k8``), no unique-read kernel and no K9 (the ring
    keeps the chain)."""
    sb, cb_kw, stops = GPU_STREAMS[stream]
    toks_e, launch_e, stats_e, ch_e = _card_stream(sb, cb_kw, stops, graphs=False)
    toks_g, launch_g, stats_g, ch_g = _card_stream(sb, cb_kw, stops, graphs=True)
    assert toks_e == toks_g and stats_e == stats_g and launch_e == launch_g
    assert ch_e.graph is None and ch_g.graph is not None
    L = GPU_CFG["num_hidden_layers"]
    a, s = stats_g["admit_dispatches"], stats_g["decode_steps"]
    import chip_smoke

    assert launch_g == {"w8a8_matmul_cached": 7 * L * (a + s),
                        "flash_attention_cached_bhsd": L * (a + s),
                        "flash_attention_bhsd": L * a,
                        **chip_smoke.expected_k8(L, a + s)}
    for t in toks_g:
        assert len(t) >= 1 and all(0 <= x < GPU_CFG["vocab_size"] for x in t)


@pytest.mark.gpu
@pytest.mark.parametrize("row_start", [0, 1, 3])
def test_cached_read_kernel_at_a_row_offset(dev, row_start):
    """K2 at a prefix-row offset reads the rows in place: equal to its plain
    version on the same rows, within bf16 tolerance, for int8 levels."""
    g = torch.Generator(device="cuda").manual_seed(4)
    L, SB, hkv, S, d = 3, 4, 4, 200, 128
    k, v = (torch.randint(-127, 128, (L, SB, hkv, S, d), dtype=torch.int8, device=dev,
                          generator=g) for _ in range(2))
    ks, vs = (torch.rand(L, SB, hkv, S, device=dev, generator=g) * 0.02 + 1e-3
              for _ in range(2))
    q = torch.randn(1, 8, 300, d, device=dev, generator=g).to(torch.bfloat16)
    lens = torch.tensor([S - 7], dtype=torch.int32, device=dev)
    kw = dict(kv_seq_lens=lens, k_scale_all=ks, v_scale_all=vs, row_start=row_start)
    out, lse = tflash.flash_attention_cached_bhsd(2, q, k, v, **kw)
    ref, rlse = tflash.flash_attention_cached_plain(2, q, k, v, **kw)
    torch.cuda.synchronize()
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    assert rel < 2e-2 and float((lse - rlse).abs().max()) < 2e-2
