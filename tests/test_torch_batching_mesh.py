"""The port's continuous batcher under a mesh against the JAX batcher on the
same mesh, on the CPU.

The port runs one process a rank: each world size is one spawn of gloo CPU
ranks (``hydragen_torch.parallel.launch``), in which every rank runs every
stream of that size, each over an engine built with ``mesh=make_mesh(...)``.
The JAX side runs here, in the test process: the JAX ``ContinuousBatcher``
on ``HydragenLlama(..., mesh=make_mesh(...))`` over the 8 host devices of
``tests/conftest.py`` (its batcher calls ``model_forward`` without a mesh,
so GSPMD partitions it over the engine's sharded parameters and cache). JAX
is imported in the test bodies only, so the spawned ranks, which import this
module, never load it.

At ``tests/test_batching.py``'s configuration in fp32, each stream of
``CASES`` on each mesh of ``MESHES`` (tp=2, dp=2, sp=2 in the two-rank
spawn, tp=2 x dp=2 in the four-rank one) must give, request by request, the
greedy tokens of the JAX mesh batcher and of the port's meshless batcher,
exactly; every rank the same tokens and ``stats``, the stats those of the
meshless batcher and the collectives exactly what the dispatch log implies.
A sampled stream equals the meshless port's draw on every mesh. The w8a8 +
int8-KV stream runs at dp=2 against the JAX batcher without a mesh, with
every quantization held by the tie rule of ``tests/test_torch_ties.py``:
the JAX batcher on a mesh engine runs every projection weight-only (its
sharded spec with no mesh reaches the dq fallback of ``model_forward``'s
``qmm``), which is not the function w8a8 computes. The admission-shaped
forward that reads prefix row 1 of a two-prefix level is held to the
meshless forward and to JAX on each two-rank mesh. The int4 unique cache
stays refused under a mesh.

The ``gpu`` case runs on the card (skipped elsewhere): a one-rank NCCL mesh
batcher through the decode graphs, bit for bit its eager stream and the
meshless batcher's.
"""

import numpy as np
import pytest
import torch

from hydragen_torch import ContinuousBatcher, HydragenLlama, ModelConfig
from hydragen_torch.models.convert import params_from_numpy
from hydragen_torch.parallel import COLLECTIVES, launch, make_mesh
from hydragen_torch.parallel.mesh import reset_collectives

torch.set_num_threads(1)

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, dtype="float32")
# The w8a8 stream: every projection's (N, K) a multiple of 128, so the JAX
# engine takes its s8 GEMM (in interpret mode) for every family, as the port
# takes K1 (its plain version here).
CFG_W8 = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4, dtype="float32")
TIMEOUT = 240.0  # seconds a spawn may take, set-up included
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1)]
MESH_IDS = ["tp2", "dp2", "sp2", "tp2dp2"]
UNIQUE = 32  # ring slots of every pool
LEVEL = 16  # tokens a level holds (8 a rank at sp=2)

# case: (pool rows, quantization, setup_caches arguments, batcher arguments,
# budgets, prefixes in the level, what else the stream does). Budgets apply
# to the six prompts in turn (a short list submits fewer requests).
CASES = {
    # 6 requests through 4 rows: queueing, admissions into freed rows, a
    # dispatch whose members span both dp ranks.
    "fifo": (4, None, {}, dict(chunk=3, bucket=4), [7] * 6, 1, {}),
    # LPT reorders the budgets; a chunk of 16 walks the tail-shrink ladder.
    "lpt_tail_shrink": (4, None, {}, dict(chunk=16, bucket=4, admit_policy="lpt"),
                        [3, 9, 2, 8, 4, 6], 1, {}),
    # eos is the 3rd greedy token of request 0.
    "eos": (4, None, {}, dict(chunk=4, bucket=4), [8] * 6, 1, dict(eos=True)),
    # Request 0 stops on a 2-gram of its own stream, request 1 on one it never
    # emits; 2 rows (one a dp rank): a stopped row is deactivated and reused.
    "stop_sequences": (2, None, {}, dict(chunk=3, bucket=4), [10] * 4, 1, dict(stops=True)),
    "lookahead_2": (4, None, {}, dict(chunk=3, bucket=4, lookahead=2), [7] * 6, 1, {}),
    # Two prefixes (sb = 2): each admission reads one prefix row
    # (``level_row``); at dp=2 each group's rows are one rank's, so a
    # dispatch has members on one rank and the other skips its forward.
    "grouped_sb2": (4, None, {}, dict(chunk=3, bucket=4), [6] * 6, 2, {}),
    # 6 rows over 3 prefixes of 2 rows: at dp=2 rank 0 holds rows 0-2 and
    # rank 1 rows 3-5, so prefix 1's group is split between the ranks.
    "dp_split_in_group": (6, None, {}, dict(chunk=3, bucket=4), [5, 7, 4, 6, 8, 3], 3, {}),
    # Quantized weights take the in-place decode write.
    "inplace_int8_weights": (4, "int8", dict(kv_quant="int8"), dict(chunk=4, bucket=8),
                             [3, 7, 10, 5, 2, 6], 1, {}),
    # The 7B serving cache: int8, BSHD, flat scales (one kv head a tp rank).
    "int8_kv_bshd_flat": (4, None, dict(kv_quant="int8", unique_bshd=True),
                          dict(chunk=3, bucket=4), [7] * 6, 1, {}),
}
SAMPLED = (4, None, dict(kv_quant="int8"), dict(chunk=3, bucket=4, temperature=0.8, top_p=0.9,
                                                 seed=7), [6, 3, 8, 5, 7, 4], 1, {})
W8A8 = (4, "w8a8", dict(kv_quant="int8"), dict(chunk=4, bucket=8), [5, 3, 6, 4], 1, {})


def _inputs(vocab=128):
    """The six prompts and the levels of 1, 2 and 3 prefixes."""
    rng = np.random.RandomState(5)
    shared = rng.randint(1, vocab, (1, 8)).astype(np.int32)
    prompts = [rng.randint(1, vocab, (n,)).astype(np.int32) for n in (3, 5, 2, 4, 6, 3)]
    levels = {1: shared,
              2: np.random.RandomState(9).randint(1, vocab, (2, 8)).astype(np.int32),
              3: np.random.RandomState(11).randint(1, vocab, (3, 8)).astype(np.int32)}
    return prompts, levels


def stream_job(case, eos=None, stops=None, vocab=128):
    """What a stream runs, in full: ``(pool, quantization, cache arguments,
    batcher arguments, levels, [(prompt, budget, group, stops)])``."""
    pool, quant, cache_kw, cb_kw, budgets, sb, _ = case
    prompts, levels = _inputs(vocab)
    cb_kw = dict(cb_kw)
    cb_kw.setdefault("temperature", 0.0)
    if eos is not None:
        cb_kw["eos_token_id"] = eos
    stops = stops or [()] * len(budgets)
    requests = [(prompts[i], n, i % sb, stops[i]) for i, n in enumerate(budgets)]
    return pool, quant, cache_kw, cb_kw, levels[sb], requests


# ---------------------------------------------------------------------------
# What the ranks run (module-level: the spawned ranks import them by name)
# ---------------------------------------------------------------------------


def serve(cfg_kw, params_np, job, mesh=None) -> dict:
    """One stream of ``job`` through the port's batcher, over ``mesh``
    (None: meshless): tokens by request, ``stats``, this rank's admission
    forwards and the stream's collectives."""
    pool, quant, cache_kw, cb_kw, levels, requests = job
    eng = HydragenLlama(ModelConfig(**cfg_kw), params_from_numpy(params_np), device="cpu",
                        quantization=quant, mesh=mesh)
    eng.setup_caches(pool, UNIQUE, [levels.shape[0]], [LEVEL], **cache_kw)
    eng.append_shared(levels)
    cb = ContinuousBatcher(eng, **cb_kw)
    rids = [cb.submit(p, max_new_tokens=n, group=g, stop_sequences=s)
            for p, n, g, s in requests]
    reset_collectives()
    out = cb.run()
    return dict(toks=[out[r] for r in rids], stats=dict(cb.stats),
                admit_forwards=cb.admit_forwards, collectives=dict(COLLECTIVES))


def admission_forward(params_np, mesh=None, rows=(1,)) -> np.ndarray:
    """An admission-shaped forward (``level_batch=(1,)``, ``level_row=rows``)
    of two 4-token suffixes over the two-prefix level: its hidden states."""
    from hydragen_torch.models.llama import model_forward

    _, levels = _inputs()
    eng = HydragenLlama(ModelConfig(**CFG), params_from_numpy(params_np), device="cpu",
                        mesh=mesh)
    eng.setup_caches(2, UNIQUE, [2], [LEVEL])
    eng.append_shared(levels[2])
    ids = torch.from_numpy(np.random.RandomState(4).randint(1, 128, (2, 4)).astype(np.int32))
    spec = eng._spec("unique_prefill", unique_history=False)._replace(
        level_batch=(1,), level_row=rows)
    local = torch.arange(4, dtype=torch.int32)[None].expand(2, 4)
    hidden = model_forward(eng.params, eng.config, eng.cache, ids,
                           local + eng.cache.shared[0].seq_lens[rows[0]], local, spec,
                           mesh=mesh)
    return hidden


def _refusals(params_np, mesh) -> dict:
    """The int4 unique cache under a mesh: ``setup_caches`` and ``shard``
    refuse it with the reference's reason."""
    from hydragen_torch.parallel.sharding import INT4_CACHE_WAITS

    out = {}
    eng = HydragenLlama(ModelConfig(**CFG), params_from_numpy(params_np), device="cpu",
                        mesh=mesh)
    try:
        eng.setup_caches(4, UNIQUE, [1], [LEVEL], kv_quant="int4")
        out["setup_caches"] = None
    except NotImplementedError as e:
        out["setup_caches"] = str(e) == INT4_CACHE_WAITS
    meshless = HydragenLlama(ModelConfig(**CFG), params_from_numpy(params_np), device="cpu")
    meshless.setup_caches(4, UNIQUE, [1], [LEVEL], kv_quant="int4")
    try:
        meshless.shard(mesh)
        out["shard"] = None
    except NotImplementedError as e:
        out["shard"] = str(e) == INT4_CACHE_WAITS
    return out


def _rank_jobs(rank, world, jobs, params):
    from tests.test_torch_ties import Resolver, port_resolved

    torch.set_num_threads(1)
    out, meshes = {}, {}
    for key, (kind, shape, arg) in jobs.items():
        if shape not in meshes:  # every rank makes its groups in one order
            tp, dp, sp = shape
            meshes[shape] = make_mesh(tp=tp, dp=dp, sp=sp, device="cpu")
        mesh = meshes[shape]
        if kind == "stream":
            out[key] = serve(CFG, params["fp32"], arg, mesh)
        elif kind == "w8a8":
            job, records = arg
            with port_resolved(Resolver(records)) as res:
                out[key] = serve(CFG_W8, params["w8"], job, mesh)
            out[key]["ties"] = res.report()
        elif kind == "level_row":
            out[key] = dict(hidden=admission_forward(params["fp32"], mesh))
        elif kind == "refusal":
            out[key] = _refusals(params["fp32"], mesh)
        else:
            raise ValueError(kind)
    return out


# ---------------------------------------------------------------------------
# The JAX side, the meshless port and the spawns
# ---------------------------------------------------------------------------


def _jax_params(cfg_kw):
    import tests.conftest  # noqa: F401  (forces the CPU platform before jax)
    import jax

    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.models.llama import init_params

    p = init_params(JConfig(**cfg_kw), jax.random.PRNGKey(0))
    return p, jax.tree.map(np.asarray, p)


def jax_serve(cfg_kw, jparams, job, shape=None) -> list:
    """The JAX batcher's tokens for ``job``, on an engine over the
    ``(tp, dp, sp)`` mesh ``shape`` (None: meshless)."""
    import tests.conftest  # noqa: F401
    from hydragen_tpu.core.batching import ContinuousBatcher as JBatcher
    from hydragen_tpu.core.engine import HydragenLlama as JEngine
    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.parallel import make_mesh as jmesh

    pool, quant, cache_kw, cb_kw, levels, requests = job
    mesh = None if shape is None else jmesh(tp=shape[0], dp=shape[1], sp=shape[2])
    eng = JEngine(JConfig(**cfg_kw), jparams, quantization=quant, mesh=mesh)
    eng.setup_caches(pool, UNIQUE, [levels.shape[0]], [LEVEL], **cache_kw)
    eng.append_shared(levels)
    cb = JBatcher(eng, **cb_kw)
    rids = [cb.submit(p, max_new_tokens=n, group=g, stop_sequences=s)
            for p, n, g, s in requests]
    out = cb.run()
    return [out[r] for r in rids]


def _derived(params_np):
    """The eos and stop streams' tokens, picked from the meshless port's
    streams without them: eos the 3rd token of request 0, request 0's stop
    its tokens 3-4, request 1's a 2-gram it never emits."""
    toks = serve(CFG, params_np, stream_job(CASES["eos"]))["toks"]
    eos = int(toks[0][2])
    toks = serve(CFG, params_np, stream_job(CASES["stop_sequences"]))["toks"]
    stops = [[list(toks[0][2:4])], [[127, 126]], (), ()]
    return eos, stops


def case_job(name, derived):
    eos, stops = derived
    extra = CASES[name][-1]
    return stream_job(CASES[name], eos=eos if extra.get("eos") else None,
                      stops=stops if extra.get("stops") else None)


@pytest.fixture(scope="module")
def params():
    return {"fp32": _jax_params(CFG), "w8": _jax_params(CFG_W8)}


@pytest.fixture(scope="module")
def meshless(params):
    """The port's meshless streams of every case, the sampled stream and
    the w8a8 stream, with the derived eos and stops."""
    p = params["fp32"][1]
    derived = _derived(p)
    out = {name: serve(CFG, p, case_job(name, derived)) for name in CASES}
    out["sampled"] = serve(CFG, p, stream_job(SAMPLED))
    out["w8a8"] = serve(CFG_W8, params["w8"][1], stream_job(W8A8, vocab=256))
    return out, derived


def _jax_w8a8(params):
    """The JAX batcher's w8a8 + int8-KV stream (meshless, the s8 GEMMs in
    interpret mode) with every quantization recorded."""
    from tests.test_torch_ties import env, jax_recorded

    records = []
    job = stream_job(W8A8, vocab=256)
    with env(HYDRAGEN_W8A8_INTERPRET="1"), jax_recorded(records):
        toks = jax_serve(CFG_W8, params["w8"][0], job)
    return toks, records


def _np_params(params):
    return {k: v[1] for k, v in params.items()}


@pytest.fixture(scope="module")
def two_ranks(params, meshless, tmp_path_factory):
    """Every stream of the two-rank meshes, the level-row forwards, the
    refusals and the w8a8 stream at dp=2, in one spawn."""
    from tests.test_torch_parallel import _once

    def compute():
        derived = meshless[1]
        jax_w8a8, records = _jax_w8a8(params)
        jobs = {}
        for shape in MESHES[:3]:
            for name in CASES:
                jobs[f"{name}{shape}"] = ("stream", shape, case_job(name, derived))
            jobs[f"sampled{shape}"] = ("stream", shape, stream_job(SAMPLED))
            jobs[f"level_row{shape}"] = ("level_row", shape, None)
        jobs["w8a8"] = ("w8a8", (1, 2, 1), (stream_job(W8A8, vocab=256), records))
        jobs["refusal"] = ("refusal", (2, 1, 1), None)
        return dict(ranks=launch(_rank_jobs, 2, jobs, _np_params(params), timeout=TIMEOUT),
                    jax_w8a8=jax_w8a8)

    return _once(tmp_path_factory, "batching_mesh_two", compute)


@pytest.fixture(scope="module")
def four_ranks(params, meshless, tmp_path_factory):
    """Every stream at tp=2 x dp=2, in one spawn."""
    from tests.test_torch_parallel import _once

    def compute():
        shape = MESHES[3]
        jobs = {f"{name}{shape}": ("stream", shape, case_job(name, meshless[1]))
                for name in CASES}
        jobs[f"sampled{shape}"] = ("stream", shape, stream_job(SAMPLED))
        return launch(_rank_jobs, 4, jobs, _np_params(params), timeout=TIMEOUT)

    return _once(tmp_path_factory, "batching_mesh_four", compute)


def _ranks_of(shape, two_ranks, four_ranks):
    return four_ranks if shape == MESHES[3] else two_ranks["ranks"]


def _same_on_every_rank(ranks, key) -> dict:
    """Rank 0's result of ``key``, after holding every rank's tokens and
    stats to it."""
    first = ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["toks"] == first["toks"], key
        assert r[key]["stats"] == first["stats"], key
    return first


def stream_collectives(shape, L, stats, admit_forwards, sampled=False) -> dict:
    """The counted collectives of one stream on a rank, from its dispatch
    log. Each forward (this rank's admission prefills, and every decode
    step) makes, at tp, two sum all-reduces a layer and one all-gather of
    the logits, and at sp one max and one sum all-reduce a layer (the
    level's read, merged). At dp every admission dispatch gathers its
    members' logits, every chunk its tokens, and a sampling step its
    logits."""
    tp, dp, sp = shape
    forwards = admit_forwards + stats["decode_steps"]
    out = dict(all_reduce_sum=0, all_reduce_max=0, all_gather=0)
    if tp > 1:
        out["all_reduce_sum"] += 2 * L * forwards
        out["all_gather"] += forwards
    if sp > 1:
        out["all_reduce_sum"] += L * forwards
        out["all_reduce_max"] += L * forwards
    if dp > 1:
        out["all_gather"] += (stats["admit_dispatches"] + stats["chunks"]
                              + (stats["decode_steps"] if sampled else 0))
    return out


def hold_counts(ranks, key, shape, want_stats, sampled=False):
    """Every rank's stats the meshless batcher's, and its collectives what
    its own dispatch log implies."""
    L = CFG["num_hidden_layers"]
    for rank, r in enumerate(ranks):
        res = r[key]
        assert res["stats"] == want_stats, (key, rank)
        assert res["collectives"] == stream_collectives(
            shape, L, res["stats"], res["admit_forwards"], sampled), (key, rank)
        if shape[1] == 1:
            assert res["admit_forwards"] == res["stats"]["admit_dispatches"], (key, rank)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_batcher_matches_jax_and_meshless(params, meshless, two_ranks, four_ranks, case,
                                               shape):
    """Every request's greedy tokens: equal on every rank, to the JAX mesh
    batcher's and to the port's meshless batcher's; the stats and the
    collectives exact."""
    ranks = _ranks_of(shape, two_ranks, four_ranks)
    key = f"{case}{shape}"
    got = _same_on_every_rank(ranks, key)
    want = meshless[0][case]
    jax_toks = jax_serve(CFG, params["fp32"][0], case_job(case, meshless[1]), shape)
    for i, (t, j, w) in enumerate(zip(got["toks"], jax_toks, want["toks"])):
        assert t == j, (key, i, t, j)
        assert t == w, (key, i, t, w)
    assert len(got["toks"]) == len(want["toks"]) == len(jax_toks)
    hold_counts(ranks, key, shape, want["stats"])
    if case == "eos":
        assert got["toks"][0][-1] == meshless[1][0] and len(got["toks"][0]) == 3
    if case == "stop_sequences":
        assert len(got["toks"][0]) == 4 and got["toks"][0][-2:] == meshless[1][1][0][0]
    if case == "grouped_sb2" and shape[1] == 2:
        # Each dispatch's members lie in one rank's rows: the other skips it.
        assert all(r[key]["admit_forwards"] < got["stats"]["admit_dispatches"]
                   for r in ranks)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_mesh_batcher_sampled_matches_meshless(meshless, two_ranks, four_ranks, shape):
    """Temperature 0.8, top-p 0.9, int8 KV: every rank's draws equal the
    meshless batcher's (one generator state, every row drawn on every
    rank), and the sampling steps' dp gathers are counted."""
    ranks = _ranks_of(shape, two_ranks, four_ranks)
    key = f"sampled{shape}"
    got = _same_on_every_rank(ranks, key)
    want = meshless[0]["sampled"]
    assert got["toks"] == want["toks"]
    for t, n in zip(got["toks"], SAMPLED[4]):
        assert len(t) == n and all(0 <= x < CFG["vocab_size"] for x in t)
    hold_counts(ranks, key, shape, want["stats"], sampled=True)


def test_mesh_batcher_w8a8_against_jax(params, meshless, two_ranks):
    """w8a8 + int8 KV at dp=2: each rank's quantizations held to the JAX
    batcher's by the tie rule (its s8 GEMMs in interpret mode), then every
    request's tokens equal JAX's on both ranks; the stats the meshless
    port's, the collectives exact."""
    from tests.test_torch_ties import assert_resolved

    ranks = two_ranks["ranks"]
    for rank, r in enumerate(ranks):
        assert_resolved(r["w8a8"]["ties"], f"w8a8 dp=2 rank {rank}")
    got = _same_on_every_rank(ranks, "w8a8")
    assert got["toks"] == two_ranks["jax_w8a8"]
    hold_counts(ranks, "w8a8", (1, 2, 1), meshless[0]["w8a8"]["stats"])


@pytest.mark.parametrize("shape", MESHES[:3], ids=MESH_IDS[:3])
def test_admission_level_row_under_a_mesh(params, two_ranks, shape):
    """An admission-shaped forward reading prefix row 1 of a two-prefix level
    (``level_batch=(1,)``, ``level_row=(1,)``): each rank's hidden states
    equal the meshless forward's and the JAX forward's over the level's row
    1 (the JAX batcher's sliced view), within 1e-4 in fp32; and they are not
    the read of prefix 0."""
    import tests.conftest  # noqa: F401
    import jax.numpy as jnp

    from hydragen_tpu.core.engine import HydragenLlama as JEngine
    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.models.llama import model_forward as jforward

    want = admission_forward(params["fp32"][1]).numpy()
    row0 = admission_forward(params["fp32"][1], rows=(0,)).numpy()
    _, levels = _inputs()
    jeng = JEngine(JConfig(**CFG), params["fp32"][0])
    jeng.setup_caches(2, UNIQUE, [2], [LEVEL])
    jeng.append_shared(levels[2])
    lv = jeng.cache.shared[0]
    one = lv._replace(k=lv.k[:, 1:2], v=lv.v[:, 1:2], seq_lens=lv.seq_lens[1:2])
    acache = jeng.cache._replace(shared=(one,) + tuple(jeng.cache.shared[1:]))
    spec = jeng._spec("unique_prefill", unique_history=False)._replace(level_batch=(1,))
    ids = np.random.RandomState(4).randint(1, 128, (2, 4)).astype(np.int32)
    local = jnp.broadcast_to(jnp.arange(4, dtype=jnp.int32)[None], (2, 4))
    jhidden = np.asarray(jforward(params["fp32"][0], JConfig(**CFG), acache, jnp.asarray(ids),
                                  local + lv.seq_lens[1], local, spec)[0])
    np.testing.assert_allclose(want, jhidden, atol=1e-4, rtol=1e-4)
    assert np.abs(want - row0).max() > 1e-2  # the two prefixes read apart
    for rank, r in enumerate(two_ranks["ranks"]):
        np.testing.assert_allclose(r[f"level_row{shape}"]["hidden"], want, atol=1e-4, rtol=1e-4,
                                   err_msg=f"rank {rank}")


def test_int4_kv_refused_under_a_mesh(params, two_ranks):
    """The int4 unique cache under a mesh waits for the reference: a mesh
    engine's ``setup_caches`` and ``shard`` of an int4-cached engine raise
    ``INT4_CACHE_WAITS`` on every rank, and the batcher still refuses an
    int4 pool (its sub-byte scatters)."""
    for r in two_ranks["ranks"]:
        assert r["refusal"] == {"setup_caches": True, "shard": True}
    eng = HydragenLlama(ModelConfig(**CFG), params_from_numpy(params["fp32"][1]), device="cpu")
    eng.setup_caches(4, UNIQUE, [1], [LEVEL], kv_quant="int4")
    eng.append_shared(_inputs()[1][1])
    with pytest.raises(AssertionError, match="sub-byte"):
        ContinuousBatcher(eng)


# --- on the card ----------------------------------------------------------------

GPU_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2, dtype="bfloat16")


def card_stream(mesh, graphs: bool) -> tuple:
    """24 requests over a 16-row w8a8 + int8-KV pool on the card (weights
    from one seed), through the graphs or the eager loop, over ``mesh``
    (None: meshless). Returns tokens, stats and whether a graph was
    captured."""
    from hydragen_torch.models.llama import init_params

    cfg = ModelConfig(**GPU_CFG)
    g = torch.Generator(device="cuda").manual_seed(5)
    params = init_params(cfg, g, quantized="w8a8", device="cuda")
    eng = HydragenLlama(cfg, params, quantization="w8a8", mesh=mesh).graph(graphs)
    eng.setup_caches(16, 56, [1], [64], kv_quant="int8", unique_bshd=True)
    eng.append_shared(torch.randint(1, 512, (1, 40), generator=g, device="cuda"))
    rng = np.random.RandomState(6)
    cb = ContinuousBatcher(eng, chunk=4, bucket=16, seed=3, lookahead=2)
    rids = [cb.submit(rng.randint(1, 512, (rng.randint(3, 33),)),
                      max_new_tokens=int(rng.randint(2, 17))) for _ in range(24)]
    out = cb.run()
    torch.cuda.synchronize()
    return [out[r] for r in rids], dict(cb.stats), cb._chunk.graph is not None


def nccl_batcher_rank(rank, world) -> dict:
    """A one-rank NCCL mesh (``keep_trivial``: its tp collectives run over
    the one rank): the stream through the graphs, then eagerly; the
    meshless stream through its graphs."""
    mesh = make_mesh(tp=1, device="cuda:0", keep_trivial=True)
    return dict(graph=card_stream(mesh, True), eager=card_stream(mesh, False),
                meshless=card_stream(None, True))


@pytest.mark.gpu
def test_nccl_mesh_batcher_graphs_equal_eager_and_meshless():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL, the decode graphs and the kernels run only there")
    res = launch(nccl_batcher_rank, 1, backend="nccl", timeout=TIMEOUT)[0]
    toks_g, stats_g, captured = res["graph"]
    assert captured and not res["eager"][2]
    assert toks_g == res["eager"][0] == res["meshless"][0]
    assert stats_g == res["eager"][1] == res["meshless"][1]
