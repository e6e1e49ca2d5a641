"""The port's tensor, data and sequence parallelism against the JAX package.

The port runs one process a rank: each world size is one spawn of gloo CPU
ranks (``hydragen_torch.parallel.launch``, with time limits on the group's
set-up and on the join, so a hung group fails its tests, not the suite's
clock), in which every rank runs every case of that size. The JAX side runs
here, in the test process, on the 8-device CPU mesh of ``tests/conftest.py``
at the same ``(tp, dp, sp)``; JAX is imported in the test bodies only, so the
spawned ranks, which import this module, never load it.

What is held (mirroring ``test_tp.py``, ``test_comm.py`` and
``test_shard_attn.py``):
- fp32 ``generate`` (two levels, two samples a prompt, WIPE) at tp, dp, sp,
  (2, 2, 2) and a tp above the kv head count: tokens equal and logits within
  1e-4 of the JAX engine on the same mesh and of the port without a mesh;
- int8 weights at (tp=2, dp=2);
- w8a8 at tp=2 against the JAX sharded engine (its per-shard GEMM routes,
  in interpret mode), each quantization of the ranks held to its JAX
  counterpart by the tie rule of ``test_torch_ties.py``;
- the parameter layout; ``from_pretrained_tp``'s slices against the host
  quantizers' output, bit for bit; the cache against the JAX cache;
- the sp LSE merge with a fully masked shard; the row-parallel GEMM;
- a dp split inside a prefix group; EOS and a stop sequence under dp;
- the collective census of one decode step.
"""

import fcntl
import os
import pickle

import numpy as np
import pytest
import torch

from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
from hydragen_torch.models.convert import params_from_numpy
from hydragen_torch.parallel import COLLECTIVES, launch, make_mesh, param_pspecs
from hydragen_torch.parallel.mesh import Mesh, reset_collectives, timed_collectives

torch.set_num_threads(1)

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=8, num_key_value_heads=4, dtype="float32")
# w8a8: every projection's per-shard (N, K) a multiple of 128 at tp=2, so the
# JAX engine takes its per-shard s8 GEMM routes (``_w8a8_blocks``) for every
# family, as the port does.
CFG_W8 = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4, dtype="float32")
# The parameter key of the w8a8 case. A last-bit difference between XLA's and
# PyTorch's float sums can move one activation or KV code across a rounding
# boundary at any key; the ranks resolve such ties to JAX's codes
# (``tests/test_torch_ties.py``), so the key pins nothing.
W8_KEY = 0
TIMEOUT = 240.0  # seconds a spawn may take, set-up included
HF_QUANT = ["w8a8", "w4a8", "mixed"]  # the quantizations from_pretrained_tp is held at
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2)]
# Rows 0-2 / 3-5 of 6 over dp=2, the level's 3 prefixes two rows each: each
# rank's rows end or start inside a prefix group.
SPLIT = dict(levels=[1, 3], lens=[8, 4], shared=(1, 6), suffix=(3, 3), samples=2, B=6)
STD = dict(levels=[1, 4], lens=[8, 4], shared=(1, 6), suffix=(4, 3), samples=2, B=8)
# The no-sharing baseline (``disable_hydragen``): one 8-token prefix (split
# 4 + 4 at sp=2) copied into 4 unique rows ahead of their 3-token suffixes.
NOSHARE = dict(shared=(1, 8), suffix=(4, 3), B=4)
NOSHARE_MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1)]


# ---------------------------------------------------------------------------
# What the ranks run (module-level: the spawned ranks import them by name)
# ---------------------------------------------------------------------------


def _prompts(layout, seed=3, vocab=128):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, vocab, size=layout["shared"]).astype(np.int32),
            rng.randint(1, vocab, size=layout["suffix"]).astype(np.int32))


def run_generate(eng, layout=STD, kv_quant=None, vocab=128, overrides=None, bshd=None,
                 **extra):
    """test_tp.py's request: tokens and every step's logits."""
    shared, suffix = _prompts(layout, vocab=vocab)
    eng.setup_caches(layout["B"], 16, layout["levels"], layout["lens"], kv_quant=kv_quant,
                     unique_bshd=bshd)
    kw = dict(input_ids=[shared, suffix], num_return_sequences=layout["samples"],
              max_new_tokens=6, temperature=0.0, return_logits=True,
              shared_cache_op=SharedCacheOp.WIPE)
    if overrides is not None:
        kw["token_overrides"] = overrides
    kw.update(extra)
    toks, logits = eng.generate(**kw)
    return np.asarray(toks), np.stack([np.asarray(x) for x in logits])


def run_no_sharing(eng, counted=None) -> dict:
    """The no-sharing baseline's requests on ``eng`` (either package's
    engine), greedy, every step's logits: ``copy``, the prefix as level 0
    copied into every unique row (``copy_shared_to_unique``) ahead of the
    suffixes; ``samples``, the prefix prefilled into the unique rows and
    repeated for 4 samples; ``two_prefixes``, a kept level of two prefixes
    (``append_shared``, then ``PRESERVE``), each copied into its own two
    rows (rows 2-3, a dp=2 rank's, read the second). ``counted()``, where
    given, is read after each request (the port's collectives) and reset
    before it."""
    shared, suffix = _prompts(NOSHARE)
    two = np.random.RandomState(4).randint(1, 128, (2, NOSHARE["shared"][1])).astype(np.int32)
    eng.setup_caches(NOSHARE["B"], 32, [2], [NOSHARE["shared"][1]])
    out = {}
    for name, ids, samples in (("copy", [shared, suffix], 1), ("samples", [shared], 4),
                               ("two_prefixes", [suffix], 1)):
        if counted is not None:
            reset_collectives()
        kw = dict(shared_cache_op=SharedCacheOp.WIPE)
        if name == "two_prefixes":
            eng.empty_shared_cache()
            eng.append_shared(two)
            kw = dict(shared_cache_op=SharedCacheOp.PRESERVE)
        toks, logits = eng.generate(input_ids=ids, num_return_sequences=samples,
                                    max_new_tokens=6, temperature=0.0, return_logits=True,
                                    disable_hydragen=True, **kw)
        out[name] = (np.asarray(toks), np.stack([np.asarray(x) for x in logits]))
        if counted is not None:
            out[f"{name}_collectives"] = counted()
    return out


def _engine(cfg_kw, params_np, mesh=None, quant=None, **kw):
    return HydragenLlama(ModelConfig(**cfg_kw), params_from_numpy(params_np), device="cpu",
                         quantization=quant, mesh=mesh, **kw)


def _decode_census(cfg_kw, params_np, mesh):
    """One decode step's collectives (``test_comm.py``'s step): the forward
    and the logits, over a 64-token level, 8 rows."""
    from hydragen_torch.models.llama import logits_from_hidden, model_forward

    eng = _engine(cfg_kw, params_np, mesh)
    eng.setup_caches(8, 32, [1], [64])
    eng.append_shared(np.random.RandomState(0).randint(1, 127, (1, 64)).astype(np.int32))
    dp = mesh.size("dp") if mesh is not None and mesh.active("dp") else 1
    r0, b = eng._dp_rows(8)
    spec = eng._spec("decode", unique_history=True, rows=(r0, 8) if dp > 1 else ())
    tok = torch.ones((b, 1), dtype=torch.int32)
    pos = torch.full((b, 1), 70, dtype=torch.int32)
    upos = torch.full((b, 1), 4, dtype=torch.int32)
    reset_collectives()
    hidden = model_forward(eng.params, eng.config, eng.cache, tok, pos, upos, spec,
                           history_lens=upos[:, 0], mesh=mesh)
    logits_from_hidden(eng.params, eng.config, hidden, mesh=mesh)
    return dict(COLLECTIVES)


def _shard_after_prefill(params_np, mesh, quant=None):
    """A meshless engine prefills a level, then ``shard(mesh)`` slices its
    parameters and its written cache, and a second request decodes over
    the kept level (``PRESERVE``)."""
    eng = _engine(CFG, params_np, quant=quant)
    shared, suffix = _prompts(STD)
    eng.setup_caches(STD["B"], 16, STD["levels"], STD["lens"])
    eng.append_shared(shared)
    if mesh is not None:
        eng.shard(mesh)
    toks, logits = eng.generate(input_ids=[suffix], num_return_sequences=2, max_new_tokens=6,
                                temperature=0.0, return_logits=True,
                                shared_cache_op=SharedCacheOp.PRESERVE)
    return np.asarray(toks), np.stack([np.asarray(x) for x in logits])


def _local_cache(eng):
    c = eng.cache
    out = dict(uk=c.unique_k, uv=c.unique_v, uks=c.unique_k_scale, uvs=c.unique_v_scale)
    for j, lv in enumerate(c.shared[:eng.num_used_levels]):
        out.update({f"l{j}k": lv.k, f"l{j}v": lv.v, f"l{j}ks": lv.k_scale, f"l{j}vs": lv.v_scale,
                    f"l{j}lens": lv.seq_lens})
    return {k: v for k, v in out.items() if v is not None}


def _case(name, arg, params, rank, world):
    """One case on this rank; ``arg`` its parameters."""
    from hydragen_torch.parallel.shard_attn import sp_lse_merge
    from hydragen_torch.parallel.shard_gemm import sharded_qmatmul_stacked_row
    from hydragen_torch.ops.quant import QuantizedTensor

    if name == "generate":
        (tp, dp, sp), quant, layout, kv_quant, *bshd = arg
        mesh = make_mesh(tp=tp, dp=dp, sp=sp, device="cpu")
        eng = _engine(CFG, params[False], mesh, quant)
        toks, logits = run_generate(eng, layout, kv_quant, bshd=bshd[0] if bshd else None)
        return dict(toks=toks, logits=logits, cache=_local_cache(eng))
    if name == "resolved":
        return _resolved_case(arg, params)
    if name == "noshare":
        tp, dp, sp = arg
        eng = _engine(CFG, params[False], make_mesh(tp=tp, dp=dp, sp=sp, device="cpu"))
        return run_no_sharing(eng, lambda: dict(COLLECTIVES))
    if name == "shard":
        (tp, dp, sp), quant = arg
        mesh = make_mesh(tp=tp, dp=dp, sp=sp, device="cpu")
        return dict(zip(("toks", "logits"), _shard_after_prefill(params[False], mesh, quant)))
    if name == "census":
        tp, dp, sp = arg
        return _decode_census(CFG, params[False], make_mesh(tp=tp, dp=dp, sp=sp, device="cpu"))
    if name == "stops":
        layout, stops = arg
        mesh = make_mesh(dp=2, device="cpu")
        eng = _engine(CFG, params[False], mesh, eos_chunk=2)
        out, COLL = [], []
        for extra in stops:
            reset_collectives()
            out.append(run_generate(eng, layout, None, max_new_tokens=8, **extra)[0])
            COLL.append(dict(COLLECTIVES))
        return dict(toks=out, collectives=COLL)
    if name == "sample":
        (tp, dp, sp), layout = arg
        eng = _engine(CFG, params[False], make_mesh(tp=tp, dp=dp, sp=sp, device="cpu"))
        return dict(toks=run_generate(eng, layout, temperature=0.8, top_p=0.9, seed=5)[0])
    if name == "merge":
        o, l = arg  # [sp, ...] per-rank partials
        mesh = make_mesh(sp=2, device="cpu")
        i = mesh.index("sp")
        reset_collectives()
        with timed_collectives() as seconds:
            mo, ml = sp_lse_merge(torch.from_numpy(o[i]), torch.from_numpy(l[i]), mesh)
        return dict(o=mo, l=ml, collectives=dict(COLLECTIVES), seconds=seconds[0])
    if name == "row_gemm":
        x, wq, ws, layer = arg
        mesh = make_mesh(tp=2, device="cpu")
        i, k = mesh.index("tp"), x.shape[1] // 2
        w = QuantizedTensor(torch.from_numpy(wq[:, :, i * k:(i + 1) * k].copy()),
                            torch.from_numpy(ws))
        xs = torch.from_numpy(x[:, i * k:(i + 1) * k].copy())
        return dict(y=sharded_qmatmul_stacked_row(xs, w, layer, "", "w8a8", mesh))
    if name == "pretrained":
        path, quant = arg
        eng = HydragenLlama.from_pretrained_tp(path, tp=2, dp=1, dtype="float32",
                                               quantization=quant, device="cpu")
        return dict(params=eng.params, tp_rank=eng.mesh.index("tp"), load_stats=eng.load_stats,
                    param_bytes=_tree_bytes(eng.params), replicated_bytes=_tree_bytes(
                        [eng.params[k] for k in ("embed_tokens", "final_norm")]
                        + [eng.params["layers"][k] for k in ("input_norm", "post_attn_norm")]))
    raise ValueError(name)


def _resolved_case(arg, params):
    """A quantized request (and a forced stream) on this rank with each of its
    quantizations held to the JAX run's ``records`` by the tie rule, ties
    resolved to JAX's codes: tokens, logits, the forced logits and the
    resolver's report."""
    from tests.test_torch_ties import Resolver, port_resolved

    from hydragen_torch.ops import gemm
    from tests.test_torch_ties import patched

    (tp, dp, sp), quant, wide, layout, kv_quant, records, forced = arg
    cfg_kw = CFG_W8 if wide else CFG
    mesh = make_mesh(tp=tp, dp=dp, sp=sp, device="cpu")
    eng = _engine(cfg_kw, params[wide], mesh, quant)
    vocab = cfg_kw["vocab_size"]
    routes = {"w4a8": 0, "w8a8": 0}  # K6 and K1 wrapper calls (their plain versions here)

    def counted(key, fn):
        def wrapped(*a, **kw):
            routes[key] += 1
            return fn(*a, **kw)
        return wrapped

    with port_resolved(Resolver(records)) as res, patched([
            (gemm, f"{k}_matmul_cached", counted(k, getattr(gemm, f"{k}_matmul_cached")))
            for k in routes]):
        toks, logits = run_generate(eng, layout, kv_quant, vocab)
        out = dict(toks=toks, logits=logits)
        if forced is not None:
            out["forced"] = run_generate(eng, layout, kv_quant, vocab, overrides=forced)[1]
    out.update(ties=res.report(), routes=routes)
    return out


def _rank_cases(rank, world, cases, params):
    torch.set_num_threads(1)
    return {key: _case(name, arg, params, rank, world) for key, (name, arg) in cases.items()}


# ---------------------------------------------------------------------------
# The JAX side and the spawns
# ---------------------------------------------------------------------------


def _jax_params(cfg_kw, key=0):
    import tests.conftest  # noqa: F401  (forces the CPU platform before jax)
    import jax

    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.models.llama import init_params

    p = init_params(JConfig(**cfg_kw), jax.random.PRNGKey(key))
    return p, jax.tree.map(np.asarray, p)


def _jax_generate(cfg_kw, jparams, mesh_shape, quant=None, layout=STD, kv_quant=None,
                  overrides=None, bshd=None, **extra):
    import tests.conftest  # noqa: F401
    from hydragen_tpu.core.engine import HydragenLlama as JEngine
    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.parallel import make_mesh as jmesh

    tp, dp, sp = mesh_shape
    eng = JEngine(JConfig(**cfg_kw), jparams, quantization=quant,
                  mesh=jmesh(tp=tp, dp=dp, sp=sp) if tp * dp * sp > 1 else None,
                  **({"eos_chunk": 2} if extra else {}))
    return run_generate(eng, layout, kv_quant, cfg_kw["vocab_size"], overrides, bshd,
                        **extra), eng


def jax_resolved_case(params, mesh_shape, quant, wide=True, layout=STD, kv_quant="int8",
                      forced=False):
    """The JAX engine's run of a quantized case on ``mesh_shape`` with every
    quantization recorded (the Pallas GEMMs in interpret mode): its outputs
    and the rank case ``("resolved", ...)`` that holds the port to them."""
    from tests.test_torch_ties import env, jax_recorded

    cfg_kw = CFG_W8 if wide else CFG
    over = None
    if forced:
        over = np.random.RandomState(2).randint(1, cfg_kw["vocab_size"], (layout["B"], 6)
                                                ).astype(np.int32)
    records = []
    with env(HYDRAGEN_W8A8_INTERPRET="1", HYDRAGEN_MESH_KERNELS_INTERPRET="1"), \
            jax_recorded(records):
        (toks, logits), _ = _jax_generate(cfg_kw, params[wide][0], mesh_shape, quant, layout,
                                          kv_quant)
        out = dict(toks=toks, logits=logits)
        if forced:
            out["forced"] = _jax_generate(cfg_kw, params[wide][0], mesh_shape, quant, layout,
                                          kv_quant, overrides=over)[0][1]
    return out, ("resolved", (mesh_shape, quant, wide, layout, kv_quant, records, over))


def hold_resolved(ranks, key, jax_out, tol=1e-3):
    """Every rank's tie report clean; tokens equal to JAX's and the same on
    every rank; logits (and forced logits) within ``tol`` of JAX's."""
    from tests.test_torch_ties import assert_resolved

    for rank, r in enumerate(ranks):
        assert_resolved(r[key]["ties"], f"{key} rank {rank}")
    np.testing.assert_array_equal(_same_on_every_rank(ranks, key, "toks"), jax_out["toks"])
    for field in ("logits", "forced"):
        if field in jax_out:
            np.testing.assert_allclose(_same_on_every_rank(ranks, key, field), jax_out[field],
                                       atol=tol, rtol=0, err_msg=field)


@pytest.fixture(scope="module")
def params():
    """fp32 parameters of CFG and CFG_W8, made by the JAX package: (jax
    tree, numpy tree) each."""
    return {False: _jax_params(CFG), True: _jax_params(CFG_W8, W8_KEY)}


def _np_params(params):
    return {k: v[1] for k, v in params.items()}


def _stop_requests(params):
    """Stops picked from the port's own meshless run, with ``eos_chunk=2``:
    a stop 2-gram for every row, rank 0's rows (0-3 at dp=2) finishing at
    column 3 and rank 1's at column 6, so the batch stops early and rank 0
    must decode on until rank 1 is done; then an EOS token of row 1."""
    eng = _engine(CFG, params[False][1], eos_chunk=2)
    full, _ = run_generate(eng, STD, max_new_tokens=8)
    stops = [full[r, 2:4].tolist() for r in range(4)] + [full[r, 5:7].tolist()
                                                          for r in range(4, 8)]
    return full, [dict(stop_sequences=stops), dict(eos_token_id=int(full[1, 3]))]


def _once(tmp_path_factory, name, compute):
    """``compute()`` once a test session: the pytest-xdist workers share the
    first one's result through a pickle in the session's temporary root,
    behind a file lock, so each spawn runs once whichever workers its tests
    land on."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"torch_parallel_{name}.pkl"
    with open(root / f"torch_parallel_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return pickle.loads(path.read_bytes())
        out = compute()
        path.write_bytes(pickle.dumps(out))
        return out


@pytest.fixture(scope="module")
def two_ranks(params, tmp_path_factory):
    """The fp32 requests at world size 2, in one spawn."""
    cases = {f"gen{m}": ("generate", (m, None, STD, None)) for m in MESHES}
    cases.update({
        "gen_split": ("generate", ((1, 2, 1), None, SPLIT, None)),
        "cache_kv8": ("generate", ((2, 1, 1), None, STD, "int8")),
    })
    cases.update({f"shard{m}": ("shard", (m, None)) for m in MESHES})
    cases.update({f"noshare{m}": ("noshare", m) for m in MESHES})
    return _once(tmp_path_factory, "two_ranks", lambda: dict(ranks=launch(
        _rank_cases, 2, cases, _np_params(params), timeout=TIMEOUT)))


@pytest.fixture(scope="module")
def two_ranks_more(params, tmp_path_factory):
    """The other cases at world size 2, in a second spawn (beside the
    first, on other workers)."""
    return _once(tmp_path_factory, "two_ranks_more",
                 lambda: _two_ranks_more(params, tmp_path_factory))


def _two_ranks_more(params, tmp_path_factory):
    full, stops = _stop_requests(params)
    jax_w8a8, case_w8a8 = jax_resolved_case(params, (2, 1, 1), "w8a8", forced=True)
    cases = {
        "gen_w8a8": case_w8a8,
        "stops": ("stops", (STD, stops)),
        "sample_dp": ("sample", ((1, 2, 1), STD)),
        "sample_dp_split": ("sample", ((1, 2, 1), SPLIT)),
        "merge": ("merge", _merge_inputs()),
        "row_gemm": ("row_gemm", _row_gemm_inputs()),
    }
    cases.update({f"census{m}": ("census", m) for m in MESHES})
    res = launch(_rank_cases, 2, cases, _np_params(params), timeout=TIMEOUT)
    return dict(ranks=res, full=full, stops=stops, jax_w8a8=jax_w8a8)


@pytest.fixture(scope="module")
def two_ranks_hf(params, tmp_path_factory):
    """``from_pretrained_tp`` at world size 2 over a tiny HF directory."""
    def compute():
        path = tmp_path_factory.mktemp("hf_tiny")
        _save_tiny_hf(path)
        cases = {f"pretrained_{q}": ("pretrained", (str(path), q)) for q in HF_QUANT}
        return dict(ranks=launch(_rank_cases, 2, cases, _np_params(params), timeout=TIMEOUT),
                    hf=path)

    return _once(tmp_path_factory, "two_ranks_hf", compute)


@pytest.fixture(scope="module")
def eight_ranks(params, tmp_path_factory):
    cases = {"gen222": ("generate", ((2, 2, 2), None, STD, None)),
             "gen_tp8": ("generate", ((8, 1, 1), None, STD, None)),
             "census222": ("census", (2, 2, 2))}
    return _once(tmp_path_factory, "eight_ranks", lambda: launch(
        _rank_cases, 8, cases, _np_params(params), timeout=TIMEOUT))


@pytest.fixture(scope="module")
def four_ranks(params, tmp_path_factory):
    cases = {"int8": ("generate", ((2, 2, 1), "int8", STD, None)),
             "gen411": ("generate", ((4, 1, 1), None, STD, None)),
             "cache_kv8_bshd": ("generate", ((2, 2, 1), None, STD, "int8", True)),
             "noshare(2, 2, 1)": ("noshare", (2, 2, 1))}
    return _once(tmp_path_factory, "four_ranks", lambda: launch(
        _rank_cases, 4, cases, _np_params(params), timeout=TIMEOUT))


def _same_on_every_rank(ranks, key, field):
    first = ranks[0][key][field]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key][field], first)
    return first


def _hold_generate(ranks, key, jax_out, port_out, tol=1e-4):
    toks = _same_on_every_rank(ranks, key, "toks")
    logits = _same_on_every_rank(ranks, key, "logits")
    for name, (t, l) in (("jax", jax_out), ("port without a mesh", port_out)):
        np.testing.assert_array_equal(toks, t, err_msg=name)
        np.testing.assert_allclose(logits, l, atol=tol, rtol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=["tp2", "dp2", "sp2"])
def test_sharded_matches_jax_and_unsharded(params, two_ranks, mesh):
    jax_out, _ = _jax_generate(CFG, params[False][0], mesh)
    port = run_generate(_engine(CFG, params[False][1]))
    _hold_generate(two_ranks["ranks"], f"gen{mesh}", jax_out, port)


@pytest.mark.parametrize("mesh", MESHES, ids=["tp2", "dp2", "sp2"])
def test_shard_after_prefill_matches_unsharded(params, two_ranks, mesh):
    """``shard(mesh)`` on an engine whose level is written (``shard_cache``
    slices its heads, rows and tokens): the next request equals the
    meshless engine's."""
    want = _shard_after_prefill(params[False][1], None)
    toks = _same_on_every_rank(two_ranks["ranks"], f"shard{mesh}", "toks")
    np.testing.assert_array_equal(toks, want[0])
    np.testing.assert_allclose(_same_on_every_rank(two_ranks["ranks"], f"shard{mesh}", "logits"),
                               want[1], atol=1e-4, rtol=1e-4)


def test_tp2_dp2_sp2_matches_jax_and_unsharded(params, eight_ranks):
    jax_out, _ = _jax_generate(CFG, params[False][0], (2, 2, 2))
    port = run_generate(_engine(CFG, params[False][1]))
    _hold_generate(eight_ranks, "gen222", jax_out, port)


def _jax_engine(cfg_kw, jparams, mesh_shape):
    import tests.conftest  # noqa: F401
    from hydragen_tpu.core.engine import HydragenLlama as JEngine
    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.parallel import make_mesh as jmesh

    tp, dp, sp = mesh_shape
    return JEngine(JConfig(**cfg_kw), jparams,
                   mesh=jmesh(tp=tp, dp=dp, sp=sp) if tp * dp * sp > 1 else None)


def no_sharing_collectives(mesh, request: str) -> dict:
    """The counted collectives of one ``run_no_sharing`` request on a rank:
    at tp, two sum all-reduces a layer and a logits all-gather a forward
    (the copy request runs 7 forwards: the level, the suffixes and 5 decode
    steps; the samples request 6); at dp, the gathers of the prefill's
    logits, of the tokens and of the step logits; at sp, the copy's
    all-gathers of the level's k and v, and nothing else (the unique cache
    is not split over sp, so no read merges). ``two_prefixes`` counts as
    ``copy`` (its level's prefill, the copy, the suffixes, 5 steps)."""
    tp, dp, sp = mesh
    copies = request != "samples"
    forwards = 7 if copies else 6
    L = CFG["num_hidden_layers"]
    return dict(all_reduce_sum=2 * L * forwards if tp > 1 else 0, all_reduce_max=0,
                all_gather=(forwards if tp > 1 else 0) + (3 if dp > 1 else 0)
                + (2 if sp > 1 and copies else 0))


@pytest.mark.parametrize("mesh", NOSHARE_MESHES, ids=["tp2", "dp2", "sp2", "tp2dp2"])
def test_no_sharing_under_a_mesh_matches_jax_and_meshless(params, two_ranks, four_ranks, mesh):
    """``disable_hydragen`` on a mesh, the requests of ``run_no_sharing``:
    each rank's copy writes its unique rows (dp) and kv heads (tp), an
    sp-split level gathered first; tokens equal on every rank, to the JAX
    engine's on the same mesh and to the meshless port's, logits within
    1e-4 of both (fp32), and the exact collectives."""
    ranks = four_ranks if mesh == (2, 2, 1) else two_ranks["ranks"]
    key = f"noshare{mesh}"
    jax_out = run_no_sharing(_jax_engine(CFG, params[False][0], mesh))
    port = run_no_sharing(_engine(CFG, params[False][1]))
    for req in ("copy", "samples", "two_prefixes"):
        toks, logits = ranks[0][key][req]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key][req][0], toks)
            np.testing.assert_array_equal(r[key][req][1], logits)
        for name, (t, lg) in (("jax", jax_out[req]), ("port without a mesh", port[req])):
            np.testing.assert_array_equal(toks, t, err_msg=f"{req} {name}")
            np.testing.assert_allclose(logits, lg, atol=1e-4, rtol=1e-4, err_msg=f"{req} {name}")
        for r in ranks:
            assert r[key][f"{req}_collectives"] == no_sharing_collectives(mesh, req), req


def test_tp_exceeding_kv_heads_replicates(params, eight_ranks):
    """tp=8 over 4 kv heads: k/v replicated, q sharded (``test_tp.py:73``)."""
    jax_out, _ = _jax_generate(CFG, params[False][0], (8, 1, 1))
    port = run_generate(_engine(CFG, params[False][1]))
    _hold_generate(eight_ranks, "gen_tp8", jax_out, port)
    # Each rank's cache holds the one kv head its query head reads.
    for rank, r in enumerate(eight_ranks):
        assert r["gen_tp8"]["cache"]["l0k"].shape[2] == 1, rank


def test_tp4_matches_jax_and_unsharded(params, four_ranks):
    """tp=4 (one kv head a rank), the four-card layout of the card check."""
    jax_out, _ = _jax_generate(CFG, params[False][0], (4, 1, 1))
    port = run_generate(_engine(CFG, params[False][1]))
    _hold_generate(four_ranks, "gen411", jax_out, port)


def test_sharded_int8_tp2_dp2(params, four_ranks):
    jax_out, _ = _jax_generate(CFG, params[False][0], (2, 2, 1), quant="int8")
    port = run_generate(_engine(CFG, params[False][1], quant="int8"))
    _hold_generate(four_ranks, "int8", jax_out, port)


def test_w8a8_tp2_against_jax_sharded(params, two_ranks_more, monkeypatch):
    """The per-shard K1 routes: column-parallel on the shared row
    quantization, row-parallel on per-shard row scales with bf16 partials
    and their sum (``shard_gemm.py:12-25``), int8 KV. Every quantization in
    the ranks is held to its JAX counterpart, a differing code must be a
    tie and takes JAX's code (``tests/test_torch_ties.py``); then tokens
    equal JAX's, and the logits of the request and of a forced stream lie
    within 1e-3 of JAX's."""
    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    monkeypatch.setenv("HYDRAGEN_MESH_KERNELS_INTERPRET", "1")
    from hydragen_tpu.ops.quant import _w8a8_blocks

    c, tp = CFG_W8, 2
    H, I = c["hidden_size"], c["intermediate_size"]
    hd = H // c["num_attention_heads"]
    Hq = c["num_attention_heads"] * hd
    for N, K in ((Hq // tp, H), (H, Hq // tp), (I // tp, H), (H, I // tp)):
        assert _w8a8_blocks(N, K) is not None, (N, K)
    hold_resolved(two_ranks_more["ranks"], "gen_w8a8", two_ranks_more["jax_w8a8"])


def test_dp_split_inside_prefix_group(params, two_ranks):
    """dp=2 over 6 rows and 3 prefixes of 2 rows: each rank's 3 rows end or
    start inside a prefix group (JAX's ``_dp_sb_mode`` None: its XLA path)."""
    from hydragen_torch.parallel.shard_attn import fold_segments

    assert fold_segments(0, 3, 6, 3) == [(0, 1, 2), (1, 1, 1)]
    assert fold_segments(3, 3, 6, 3) == [(1, 1, 1), (2, 1, 2)]
    jax_out, _ = _jax_generate(CFG, params[False][0], (1, 2, 1), layout=SPLIT)
    port = run_generate(_engine(CFG, params[False][1]), SPLIT)
    _hold_generate(two_ranks["ranks"], "gen_split", jax_out, port)


def test_stop_and_eos_under_dp(params, two_ranks_more):
    """EOS and a stop sequence at dp=2 with a check every 2 steps: the
    ranks agree on the finished flags (one max all-reduce a check) and
    leave the loop together; tokens equal the meshless port's and the JAX
    dp=2 engine's."""
    r = two_ranks_more["ranks"]
    for i, extra in enumerate(two_ranks_more["stops"]):
        want = run_generate(_engine(CFG, params[False][1], eos_chunk=2), STD, max_new_tokens=8,
                            **extra)[0]
        (jt, _), _ = _jax_generate(CFG, params[False][0], (1, 2, 1), max_new_tokens=8, **extra)
        got = [x["stops"]["toks"][i] for x in r]
        for g in got:
            np.testing.assert_array_equal(g, want)
            np.testing.assert_array_equal(g, jt)
        assert r[0]["stops"]["collectives"][i]["all_reduce_max"] >= 1
    assert r[0]["stops"]["toks"][0].shape[1] < 8, "the stop request should end early"


@pytest.mark.parametrize("layout", ["STD", "SPLIT"])
def test_sampling_under_dp_matches_meshless(params, two_ranks_more, layout):
    """temperature 0.8, top-p 0.9 at dp=2: every rank samples the whole
    batch's rows from one generator state (the logits gathered over dp) and
    keeps its own, so the tokens equal the meshless port's draw."""
    lay = {"STD": STD, "SPLIT": SPLIT}[layout]
    want = run_generate(_engine(CFG, params[False][1]), lay, temperature=0.8, top_p=0.9,
                        seed=5)[0]
    key = "sample_dp" if layout == "STD" else "sample_dp_split"
    for r in two_ranks_more["ranks"]:
        np.testing.assert_array_equal(r[key]["toks"], want)


def test_sp_lse_merge_against_jax(two_ranks_more):
    """``sp_lse_merge`` against ``_sp_lse_merge`` under ``shard_map``, with
    rank 1 fully masked on some rows (lse -inf, out 0)."""
    import tests.conftest  # noqa: F401
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from hydragen_tpu.parallel import make_mesh as jmesh
    from hydragen_tpu.parallel.shard_attn import _sp_lse_merge, shard_map

    o, l = _merge_inputs()

    def body(o, l):
        mo, ml = _sp_lse_merge(o[0], l[0], jnp.float32)
        return mo[None], ml[None]

    jo, jl = shard_map(body, mesh=jmesh(sp=2), in_specs=(P("sp"), P("sp")),
                       out_specs=(P("sp"), P("sp")))(jnp.asarray(o), jnp.asarray(l))
    for rank, r in enumerate(two_ranks_more["ranks"]):
        m = r["merge"]
        np.testing.assert_allclose(m["o"], np.asarray(jo)[rank], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(m["l"], np.asarray(jl)[rank], atol=1e-6, rtol=1e-6)
        assert m["collectives"] == {"all_reduce_sum": 1, "all_reduce_max": 1,
                                    "all_gather": 0}
        assert m["seconds"] > 0  # timed_collectives read both calls
    assert np.isneginf(np.asarray(jl)[0][2, 0]).all()  # the head masked on both ranks


def _merge_inputs():
    rng = np.random.RandomState(5)
    o = rng.randn(2, 3, 4, 2, 8).astype(np.float32)
    l = rng.randn(2, 3, 4, 2).astype(np.float32)
    o[1, 1], l[1, 1] = 0.0, -np.inf  # rank 1 fully masked on row 1
    o[:, 2, 0], l[:, 2, 0] = 0.0, -np.inf  # head 0 of row 2 masked on both
    return o, l


def _row_gemm_inputs():
    rng = np.random.RandomState(7)
    M, N, K, L = 16, 256, 512, 3
    x = rng.randn(M, K).astype(np.float32)
    wq = rng.randint(-127, 128, (L, N, K)).astype(np.int8)
    ws = (rng.rand(L, N) * 2e-3 + 1e-4).astype(np.float32)
    return x, wq, ws, 1


def test_row_parallel_gemm_against_jax(two_ranks_more, monkeypatch):
    """K1's row-parallel family at tp=2 (the plain version on the CPU)
    against ``sharded_qmatmul_stacked_row`` in interpret mode
    (``test_shard_attn.py:371``): per-shard row quantization, bf16 partials,
    their sum over tp."""
    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    import tests.conftest  # noqa: F401
    import jax.numpy as jnp

    from hydragen_tpu.ops.quant import QuantizedTensor as JQ
    from hydragen_tpu.parallel import make_mesh as jmesh
    from hydragen_tpu.parallel.shard_gemm import sharded_qmatmul_stacked_row

    x, wq, ws, layer = _row_gemm_inputs()
    jy = sharded_qmatmul_stacked_row(jnp.asarray(layer), jnp.asarray(x),
                                     JQ(q=jnp.asarray(wq), scale=jnp.asarray(ws)),
                                     mesh=jmesh(tp=2), interpret=True)
    jy = np.asarray(jy.astype(jnp.float32))
    for r in two_ranks_more["ranks"]:
        y = r["row_gemm"]["y"]
        assert y.shape == jy.shape
        # bf16 outputs: equal, or one bf16 step apart where the two sums round.
        np.testing.assert_allclose(y, jy, rtol=2 ** -7, atol=1e-6)


def test_collective_census(params, two_ranks_more, eight_ranks):
    """One decode step (forward and logits), ``test_comm.py``'s: exactly two
    sum all-reduces a layer and one logits all-gather at tp=2; none at dp=2;
    at sp=2 one max and one sum all-reduce a layer for the one level;
    (2, 2, 2) the sum of tp's and sp's; unsharded none."""
    L = CFG["num_hidden_layers"]
    want = {(2, 1, 1): dict(all_reduce_sum=2 * L, all_reduce_max=0, all_gather=1),
            (1, 2, 1): dict(all_reduce_sum=0, all_reduce_max=0, all_gather=0),
            (1, 1, 2): dict(all_reduce_sum=L, all_reduce_max=L, all_gather=0),
            (2, 2, 2): dict(all_reduce_sum=3 * L, all_reduce_max=L, all_gather=1)}
    for mesh in MESHES:
        for r in two_ranks_more["ranks"]:
            assert r[f"census{mesh}"] == want[mesh], mesh
    for r in eight_ranks:
        assert r["census222"] == want[(2, 2, 2)]
    assert _decode_census(CFG, params[False][1], None) == dict(
        all_reduce_sum=0, all_reduce_max=0, all_gather=0)


def test_param_layout_matches_jax():
    """The split dims of every parameter equal JAX's ``param_pspecs``
    (``test_tp.py:102``), and the slices have their shapes."""
    import tests.conftest  # noqa: F401
    import jax

    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.parallel import make_mesh as jmesh
    from hydragen_tpu.parallel import param_pspecs as jspecs
    from hydragen_torch.models.llama import init_params
    from hydragen_torch.parallel import shard_params

    mesh = Mesh(tp=4, dp=2, sp=1, rank=5, coords=dict(dp=1, sp=0, tp=1), groups={},
                device=torch.device("cpu"), backend="gloo")
    cfg = ModelConfig(**CFG)
    ours, theirs = param_pspecs(cfg, mesh), jspecs(JConfig(**CFG), jmesh(tp=4, dp=2))
    assert jax.device_count() >= 8
    for tree_o, tree_t in ((ours, theirs), (ours["layers"], theirs["layers"])):
        assert sorted(tree_o) == sorted(tree_t)
        for k, spec in tree_t.items():
            if k != "layers":
                assert tuple(spec) == tree_o[k], k
    p = shard_params(init_params(cfg, torch.Generator().manual_seed(1)), cfg, mesh)
    L, H, Hq = CFG["num_hidden_layers"], CFG["hidden_size"], 8 * 8
    assert p["layers"]["wq"].shape == (L, H, Hq // 4)
    assert p["layers"]["wo"].shape == (L, Hq // 4, H)
    assert p["layers"]["down"].shape == (L, CFG["intermediate_size"] // 4, H)
    assert p["lm_head"].shape == (H, CFG["vocab_size"] // 4)


@pytest.mark.parametrize("case", ["cache_kv8", "cache_kv8_bshd"])
def test_cache_matches_jax_sharded_cache(params, two_ranks, four_ranks, case):
    """After the request with int8 KV, the ranks' caches, their kv heads
    gathered (and their dp rows), equal the JAX sharded engine's within one
    int8 code (the KV quantizer rounds float sums that differ in the last
    bit): both levels and the unique cache. At tp=2 the unique cache is
    BHSD (the layout taken from the global heads); forced BSHD at (tp=2,
    dp=2) it keeps flat local scales ``[L, B/dp, U*hkv/tp]``, reshaped here
    to JAX's 4-D mesh scales."""
    bshd = case == "cache_kv8_bshd"
    mesh = (2, 2, 1) if bshd else (2, 1, 1)
    _, jeng = _jax_generate(CFG, params[False][0], mesh, kv_quant="int8", bshd=bshd or None)
    jc = jeng.cache
    ranks = [r[case]["cache"] for r in (four_ranks if bshd else two_ranks["ranks"])]
    assert bool(jc.unique_bshd) == bshd
    head_ax = 3 if bshd else 2

    def gathered(key, axis):
        """[dp][tp] ranks (tp minor): heads over tp, then rows over dp."""
        per_dp = [np.concatenate([ranks[d * 2 + t][key] for t in range(2)], axis=axis)
                  for d in range(len(ranks) // 2)]
        return per_dp[0] if key.startswith("l") else np.concatenate(per_dp, axis=1)

    def within_a_code(key, jq, js, axis):
        q = gathered(key, axis).astype(np.float32)
        if key.startswith("u") and bshd:  # flat [L, b, U*hkv_loc] -> [L, b, U, hkv_loc]
            for r in ranks:
                r[key + "s"] = r[key + "s"].reshape(*r[key + "s"].shape[:2], -1,
                                                    r[key].shape[3])
        s = gathered(key + "s", axis)
        jq, js = np.asarray(jq).astype(np.float32), np.asarray(js)
        assert q.shape == jq.shape and s.shape == js.shape, key
        step = np.maximum(s, js)[..., None]
        assert np.all(np.abs(q * s[..., None] - jq * js[..., None]) <= 1.0001 * step), key

    for j, jl in enumerate(jc.shared[:2]):
        within_a_code(f"l{j}k", jl.k, jl.k_scale, 2)
        within_a_code(f"l{j}v", jl.v, jl.v_scale, 2)
        np.testing.assert_array_equal(ranks[0][f"l{j}lens"], np.asarray(jl.seq_lens))
    within_a_code("uk", jc.unique_k, jc.unique_k_scale, head_ax)
    within_a_code("uv", jc.unique_v, jc.unique_v_scale, head_ax)


def _save_tiny_hf(path):
    import transformers

    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=8,
                                   num_key_value_heads=4)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(path)


@pytest.mark.parametrize("quant", HF_QUANT)
def test_from_pretrained_tp_slices_bit_equal(two_ranks_hf, quant):
    """``from_pretrained_tp`` on a tiny ``save_pretrained`` directory: each
    rank's parameters equal the host quantizers' global output (int8 with
    f32 scales, or int4 with bf16 group scales, the row-parallel families
    packed again for the rank's K slice), sliced by ``shard_params``, bit
    for bit."""
    from hydragen_torch.models import hf
    from hydragen_torch.ops.quant import Quantized4Tensor, QuantizedTensor
    from hydragen_torch.parallel import shard_params

    cfg, glob = hf.from_pretrained(two_ranks_hf["hf"], dtype="float32", quantization=quant)

    def flat(t, prefix=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
        if isinstance(t, (QuantizedTensor, Quantized4Tensor)) or (
                isinstance(t, tuple) and len(t) == 2):
            return {f"{prefix}q": np.asarray(t[0]), f"{prefix}scale": _np_bits(t[1])}
        return {prefix: _np_bits(t)}

    for r in two_ranks_hf["ranks"]:
        got = r[f"pretrained_{quant}"]
        rank = got["tp_rank"]
        mesh = Mesh(tp=2, dp=1, sp=1, rank=rank, coords=dict(dp=0, sp=0, tp=rank), groups={},
                    device=torch.device("cpu"), backend="gloo")
        want = flat(shard_params(glob, cfg, mesh))
        mine = flat(got["params"])
        assert sorted(mine) == sorted(want)
        for k in want:
            assert mine[k].dtype == want[k].dtype and np.array_equal(mine[k], want[k]), k
    if quant == "w8a8":
        assert glob["layers"]["wo"].scale.dtype == torch.float32
    else:
        assert isinstance(glob["layers"]["down"], Quantized4Tensor)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def loaded_rank_bytes(cfg, tp: int) -> int:
    """A rank's parameter bytes from the shapes under the sharding rules, for
    the loader's w8a8 output (``chip_smoke.py``'s ``expected_param_bytes``
    for a loaded model): fp32 embedding and norms of this model, int8
    payloads with f32 column scales, the MLP unpadded; q/k/v, gate/up and
    the LM head split on their columns, o and down on their rows, their
    scales whole."""
    H, V, L, I = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers, cfg.intermediate_size
    hd = cfg.head_dim
    Hq, Hkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    n = V * H * 4 + H * 4 + (V // tp) * (H + 4) + 2 * L * H * 4
    for N, K, column in ((Hq, H, True), (Hkv, H, True), (Hkv, H, True), (H, Hq, False),
                         (I, H, True), (I, H, True), (H, I, False)):
        n += L * (N // tp) * (K + 4) if column else L * N * (K // tp + 4)
    return n


@pytest.mark.parametrize("quant", HF_QUANT)
def test_from_pretrained_tp_allocates_only_the_ranks_slices(two_ranks_hf, quant):
    """Under a mesh the loader allocates each stack at the rank's shape: the
    bytes it allocated to keep (``load_stats["host_param_bytes"]``) are the
    rank's parameters' bytes, about half the meshless load's at tp=2, and
    for w8a8 exactly what the sharding rules give from the shapes. A loader
    that allocated a global stack and cut it afterwards would count the
    global bytes."""
    from hydragen_torch import HydragenLlama

    glob = HydragenLlama.from_pretrained(two_ranks_hf["hf"], dtype="float32",
                                         quantization=quant, device="cpu")
    whole = glob.load_stats["host_param_bytes"]
    assert whole == _tree_bytes(glob.params)
    for r in two_ranks_hf["ranks"]:
        got = r[f"pretrained_{quant}"]
        mine = got["load_stats"]["host_param_bytes"]
        assert mine == got["param_bytes"], (mine, got["param_bytes"])
        rep = got["replicated_bytes"]
        assert mine - rep < 0.6 * (whole - rep), (mine, whole, rep)
        assert got["load_stats"]["load_s"] > 0
        if quant == "w8a8":
            assert mine == loaded_rank_bytes(glob.config, 2)


def _np_bits(t):
    """A tensor as numpy, bf16 widened to f32 (exactly), as ``launch`` hands
    back a rank's tensors."""
    if torch.is_tensor(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


@pytest.mark.parametrize("backend,tp,graphs", [("nccl", 1, True), ("nccl", 2, True),
                                                ("gloo", 1, False), ("gloo", 2, False)])
def test_graphs_stay_on_under_nccl_only(params, backend, tp, graphs):
    """Decode graphs stay on (as on the card) under an NCCL mesh of one or
    more ranks; a gloo mesh turns them off and refuses ``graph(True)``."""
    eng = _engine(CFG, params[False][1])
    eng._use_graphs = True  # as an engine on the card starts
    mesh = Mesh(tp=tp, dp=1, sp=1, rank=0, coords=dict(dp=0, sp=0, tp=0), groups={},
                device=torch.device("cpu"), backend=backend, keep_trivial=True)
    eng._set_mesh(mesh)
    assert eng.graphs_enabled is graphs
    if backend == "gloo":
        with pytest.raises(RuntimeError, match="need NCCL"):
            eng.graph(True)


@pytest.mark.parametrize("M", [256, 2048])
@pytest.mark.parametrize("N,K", [(2048, 4096), (4096, 2048), (5632, 4096), (4096, 5632)],
                         ids=["qkv", "o", "gate_up", "down"])
def test_k1_plan_splits_k_whole_at_tp2_shapes(M, N, K):
    """K1's plan at a tp=2 rank's 7B shapes (K = 2,048 and 5,632 are new to
    it): its K split covers K's 128-byte steps exactly, none empty."""
    from hydragen_torch.ops.gemm import GEMM_BK, gemm_plan

    plan = gemm_plan(M, N, K, 132)
    steps = K // GEMM_BK
    assert K % GEMM_BK == 0
    assert (plan.splits - 1) * plan.split_steps < steps <= plan.splits * plan.split_steps
    assert steps == plan.splits * plan.split_steps, plan


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from hydragen_torch.ops import cuda_lib

    cuda_lib.build()
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [256, 2048])
@pytest.mark.parametrize("N,K", [(2048, 4096), (4096, 2048), (5632, 4096), (4096, 5632)],
                         ids=["qkv", "o", "gate_up", "down"])
def test_k1_at_tp2_shapes(card, M, N, K):
    """K1 at a tp=2 rank's 7B shapes: bit for bit the scaled exact i32
    product (``torch._int_mm``), and close to its plain version."""
    from hydragen_torch.ops import gemm

    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randint(-127, 128, (2, N, K), dtype=torch.int8, device=card, generator=g)
    ws = (torch.rand(2, N, device=card, generator=g) * 2e-3 + 1e-4).to(torch.bfloat16)
    a_q, a_s = gemm.quantize_rows(torch.randn(M, K, device=card, generator=g))
    out = gemm.w8a8_matmul_cached(1, a_q, a_s, w, ws)
    exact = (torch._int_mm(a_q, w[1].T.contiguous()).float() * a_s * ws[1].float()[None, :]
             ).to(torch.bfloat16)
    assert torch.equal(out, exact)
    assert _rel(out, gemm.w8a8_cached_plain(1, a_q, a_s, w, ws, out_dtype=torch.float32)) < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("M", [256, 2048])
@pytest.mark.parametrize("N", [2048, 5632], ids=["qkv", "gate_up"])
def test_k6_at_tp2_shapes(card, M, N):
    """K6 at a tp=2 rank's 7B column shapes (q/k/v N = 2,048, gate/up N =
    5,632 of the padded MLP, K = 4,096, group 128; decode and prefill M)
    against the f32 oracle ``w4a8_reference``: within 1e-5 of its largest
    output (``chip_smoke.py``'s ``TOL_W4A8``)."""
    from hydragen_torch.ops import gemm

    K = 4096
    g = torch.Generator(device="cuda").manual_seed(0)
    qp = torch.randint(-128, 128, (2, N, K // 2), dtype=torch.int8, device=card, generator=g)
    gs = (torch.rand(2, K // 128, N, device=card, generator=g) * 2e-3 + 1e-4).to(torch.bfloat16)
    a_q, a_s = gemm.quantize_rows(torch.randn(M, K, device=card, generator=g))
    out = gemm.w4a8_matmul_cached(1, a_q, a_s, qp, gs, out_dtype=torch.float32)
    ref = gemm.w4a8_reference(a_q, a_s, qp[1], gs[1], out_dtype=torch.float32)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.gpu
def test_column_parallel_w4a8_raises_where_k6_does_not_take_the_shape(card):
    """The column-parallel w4a8 route on a CUDA tensor at a group size K6
    does not take (32): it raises, it does not fall back to weight-only dq."""
    from hydragen_torch.ops.quant import Quantized4Tensor
    from hydragen_torch.parallel.shard_gemm import sharded_qmatmul_stacked

    w = Quantized4Tensor(qp=torch.zeros(2, 64, 64, dtype=torch.int8, device=card),
                         gscale=torch.ones(2, 4, 64, dtype=torch.bfloat16, device=card))
    x = torch.randn(1, 8, 128, device=card).to(torch.bfloat16)
    with pytest.raises(ValueError, match="group size"):
        sharded_qmatmul_stacked(x, w, 1, "bth,hd->btd", "w4a8")


@pytest.mark.gpu
@pytest.mark.parametrize("heads,S", [(16, 2048), (32, 1024)], ids=["tp2", "sp2"])
def test_k2_at_sharded_level_reads(card, heads, S):
    """K2 at a tp=2 rank's 16 heads and an sp=2 rank's 1,024-token slice,
    int8, read in place from the second of two prefix rows and a masked
    one (an sp rank past a prefix's end: out 0, lse -inf)."""
    from hydragen_torch.ops import flash

    g = torch.Generator(device="cuda").manual_seed(1)
    shape = (2, 3, heads, S, 128)
    k, v = (torch.randint(-127, 128, shape, dtype=torch.int8, device=card, generator=g)
            for _ in range(2))
    ks, vs = (torch.rand(shape[:-1], device=card, generator=g) * 0.02 + 1e-3 for _ in range(2))
    q = torch.randn(2, heads, 256, 128, device=card, generator=g).to(torch.bfloat16)
    lens = torch.tensor([S - 5, 0], dtype=torch.int32, device=card)
    kw = dict(kv_seq_lens=lens, k_scale_all=ks, v_scale_all=vs, row_start=1)
    o, lse = flash.flash_attention_cached_bhsd(1, q, k, v, **kw)
    po, plse = flash.flash_attention_cached_plain(1, q, k, v, **kw)
    assert _rel(o, po) < 2e-2
    assert float((lse[0] - plse[0]).abs().max()) < 2e-2
    assert torch.isneginf(lse[1]).all() and torch.isneginf(plse[1]).all()
    assert float(o[1].abs().max()) == 0.0


@pytest.mark.gpu
def test_k4_and_k3_at_tp2_heads(card):
    """K4 (causal prefill) and K3 (the unique read with the own token and
    the shared partial merged, flat local scales) at a tp=2 rank's 16
    heads."""
    from hydragen_torch.ops import decode, flash

    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(1, 16, 1024, 128, device=card, generator=g).to(torch.bfloat16)
               for _ in range(3))
    o, lse = flash.flash_attention_bhsd(q, k, v, causal=True)
    po, plse = flash.flash_attention_bhsd_plain(q, k, v, causal=True)
    assert _rel(o, po) < 2e-2 and float((lse - plse).abs().max()) < 2e-2
    B, S, h = 64, 64, 16
    ck, cv = (torch.randint(-127, 128, (2, B, S, h, 128), dtype=torch.int8, device=card,
                            generator=g) for _ in range(2))
    cks, cvs = (torch.rand(2, B, S * h, device=card, generator=g) * 0.02 + 1e-3
                for _ in range(2))
    qd = torch.randn(B, h, 1, 128, device=card, generator=g).to(torch.bfloat16)
    own = tuple(torch.randn(B, h, 1, 128, device=card, generator=g).to(torch.bfloat16)
                for _ in range(2))
    sh = (torch.randn(B, h, 1, 128, device=card, generator=g).to(torch.bfloat16),
          torch.randn(B, h, 1, device=card, generator=g))
    kw = dict(kv_seq_lens=torch.full((B,), S - 1, dtype=torch.int32, device=card),
              k_scale_all=cks, v_scale_all=cvs, own_kv=own, shared_partial=sh, kv_bits=8)
    o, lse = decode.decode_attention_cached(1, qd, ck, cv, **kw)
    po, plse = decode.decode_attention_cached_plain(1, qd, ck, cv, **kw)
    assert _rel(o, po) < 2e-2 and float((lse - plse).abs().max()) < 2e-2


def _gloo_card_rank(rank, world, seed):
    """Two ranks on one card over gloo: a 2-layer 7B-width w8a8 engine at
    tp=2 through the eager loop."""
    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params
    import dataclasses

    cfg = dataclasses.replace(PRESETS["llama-2-7b"], num_hidden_layers=2)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, g, quantized="w8a8", device="cuda")
    mesh = make_mesh(tp=2, device="cuda:0")
    eng = HydragenLlama(cfg, params, quantization="w8a8", mesh=mesh)
    del params
    prompt = torch.randint(1, cfg.vocab_size, (1, 256), generator=g, device="cuda")
    eng.setup_caches(16, 32, [1], [256], kv_quant="int8")
    toks, logits = eng.generate(input_ids=[prompt], num_return_sequences=16, max_new_tokens=8,
                                temperature=0.0, return_logits=True,
                                shared_cache_op=SharedCacheOp.WIPE)
    return dict(toks=toks, logits=torch.stack(logits), graphs=eng.graphs_enabled)


@pytest.mark.gpu
def test_gloo_two_ranks_on_one_card_match_meshless(card):
    """Two gloo ranks sharing one card at tp=2 against the meshless engine
    on the same weights: tokens equal on both ranks, logits close (the
    row-parallel quantization is per shard), no graphs under gloo."""
    import dataclasses

    from hydragen_torch.models.config import PRESETS
    from hydragen_torch.models.llama import init_params

    ranks = launch(_gloo_card_rank, 2, 0, timeout=600)
    cfg = dataclasses.replace(PRESETS["llama-2-7b"], num_hidden_layers=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, g, quantized="w8a8", device="cuda")
    eng = HydragenLlama(cfg, params, quantization="w8a8")
    prompt = torch.randint(1, cfg.vocab_size, (1, 256), generator=g, device="cuda")
    eng.setup_caches(16, 32, [1], [256], kv_quant="int8")
    # The meshless engine on the ranks' token stream (greedy streams part at
    # near ties: the row-parallel quantization is per shard).
    _, logits = eng.generate(input_ids=[prompt], num_return_sequences=16, max_new_tokens=8,
                             temperature=0.0, return_logits=True,
                             token_overrides=torch.as_tensor(ranks[0]["toks"]).cuda(),
                             shared_cache_op=SharedCacheOp.WIPE)
    np.testing.assert_array_equal(ranks[0]["toks"], ranks[1]["toks"])
    assert not ranks[0]["graphs"]
    ref = torch.stack(logits).float().cpu().numpy()
    got = ranks[0]["logits"]
    for step in range(len(ref)):
        rms = np.linalg.norm(got[step] - ref[step]) / np.linalg.norm(ref[step])
        assert rms < 0.2, (step, rms)
