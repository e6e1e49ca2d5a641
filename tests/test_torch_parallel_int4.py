"""The port's int4 weights under a mesh against the JAX package.

``quantization="w4a8"``, ``"int4"`` (weight-only) and ``"mixed"`` (int8 with
an int4 ``down``) over gloo CPU ranks, each case held to the JAX engine on
the same ``(tp, dp, sp)`` of the 8-device CPU mesh (its Pallas GEMMs in
interpret mode), fp32, with the ranks' quantizations held to JAX's by the
tie rule of ``tests/test_torch_ties.py`` (ties resolved to JAX's codes and
scales, every pass held). Also: each rank's int4 slices against the global
weight, bit for bit (column, row and mixed families; the group count
divisible by tp or not); ``shard`` of an int4 engine; tp=4 weight-only int4
with 8 heads over 4 kv heads against the meshless port and JAX; the int4
unique cache refused under a mesh, as the reference cannot shard it. K6
at a tp=2 rank's 7B shapes on the card: ``tests/test_torch_parallel.py``
(``-m gpu --noconftest``).

The spawned ranks run ``tests/test_torch_parallel.py``'s ``_rank_cases``;
JAX is imported in test bodies and fixtures only.
"""

import numpy as np
import pytest
import torch

from hydragen_torch import HydragenLlama, ModelConfig
from hydragen_torch.models.convert import params_from_numpy
from hydragen_torch.parallel import launch
from hydragen_torch.parallel.mesh import Mesh
from tests.test_torch_parallel import (
    CFG,
    CFG_W8,
    STD,
    TIMEOUT,
    W8_KEY,
    _hold_generate,
    _jax_params,
    _np_params,
    _once,
    _rank_cases,
    _same_on_every_rank,
    _shard_after_prefill,
    hold_resolved,
    jax_resolved_case,
)

torch.set_num_threads(1)

# Two prompts on the first level: every forward's rows divide over dp=2, so
# the JAX engine keeps its s8 GEMMs there (its shard_map GEMMs need the rows
# split over dp, and a one-prompt prefill at dp=2 runs weight-only dq in JAX,
# where the port runs K1; ROADMAP.md §3).
DP_ROWS = dict(levels=[2, 4], lens=[8, 4], shared=(2, 6), suffix=(4, 3), samples=2, B=8)
# tests/test_quant.py:174's model: 8 query heads over 4 kv heads, at tp=4.
CFG_T4 = dict(vocab_size=128, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=4, dtype="float32")


@pytest.fixture(scope="module")
def params():
    return {False: _jax_params(CFG), True: _jax_params(CFG_W8, W8_KEY),
            "t4": _jax_params(CFG_T4)}


def _t4_request(eng):
    """tests/test_quant.py:174's request: one 6-token prompt, 4 greedy
    samples of 4 tokens."""
    from hydragen_torch import SharedCacheOp

    prompt = np.random.RandomState(0).randint(1, 128, (1, 6)).astype(np.int32)
    eng.setup_caches(4, 16, [1], [8])
    toks, logits = eng.generate(input_ids=[prompt], num_return_sequences=4, max_new_tokens=4,
                                temperature=0.0, return_logits=True,
                                shared_cache_op=SharedCacheOp.WIPE)
    return np.asarray(toks), np.stack([np.asarray(x) for x in logits])


def t4_rank(rank, world, params_np):
    """A rank of the tp=4 weight-only int4 case."""
    from hydragen_torch.parallel import make_mesh

    torch.set_num_threads(1)
    eng = HydragenLlama(ModelConfig(**CFG_T4), params_from_numpy(params_np), device="cpu",
                        quantization="int4", mesh=make_mesh(tp=4, device="cpu"))
    return dict(zip(("toks", "logits"), _t4_request(eng)))


@pytest.fixture(scope="module")
def int4_two(params, tmp_path_factory):
    """The tp=2 cases, in one spawn of two ranks."""
    def compute():
        jax_out, cases = {}, {}
        for key, quant, forced in (("w4a8_tp2", "w4a8", True), ("int4_tp2", "int4", False),
                                   ("mixed_tp2", "mixed", True)):
            jax_out[key], cases[key] = jax_resolved_case(params, (2, 1, 1), quant,
                                                         forced=forced)
        cases["shard_int4"] = ("shard", ((2, 1, 1), "int4"))
        ranks = launch(_rank_cases, 2, cases, _np_params(params), timeout=TIMEOUT)
        return dict(ranks=ranks, jax=jax_out)

    return _once(tmp_path_factory, "int4_two", compute)


@pytest.fixture(scope="module")
def int4_four(params, tmp_path_factory):
    """The four-rank cases: tp=2 x dp=2, tp=2 x sp=2, and tp=4."""
    def compute():
        jax_out, cases = {}, {}
        for key, mesh, quant, layout in (("int4_tp2dp2", (2, 2, 1), "int4", STD),
                                         ("mixed_tp2dp2", (2, 2, 1), "mixed", DP_ROWS),
                                         ("w4a8_tp2sp2", (2, 1, 2), "w4a8", STD)):
            jax_out[key], cases[key] = jax_resolved_case(params, mesh, quant, layout=layout)
        ranks = launch(_rank_cases, 4, cases, _np_params(params), timeout=TIMEOUT)
        t4 = launch(t4_rank, 4, params["t4"][1], timeout=TIMEOUT)
        return dict(ranks=ranks, jax=jax_out, t4=t4)

    return _once(tmp_path_factory, "int4_four", compute)


def _count_routes(ranks, key):
    return [r[key]["routes"] for r in ranks]


# ---------------------------------------------------------------------------
# Against JAX on the same mesh
# ---------------------------------------------------------------------------


def test_w4a8_tp2_against_jax_sharded(params, int4_two):
    """w4a8 at tp=2 with int8 KV: the column families on K6 per rank (JAX's
    per-shard w4a8 GEMM takes each of them here, ``_w4a8_blocks``), the
    row-parallel ``wo``/``down`` on the weight-only dq partial and the sum
    all-reduce; tokens equal JAX's, logits of the request and of a forced
    stream within 1e-3."""
    from hydragen_tpu.ops.quant import _w4a8_blocks

    c, tp = CFG_W8, 2
    H, I = c["hidden_size"], c["intermediate_size"]
    Hq = Hkv = H  # 4 heads over 4 kv heads of 64
    for N, K in ((Hq // tp, H), (Hkv // tp, H), (I // tp, H)):
        assert _w4a8_blocks(N, K, 128) is not None, (N, K)
    hold_resolved(int4_two["ranks"], "w4a8_tp2", int4_two["jax"]["w4a8_tp2"])
    L = c["num_hidden_layers"]
    for routes in _count_routes(int4_two["ranks"], "w4a8_tp2"):
        # q, k, v, gate, up on K6 in every pass of every layer; no K1.
        assert routes["w4a8"] > 0 and routes["w4a8"] % (5 * L) == 0 and routes["w8a8"] == 0


@pytest.mark.parametrize("key", ["int4_tp2", "int4_tp2dp2"])
def test_int4_weight_only_against_jax_sharded(int4_two, int4_four, key):
    """Weight-only int4 (every family dq, the row-parallel ones on each
    rank's locally packed K slice, then the all-reduce) with int8 KV at
    tp=2 and tp=2 x dp=2: tokens equal JAX's, logits within 1e-3, no s8
    GEMM."""
    run = int4_two if key == "int4_tp2" else int4_four
    hold_resolved(run["ranks"], key, run["jax"][key])
    for routes in _count_routes(run["ranks"], key):
        assert routes == {"w4a8": 0, "w8a8": 0}


@pytest.mark.parametrize("key", ["mixed_tp2", "mixed_tp2dp2"])
def test_mixed_against_jax_sharded(int4_two, int4_four, key):
    """"mixed" (int8 with an int4 ``down``) at tp=2 and tp=2 x dp=2: K1 for
    the int8 families (row-parallel ``wo`` on per-shard row scales), the int4
    ``down`` on the dq partial; tokens equal JAX's, logits within 1e-3."""
    run = int4_two if key == "mixed_tp2" else int4_four
    hold_resolved(run["ranks"], key, run["jax"][key])
    L = CFG_W8["num_hidden_layers"]
    for routes in _count_routes(run["ranks"], key):
        assert routes["w8a8"] > 0 and routes["w8a8"] % (6 * L) == 0 and routes["w4a8"] == 0


def test_w4a8_tp2_sp2_against_jax_sharded(int4_four):
    """w4a8 at tp=2 x sp=2 (each level's sequence split, the weights
    replicated over sp): tokens equal JAX's, logits within 1e-3."""
    hold_resolved(int4_four["ranks"], "w4a8_tp2sp2", int4_four["jax"]["w4a8_tp2sp2"])


def test_int4_tp4_replicated_heads_matches_meshless_and_jax(params, int4_four):
    """``tests/test_quant.py:174``'s case: weight-only int4 at tp=4 with 8
    query heads over 4 kv heads (``wo``'s 2 groups do not divide over 4
    ranks: each rank's scales are the 64-wide subgroups of its K slice).
    Tokens equal the meshless port's and the JAX engine's at tp=4; logits
    within 1e-4 of both (fp32, no quantized activations)."""
    import tests.conftest  # noqa: F401
    from hydragen_tpu.core.engine import HydragenLlama as JEngine
    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.parallel import make_mesh as jmesh

    jeng = JEngine(JConfig(**CFG_T4), params["t4"][0], quantization="int4", mesh=jmesh(tp=4))
    meshless = HydragenLlama(ModelConfig(**CFG_T4), params_from_numpy(params["t4"][1]),
                             device="cpu", quantization="int4")
    ranks = [{"t4": r} for r in int4_four["t4"]]
    _hold_generate(ranks, "t4", _t4_request(jeng), _t4_request(meshless))


def test_shard_int4_engine_after_prefill_matches_unsharded(params, int4_two):
    """``shard(mesh)`` of a weight-only int4 engine whose level is written:
    its int4 weights are sliced (the row families packed again) and the
    next request equals the meshless engine's."""
    want = _shard_after_prefill(params[False][1], None, "int4")
    np.testing.assert_array_equal(_same_on_every_rank(int4_two["ranks"], "shard_int4", "toks"),
                                  want[0])
    np.testing.assert_allclose(_same_on_every_rank(int4_two["ranks"], "shard_int4", "logits"),
                               want[1], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The layout, and what still raises
# ---------------------------------------------------------------------------


def _mesh(tp, rank, dp=1):
    return Mesh(tp=tp, dp=dp, sp=1, rank=rank, coords=dict(dp=0, sp=0, tp=rank), groups={},
                device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("quant", ["int4", "mixed"])
@pytest.mark.parametrize("tp", [2, 4])
def test_int4_slices_dequantize_to_the_global_slices(quant, tp):
    """Each rank's int4 weights, dequantized, equal the rank's slice of the
    globally dequantized weight bit for bit: q/k/v/gate/up on their output
    columns, ``wo``/``down`` on a contiguous K range in the rank's own planar
    pack. At tp=4 ``wo``'s 2 groups do not divide over the ranks (its scales
    go to 64-wide subgroups of each rank's K slice), where ``down``'s 4
    groups do; at tp=2 both divide. The weight-only product on the slices,
    summed over the ranks, gives the global product within 1e-5."""
    from hydragen_torch.models.llama import init_params
    from hydragen_torch.ops.quant import (
        Quantized4Tensor,
        QuantizedTensor,
        dequantize4,
        qmatmul,
        quantize_params,
    )
    from hydragen_torch.parallel import shard_params

    cfg = ModelConfig(**CFG_T4)
    glob = quantize_params(init_params(cfg, torch.Generator().manual_seed(3)),
                           bits=4 if quant == "int4" else 8,
                           bits4_families=("down",) if quant == "mixed" else ())
    lg = glob["layers"]
    assert isinstance(lg["down"], Quantized4Tensor) and lg["down"].gscale.shape[-2] % tp == 0
    if quant == "int4":
        assert lg["wo"].gscale.shape[-2] % tp == (0 if tp == 2 else 2)
    rank_layers = [shard_params(glob, cfg, _mesh(tp, rank))["layers"] for rank in range(tp)]
    for rank, lp in enumerate(rank_layers):
        for fam in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
            g, loc = lg[fam], lp[fam]
            if not isinstance(g, Quantized4Tensor):  # "mixed": an int8 family
                assert isinstance(loc, QuantizedTensor), fam
                continue
            assert isinstance(loc, Quantized4Tensor), fam
            full, mine = dequantize4(g, torch.float32), dequantize4(loc, torch.float32)
            col = fam not in ("wo", "down")
            dim = 2 if col else 1
            size = full.shape[dim] // tp
            want = full.narrow(dim, rank * size, size)
            assert mine.shape == want.shape and torch.equal(mine, want), (fam, rank)
            if not col:  # the rank's own pack: K / (2 tp) bytes a row
                assert loc.qp.shape[-1] == g.qp.shape[-1] // tp, fam
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5, 512).astype(np.float32))
    for fam in ("wo", "down"):
        g = lg[fam]
        if not isinstance(g, Quantized4Tensor):
            continue
        K = g.in_features
        xs = x[..., :K]
        parts = sum(qmatmul(xs[..., r * K // tp:(r + 1) * K // tp],
                            Quantized4Tensor(*(t[1] for t in rank_layers[r][fam])),
                            "bti,ih->bth")
                    for r in range(tp))
        whole = qmatmul(xs, Quantized4Tensor(g.qp[1], g.gscale[1]), "bti,ih->bth")
        np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=fam)


def test_int4_unique_cache_under_a_mesh_raises_as_the_reference_cannot_shard_it():
    """``kv_quant="int4"`` under a mesh raises ``NotImplementedError`` in
    ``setup_caches`` and ``shard`` (an int4 engine's weights shard; its
    int4 unique cache does not), naming the reference's gap; and the JAX
    engine's ``shard_cache`` does fail on an int4 unique cache, so this test
    notices the day the reference gains it."""
    import tests.conftest  # noqa: F401
    from hydragen_tpu.core.engine import HydragenLlama as JEngine
    from hydragen_tpu.models.config import ModelConfig as JConfig
    from hydragen_tpu.parallel import make_mesh as jmesh
    from hydragen_torch.models.llama import init_params

    cfg = ModelConfig(**CFG_W8)
    p = init_params(cfg, torch.Generator().manual_seed(0))
    eng = HydragenLlama(cfg, p, device="cpu", quantization="w4a8", mesh=_mesh(2, 0))
    eng.setup_caches(4, 16, [1], [16], kv_quant="int8")  # int8 KV shards
    with pytest.raises(NotImplementedError, match="JAX reference"):
        eng.setup_caches(4, 16, [1], [16], kv_quant="int4")
    meshless = HydragenLlama(cfg, p, device="cpu", quantization="w4a8")
    meshless.setup_caches(4, 16, [1], [16], kv_quant="int4")
    with pytest.raises(NotImplementedError, match="JAX reference"):
        meshless.shard(_mesh(2, 0))
    jeng = JEngine(JConfig(**CFG_W8), _jax_params(CFG_W8)[0], quantization="int4",
                   mesh=jmesh(tp=2))
    with pytest.raises(ValueError, match="Mismatch custom node data"):
        jeng.setup_caches(4, 16, [1], [16], kv_quant="int4")
