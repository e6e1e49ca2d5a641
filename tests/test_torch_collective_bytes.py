"""The collectives' byte counter and host ranges (``parallel/mesh.py``).

Every counted collective adds the bytes it is handed to
``COLLECTIVE_BYTES``: a low-precision sum its f32 copy, a gather the
rank's piece. Held exactly at tp=2 over two gloo ranks (one spawn shared
by the cases): call by call, over one decode step of a tp engine, and
through ``captured_collectives`` / ``add_collectives``, which carry a
graph's counts to each replay. While a profiler records, a tp forward
shows the ``hg.all_reduce`` and ``hg.all_gather`` ranges. On the card a
one-rank NCCL mesh's decode graphs count, replay by replay, what its eager
loop counts (``-m gpu``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
from hydragen_torch.models.llama import init_params
from hydragen_torch.parallel import launch
from hydragen_torch.parallel import mesh as mesh_lib

CFG = ModelConfig(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, dtype="float32")
B, T = 4, 5  # rows, suffix tokens


def counters() -> tuple:
    return dict(mesh_lib.COLLECTIVES), dict(mesh_lib.COLLECTIVE_BYTES)


def delta(after: tuple, before: tuple) -> tuple:
    return tuple({k: a[k] - b[k] for k in a if a[k] != b[k]} for a, b in zip(after, before))


def engine(mesh, device="cpu", cfg=CFG):
    params = init_params(cfg, torch.Generator().manual_seed(3))
    eng = HydragenLlama(cfg, params, device=device, mesh=mesh)
    eng.setup_caches(B, T + 8, [1], [16])
    return eng


def request(new: int) -> dict:
    r = np.random.default_rng(5)
    return dict(input_ids=[r.integers(1, CFG.vocab_size, (1, 12)),
                           r.integers(1, CFG.vocab_size, (B, T))],
                max_new_tokens=new, temperature=0.0, shared_cache_op=SharedCacheOp.WIPE)


def _rank(rank, world):
    from hydragen_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(tp=world, device="cpu")
    out = {}
    mesh_lib.reset_collectives()
    calls = []
    for x, op in ((torch.ones(3, 5, dtype=torch.bfloat16), "sum"),
                  (torch.ones(2, 7), "max"), (torch.ones(4, dtype=torch.int32), "gather")):
        before = counters()
        if op == "gather":
            mesh_lib.all_gather(x, mesh, "tp")
        else:
            mesh_lib.all_reduce(x, op, mesh, "tp")
        calls.append(delta(counters(), before))
    out["calls"] = calls

    into, nbytes = {}, {}
    before = counters()
    with mesh_lib.captured_collectives(into, nbytes):
        mesh_lib.all_reduce(torch.ones(8, 4, dtype=torch.bfloat16), "sum", mesh, "tp")
        mesh_lib.all_gather(torch.ones(6), mesh, "tp")
    out["captured"] = (into, nbytes, delta(counters(), before))
    for _ in range(3):
        mesh_lib.add_collectives(into, nbytes)
    out["replayed"] = delta(counters(), before)

    eng = engine(mesh)
    steps = {}
    for new in (2, 3):
        before = counters()
        eng.generate(**request(new))
        steps[new] = delta(counters(), before)
    out["steps"] = steps

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.generate(**request(2))
    out["ranges"] = sorted({e.name for e in prof.events() if e.name.startswith("hg.")})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_parallel import _once  # JAX's, not on the card

    return _once(tmp_path_factory, "collective_bytes", lambda: launch(_rank, 2, timeout=300))


def test_each_collective_counts_the_bytes_it_is_handed(ranks):
    for res in ranks:
        (c0, b0), (c1, b1), (c2, b2) = res["calls"]
        assert (c0, b0) == ({"all_reduce_sum": 1}, {"all_reduce_sum": 3 * 5 * 4})  # f32 copy
        assert (c1, b1) == ({"all_reduce_max": 1}, {"all_reduce_max": 2 * 7 * 4})
        assert (c2, b2) == ({"all_gather": 1}, {"all_gather": 4 * 4})


def test_a_capture_keeps_its_counts_for_each_replay(ranks):
    for res in ranks:
        into, nbytes, during = res["captured"]
        assert during == ({}, {})
        assert into == {"all_reduce_sum": 1, "all_gather": 1}
        assert nbytes == {"all_reduce_sum": 8 * 4 * 4, "all_gather": 6 * 4}
        assert res["replayed"] == ({"all_reduce_sum": 3, "all_gather": 3},
                                   {"all_reduce_sum": 3 * 128, "all_gather": 3 * 24})


def test_a_tp_decode_step_counts_its_partials_and_logits(ranks):
    L, H, V = CFG.num_hidden_layers, CFG.hidden_size, CFG.vocab_size
    for res in ranks:
        c2, b2 = res["steps"][2]
        c3, b3 = res["steps"][3]
        # One more step: two sum all-reduces a layer of the rows' [B, H]
        # partials (f32), one gather of each rank's half of the logits.
        assert {k: c3[k] - c2.get(k, 0) for k in c3} == {"all_reduce_sum": 2 * L,
                                                         "all_gather": 1}
        assert {k: b3[k] - b2.get(k, 0) for k in b3} == {"all_reduce_sum": 2 * L * B * H * 4,
                                                         "all_gather": B * V // 2 * 4}


def test_a_profiled_tp_forward_shows_the_collectives_ranges(ranks):
    for res in ranks:
        assert {"hg.all_reduce", "hg.all_gather", "hg.generate"} <= set(res["ranges"])


@pytest.mark.gpu
def test_nccl_graph_replays_count_the_eager_loops_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graphs run only there")
    import datetime

    import torch.distributed as dist

    from hydragen_torch.parallel import make_mesh

    if not dist.is_initialized():
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{mesh_lib._free_port()}",
                                world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(tp=1, device="cuda:0", keep_trivial=True)
    got = {}
    for graphs in (False, True):
        # The card's attention kernels take head sizes 64 and 128.
        eng = engine(mesh, "cuda:0", dataclasses.replace(CFG, hidden_size=256,
                                                          dtype="bfloat16"))
        eng.graph(graphs)
        eng.generate(**request(6))  # the graph's warm-up and capture
        before = counters()
        eng.generate(**request(6))
        got[graphs] = delta(counters(), before)
    assert got[True] == got[False] and got[True][1]["all_reduce_sum"] > 0
