"""The tensor-parallel cell's harness (``ranks.py``, ``drivers/generate_tp.py``
and the collectives' readers), on the CPU.

The weights a rank draws a tensor at a time equal ``make_weights`` cut by
the program's ``shard_params``, tensor by tensor. A tiny ``generate_tp`` cell,
written as new files, runs through ``run.run_cell`` over four gloo ranks
and comes back correct, traced or not, with the control failing where it
passes; a follower that raises ends the run nonzero within a minute. The
three readers give their definitions' numbers on made-up timelines; on a
program without the collectives' ranges the prefill's reader reads nothing,
and the roofline, counted from the shapes, reads as before."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import pytest
import torch

from portbench import calibrate, collectives, port, ranks, run, spans
from portbench.cell import make_weights
from portbench.tests import tiny
from portbench.timeline import Op, Timeline

PKG = Path(run.__file__).resolve().parent
CPU = torch.device("cpu")
# 8 query heads a kv head and kv heads, MLP channels and vocabulary split
# four ways, as DeepSeek-LLM-67B's at tp=4.
CONFIG = dict(tiny.CONFIG, hidden_size=128, num_attention_heads=16, num_key_value_heads=4,
              intermediate_size=344, serving=dict(tiny.CONFIG["serving"], chips=4, tp=4))
GEN = dict(tiny.GEN, kind="generate_tp")
NEW = ("collective_ms_per_step.tp", "prefill_collective_ms.tp", "allreduce_roofline.tp")
AR = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
AG = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
K1 = "void w8a8_kernel<2, 128, __nv_bfloat16, float>(CUtensorMap)"
RAISING = '''
from portbench.drivers import generate_tp


class Driver(generate_tp.Driver):
    def generate(self, call, new):
        if self.rank == 2 and call >= 0:
            raise RuntimeError("a follower's fault")
        return super().generate(call, new)
'''


def make_bench(root: Path, traffic: dict = GEN, driver: str = "") -> Path:
    """The tiny benchmark with the tp configuration and mix, its generate
    cell on four chips and the three readers listed for it."""
    tiny.make_bench(root, config=CONFIG, gen=traffic)
    if driver:
        (root / "bench" / "drivers").mkdir()
        (root / "bench" / "drivers" / f"{traffic['kind']}.py").write_text(driver)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][0]["chips"] = 4
    for name in NEW:
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "device_trace", "layer": "collectives",
                                   "moves": "gen_tok_s", "workloads": ["tiny-gen"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def fake_mesh(rank: int):
    from hydragen_torch.parallel.mesh import Mesh

    return Mesh(tp=4, dp=1, sp=1, rank=rank, coords={"dp": 0, "sp": 0, "tp": rank},
                groups={}, device=CPU, backend="gloo")


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, tuple):
        for k, v in zip(tree._fields, tree):
            yield path + (k,), v
    else:
        yield path, tree


@pytest.mark.parametrize("rank", range(4))
def test_a_ranks_draw_equals_make_weights_cut_by_shard_params(rank):
    from hydragen_torch.parallel.sharding import shard_params

    seed, mesh = 2**40 + 9, fake_mesh(rank)
    whole = shard_params(port.port_params(make_weights(CONFIG, seed, CPU)),
                         port.model_config(CONFIG), mesh, CPU)
    mine = ranks.rank_params(CONFIG, seed, CPU, mesh)
    a, b = dict(leaves(dict(mine))), dict(leaves(whole))
    assert a.keys() == b.keys() and len(a) == 20
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # The split families hold a quarter: q's heads, o's input channels.
    assert mine["layers"]["wq"].q.shape == (2, 32, 128)
    assert mine["layers"]["wo"].q.shape == (2, 128, 32)
    assert mine["lm_head"].q.shape == (384 // 4, 128)


def test_a_tp_cell_added_as_new_files_runs_on_four_ranks(tmp_path):
    root = make_bench(tmp_path)
    res = run.run_cell(root, "tiny-gen", 2**31 + 5, 0.3, False, CPU)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 16
    assert set(res["metrics"]) == {"gen_tok_s", "setup_s"}
    assert res["device"]["count"] == 4
    traced = run.run_cell(root, "tiny-gen", 2**31 + 7, 0.3, True, CPU)
    assert traced["correct"] and traced["failed"] == 0
    # No device on the CPU: the three readers read nothing, and raise nothing.
    assert set(traced["metrics"]) == {"calls_per_s.gen"}


def test_the_control_fails_where_the_tp_program_passes(tmp_path):
    root = make_bench(tmp_path)
    r = calibrate.readings(root, "tiny-gen", 3, 0.3, True, CPU)
    assert r["failed"] == 0
    assert r["program_correct"] is True and r["control_correct"] is False, r


def test_a_follower_that_raises_ends_the_run_nonzero(tmp_path):
    root = make_bench(tmp_path, dict(GEN, kind="generate_tp_raise"), RAISING)
    code = textwrap.dedent(f"""
        import sys, torch
        from pathlib import Path
        sys.path.insert(0, {str(PKG.parent)!r})
        from portbench import run
        torch.set_num_threads(1)
        run.run_cell(Path({str(root)!r}), "tiny-gen", 4, 0.3, False, torch.device("cpu"))
        print("returned")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=PKG.parent, timeout=120)
    assert out.returncode != 0 and "returned" not in out.stdout
    # Rank 0's watchdog stops the run, or rank 0's own collective fails first.
    assert "a follower's fault" in out.stderr
    assert time.monotonic() - t < 60


def reader(name):
    return run.load_module(PKG / "metrics" / f"{name}.py", "test_" + name.replace(".", "_")).read


def traced_call(nbytes=None) -> run.Record:
    """A traced call of three new tokens: NCCL's kernels in the decode loop
    and the prefill, the rest K1's."""
    dev = [Op(K1, 1.0, 1.2), Op(AR, 1.2, 1.5), Op(AG, 1.5, 1.6),  # prefill
           Op(K1, 5.0, 5.1), Op(AR, 5.1, 5.15), Op(AR, 5.2, 5.25), Op(AG, 5.3, 5.31),
           Op(K1, 6.0, 6.1), Op(AR, 6.1, 6.15), Op(AR, 6.2, 6.25), Op(AG, 6.3, 6.31),
           Op("nccl:all_reduce", 6.1, 6.16)]  # the process group's range, no kernel
    harness = [Op("pb.call", 0.5, 9.5), Op("pb.decode", 4.9, 9.0)]
    d = types.SimpleNamespace(records={}, P=100, b=4, t=25, n=3)
    if nbytes is not None:
        d.records["collective_bytes"] = {"all_reduce_sum": nbytes, "all_gather": 10}
    return run.Record(types.SimpleNamespace(config=CONFIG), d,
                      Timeline(dev, harness, harness, Op("pb.window", 0.4, 9.6)))


def prefill(with_ranges: bool) -> spans.Prefill:
    """A profiled prefill: one all-reduce's cast, kernel and cast back under
    ``hg.all_reduce`` in each prefill span, a gather's under ``hg.all_gather``,
    K1 outside them, and an all-reduce outside both prefills."""
    sp = [Op("hg.generate", 0.5, 5.0), Op("hg.shared_prefill", 1.0, 2.0),
          Op("hg.unique_prefill", 2.1, 2.9)]
    if with_ranges:
        sp += [Op("hg.all_reduce", 1.2, 1.4), Op("hg.all_reduce", 2.2, 2.3),
               Op("hg.all_gather", 2.5, 2.6), Op("hg.all_reduce", 3.2, 3.3)]
    at = ((1.1, 1), (1.25, 2), (1.3, 3), (1.35, 4), (2.25, 5), (2.55, 6), (3.25, 7))
    launches = [spans.Launch("cudaLaunchKernel", t, c) for t, c in at]
    ew = "void at::native::vectorized_elementwise_kernel<4>(int)"
    dev = [spans.DeviceOp(K1, 6.0, 6.5, 1), spans.DeviceOp(ew, 6.5, 6.6, 2),
           spans.DeviceOp(AR, 6.6, 7.0, 3), spans.DeviceOp(ew, 7.0, 7.1, 4),
           spans.DeviceOp(AR, 7.2, 7.5, 5), spans.DeviceOp(AG, 7.5, 7.55, 6),
           spans.DeviceOp(AR, 8.0, 8.2, 7)]
    return spans.Prefill(sp, launches, dev, tokens_run=100)


def test_the_collectives_readers_give_their_numbers():
    rec = traced_call(nbytes=9e9)
    # NCCL in the decode loop: 2 x (0.05 + 0.05 + 0.01) s over 2 steps.
    assert reader("collective_ms_per_step.tp")(rec) == pytest.approx(110.0)
    # Two bf16 [tokens, 128] partials a layer, 2 layers, over the prompt's
    # 100 tokens, 4 rows x 25 suffix tokens and 4 rows x 2 decode steps.
    nbytes = collectives.allreduce_bytes(CONFIG, 100, 4, 25, 3)
    assert nbytes == 2 * 2 * (100 + 100 + 8) * 128 * 2
    assert collectives.allreduce_bytes(dict(CONFIG, serving=dict(
        CONFIG["serving"], compute_dtype="float32")), 100, 4, 25, 3) == 2 * nbytes
    # 9 GB at 450 GB/s is 20 ms; the floor, over the all-reduce kernels' 0.5 s.
    assert collectives.allreduce_floor_s(9e9) == pytest.approx(0.02)
    assert reader("allreduce_roofline.tp")(rec) == pytest.approx(100 * nbytes / 450e9 / 0.5)
    rec.driver.records[spans.RECORD] = prefill(True)
    # Under the ranges in the prefills: 6.5-7.1 and 7.2-7.55, busy.
    assert reader("prefill_collective_ms.tp")(rec) == pytest.approx(950.0)


def test_a_program_without_ranges_or_byte_counts_reads_nothing(capsys):
    rec = traced_call()
    rec.driver.records[spans.RECORD] = prefill(False)
    assert reader("prefill_collective_ms.tp")(rec) is None
    # The roofline needs no byte counter: its bytes come from the shapes.
    assert reader("allreduce_roofline.tp")(rec) == reader("allreduce_roofline.tp")(
        traced_call(nbytes=9e9))
    # No NCCL kernel named as an all-reduce: said, and nothing read.
    rec = traced_call(nbytes=9e9)
    rec.timeline.device[:] = [o._replace(name=o.name.replace("AllReduce_Sum_f32", "Generic"))
                              for o in rec.timeline.device]
    assert reader("allreduce_roofline.tp")(rec) is None
    assert "no all-reduce kernel" in capsys.readouterr().err
    assert reader("collective_ms_per_step.tp")(traced_call()) == pytest.approx(110.0)
