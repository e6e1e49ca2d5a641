"""The program's spans as the benchmark reads them (``portbench/spans.py``).

On made-up timelines and profiles: the program's ``hg.*`` ranges, which are
host ranges only, leave the seven accepted readers and
``breakdown.device_ops`` as they were, and name the idle gaps where the host
was in the program's own code; a device operation belongs to the spans
around its launch, a graph's kernels to the step whose ``cudaGraphLaunch``
replayed them; the four new readers give the numbers their definitions
give, and nothing on a program without spans or counters. On the CPU a
traced run of a tiny cell reads the padding share from the engine's
counters."""

import json
import types
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

from portbench import run, spans, yardstick
from portbench.tests import tiny
from portbench.timeline import Op, Timeline

PKG = Path(run.__file__).resolve().parent
ACCEPTED = ("prefill_share.gen", "call_mfu.gen", "decode_mfu.gen", "other_ms_per_step.gen",
            "gemm_roofline.gen", "attn_roofline.gen", "idle_share.gen")
NEW = ("shared_prefill_ms.gen", "unique_prefill_ms.gen", "prefill_pad_share.gen",
       "prefill_other_us_per_tok.gen")
CFG = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 1,
       "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 100}
K1 = "void w8a8_kernel<2, 128, __nv_bfloat16, float>(CUtensorMap)"
FLASH = "void (anonymous namespace)::flash_kernel<128, true>(Params)"
EW = "void at::native::vectorized_elementwise_kernel<4>(int)"


def reader(name):
    return run.load_module(PKG / "metrics" / f"{name}.py", "test_" + name.replace(".", "_")).read


def driver(**kw):
    d = types.SimpleNamespace(records={}, n=3, eng=types.SimpleNamespace(), **kw)
    work = yardstick.generate_work(yardstick.Model(CFG), 16, 4, 8, d.n)
    d.work = lambda: work
    d.records.update(launches={"w8a8_matmul_cached": sum(p["k1"] for p in work.values())},
                     prefill_share=0.5)
    return d


def call_timeline(program_spans: bool) -> Timeline:
    """A traced call of the tiny model (7 K1 launches a forward): the
    harness's fenced spans, the device's operations, the host's, and with
    ``program_spans`` the program's ``hg.*`` host ranges."""
    dev = []
    for lo, forwards in ((0.6, 1), (2.6, 1), (5.0, 2)):
        t = lo + 0.1
        for _ in range(forwards):
            for _ in range(7):
                dev.append(Op(K1, t, t + 0.05))
                t += 0.06
            dev += [Op(FLASH, t, t + 0.1), Op(EW, t + 0.1, t + 0.15)]
            t += 0.2
    harness = [Op("pb.call", 0.5, 9.5), Op("pb.shared_prefill", 0.6, 2.5),
               Op("pb.unique_prefill", 2.6, 3.3), Op("pb.decode", 5.0, 9.0)]
    host = harness + [Op("aten::copy_", 2.45, 2.55), Op("cudaGraphLaunch", 6.0, 6.2)]
    if program_spans:
        host += [Op("hg.generate", 0.55, 9.45), Op("hg.shared_prefill", 0.62, 2.45),
                 Op("hg.norm", 0.63, 0.65), Op("hg.unique_prefill", 2.62, 3.28),
                 Op("hg.first_token", 3.35, 4.95), Op("hg.decode", 5.02, 8.95),
                 Op("hg.decode_step", 5.05, 6.3)]
    return Timeline(dev, harness, host, Op("pb.window", 0.4, 9.6))


def test_program_spans_leave_the_accepted_readings_and_name_the_gaps():
    before, after = call_timeline(False), call_timeline(True)
    for name in ACCEPTED:
        read = reader(name)
        a = read(run.Record(None, driver(), before))
        b = read(run.Record(None, driver(), after))
        assert a is not None and a == b, name
    bb, ba = before.breakdown(), after.breakdown()
    assert ba["device_ops"] == bb["device_ops"]
    assert not any(k.startswith(spans.PREFIX) for k, _ in ba["device_ops"])
    assert (after.busy_s(), after.window_s) == (before.busy_s(), before.window_s)
    # The gap between the unique prefill's last kernel and the decode's
    # first: the harness's span before, the program's first token now.
    gaps = dict(ba["idle_gaps"])
    assert "hg.first_token" in gaps and "hg.first_token" not in dict(bb["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(sum(dict(bb["idle_gaps"]).values()))


class Event:
    """What ``read_profile`` reads of one of the profiler's events."""

    def __init__(self, name, start, end, cuda=False, corr=0):
        self._v = (name, int(start * 1e9), int((end - start) * 1e9), cuda, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]


def fake_profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_graph_kernels_belong_to_the_step_whose_graph_launch_replayed_them():
    events = [
        Event("hg.decode", 10.0, 20.0), Event("hg.decode_step", 11.0, 12.0),
        Event("hg.decode_step", 13.0, 14.0), Event("aten::copy_", 14.5, 14.6),
        Event("cudaGraphLaunch", 11.5, 11.6, corr=10),
        Event("cudaGraphLaunch", 13.5, 13.6, corr=11),
        Event("cudaMemcpyAsync", 14.55, 14.58, corr=12),
        # The device runs behind the host: none of these lies inside the
        # host range of the step that launched it.
        Event(K1, 15.0, 15.1, cuda=True, corr=10), Event(EW, 15.1, 15.2, cuda=True, corr=10),
        Event(K1, 16.0, 16.1, cuda=True, corr=11),
        Event("Memcpy DtoH (Device -> Pinned)", 16.2, 16.3, cuda=True, corr=12),
        # The card's side of a range is no operation.
        Event("hg.decode", 15.0, 16.3, cuda=True), Event("pb.decode", 15.0, 16.3, cuda=True),
    ]
    sp, launches, dev = spans.read_profile(fake_profile(events))
    assert [s.name for s in sp] == ["hg.decode", "hg.decode_step", "hg.decode_step"]
    assert [ln.correlation for ln in launches] == [10, 11, 12]
    assert len(dev) == 4
    paths = [p for _, p in spans.attribute(sp, launches, dev)]
    step = ("hg.decode", "hg.decode_step")
    assert paths == [step, step, step, ("hg.decode",)]


def prefill_record():
    """A profiled prefill: kernels launched under stage spans, under a
    prefill span alone, outside every span, and one with no launch."""
    sp = [Op("hg.generate", 0.5, 5.0), Op("hg.shared_prefill", 1.0, 2.0),
          Op("hg.norm", 1.1, 1.2), Op("hg.qkv", 1.2, 1.4), Op("hg.attn", 1.4, 1.6),
          Op("hg.unique_prefill", 2.1, 2.9), Op("hg.mlp", 2.2, 2.5)]
    launches = [spans.Launch("cudaLaunchKernel", t, c) for t, c in
                ((1.15, 1), (1.25, 2), (1.3, 3), (1.5, 4), (1.9, 5), (2.3, 6), (2.4, 7), (0.2, 8))]
    dev = [spans.DeviceOp("void at::native::reduce_kernel<512>(x)", 3.0, 3.1, 1),
           spans.DeviceOp(K1, 3.1, 3.3, 2), spans.DeviceOp(EW, 3.3, 3.35, 3),
           spans.DeviceOp(FLASH, 3.35, 3.6, 4),
           spans.DeviceOp("void at::native::index_elementwise_kernel<128>(x)", 3.6, 3.61, 5),
           spans.DeviceOp(EW, 3.7, 3.9, 6), spans.DeviceOp(EW, 3.8, 4.0, 7),
           spans.DeviceOp(EW, 0.3, 0.4, 8), spans.DeviceOp(EW, 4.5, 4.6, 99)]
    return spans.Prefill(sp, launches, dev, tokens_run=1000)


def test_the_new_readers_give_their_numbers(capsys):
    d = driver()
    d.records[spans.RECORD] = prefill_record()
    d.eng.stats = {"shared_tokens": 32768, "shared_tokens_run": 32768,
                   "unique_tokens": 256 * 64, "unique_tokens_run": 256 * 128}
    rec = run.Record(None, d, None)
    got = {name: reader(name)(rec) for name in NEW}
    assert got["shared_prefill_ms.gen"] == pytest.approx(610.0)  # 3.0-3.61, busy
    assert got["unique_prefill_ms.gen"] == pytest.approx(300.0)  # 3.7-4.0, overlap once
    assert got["prefill_pad_share.gen"] == pytest.approx(25.0)
    # Other kernels: norm 0.1, qkv 0.05, no stage 0.01, mlp 0.2 + 0.2 s,
    # over 1,000 tokens; K1 and flash are the port's own.
    assert got["prefill_other_us_per_tok.gen"] == pytest.approx(560.0)
    err = capsys.readouterr().err
    assert "mlp 400.000" in err and "norm 100.000" in err and "(no stage) 10.000" in err
    assert "under no stage span: 0.9901 %" in err  # 0.01 of 1.01 s
    d.eng.stats = {"shared_tokens": 128, "shared_tokens_run": 128,
                   "unique_tokens": 128 * 512, "unique_tokens_run": 128 * 512}
    assert reader("prefill_pad_share.gen")(rec) == 0.0


def test_a_program_without_spans_or_counters_reads_nothing():
    def no_call(*a, **kw):
        raise AssertionError("profiled a program that records no span")

    d = driver(_call=no_call, trace_call=1, device=torch.device("cpu"))
    rec = run.Record(None, d, call_timeline(False))
    assert spans.prefill(rec) is None
    assert all(reader(name)(rec) is None for name in NEW)
    d.eng.stats = dict.fromkeys(("shared_tokens", "shared_tokens_run", "unique_tokens",
                                 "unique_tokens_run"), 0)
    d.records.pop(spans.RECORD)
    assert spans.prefill(rec) is None  # stats, but no span in the window


def test_a_traced_tiny_cell_reads_the_padding_from_the_engine(tmp_path):
    root = tiny.make_bench(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, unit, source in (("shared_prefill_ms.gen", "ms", "device_trace"),
                               ("prefill_pad_share.gen", "%", "program_counter"),
                               ("prefill_other_us_per_tok.gen", "us", "device_trace")):
        bench["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                   "source": source, "layer": "engine", "moves": "gen_tok_s",
                                   "workloads": ["tiny-gen"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run.run_cell(root, "tiny-gen", 2**31 + 11, 0.3, True, torch.device("cpu"))
    assert res["correct"]
    # 40 prompt tokens (the level holds 40: no padding); 16 suffixes of 8
    # tokens computed as 32, the unique cache's length (8 + 16 new, to 16s).
    want = 100.0 * (16 * 32 - 16 * 8) / (40 + 16 * 32)
    assert res["metrics"]["prefill_pad_share.gen"]["value"] == pytest.approx(want)
    # No device on the CPU: the device readers read nothing.
    assert "shared_prefill_ms.gen" not in res["metrics"]
    assert "prefill_other_us_per_tok.gen" not in res["metrics"]
