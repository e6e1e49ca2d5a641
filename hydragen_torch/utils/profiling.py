"""Device time by kernel, from ``torch.profiler``.

Port of ``hydragen_tpu.utils.profiling``. Where the JAX package parses XLA's
xplane protobuf, this reads the profiler's events:

- ``trace()`` profiles a block of work, fenced at both ends, and keeps its
  wall time;
- ``op_summary()`` / ``print_op_summary()`` give the device time of each
  kernel by its full name, as ``OpStat`` with the JAX package's fields;
- ``step_summary()`` / ``print_step_summary()`` take the place of
  ``while_summary()``: the kernels of N decode steps (graph replays or the
  eager loop), the template instantiations of one kernel folded into one
  row, as XLA's layer-numbered ops are folded there, beside the block's wall
  time a step. The profiler's busy time is printed beside the wall time, so
  a profile whose busy time falls far below the wall at the same launch
  counts reads as the profiler's, not the card's;
- ``trace_decode()`` traces the decode loop of one request, its prefill
  outside the profile;
- ``kernel_table()`` and ``group_ms()`` are the sums the above are built
  on, for callers that group kernels by name themselves.

On a CPU device the "kernels" are the aten ops, each by its own (self) CPU
time, so that the scripts that profile also run in the CPU tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from hydragen_torch.utils.timing import fence


class OpStat(NamedTuple):
    name: str
    total_ms: float
    count: int
    fraction: float


@dataclasses.dataclass
class Trace:
    """A profiled block: its device, the ``torch.profiler.profile`` and the
    wall milliseconds of the block (set when the block ends)."""

    device: torch.device
    prof: object = None
    wall_ms: float = 0.0


@contextlib.contextmanager
def trace(device="cuda", record_shapes: bool = False):
    """Profile the block (CPU activity, and CUDA's on a CUDA device): the
    device is fenced before the profiler starts and before the block's wall
    clock stops. Yields a ``Trace``."""
    from torch.profiler import ProfilerActivity, profile

    tr = Trace(torch.device(device))
    acts = [ProfilerActivity.CPU]
    if tr.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    fence(tr.device)
    with profile(activities=acts, record_shapes=record_shapes) as prof:
        t = time.perf_counter()
        yield tr
        fence(tr.device)
        tr.wall_ms = (time.perf_counter() - t) * 1e3
    tr.prof = prof


def trace_decode(engine, request: Callable[[], object], decode_steps=None,
                 record_shapes: bool = False) -> Trace:
    """Run ``request()`` (a ``generate`` or a batcher's decode chunk on
    ``engine``) with each call of the engine's decode loop under ``trace``,
    and return the last call's ``Trace``: the request's prefill and sampling
    stay outside it. ``decode_steps`` is the loop to trace (default: the
    engine's own); the engine's loop is put back after."""
    inner = engine._decode_steps if decode_steps is None else decode_steps
    saved, window = engine._decode_steps, {}

    def traced(*a, **kw):
        with trace(engine.device, record_shapes=record_shapes) as tr:
            out = inner(*a, **kw)
        window["tr"] = tr
        return out

    engine._decode_steps = traced
    try:
        request()
    finally:
        engine._decode_steps = saved
    if "tr" not in window:
        raise RuntimeError("trace_decode: the request ran no decode step")
    return window["tr"]


def kernel_table(prof, device_type: str = "cuda") -> Dict[str, Tuple[float, int]]:
    """{kernel name: (device microseconds, launches)} of a profile. On
    ``"cpu"``: {aten op: (self CPU microseconds, calls)}."""
    if device_type != "cuda":
        return {e.key: (float(e.self_cpu_time_total), int(e.count))
                for e in prof.key_averages() if e.self_cpu_time_total > 0}
    from torch.autograd import DeviceType

    table: Dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = table.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us()
            row[1] += 1
    return {k: (us, n) for k, (us, n) in table.items()}


def group_ms(table: Dict[str, Tuple[float, int]], names: Iterable[str], per: float = 1,
             other: Optional[str] = "other") -> Dict[str, float]:
    """Milliseconds of ``table`` by group, divided by ``per``: a kernel goes
    to the first of ``names`` its name contains, else to ``other`` (dropped
    when ``other`` is None). Every name of ``names`` is a key."""
    names = list(names)
    out = dict.fromkeys(names, 0.0)
    for name, (us, _) in table.items():
        key = next((k for k in names if k in name), other)
        if key is not None:
            out[key] = out.get(key, 0.0) + us / 1e3 / per
    return out


def fold_name(name: str) -> str:
    """A kernel's name without its return type, namespace of an anonymous
    namespace, template arguments and parameter list:
    ``void (anonymous namespace)::flash_kernel<128, true>(Params)`` ->
    ``flash_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    cuts = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cuts)] if cuts else name).strip()


def _stats(table: Dict[str, Tuple[float, int]], top: int) -> List[OpStat]:
    busy = sum(us for us, _ in table.values()) or 1.0
    rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:top]
    return [OpStat(name=n, total_ms=us / 1e3, count=c, fraction=us / busy)
            for n, (us, c) in rows]


def op_summary(tr: Trace, top: int = 25) -> List[OpStat]:
    """Device time of each kernel of the trace by its full name, largest
    first; ``fraction`` is of the trace's device busy time."""
    return _stats(kernel_table(tr.prof, tr.device.type), top)


def print_op_summary(tr: Trace, top: int = 25) -> None:
    for st in op_summary(tr, top=top):
        print(f"{st.fraction*100:5.1f}%  {st.total_ms:9.3f} ms  n={st.count:<6d} {st.name[:80]}")


@dataclasses.dataclass
class StepSummary:
    steps: int
    wall_ms: float  # the traced block's wall time
    busy_ms: float  # the kernels' summed device time
    kernels: int  # launches in the block
    ops: List[OpStat]  # folded names; fraction of busy_ms


def step_summary(tr: Trace, steps: int, top: int = 25) -> StepSummary:
    """The kernels of a trace of ``steps`` decode steps, the instantiations
    of each kernel folded together (``fold_name``)."""
    table = kernel_table(tr.prof, tr.device.type)
    folded: Dict[str, list] = {}
    for name, (us, n) in table.items():
        row = folded.setdefault(fold_name(name), [0.0, 0])
        row[0] += us
        row[1] += n
    busy = sum(us for us, _ in table.values())
    return StepSummary(steps=steps, wall_ms=tr.wall_ms, busy_ms=busy / 1e3,
                       kernels=sum(n for _, n in table.values()),
                       ops=_stats({k: tuple(v) for k, v in folded.items()}, top))


def print_step_summary(tr: Trace, steps: int, top: int = 25) -> StepSummary:
    s = step_summary(tr, steps, top=top)
    print(f"{steps} decode steps: wall {s.wall_ms / steps:.3f} ms/step, profiler busy "
          f"{s.busy_ms / steps:.3f} ms/step ({s.kernels / steps:.0f} kernels/step); "
          f"by kernel:")
    for st in s.ops:
        print(f"{st.fraction*100:5.1f}%  {st.total_ms / steps:8.4f} ms/step  "
              f"n/step={st.count / steps:<7.1f} {st.name[:70]}")
    return s
