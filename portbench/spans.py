"""The program's own spans in a profile, and the device operations launched
inside each.

The program marks stretches of its code with host ranges named ``hg.<name>``
(``hydragen_torch.utils.profiling.span``): the whole ``generate`` call, its
shared and unique prefills, the first token, the decode loop and each step,
and the stages of every layer of an eager forward (``hg.norm``, ``hg.qkv``,
``hg.rope``, ``hg.attn``, ``hg.o_proj``, ``hg.mlp``, ``hg.kv_write``,
``hg.head``). A device operation belongs to the spans the host was inside
when it launched the operation: the profiler gives the launching runtime
call (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...)
and the operation one correlation id, and a graph replay's kernels carry
the id of their ``cudaGraphLaunch``. Nothing is fenced.

The traced window's ``Timeline`` keeps no correlation ids, so ``prefill``
profiles the traced call once more after the window, at one new token (its
prefills and first token alone, as ``prefill_share.gen`` times it), and
reads the ids from that profile. On a program without these spans (its
window holds no ``hg.`` range) or without prefill counters, nothing is
profiled and the readers read nothing.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

from portbench import yardstick
from portbench.timeline import Op, fence

PREFIX = "hg."
PREFILLS = ("shared_prefill", "unique_prefill")
STAGES = ("norm", "qkv", "rope", "attn", "o_proj", "mlp", "kv_write", "head")
# Host runtime and driver calls that put work on the device.
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                   "cudaMemset", "cuMemcpy", "cuMemset")
RECORD = "program_spans"  # the key of ``prefill``'s result in the driver's records


class DeviceOp(NamedTuple):
    name: str
    start: float  # seconds on the profiler's clock
    end: float
    correlation: int


class Launch(NamedTuple):
    name: str
    start: float
    correlation: int


def read_profile(prof) -> Tuple[List[Op], List[Launch], List[DeviceOp]]:
    """(program spans, launches, device operations) of a finished
    ``torch.profiler.profile``, on the host's clock in seconds. Device-side
    annotations of any range (``hg.``, ``pb.``) are not operations."""
    from torch.autograd import DeviceType

    spans, launches, device = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns() * 1e-9
        end = (e.start_ns() + e.duration_ns()) * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith((PREFIX, "pb.")):
                device.append(DeviceOp(name, start, end, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append(Op(name, start, end))
        elif name.startswith(LAUNCH_PREFIXES):
            launches.append(Launch(name, start, e.correlation_id()))
    return spans, launches, device


def enclosing(spans: Iterable[Op], times: Sequence[float]) -> List[Tuple[str, ...]]:
    """For each of ``times`` (ascending), the names of the spans covering it,
    outermost first. The spans are one thread's, so they nest."""
    order = sorted(spans, key=lambda s: (s.start, -s.end))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i].start <= t:
            s = order[i]
            i += 1
            while stack and stack[-1].end <= s.start:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(tuple(s.name for s in stack))
    return out


def attribute(spans: Iterable[Op], launches: Iterable[Launch],
              device: Iterable[DeviceOp]) -> List[Tuple[DeviceOp, Optional[Tuple[str, ...]]]]:
    """Each device operation with the spans covering its launch, outermost
    first (None where the profile holds no launch of its correlation id)."""
    at = {ln.correlation: ln.start for ln in launches}
    device = list(device)
    times = sorted({at[o.correlation] for o in device if o.correlation in at})
    paths = dict(zip(times, enclosing(spans, times)))
    return [(o, paths[at[o.correlation]] if o.correlation in at else None) for o in device]


class Prefill:
    """The device operations of one call's prefills, each with the spans it
    was launched under, and the tokens the prefills computed."""

    def __init__(self, spans: List[Op], launches: List[Launch], device: List[DeviceOp],
                 tokens_run: int):
        self.ops = attribute(spans, launches, device)
        self.tokens_run = tokens_run

    def under(self, *names: str) -> List[Tuple[DeviceOp, Tuple[str, ...]]]:
        """The operations launched under any of the spans ``names``."""
        want = {PREFIX + n for n in names}
        return [(o, p) for o, p in self.ops if p and want.intersection(p)]

    def busy_ms(self, *names: str) -> Optional[float]:
        """Device-busy milliseconds of the operations launched under
        ``names`` (None where there are none)."""
        ops = [o for o, _ in self.under(*names)]
        if not ops:
            return None
        return 1e3 * yardstick.busy_s((o.start, o.end) for o in ops)

    def other_by_stage(self) -> Dict[str, float]:
        """Seconds of device time in kernels none of the port's own
        (``yardstick.group_of`` says ``"other"``) launched under the
        prefills, by the innermost stage span (``""`` under none)."""
        out: Dict[str, float] = {}
        for o, path in self.under(*PREFILLS):
            if yardstick.group_of(o.name) == "other":
                k = stage(path)
                out[k] = out.get(k, 0.0) + (o.end - o.start)
        return out

    def unstaged_share(self) -> Optional[float]:
        """Share of the prefills' device time launched under no stage span."""
        ops = self.under(*PREFILLS)
        total = sum(o.end - o.start for o, _ in ops)
        if total <= 0:
            return None
        return sum(o.end - o.start for o, p in ops if not stage(p)) / total


def stage(path: Tuple[str, ...]) -> str:
    """The innermost stage span of ``path`` (without ``hg.``), else ``""``."""
    for name in reversed(path):
        if name[len(PREFIX):] in STAGES:
            return name[len(PREFIX):]
    return ""


def prefill(rec) -> Optional[Prefill]:
    """The traced call's prefills, profiled once after the window (kept in
    the driver's records under ``RECORD``); None where the program records
    no span or counts no prefill token."""
    records = rec.driver.records
    if RECORD not in records:
        records[RECORD] = _profile_prefill(rec)
    return records[RECORD]


def _profile_prefill(rec) -> Optional[Prefill]:
    from torch.profiler import ProfilerActivity, profile

    tl, d = rec.timeline, rec.driver
    stats = getattr(d.eng, "stats", None)
    if tl is None or stats is None or not any(o.name.startswith(PREFIX) for o in tl.host):
        return None
    acts = [ProfilerActivity.CPU]
    if d.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    keys = ("shared_tokens_run", "unique_tokens_run")
    before = sum(stats[k] for k in keys)
    fence(d.device)
    with profile(activities=acts) as prof:
        d._call(d.trace_call, 1)
        fence(d.device)
    return Prefill(*read_profile(prof), sum(stats[k] for k in keys) - before)
