"""The traced run's records: a ``torch.profiler`` timeline of the card and
the harness's own spans around calls into the program.

``Tracer`` profiles one stretch of a run (``with tracer.window():``), the
device fenced at both ends, and records named spans inside it
(``with tracer.span(name):``, a ``record_function`` range fenced at both
ends, so the device work of the span ends inside it). ``Timeline`` is what
is read afterwards: the device's operations (kernels, copies, fills) as
intervals on the host's clock, the spans, and the host's own operations,
read straight from the profiler's event list (no tree is built, so a
trace of a million kernels is read in seconds).
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, NamedTuple, Optional

from portbench import yardstick

SPAN_PREFIX = "pb."


class Op(NamedTuple):
    name: str
    start: float  # seconds on the profiler's clock
    end: float


class Timeline:
    """What one traced window recorded."""

    def __init__(self, device: List[Op], spans: List[Op], host: List[Op],
                 window: Op, device_spans: List[Op] = ()):
        self.device = sorted(device, key=lambda o: o.start)
        self.spans = spans
        self.host = sorted(host, key=lambda o: o.start)
        self.window = window
        # The card's side of each span (the profiler's GPU user annotations),
        # where the profiler gives them.
        self.device_spans = list(device_spans)
        self._starts = [o.start for o in self.device]
        self._host_starts = [o.start for o in self.host]

    @property
    def window_s(self) -> float:
        return self.window.end - self.window.start

    def ops_in(self, lo: float, hi: float) -> List[Op]:
        """Device operations that start inside ``[lo, hi)``."""
        i, j = bisect.bisect_left(self._starts, lo), bisect.bisect_left(self._starts, hi)
        return self.device[i:j]

    def busy_s(self, lo: Optional[float] = None, hi: Optional[float] = None) -> float:
        """Seconds of ``[lo, hi]`` (default the window) with a device
        operation running."""
        lo = self.window.start if lo is None else lo
        hi = self.window.end if hi is None else hi
        return yardstick.busy_s(((o.start, o.end) for o in self.ops_in(lo - 1.0, hi)), lo, hi)

    def idle_share(self, lo: Optional[float] = None, hi: Optional[float] = None) -> float:
        lo = self.window.start if lo is None else lo
        hi = self.window.end if hi is None else hi
        return yardstick.idle_share(((o.start, o.end) for o in self.ops_in(lo - 1.0, hi)),
                                    lo, hi)

    def spans_named(self, name: str) -> List[Op]:
        return [s for s in self.spans if s.name == SPAN_PREFIX + name]

    def device_extent(self, span: Op) -> Optional[Op]:
        """First device start to last device end of the work inside a
        (fenced) host span."""
        ops = self.ops_in(span.start, span.end)
        if not ops:
            return None
        return Op(span.name, ops[0].start, max(o.end for o in ops))

    def host_doing(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost host operation
        covering it (the one that started last among the 2,000 before it),
        else the innermost harness span covering it, else ``"host idle"``."""
        i = bisect.bisect_right(self._host_starts, t)
        for o in reversed(self.host[max(0, i - 2000):i]):
            if o.end >= t and o.name != SPAN_PREFIX + "window":
                return o.name
        inner = [s for s in self.spans if s.start <= t <= s.end]
        return max(inner, key=lambda s: s.start).name if inner else "host idle"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time (by folded name) and
        the idle gaps of the window summed by what the host was doing."""
        by_name: Dict[str, float] = {}
        for o in self.ops_in(self.window.start - 1.0, self.window.end):
            k = yardstick.fold_name(o.name)
            by_name[k] = by_name.get(k, 0.0) + (o.end - o.start)
        gaps = yardstick.idle_gaps(((o.start, o.end) for o in self.device),
                                   self.window.start, self.window.end)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]  # the longest first
        by_host: Dict[str, float] = {}
        for a, b in gaps:
            k = self.host_doing((a + b) / 2)
            by_host[k] = by_host.get(k, 0.0) + (b - a)
        return {"device_ops": yardstick.top(by_name, n), "idle_gaps": yardstick.top(by_host, n)}


def read_events(prof) -> tuple:
    """(device ops, spans, host ops, device spans) from a finished
    ``torch.profiler.profile``, on the host's clock in seconds. An event on
    the CUDA side is a device operation (kernel, copy, fill) unless it is
    the device side of a harness span (named ``pb.``); on the host side a
    ``pb.`` event is a span, the rest are the host's operations."""
    from torch.autograd import DeviceType

    device, spans, host, dspans = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        op = Op(e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
        mine = op.name.startswith(SPAN_PREFIX)
        if e.device_type() == DeviceType.CUDA:
            (dspans if mine else device).append(op)
        else:
            host.append(op)
            if mine:
                spans.append(op)
    return device, spans, host, dspans


def fence(device) -> None:
    """Wait for the work queued on a CUDA ``device`` (nothing on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """Profiles one window of a run and the spans inside it. Outside the
    window ``span`` only fences (or does nothing with ``fence=False``)."""

    def __init__(self, device):
        self.device = device
        self._prof = None  # while a window is traced
        self._done = None  # the finished profile, read on first use
        self._timeline: Optional[Timeline] = None

    def _fence(self):
        fence(self.device)

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def timeline(self) -> Optional[Timeline]:
        """The traced window's records (None if no window was traced), read
        from the profile when first asked for, after the run."""
        if self._timeline is None and self._done is not None:
            device, spans, host, dspans = read_events(self._done)
            win = next((s for s in spans if s.name == SPAN_PREFIX + "window"), None)
            if win is None:
                raise RuntimeError("the profiler recorded no window span")
            self._timeline = Timeline(device, [s for s in spans if s is not win], host, win,
                                      dspans)
            self._done = None
        return self._timeline

    def warm(self) -> None:
        """Start and stop the profiler once over nothing: its first start in
        a process takes seconds (the tracing library's set-up), which would
        otherwise stall the traced window's start."""
        from torch.profiler import profile

        prof = profile(activities=self._activities())
        prof.start()
        prof.stop()

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import profile, record_function

        self._fence()
        prof = profile(activities=self._activities())
        prof.start()
        self._prof = prof
        try:
            with record_function(SPAN_PREFIX + "window"):
                yield self
                self._fence()
        finally:
            prof.stop()
            self._prof, self._done = None, prof

    @contextlib.contextmanager
    def span(self, name: str, fence: bool = True):
        """A named span: fenced at both ends so that its device work lies
        inside it (``fence=False``: the host's range alone, the device side
        from the profiler's GPU annotation where it gives one)."""
        if not self.active:
            yield
            return
        from torch.profiler import record_function

        if fence:
            self._fence()
        with record_function(SPAN_PREFIX + name):
            yield
            if fence:
                self._fence()

    @contextlib.contextmanager
    def wrapped(self, obj, attrs: dict, fence: bool = True):
        """Within the block, each method ``attr`` of ``obj`` (an instance
        attribute shadowing the class's) runs inside ``span(attrs[attr])``;
        put back after."""
        saved = {a: getattr(obj, a) for a in attrs}
        own = {a: obj.__dict__[a] for a in attrs if a in obj.__dict__}

        def wrap(fn, name):
            def inner(*a, **kw):
                with self.span(name, fence=fence):
                    return fn(*a, **kw)
            return inner

        for a, name in attrs.items():
            setattr(obj, a, wrap(saved[a], name))
        try:
            yield
        finally:
            for a in attrs:
                if a in own:
                    setattr(obj, a, own[a])
                else:
                    delattr(obj, a)
