"""other_ms_per_step.gen (ms): device milliseconds a decode step spends in
kernels that are none of the port's own (K1-K7, ``split_combine``): norms,
quantizers, RoPE, residuals, the int8 cache writes, the LM head, sampling;
from the profiler's kernel names in the traced call's decode loop."""

from portbench import yardstick


def read(rec):
    tl = rec.timeline
    spans = tl.spans_named("decode") if tl is not None else []
    if not spans:
        return None
    ops = tl.ops_in(spans[0].start, spans[0].end)
    if not ops:
        return None
    other = sum(o.end - o.start for o in ops if yardstick.group_of(o.name) == "other")
    return 1e3 * other / (rec.driver.n - 1)
