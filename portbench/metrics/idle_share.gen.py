"""idle_share.gen (%): share of the traced generate call's wall time (host
clock, fenced at both ends) in which no operation ran on the device."""


def read(rec):
    tl = rec.timeline
    spans = tl.spans_named("call") if tl is not None else []
    if not spans or not tl.device:
        return None
    return 100.0 * tl.idle_share(spans[0].start, spans[0].end)
