"""call_mfu.gen (%): the whole traced generate call's model operations (its
prefills and decode steps), each at its published peak, summed, over the
device time from the call's first operation to its last: the share of the
card's peak that bounds every kernel roofline of the call."""


def read(rec):
    tl = rec.timeline
    spans = tl.spans_named("call") if tl is not None else []
    ext = tl.device_extent(spans[0]) if spans else None
    if ext is None:
        return None
    at_peak = sum(w.at_peak_s() for p in rec.driver.work().values()
                  for w in (p["gemm"], p["attn"], p["head"]))
    return 100.0 * at_peak / (ext.end - ext.start)
