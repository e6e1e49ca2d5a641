"""decode_mfu.gen (%): the decode steps' model operations of the traced
generate call, each at its published peak (the s8 products at the int8
peak, attention and the LM head at the bf16 peak), summed, over the device
time from the first to the last operation of the decode loop."""


def read(rec):
    tl = rec.timeline
    spans = tl.spans_named("decode") if tl is not None else []
    ext = tl.device_extent(spans[0]) if spans else None
    if ext is None:
        return None
    dec = rec.driver.work()["decode"]
    at_peak = dec["gemm"].at_peak_s() + dec["attn"].at_peak_s() + dec["head"].at_peak_s()
    return 100.0 * at_peak / (ext.end - ext.start)
