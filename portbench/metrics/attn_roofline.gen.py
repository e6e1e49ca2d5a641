"""attn_roofline.gen (%): the roofline bound of the attention the traced
generate call needs (the prompt's causal prefill, the suffixes' read of the
level and their own causal read, each decode step's level read and unique
read; counted from lengths, not from which kernel runs) over the device
time of the attention kernels (K2/K4 ``flash_kernel``, K5, K3 and
``split_combine``) in the call."""

from portbench import yardstick


def read(rec):
    tl = rec.timeline
    spans = tl.spans_named("call") if tl is not None else []
    if not spans:
        return None
    t = sum(o.end - o.start for o in tl.ops_in(spans[0].start, spans[0].end)
            if yardstick.fold_name(o.name) in yardstick.ATTENTION_KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(p["attn"].bound for p in rec.driver.work().values()) / t
