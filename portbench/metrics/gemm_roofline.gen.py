"""gemm_roofline.gen (%): K1's roofline bound over K1's device time in the
traced generate call. The bound sums each launch's least time (operations at
the int8 peak or bytes at the memory rate, counted once each from the
shapes the call runs: the shared prefill, the unique prefill and every
decode step). Nothing is read where the launches the program counted, or
the K1 kernels the trace saw, differ from the shapes counted."""

import sys

from portbench import yardstick


def read(rec):
    tl = rec.timeline
    spans = tl.spans_named("call") if tl is not None else []
    if not spans:
        return None
    work = rec.driver.work()
    k1 = sum(p["k1"] for p in work.values())
    counted = rec.driver.records.get("launches", {})
    ops = [o for o in tl.ops_in(spans[0].start, spans[0].end)
           if yardstick.fold_name(o.name) == "w8a8_kernel"]
    launched = counted.get("w8a8_matmul_cached_f32_scales", 0) + counted.get("w8a8_matmul_cached", 0)
    if len(ops) != k1 or launched != k1:
        print(f"gemm_roofline.gen: not read: {len(ops)} K1 kernels seen, {launched} launched, "
              f"{k1} counted from the shapes", file=sys.stderr)
        return None
    return 100.0 * sum(p["gemm"].bound for p in work.values()) / sum(o.end - o.start for o in ops)
