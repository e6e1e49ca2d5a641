"""gemm_roofline.serve (%): K1's roofline bound over K1's device time in the
decode steps of the traced serving slice. Every step runs the seven
products of each layer over the whole pool (``pool_rows`` rows); their
least time is counted once each from those shapes, as a mean over a step's
launches. The kernels are those inside the profiler's device side of the
harness's span around each decode chunk; that side can start a few kernels
after the chunk's first (call 21.5: 6,657 of 6,720), so the bound is taken
over the launches seen. Nothing is read where the profiler gives no device
side of the spans, where it misses more than a twentieth of the steps'
launches, or where the launches the program counted differ from the steps
and admissions counted."""

import sys

from portbench import yardstick


def read(rec):
    tl, sl = rec.timeline, rec.driver.records.get("slice")
    spans = [s for s in tl.device_spans if s.name == "pb.decode"] if tl is not None else []
    if not spans or sl is None:
        return None
    m = yardstick.Model(rec.cell.config)
    steps, admits = sl["stats"]["decode_steps"], sl["stats"]["admit_dispatches"]
    counted = sl["launches"]
    ops = [o for s in spans for o in tl.ops_in(s.start, s.end)
           if yardstick.fold_name(o.name) == "w8a8_kernel"]
    launched = counted.get("w8a8_matmul_cached_f32_scales", 0) + counted.get("w8a8_matmul_cached", 0)
    per_step = 7 * m.L
    if not 0.95 * per_step * steps <= len(ops) <= per_step * steps \
            or launched != per_step * (steps + admits):
        print(f"gemm_roofline.serve: not read: {len(ops)} K1 kernels in {len(spans)} decode "
              f"spans, {launched} launched, for {steps} steps and {admits} admissions",
              file=sys.stderr)
        return None
    B = int(rec.cell.traffic["pool_rows"])
    bound = sum(yardstick.bound_s(b, o, "int8")
                for o, b in (yardstick.gemm_w8a8(B, N, K) for N, K in m.projections()))
    return 100.0 * bound / 7 * len(ops) / sum(o.end - o.start for o in ops)
