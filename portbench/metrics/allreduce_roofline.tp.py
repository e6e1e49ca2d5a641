"""allreduce_roofline.tp (%): the least time of the traced call's sum
all-reduces (the bytes the call's shapes need, bf16 partials and no
padding: ``collectives.allreduce_bytes``, at one direction of NVLink 4:
``collectives.allreduce_floor_s``) over the device time of NCCL's
all-reduce kernels on rank 0's card in that call. Where the program
counts the bytes it hands its all-reduces (``COLLECTIVE_BYTES``), their
ratio to the floor's bytes goes to standard error."""

import sys

from portbench import collectives


def read(rec):
    tl = rec.timeline
    spans = tl.spans_named("call") if tl is not None else []
    if not spans:
        return None
    d = rec.driver
    nbytes = collectives.allreduce_bytes(rec.cell.config, d.P, d.b, d.t, d.n)
    ops = [o for o in tl.ops_in(spans[0].start, spans[0].end)
           if collectives.is_all_reduce(o.name)]
    if not ops:
        names = sorted({o.name for o in tl.ops_in(spans[0].start, spans[0].end)
                        if collectives.is_nccl(o.name)})
        print(f"allreduce_roofline.tp: not read: no all-reduce kernel among NCCL's {names}",
              file=sys.stderr)
        return None
    handed = d.records.get("collective_bytes", {}).get("all_reduce_sum")
    if handed:
        print(f"allreduce_roofline.tp: the program handed its all-reduces {handed / nbytes:.3f}"
              f" x the {nbytes / 1e9:.2f} GB the shapes need", file=sys.stderr)
    return 100.0 * collectives.allreduce_floor_s(nbytes) / sum(o.end - o.start for o in ops)
