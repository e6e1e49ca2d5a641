"""prefill_collective_ms.tp (ms): device-busy milliseconds of the operations
the program launched inside its ``hg.all_reduce`` and ``hg.all_gather``
ranges (the collective with its casts) within its two prefill spans, on
rank 0's card, in the traced call profiled once more at one new token
(``portbench/spans.py``). Nothing is read from a program without those
ranges."""

from portbench import spans, yardstick

RANGES = {spans.PREFIX + "all_reduce", spans.PREFIX + "all_gather"}


def read(rec):
    p = spans.prefill(rec)
    if p is None:
        return None
    ops = [o for o, path in p.under(*spans.PREFILLS) if RANGES.intersection(path)]
    if not ops:
        return None
    return 1e3 * yardstick.busy_s((o.start, o.end) for o in ops)
