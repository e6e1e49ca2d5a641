"""collective_ms_per_step.tp (ms): device milliseconds a decode step spends
in NCCL's kernels on rank 0's card (a tp step's two all-reduces a layer and
the logits' all-gather, each with its wait for the other ranks), matched by
name under the traced call's decode span, over its ``new_tokens - 1``
steps."""

from portbench import collectives


def read(rec):
    tl = rec.timeline
    spans = tl.spans_named("decode") if tl is not None else []
    if not spans:
        return None
    ops = [o for o in tl.ops_in(spans[0].start, spans[0].end) if collectives.is_nccl(o.name)]
    if not ops:
        return None
    return 1e3 * sum(o.end - o.start for o in ops) / (rec.driver.n - 1)
