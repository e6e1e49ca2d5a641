"""decode_mfu.serve (%): the model operations of the decode tokens served in
the traced slice, each at its published peak, summed, over the device time
of the slice's decode chunks (the profiler's device side of the harness's
span around each chunk's graph replays).

A token's operations are its row's share of the seven products, its
attention over its context (the system prompt, its suffix, the tokens
before it, its own) and its LM head row: the work the served requests need,
not the pool's idle rows or its masked ring slots. The tokens are those the
host saw in the slice, which lag the device by one chunk at each end of it.
Nothing is read where the profiler gives no device side of the spans."""

from portbench import yardstick


def read(rec):
    tl, sl = rec.timeline, rec.driver.records.get("slice")
    if tl is None or sl is None:
        return None
    t = sum(s.end - s.start for s in tl.device_spans if s.name == "pb.decode")
    if t <= 0:
        return None
    m, P = yardstick.Model(rec.cell.config), rec.driver.P
    at_peak = 0.0
    for q, n0, n1 in sl["tokens"]:
        for j in range(max(n0, 1) + 1, n1 + 1):  # token j >= 2 comes from a decode step
            at_peak += yardstick.decode_token_work(m, P + len(q.ids) + j - 1).at_peak_s()
    return 100.0 * at_peak / t
