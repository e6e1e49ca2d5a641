"""idle_share.serve (%): share of the traced slice of the serving window
(host clock, fenced at both ends) in which no operation ran on the device."""


def read(rec):
    tl = rec.timeline
    if tl is None or not tl.device:
        return None
    return 100.0 * tl.idle_share()
