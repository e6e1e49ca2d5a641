"""prefill_share.gen (%): the synchronised wall time of a generate call at
``max_new_tokens=1`` (its prefills alone) over the same call whole, both
timed on the host's clock after the traced window."""


def read(rec):
    v = rec.driver.records.get("prefill_share")
    return None if v is None else 100.0 * v
