"""submit_lag_p95_s.serve (s): 95th percentile over the run's requests of
the time each was submitted minus the time it was due: how late the open
loop ran while the host sat in the batcher's steps (the harness's clock)."""

from portbench import yardstick


def read(rec):
    lags = rec.driver.submit_lags()
    return yardstick.percentile(lags, 95) if lags else None
