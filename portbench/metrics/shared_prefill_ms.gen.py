"""shared_prefill_ms.gen (ms): device-busy milliseconds of the operations
the program launched inside its ``hg.shared_prefill`` span (the prompt's
prefill into its level), in the traced call profiled once more at one new
token (``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    p = spans.prefill(rec)
    return None if p is None else p.busy_ms("shared_prefill")
