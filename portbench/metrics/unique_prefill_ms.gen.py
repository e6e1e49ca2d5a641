"""unique_prefill_ms.gen (ms): device-busy milliseconds of the operations
the program launched inside its ``hg.unique_prefill`` span (the suffixes'
forward against the level, their write into the unique cache), in the
traced call profiled once more at one new token (``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    p = spans.prefill(rec)
    return None if p is None else p.busy_ms("unique_prefill")
