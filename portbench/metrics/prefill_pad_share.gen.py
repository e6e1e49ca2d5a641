"""prefill_pad_share.gen (%): share of the prefill tokens the program
computed that are bucket padding: the engine's counters (``stats``) of the
tokens its prefills computed (``shared_tokens_run``, ``unique_tokens_run``)
less those they were given (``shared_tokens``, ``unique_tokens``), over
those computed, summed over the run's calls (every call of a cell has the
same widths)."""


def read(rec):
    stats = getattr(rec.driver.eng, "stats", None)
    if stats is None:
        return None
    run = stats["shared_tokens_run"] + stats["unique_tokens_run"]
    if run <= 0:
        return None
    return 100.0 * (run - stats["shared_tokens"] - stats["unique_tokens"]) / run
