"""prefill_other_us_per_tok.gen (us): microseconds of device time in
kernels none of the port's own (norms, RoPE, SiLU, ``quantize_rows``,
casts, cache writes, copies, the LM head) launched inside the program's two
prefill spans, over the tokens the prefills computed (padding included), in
the traced call profiled once more at one new token
(``portbench/spans.py``). Also prints to standard error the same time by
the layer stage it was launched in, and the share of the prefills' device
time launched under no stage span."""

import sys

from portbench import spans


def read(rec):
    p = spans.prefill(rec)
    if p is None or p.tokens_run <= 0:
        return None
    by_stage = p.other_by_stage()
    if not by_stage:
        return None
    per_tok = {k or "(no stage)": 1e6 * v / p.tokens_run for k, v in by_stage.items()}
    split = ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_tok.items(), key=lambda kv: -kv[1]))
    print(f"prefill_other_us_per_tok.gen by stage (us a token): {split}", file=sys.stderr)
    print(f"prefill device time under no stage span: {100.0 * p.unstaged_share():.4f} %",
          file=sys.stderr)
    return sum(per_tok.values())
