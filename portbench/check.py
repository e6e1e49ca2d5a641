"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``portbench/reference``) runs over a sample of what the timed
path served, drawn from the seed: each sampled request's prompt with its
served tokens. At every position where a served token was chosen, the gap
is how far the served token's reference logit lies below the reference's
best logit there, in units of the standard deviation of the reference's
logits at that position. Greedy decoding serves the program's own best
token, so a gap is the program's error where it changed a choice.

The number compared is the mean gap over all the sample's positions. The
widest gap is logged beside it but not compared: it swings from seed to
seed by nature (a tail of bf16 rounding over near-tied logits), and the
control's smallest read under three times the largest sound reading in
each cell (PERF.md).

The control is the reference one precision step down (``w_bits=4,
kv_bits=4``) put in the program's place: at each position of the same
prompts and tokens, the gap of the token the control puts first.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from portbench.reference import Reference


class Sample(NamedTuple):
    """What is compared: one shared prefix and, for each sampled request,
    its continuation ids (its own prompt and all but its last served
    token) and its served tokens."""

    prefix: np.ndarray
    conts: List[np.ndarray]
    served: List[np.ndarray]


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``[n]``: (best logit - the token's logit) / std of the logits, row by row."""
    logits = logits.float()
    best = logits.max(dim=-1).values
    chosen = logits.gather(-1, tokens.long().to(logits.device)[:, None])[:, 0]
    return (best - chosen) / logits.std(dim=-1)


def reference_logits(sample: Sample, weights: dict, config: dict, device,
                     w_bits: int = 8, kv_bits: int = 8) -> List[torch.Tensor]:
    ref = Reference(weights, config, w_bits=w_bits, kv_bits=kv_bits)
    ids = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)  # noqa: E731
    return ref.served_logits(ids(sample.prefix), [ids(c) for c in sample.conts],
                             [len(s) for s in sample.served])


def served_gaps(sample: Sample, logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """The gap of every served token of the sample in the reference's logits."""
    return torch.cat([gaps(lg, torch.as_tensor(np.asarray(s))) for lg, s in
                      zip(logits, sample.served)])


def control_gaps(logits: Sequence[torch.Tensor], control: Sequence[torch.Tensor]) -> torch.Tensor:
    """The gap, in the reference's logits, of the token the control puts
    first at every position."""
    return torch.cat([gaps(lg, c.argmax(dim=-1)) for lg, c in zip(logits, control)])


def gap_stats(g: torch.Tensor) -> dict:
    """A sample's gaps summarised: the mean (the number compared), the
    widest, the 99th percentile, and the share of positions whose token is
    not the reference's best."""
    g = g.double()
    return {"mean": float(g.mean()), "max": float(g.max()),
            "p99": float(torch.quantile(g, 0.99)), "changed": float((g > 0).double().mean())}


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every number compared beside its limit, in the
    order ``{"mean_gap": [value, limit], "failed": [value, limit]}``; correct
    when each is at most its limit. A number with no limit fails."""
    checks = {k: [v, limits.get(k)] for k, v in readings.items()}
    ok = all(lim is not None and v <= lim for v, lim in checks.values())
    return ok, checks
