"""Exact merge of partial attention results via log-sum-exp weights.

Port of ``hydragen_tpu.ops.combine``: given attentions computed separately
over disjoint KV sets (shared prefix levels, the unique suffix), produce the
attention over their union, exactly:

    ``o = sum_i exp(lse_i - max_j lse_j) * o_i / sum_i exp(lse_i - max_j lse_j)``

Plain elementwise tensor code: the decode kernel (``ops/decode.py``) fuses
the one merge that sits on the hot path.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def combine_lse(outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor]):
    """Merge N partial attention results.

    Args:
        outs: ``[batch, seq, heads, dim]`` partial outputs (any layout whose
            last axis is ``dim`` and whose leading axes match ``lses``).
        lses: matching ``[batch, seq, heads]`` log-sum-exps (``-inf`` marks a
            fully masked row, which then contributes nothing).

    Returns:
        The merged output in ``outs[0].dtype``.
    """
    assert len(outs) == len(lses) and len(outs) > 0
    if len(outs) == 1:
        return outs[0]
    lses = [l.float() for l in lses]
    max_lse = lses[0]
    for l in lses[1:]:
        max_lse = torch.maximum(max_lse, l)
    # Guard fully masked rows (all -inf) so exp(-inf - -inf) never NaNs.
    max_safe = torch.clamp(max_lse, min=-1e30)
    weights = [torch.exp(l - max_safe) for l in lses]
    denom = weights[0]
    for w in weights[1:]:
        denom = denom + w
    denom = torch.where(denom == 0.0, 1.0, denom)

    merged = outs[0].float() * weights[0][..., None]
    for o, w in zip(outs[1:], weights[1:]):
        merged = merged + o.float() * w[..., None]
    return (merged / denom[..., None]).to(outs[0].dtype)


def combine_lse_with_stats(
    outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor]
):
    """Like ``combine_lse`` but also returns the merged lse."""
    merged = combine_lse(outs, lses)
    lse_stack = torch.stack([l.float() for l in lses])
    max_safe = torch.clamp(lse_stack.amax(dim=0), min=-1e30)
    total = torch.exp(lse_stack - max_safe[None]).sum(dim=0)
    new_lse = torch.where(
        total == 0.0,
        -math.inf,
        max_safe + torch.log(torch.where(total == 0.0, 1.0, total)),
    )
    return merged, new_lse
