"""Attention under a mesh: the shared-level read over a rank's rows and
sequence shard, and the exact merge of sequence-parallel partials.

Port of ``hydragen_tpu.parallel.shard_attn``. A rank's tensors are its
shard (its query and kv heads, its unique rows, its slice of each level),
so the causal prefill (K4) and the unique decode read (K3, with the merged
shared partial fused in) run on them exactly as without a mesh; prefill
attention over the current input is never sp-sharded. What needs the mesh
is the level read:

- **dp.** A rank's rows ``[row0, row0 + b)`` of a global batch fold onto a
  level's prefixes as global row ``i`` folds onto prefix ``i // (total //
  sb)``. The rows may start or split a prefix group (``_dp_sb_mode``'s
  cases, which JAX sends to XLA where ``shard_map`` cannot express them);
  the port has no global fallback, so ``fold_segments`` cuts the rows into
  runs that each fold cleanly (whole groups, or part of one), and each run
  is one K2 read from its first prefix row (``row_start``).
- **sp.** Each rank reads its slice of the level's sequence with K2 at the
  local lengths ``clip(len - offset, 0, S/sp)``, and the partials merge by
  ``sp_lse_merge`` (``_sp_lse_merge``'s math: one max and one sum
  all-reduce over sp, the sum carrying the weighted outputs and the weights
  together; ``lse = -inf`` for a fully masked shard). The merge comes
  before the partial reaches K3's fused LSE merge.

The no-sharing baseline (``disable_hydragen``) copies level 0 into every
unique row; a unique cache is not split over sp, so an sp-split level is
gathered first (``gather_level``: one all-gather a cached tensor).
"""

from __future__ import annotations

import math

import torch

from hydragen_torch.ops import flash
from hydragen_torch.ops.hydragen import (
    _attention,
    fold_queries_for_shared,
    unfold_shared_lse,
    unfold_shared_out,
)
from hydragen_torch.parallel.mesh import Mesh, all_gather, all_reduce


def sp_lse_merge(o: torch.Tensor, l: torch.Tensor, mesh: Mesh):
    """Exact LSE merge of the sp ranks' partials ``(o [..., d], l [...])``;
    a fully masked rank carries ``l = -inf``. Returns the merged ``(o, l)``
    (``o`` in its dtype, ``l`` f32) on every sp rank."""
    lf = l.float()
    mx = all_reduce(lf, "max", mesh, "sp")
    mx_safe = torch.clamp(mx, min=-1e30)
    w = torch.exp(lf - mx_safe)
    sums = all_reduce(torch.cat([o.float() * w[..., None], w[..., None]], dim=-1), "sum",
                      mesh, "sp")
    num, den = sums[..., :-1], sums[..., -1]
    den_safe = torch.where(den == 0.0, 1.0, den)
    out = (num / den_safe[..., None]).to(o.dtype)
    lse = torch.where(den == 0.0, -math.inf, mx_safe + torch.log(den_safe))
    return out, lse


def fold_segments(row0: int, rows: int, total: int, sb: int, first: int = 0) -> list:
    """Rows ``[row0, row0 + rows)`` of a ``total``-row batch over ``sb``
    prefixes (row ``i`` reads prefix ``first + i // (total // sb)``; ``first``
    is the level's first prefix row read, ``ForwardSpec.level_row``) as runs
    that each fold cleanly: ``[(first prefix, prefixes, rows), ...]``."""
    assert total % sb == 0, (total, sb)
    sps = total // sb
    segs, r, end = [], row0, row0 + rows
    while r < end:
        p = r // sps
        if r % sps == 0 and end - r >= sps:
            k = (end - r) // sps
            segs.append((first + p, k, k * sps))
            r += k * sps
        else:
            n = min((p + 1) * sps, end) - r
            segs.append((first + p, 1, n))
            r += n
    return segs


def sharded_level_attention(layer: int, q: torch.Tensor, level, segments, filled: int,
                            impl: str, mesh: Mesh):
    """One layer's read of a shared level for this rank's rows.

    q ``[b, hq, t, d]`` (the rank's rows and heads, unfolded); ``level`` a
    local ``SharedLevel`` (its kv heads, its sequence shard); ``segments``
    from :func:`fold_segments`; ``filled`` the level's global filled length
    (the plain path's view). Returns ``(out [b, hq, t, d], lse [b, hq, t])``,
    merged over sp when the level is split."""
    b, _, t, _ = q.shape
    off, S = level.seq_offset, level.max_seq_len
    outs, lses, q0 = [], [], 0
    for p, k, n in segments:
        qf = fold_queries_for_shared(q[q0:q0 + n], k)
        q0 += n
        lens = level.seq_lens[p:p + k]
        if level.seq_shards > 1:
            lens = torch.clamp(lens - off, 0, S)
        if impl == "kernel":
            o, l = flash.flash_attention_cached_bhsd(
                layer, qf, level.k, level.v, kv_seq_lens=lens, k_scale_all=level.k_scale,
                v_scale_all=level.v_scale, row_start=p)
        else:
            # At least one (masked) token: a shard past the level's end has none.
            fl = min(max(filled - off, 1), S)

            def view(x, s):
                xv = x[layer, p:p + k, :, :fl]
                return xv if s is None else (xv, s[layer, p:p + k, :, :fl])

            o, l = _attention(qf, view(level.k, level.k_scale), view(level.v, level.v_scale),
                              causal=False, kv_seq_lens=lens, impl=impl)
        outs.append(unfold_shared_out(o, n, t))
        lses.append(unfold_shared_lse(l, n, t))
    assert q0 == b, (q0, b)
    o = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
    l = lses[0] if len(lses) == 1 else torch.cat(lses, 0)
    if level.seq_shards > 1:
        o, l = sp_lse_merge(o, l, mesh)
    return o, l


def gather_level(level, mesh: Mesh):
    """A level split over sp with every token of its sequence on each rank
    (this rank's kv heads): one all-gather along the tokens for each cached
    tensor (payloads, and scales when quantized). An unsplit level is
    returned as it is."""
    if level.seq_shards == 1:
        return level

    def whole(x):
        return None if x is None else all_gather(x, mesh, "sp", dim=3)

    return level._replace(k=whole(level.k), v=whole(level.v), k_scale=whole(level.k_scale),
                          v_scale=whole(level.v_scale), seq_shards=1, seq_shard=0)
