"""The Hydragen attention op: shared-prefix decomposition and inter-sequence
batching. Port of ``hydragen_tpu.ops.hydragen``.

For a batch of ``b`` sequences whose KV history factors into a stack of
shared levels (level ``i`` holds ``sb_i`` distinct prefixes, ``sb_i | b``)
plus a per-sequence unique suffix, attention is computed per level and merged
exactly via log-sum-exp:

1. inter-sequence batching: the queries of all ``b // sb_i`` sequences that
   share a prefix are folded into the query-length dimension, so the prefix
   KV is read once for the whole group;
2. the unique suffix: causal self-attention at prefill (``seq_lens=None``)
   or length-masked attention over the unique cache at decode;
3. ``combine_lse`` merges the partials.

``impl``: ``"kernel"`` (the default) sends every call but the structural
exclusions of :func:`use_flash_kernel` to the flash kernel's wrapper (which
runs the plain version on a CPU tensor and launches the kernel or raises on
a CUDA tensor); ``"torch"`` runs the plain reference ops on any device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hydragen_torch.ops import flash
from hydragen_torch.ops.combine import combine_lse
from hydragen_torch.ops.reference import attention_bhsd

IMPLS = ("kernel", "torch")


def pick_impl(impl: str | None) -> str:
    impl = "kernel" if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of {IMPLS}")
    return impl


def use_flash_kernel(impl: str, q: torch.Tensor, k: torch.Tensor, *, kv_mask=None,
                     kv_bshd: bool = False, kv_bits: int = 8) -> bool:
    """The one gate between the flash kernel and the plain path.

    Arbitrary masks, the BSHD unique-cache layout and int4 token-packed
    payloads are the plain path's alone, as in the JAX package; every other
    call goes to the kernel's wrapper, with no shape thresholds, and on a
    CUDA tensor the wrapper raises on what its kernel does not take (a dtype,
    a head size)."""
    return (pick_impl(impl) == "kernel" and kv_mask is None and not kv_bshd
            and kv_bits == 8)


def _attention(q, k, v, *, causal, kv_seq_lens, impl, kv_mask=None, kv_bshd=False,
               kv_bits=8):
    """One BHSD (out, lse) attention. ``k``/``v`` may each be an ``(int8 or
    int4 payload, f32 scale)`` pair for a quantized KV source."""
    k, ks = k if isinstance(k, tuple) else (k, None)
    v, vs = v if isinstance(v, tuple) else (v, None)
    if use_flash_kernel(impl, q, k, kv_mask=kv_mask, kv_bshd=kv_bshd, kv_bits=kv_bits):
        return flash.flash_attention_bhsd(
            q, k, v, causal=causal, kv_seq_lens=kv_seq_lens, k_scale=ks, v_scale=vs,
        )
    return attention_bhsd(
        q, k, v, causal=causal, kv_seq_lens=kv_seq_lens, kv_mask=kv_mask,
        k_scale=ks, v_scale=vs, kv_bshd=kv_bshd, kv_bits=kv_bits,
    )


def fold_queries_for_shared(q: torch.Tensor, sb: int) -> torch.Tensor:
    """Inter-sequence batching: [b, hq, nq, d] -> [sb, hq, (b//sb)*nq, d]."""
    b, hq, nq, d = q.shape
    sps = b // sb
    return q.reshape(sb, sps, hq, nq, d).transpose(1, 2).reshape(sb, hq, sps * nq, d)


def unfold_shared_out(s_out: torch.Tensor, b: int, nq: int) -> torch.Tensor:
    """Inverse of fold_queries_for_shared for [sb, hq, sps*nq, d] outputs."""
    sb, hq, _, d = s_out.shape
    sps = b // sb
    return s_out.reshape(sb, hq, sps, nq, d).transpose(1, 2).reshape(b, hq, nq, d)


def unfold_shared_lse(s_lse: torch.Tensor, b: int, nq: int) -> torch.Tensor:
    sb, hq, _ = s_lse.shape
    sps = b // sb
    return s_lse.reshape(sb, hq, sps, nq).transpose(1, 2).reshape(b, hq, nq)


def hydragen_attention_bhsd(
    q: torch.Tensor,
    k: torch.Tensor | None,
    v: torch.Tensor | None,
    shared_ks: Sequence[torch.Tensor],
    shared_vs: Sequence[torch.Tensor],
    shared_seq_lens: Sequence[torch.Tensor | None],
    seq_lens: torch.Tensor | None = None,
    *,
    impl: str | None = None,
):
    """Canonical-layout Hydragen attention.

    q ``[b, hq, nq, d]``; k/v ``[b, hkv, kv_len, d]`` unique KV (or None);
    shared levels ``[sb_i, hkv, slen_i, d]`` with ``b % sb_i == 0`` and
    lengths ``[sb_i]`` or None; seq_lens ``[b]`` or None (causal
    self-attention). Returns ``[b, hq, nq, d]`` in q's dtype.
    """
    impl = pick_impl(impl)
    b, hq, nq, d = q.shape
    assert len(shared_ks) == len(shared_vs) == len(shared_seq_lens)
    has_unique = k is not None and k.shape[2] > 0
    outs, lses = [], []
    for sk, sv, slens in zip(shared_ks, shared_vs, shared_seq_lens):
        sb = sk.shape[0]
        assert b % sb == 0, f"shared batch {sb} must divide batch {b}"
        s_out, s_lse = _attention(
            fold_queries_for_shared(q, sb), sk, sv, causal=False, kv_seq_lens=slens,
            impl=impl,
        )
        s_out = unfold_shared_out(s_out, b, nq)
        if not has_unique and len(shared_ks) == 1:
            return s_out
        outs.append(s_out)
        lses.append(unfold_shared_lse(s_lse, b, nq))
    if has_unique:
        u_out, u_lse = _attention(
            q, k, v, causal=seq_lens is None, kv_seq_lens=seq_lens, impl=impl
        )
        outs.append(u_out)
        lses.append(u_lse)
    assert outs, "hydragen_attention needs at least one KV source"
    return combine_lse(outs, lses)


def hydragen_attention(q, k, v, shared_ks, shared_vs, shared_seq_lens, seq_lens=None,
                       *, impl: str | None = None):
    """Public BSHD op: q ``[b, nq, hq, d]``; k/v ``[b, kvlen, hkv, d]``; shared
    levels ``[sb_i, slen_i, hkv, d]``. Returns ``[b, nq, hq, d]``."""
    t = lambda x: x.transpose(1, 2) if x is not None else None  # noqa: E731
    out = hydragen_attention_bhsd(
        t(q), t(k), t(v), [t(x) for x in shared_ks], [t(x) for x in shared_vs],
        shared_seq_lens, seq_lens, impl=impl,
    )
    return out.transpose(1, 2)
