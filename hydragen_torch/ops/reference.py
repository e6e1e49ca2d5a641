"""Plain PyTorch attention with log-sum-exp output.

The numerical oracle for the CUDA attention kernels and the path every
structural exclusion of the kernels takes (arbitrary ``kv_mask``, the BSHD
unique-cache layout). Port of ``hydragen_tpu.ops.reference``.

Layout conventions:
- internal canonical layout BHSD: ``q [b, hq, m, d]``, ``k/v [b, hkv, s, d]``,
  ``out [b, hq, m, d]``, ``lse [b, hq, m]`` (fp32);
- the public API keeps the BSHD ``[batch, len, heads, dim]`` layout through
  thin transpose wrappers.
"""

from __future__ import annotations

import math

import torch

# Large negative instead of -inf so exp(mask - mask) never yields NaN.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def attention_bhsd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_seq_lens: torch.Tensor | None = None,
    scale: float | None = None,
    kv_mask: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    kv_bshd: bool = False,
):
    """Canonical-layout attention returning ``(out, lse)``.

    Args:
        q: ``[b, hq, m, d]`` queries.
        k, v: ``[b, hkv, s, d]`` (GQA: query head ``h`` reads kv head
            ``h // (hq // hkv)``), or ``[b, s, hkv, d]`` when ``kv_bshd``.
        causal: query ``i`` attends kv positions ``j <= i + (s - m)``
            (diagonal aligned to the end).
        kv_seq_lens: optional ``[b]`` int; kv positions ``>= len`` masked.
        scale: softmax scale, default ``1/sqrt(d)``.
        kv_mask: optional ``[b, s]`` bool; False positions masked.
        k_scale, v_scale: optional ``[b, hkv, s]`` (``[b, s, hkv]`` when
            ``kv_bshd``) f32 per-token scales of int8 k/v payloads. They
            commute out of both products, onto the score and probability
            columns, so no dequantized copy of the payload is made.

    Returns:
        out ``[b, hq, m, d]`` (q.dtype), lse ``[b, hq, m]`` f32, natural log,
        ``-inf`` on rows whose keys are all masked.
    """
    b, hq, m, d = q.shape
    if kv_bshd:
        _, s, hkv, dk = k.shape
    else:
        _, hkv, s, dk = k.shape
    assert dk == d, f"kv head_dim {dk} != q head_dim {d}"
    assert hq % hkv == 0, f"GQA requires hq % hkv == 0, got {hq} {hkv}"
    assert (k_scale is None) == (v_scale is None)
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device

    qg = (q.float() * scale).reshape(b, hkv, group, m, d)
    k_sub = "bskd" if kv_bshd else "bksd"
    scores = torch.einsum(f"bkgmd,{k_sub}->bkgms", qg, k.float())
    if k_scale is not None:
        ksf = k_scale.float()
        if kv_bshd:
            ksf = ksf.transpose(1, 2)
        scores = scores * ksf[:, :, None, None, :]

    mask = torch.ones((b, 1, 1, m, s), dtype=torch.bool, device=dev)
    if causal:
        qpos = torch.arange(m, device=dev)[:, None] + (s - m)
        kpos = torch.arange(s, device=dev)[None, :]
        mask = mask & (kpos <= qpos)[None, None, None]
    if kv_seq_lens is not None:
        kpos = torch.arange(s, device=dev)
        lens = kv_seq_lens.to(dev)
        mask = mask & (kpos[None, :] < lens[:, None])[:, None, None, None]
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, None, :]

    scores = torch.where(mask, scores, MASK_VALUE)
    mx = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(mx, min=-1e30)
    p = torch.exp(scores - m_safe)
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)

    pn = p / l_safe
    if v_scale is not None:
        vsf = v_scale.float()
        if kv_bshd:
            vsf = vsf.transpose(1, 2)
        pn = pn * vsf[:, :, None, None, :]
    o = torch.einsum(f"bkgms,{k_sub}->bkgmd", pn, v.float())
    out = o.reshape(b, hq, m, d).to(q.dtype)

    lse = m_safe[..., 0] + torch.log(l_safe[..., 0])
    lse = torch.where(l[..., 0] == 0.0, -math.inf, lse).reshape(b, hq, m)
    return out, lse


def attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_seq_lens: torch.Tensor | None = None,
    scale: float | None = None,
):
    """Public BSHD wrapper: q ``[b, m, hq, d]``, k/v ``[b, s, hkv, d]``.

    Returns out ``[b, m, hq, d]``, lse ``[b, m, hq]``.
    """
    out, lse = attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, kv_seq_lens=kv_seq_lens, scale=scale,
    )
    return out.transpose(1, 2), lse.transpose(1, 2)
