"""Flash attention returning ``(out, lse)``: the CUDA kernel of
``csrc/flash.cu`` behind two entries, each with its plain PyTorch version.

Port of ``hydragen_tpu.ops.flash``:
- ``flash_attention_bhsd``: causal prefill (diagonal aligned to the end) and
  non-causal reads, optional ``kv_seq_lens`` and int8 KV with per-token
  scales, GQA folded into the query rows;
- ``flash_attention_cached_bhsd``: non-causal read of ONE layer of the
  stacked shared-level buffers ``[L, SB, hkv, S, d]``, in place;
- ``flash_attention``: the BSHD wrapper.

A CUDA tensor goes to the kernel (bf16 queries, bf16 or int8 KV, head_dim 64
or 128) or raises; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops.reference import attention_bhsd

LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)


def _fn():
    f = cuda_lib.library("flash").hydragen_flash_attention
    f.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    return f


def _check(name, t, dev, dtypes):
    if t.device != dev or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(
            f"flash kernel: {name} must be a contiguous tensor of {dtypes} on {dev}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _launch(qf, k_rows, v_rows, ks_rows, vs_rows, lens, *, row_offset, BH, M, q_len,
            S, hkv, causal, scale):
    """qf [BH, M, d] bf16; k/v rows [rows, S, d]; scales [rows, S] f32."""
    dev = qf.device
    d = qf.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {d} not in {HEAD_DIMS}")
    _check("q", qf, dev, (torch.bfloat16,))
    _check("k", k_rows, dev, (torch.bfloat16, torch.int8))
    _check("v", v_rows, dev, (k_rows.dtype,))
    int8 = k_rows.dtype == torch.int8
    if int8 != (ks_rows is not None):
        raise ValueError("flash kernel: int8 k/v need f32 scales, bf16 k/v none")
    if int8:
        _check("k_scale", ks_rows, dev, (torch.float32,))
        _check("v_scale", vs_rows, dev, (torch.float32,))
    for name, t in (("q", qf), ("k", k_rows), ("v", v_rows)):
        cuda_lib.check_aligned(f"flash kernel: {name}", t)
    if lens is not None:
        lens = lens.to(device=dev, dtype=torch.int32).contiguous()
        if lens.shape != (BH // hkv,):
            raise ValueError(f"flash kernel: kv_seq_lens must be [{BH // hkv}], got "
                             f"{tuple(lens.shape)}")
    out = torch.empty((BH, M, d), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((BH, M), dtype=torch.float32, device=dev)
    if BH and M:
        status = _fn()(
            qf.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
            ks_rows.data_ptr() if int8 else None, vs_rows.data_ptr() if int8 else None,
            lens.data_ptr() if lens is not None else None,
            out.data_ptr(), lse.data_ptr(), row_offset, BH, M, q_len, S, hkv, d,
            int(int8), int(causal), scale * LOG2E, cuda_lib.stream_ptr(dev),
        )
        cuda_lib.check(status, "flash attention")
    return out, lse


def flash_attention_bhsd_plain(q, k, v, *, causal=False, kv_seq_lens=None, scale=None,
                               k_scale=None, v_scale=None):
    """Plain PyTorch version of ``flash_attention_bhsd``."""
    return attention_bhsd(q, k, v, causal=causal, kv_seq_lens=kv_seq_lens, scale=scale,
                          k_scale=k_scale, v_scale=v_scale)


def flash_attention_bhsd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_seq_lens: torch.Tensor | None = None,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
):
    """Flash attention in the canonical BHSD layout.

    q ``[b, hq, m, d]``, k/v ``[b, hkv, s, d]`` (int8 with ``k_scale`` /
    ``v_scale`` ``[b, hkv, s]`` f32). Returns (out ``[b, hq, m, d]``, lse
    ``[b, hq, m]`` f32), as ``ops.reference.attention_bhsd``."""
    if not q.is_cuda:
        return flash_attention_bhsd_plain(q, k, v, causal=causal, kv_seq_lens=kv_seq_lens,
                                          scale=scale, k_scale=k_scale, v_scale=v_scale)
    b, hq, m, d = q.shape
    _, hkv, s, _ = k.shape
    assert hq % hkv == 0 and k.shape == v.shape and k.shape[0] == b
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # GQA fold: [b, hq, m, d] -> [b*hkv, group*m, d], a pure view of BHSD.
    qf = q.contiguous().reshape(b * hkv, group * m, d)
    out, lse = _launch(
        qf, k.contiguous(), v.contiguous(),
        None if k_scale is None else k_scale.contiguous(),
        None if v_scale is None else v_scale.contiguous(),
        kv_seq_lens, row_offset=0, BH=b * hkv, M=group * m, q_len=m, S=s, hkv=hkv,
        causal=causal, scale=scale,
    )
    cuda_lib.LAUNCHES["flash_attention_bhsd"] += 1
    return out.reshape(b, hq, m, d), lse.reshape(b, hq, m)


def flash_attention_cached_plain(layer, q, k_all, v_all, *, kv_seq_lens=None,
                                 k_scale_all=None, v_scale_all=None, scale=None):
    """Plain PyTorch version of ``flash_attention_cached_bhsd``."""
    b = q.shape[0]
    return attention_bhsd(
        q, k_all[layer, :b], v_all[layer, :b], kv_seq_lens=kv_seq_lens, scale=scale,
        k_scale=None if k_scale_all is None else k_scale_all[layer, :b],
        v_scale=None if v_scale_all is None else v_scale_all[layer, :b],
    )


def flash_attention_cached_bhsd(
    layer: int,
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    *,
    kv_seq_lens: torch.Tensor | None = None,
    k_scale_all: torch.Tensor | None = None,
    v_scale_all: torch.Tensor | None = None,
    scale: float | None = None,
):
    """Non-causal flash attention reading ONE layer of stacked level buffers.

    q ``[b, hq, m, d]`` (folded); k_all/v_all ``[L, SB, hkv, S, d]`` with
    ``b <= SB``; scales ``[L, SB, hkv, S]`` f32; kv_seq_lens ``[b]``. The
    kernel indexes kv row ``layer * SB * hkv + b * hkv + kv_head`` of the
    buffers as they are: no per-layer slice is made. Returns ``(out
    [b, hq, m, d], lse [b, hq, m])``, equal to ``flash_attention_bhsd`` on the
    layer's slice."""
    layer = int(layer)
    if not q.is_cuda:
        return flash_attention_cached_plain(
            layer, q, k_all, v_all, kv_seq_lens=kv_seq_lens, k_scale_all=k_scale_all,
            v_scale_all=v_scale_all, scale=scale,
        )
    b, hq, m, d = q.shape
    L, SB, hkv, s, dk = k_all.shape
    assert dk == d and hq % hkv == 0 and v_all.shape == k_all.shape
    assert b <= SB, f"folded batch {b} exceeds allocated level batch {SB}"
    assert 0 <= layer < L
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.contiguous().reshape(b * hkv, group * m, d)
    rows = L * SB * hkv
    out, lse = _launch(
        qf, k_all.reshape(rows, s, d), v_all.reshape(rows, s, d),
        None if k_scale_all is None else k_scale_all.reshape(rows, s),
        None if v_scale_all is None else v_scale_all.reshape(rows, s),
        kv_seq_lens, row_offset=layer * SB * hkv, BH=b * hkv, M=group * m, q_len=m,
        S=s, hkv=hkv, causal=False, scale=scale,
    )
    cuda_lib.LAUNCHES["flash_attention_cached_bhsd"] += 1
    return out.reshape(b, hq, m, d), lse.reshape(b, hq, m)


def flash_attention(q, k, v, *, causal=False, kv_seq_lens=None, scale=None):
    """Public BSHD wrapper: q ``[b, m, hq, d]``, k/v ``[b, s, hkv, d]``."""
    out, lse = flash_attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, kv_seq_lens=kv_seq_lens, scale=scale,
    )
    return out.transpose(1, 2), lse.transpose(1, 2)
