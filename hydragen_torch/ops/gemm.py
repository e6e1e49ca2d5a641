"""W8A8 GEMM: s8 x s8 -> i32 products with a fused dequant epilogue.

Port of ``hydragen_tpu.ops.gemm`` (the int8 parts). Scheme:
- weights: per-output-channel s8, stored ``[out, in]`` (``ops/quant.py``),
  stacked ``[L, N, K]`` with bf16 scales ``[L, N]``;
- activations: per-row dynamic s8 (one f32 scale per token row).

``w8a8_matmul_cached`` computes ``a_s8 @ w_all[layer]^T * (row x col
scales)`` with the CUDA kernel of ``csrc/gemm.cu`` for a CUDA tensor, and
with its plain version ``w8a8_cached_plain`` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from hydragen_torch.ops import cuda_lib


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic activation quantization: [M, K] -> (s8, f32 [M, 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.round(xf / scale).to(torch.int8)
    return q, scale


def w8a8_reference(a_q, a_scale, w_q, w_scale, out_dtype=torch.bfloat16):
    """f32 oracle of the product (exact while the i32 sums fit f32's 24-bit
    mantissa; beyond that it rounds where the kernel's i32 sum does not)."""
    acc = torch.einsum("mk,nk->mn", a_q.float(), w_q.float())
    return (acc * a_scale.float() * w_scale.float()[None, :]).to(out_dtype)


def w8a8_cached_plain(layer: int, a_q, a_scale, w_all, w_scale_all,
                      out_dtype=torch.bfloat16):
    """Plain PyTorch version of ``w8a8_matmul_cached``."""
    return w8a8_reference(a_q, a_scale, w_all[layer], w_scale_all[layer], out_dtype)


def w8a8_supported(N: int, K: int) -> bool:
    """Shapes the kernel takes: 16-byte rows for cp.async, paired columns."""
    return K % 16 == 0 and N % 2 == 0


def _fn():
    f = cuda_lib.library("gemm").hydragen_w8a8_gemm
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def w8a8_matmul_cached(
    layer: int,
    a_q: torch.Tensor,          # [M, K] s8 activations (quantize_rows)
    a_scale: torch.Tensor,      # [M, 1] f32
    w_all: torch.Tensor,        # [L, N, K] s8 stacked weights
    w_scale_all: torch.Tensor,  # [L, N] bf16 per-(layer, out-channel) scales
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``a @ w_all[layer]^T`` read straight out of the stacked weight: the
    kernel gets the layer's base pointer, so no per-layer slice is copied."""
    M, K = a_q.shape
    L, N, K2 = w_all.shape
    assert K == K2, (a_q.shape, w_all.shape)
    layer = int(layer)
    assert 0 <= layer < L, (layer, L)
    if not a_q.is_cuda:
        return w8a8_cached_plain(layer, a_q, a_scale, w_all, w_scale_all, out_dtype)
    dev = a_q.device
    for name, t, dt in (("a_q", a_q, torch.int8), ("a_scale", a_scale, torch.float32),
                        ("w_all", w_all, torch.int8),
                        ("w_scale_all", w_scale_all, torch.bfloat16)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"w8a8 kernel: {name} must be a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if a_scale.numel() != M or w_scale_all.shape != (L, N):
        raise ValueError(f"w8a8 kernel: scale shapes {tuple(a_scale.shape)} "
                         f"{tuple(w_scale_all.shape)} do not match M={M} L={L} N={N}")
    if not w8a8_supported(N, K):
        raise ValueError(f"w8a8 kernel: needs K % 16 == 0 and N % 2 == 0, got N={N} K={K}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w8a8 kernel: out_dtype {out_dtype} not supported")
    cuda_lib.check_aligned("w8a8 kernel: a_q", a_q)
    cuda_lib.check_aligned("w8a8 kernel: w_all", w_all)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0:
        return out
    status = _fn()(
        a_q.data_ptr(), a_scale.data_ptr(),
        w_all.data_ptr() + layer * N * K,
        w_scale_all.data_ptr() + layer * N * w_scale_all.element_size(),
        out.data_ptr(), M, N, K, int(out_dtype == torch.bfloat16),
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(status, "w8a8_matmul_cached")
    cuda_lib.LAUNCHES["w8a8_matmul_cached"] += 1
    return out
