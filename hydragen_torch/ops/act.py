"""K8: the s8 activations K1 and K6 read, each made by one kernel.

Under ``matmul="w8a8"`` or ``"w4a8"`` every reader of the two norms' outputs
and of the MLP's SiLU product is an s8 GEMM, which reads only the per-row
quantization of it (``gemm.quantize_rows``: s8 codes ``[M, K]`` and an f32
scale ``[M, 1]``). In eager PyTorch each of those chains is 7-9 kernels over
bf16 and f32 copies of ``[M, K]``; here one kernel of ``csrc/act.cu`` reads
the inputs once and writes the pair (and, where the norm folds in the
residual add, the new residual):

- ``rms_norm_quant(x, weight, eps, delta=None)``: the RMS norm of ``x`` (of
  ``x + delta``, returned as the next residual, when ``delta`` is given),
  quantized per row;
- ``silu_mul_quant(g, u)``: ``silu(g) * u`` as the MLP rounds it, quantized
  per row;
- ``quantize_rows_kernel(x)``: the quantization alone, which
  ``gemm.quantize_rows`` runs on a CUDA tensor.

Each has a plain version here, the chain it replaces; a CPU tensor takes it,
a CUDA tensor launches the kernel or raises. The codes are the plain
chains', bit for bit, except that the norm's sum of squares is taken in
another order than ``torch.mean``'s and may round to a neighbouring float.
The JAX package has no counterpart: XLA fuses these ops inside jit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hydragen_torch.ops import cuda_lib, gemm
from hydragen_torch.ops.quant import RECIP_127

ACT_UNIT = 16  # elements a thread takes at a time (one 16-byte store of codes)
# Units a thread: the most threads a block of each takes (csrc/act.cu:max_threads).
ACT_MAX_THREADS = {1: 1024, 2: 512, 4: 256, 8: 256}
_OPS = {"quantize_rows": 0, "rms_norm_quant": 1, "rms_norm_add_quant": 2,
        "silu_mul_quant": 3}


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rms_norm_quant_plain(x, weight, eps, delta=None):
    """Plain version of ``rms_norm_quant``: ``(pair, h)``."""
    h = x if delta is None else x + delta
    y = rms_norm(h, weight, eps)
    return gemm.quantize_rows_plain(y.reshape(-1, y.shape[-1])), h


def silu_mul_quant_plain(g, u):
    """Plain version of ``silu_mul_quant``."""
    y = torch.nn.functional.silu(g.float()).to(u.dtype) * u
    return gemm.quantize_rows_plain(y.reshape(-1, y.shape[-1]))


def act_plans(K: int) -> list[tuple[int, int]]:
    """The blocks K8's kernel takes for a row of ``K`` elements: ``(threads,
    units a thread)``, each unit ``ACT_UNIT`` elements, fewest units
    first."""
    if K % ACT_UNIT:
        raise ValueError(f"act kernel: K={K} is not a multiple of {ACT_UNIT}")
    units = K // ACT_UNIT
    plans = [(32 * -(-units // (32 * nu)), nu) for nu in ACT_MAX_THREADS]
    return [(t, nu) for t, nu in plans if t <= ACT_MAX_THREADS[nu]]


def act_plan(K: int, op: str = "quantize_rows") -> tuple[int, int]:
    """K8's block for a row of ``K`` elements: the fewest units a thread
    within 256 threads, or 512 for the SiLU product
    (``kernel_times.py --k8-plans`` at the cells' shapes: fewer units a
    thread read faster up to those sizes, and the SiLU product, with an
    ``expf`` and a division an element, gains from the larger block)."""
    limit = 512 if op == "silu_mul_quant" else 256
    plans = [p for p in act_plans(K) if p[0] <= limit]
    if not plans:
        raise ValueError(f"act kernel: K={K} is wider than {limit * 8 * ACT_UNIT}")
    return plans[0]


def mean_factor(M: int, K: int) -> float:
    """The f32 factor ``torch.mean`` multiplies a row's sum by on the card:
    f32(M) / f32(M K)."""
    return float(np.float32(M) / np.float32(M * K))


@functools.cache
def _act_fn():
    f = cuda_lib.library("act").hydragen_act_quant
    f.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                  + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _launch(counter: str, op: str, x, x2=None, weight=None, eps: float = 0.0, plan=None):
    """One K8 launch over the rows of ``x [..., K]`` (and ``x2``, ``weight``
    where the op reads them). Returns ``(codes [M, K] s8, scales [M, 1]
    f32)`` and, for the norm with its residual add, ``x + x2`` shaped as
    ``x``. ``plan`` (default ``act_plan``) lets a sweep force the block."""
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    what = f"act kernel ({counter})"
    for name, t, shape in (("x", x, x.shape), ("x2", x2, x.shape), ("weight", weight, (K,))):
        if t is None:
            continue
        if (t.device != x.device or t.dtype != x.dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {x.dtype} tensor of shape "
                             f"{tuple(shape)} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        cuda_lib.check_aligned(f"{what}: {name}", t)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: activations must be bf16 or f32, got {x.dtype}")
    threads, nu = plan or act_plan(K, op)
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    h = torch.empty_like(x) if op == "rms_norm_add_quant" else None
    if M:
        status = _act_fn()(
            _OPS[op], int(x.dtype == torch.float32), x.data_ptr(),
            x2.data_ptr() if x2 is not None else None,
            weight.data_ptr() if weight is not None else None,
            h.data_ptr() if h is not None else None, q.data_ptr(), scale.data_ptr(),
            M, K, float(eps), mean_factor(M, K), float(RECIP_127), threads, nu,
            cuda_lib.stream_ptr(x.device),
        )
        cuda_lib.check(status, what)
        cuda_lib.LAUNCHES[counter] += 1
    return (q, scale) if h is None else ((q, scale), h)


def rms_norm_quant(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   delta: torch.Tensor | None = None):
    """The per-row s8 quantization of ``rms_norm(h, weight, eps)``, where
    ``h`` is ``x`` or, with ``delta``, ``x + delta`` rounded to ``x``'s
    type (the residual add before the post-attention norm). Returns
    ``((codes [M, K] s8, scales [M, 1] f32), h)``; the normed activation
    itself is never written."""
    if not x.is_cuda:
        return rms_norm_quant_plain(x, weight, eps, delta)
    if delta is None:
        return _launch("rms_norm_quant", "rms_norm_quant", x, weight=weight, eps=eps), x
    return _launch("rms_norm_quant", "rms_norm_add_quant", x, delta, weight, eps)


def silu_mul_quant(g: torch.Tensor, u: torch.Tensor):
    """The per-row s8 quantization of ``silu(g) * u`` as the MLP rounds it
    (SiLU in f32, rounded to ``u``'s type, times ``u``): ``(codes [M, K]
    s8, scales [M, 1] f32)``, the input of ``down``."""
    if not g.is_cuda:
        return silu_mul_quant_plain(g, u)
    return _launch("silu_mul_quant", "silu_mul_quant", g, u)


def quantize_rows_kernel(x: torch.Tensor):
    """``gemm.quantize_rows`` on a CUDA tensor ``[M, K]``: K8 with no
    prologue."""
    return _launch("quantize_rows", "quantize_rows", x)
