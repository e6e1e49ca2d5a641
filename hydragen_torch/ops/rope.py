"""K9: a decoder layer's RoPE and its int8 KV write, made by one kernel.

Where a forward writes its new KV into an int8 cache (a shared level being
filled, the unique cache's prefill tokens, the decode slot), every reader of
the projections' q, k and v takes only the rotated q and k, v, and the int8
KV in the cache. In eager PyTorch that is ``apply_rope`` on q and k (about
ten kernels a tensor over f32 copies), ``quantize_kv`` on k and v (about
eight each) and the write (a copy, or four ``index_copy_`` calls at a decode
slot). ``rope_kv_quant`` does it in one launch of ``csrc/rope.cu``: it
returns the rotated q and k (and v) head-major and writes the codes and
scales straight into the destination, given as a :class:`KVDest` of strided
views, so a BHSD level, a BHSD or BSHD unique cache and flat scales take
the same kernel.

``rope_kv_quant_plain`` is the chain it replaces; a CPU tensor takes it, a
CUDA tensor launches the kernel or raises. The kernel's rotated values,
codes and scales are the chain's bit for bit. The JAX package has no
counterpart: XLA fuses these ops inside jit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops.quant import RECIP_127, quantize_kv

HEAD_DIMS = (128,)  # the kernel's (hd / 8 lanes a head), the cells' head size
MAX_THREADS = 256


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[b, h, t, d]`` (BHSD); cos/sin ``[b, t, d]``. rotate_half
    convention, accumulated in f32."""
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    out = x.float() * cos[:, None].float() + rot.float() * sin[:, None].float()
    return out.to(x.dtype)


class KVDest(NamedTuple):
    """Where one layer's new KV goes: int8 payload views ``k``, ``v`` ``[b,
    hkv, T, hd]`` and f32 scale views ``k_scale``, ``v_scale`` ``[b, hkv,
    T]``, in any layout with ``hd`` contiguous (views of the cache's
    buffers, written in place). The input's tokens ``[w0, w0 + n)``
    (``window``) go to destination tokens ``[slot, slot + n)``; ``slot`` is
    a host int or a one-element int32 tensor on the device (a decode step's
    own, read where the write runs)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    slot: object
    window: tuple


def takes(x: torch.Tensor, head_dim: int) -> bool:
    """Does :func:`rope_kv_quant` take activations like ``x`` at
    ``head_dim``? Its plain version takes anything on the CPU; on the card,
    the kernel's bf16 at its head sizes."""
    return not x.is_cuda or (x.dtype == torch.bfloat16 and head_dim in HEAD_DIMS)


def rope_kv_quant_plain(q, k, v, cos, sin, dest: KVDest, nh: int, nkv: int, hd: int):
    """Plain version of :func:`rope_kv_quant`: ``apply_rope``,
    ``quantize_kv`` and the writes, op by op."""
    b, t = q.shape[:2]
    q = apply_rope(q.reshape(b, t, nh, hd).transpose(1, 2), cos, sin)
    k = apply_rope(k.reshape(b, t, nkv, hd).transpose(1, 2), cos, sin)
    v = v.reshape(b, t, nkv, hd).transpose(1, 2)
    w0, n = dest.window
    if torch.is_tensor(dest.slot):
        idx = dest.slot.reshape(1).long() + torch.arange(n, device=dest.k.device)
    for x, buf, sbuf in ((k, dest.k, dest.k_scale), (v, dest.v, dest.v_scale)):
        xq, xs = quantize_kv(x[:, :, w0:w0 + n])
        if torch.is_tensor(dest.slot):
            buf.index_copy_(2, idx, xq)
            sbuf.index_copy_(2, idx, xs)
        else:
            buf[:, :, dest.slot:dest.slot + n] = xq
            sbuf[:, :, dest.slot:dest.slot + n] = xs
    return q, k, v


@functools.cache
def _fn():
    f = cuda_lib.library("rope").hydragen_rope_kv_quant
    f.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                  + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def threads_for(nh: int, nkv: int, hd: int) -> int:
    """K9's block: a group of ``hd / 8`` lanes a head, as many groups as
    the token's ``nh + 2 nkv`` heads need, within ``MAX_THREADS``."""
    lanes = (nh + 2 * nkv) * (hd // 8)
    return min(MAX_THREADS, 32 * -(-lanes // 32))


def rope_kv_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, dest: KVDest, nh: int, nkv: int, hd: int):
    """RoPE on q and k and the int8 write of k and v, for one layer.

    Args:
        q: ``[b, t, nh * hd]``; k, v: ``[b, t, nkv * hd]`` (rows of tokens,
            each at one row stride, ``hd`` contiguous): the projections'
            outputs.
        cos, sin: ``[b, t, hd]`` from ``rope_cos_sin``, in q's type (bf16
            on the card).
        dest: where k and v go, quantized (:class:`KVDest`).

    Returns the rotated ``q [b, nh, t, hd]`` and ``k [b, nkv, t, hd]`` and
    ``v [b, nkv, t, hd]``. On the card they are contiguous (at ``t == 1``,
    v is the input's view, which is); on the CPU they are the plain
    version's views. One launch, counted as ``rope_kv_quant``."""
    if not q.is_cuda:
        return rope_kv_quant_plain(q, k, v, cos, sin, dest, nh, nkv, hd)
    b, t = q.shape[:2]
    dev, dt = q.device, q.dtype
    what = "rope_kv_quant kernel"
    if dt != torch.bfloat16 or hd not in HEAD_DIMS:
        raise ValueError(f"{what}: needs bf16 activations and head_dim in {HEAD_DIMS}, "
                         f"got {dt} and {hd}")
    w0, n = dest.window
    vec = 8  # the kernel's 4-element accesses
    rows = {}  # each input's row stride
    for name, x, width in (("q", q, nh * hd), ("k", k, nkv * hd), ("v", v, nkv * hd)):
        rows[name] = x.stride(1) if t > 1 else x.stride(0)
        if (x.device != dev or x.dtype != dt or tuple(x.shape) != (b, t, width)
                or x.stride(2) != 1 or (b > 1 and x.stride(0) != t * rows[name])
                or (rows[name] * x.element_size()) % vec):
            raise ValueError(f"{what}: {name} must be {dt} [{b}, {t}, {width}] on {dev} in rows "
                             f"of one stride, got {x.dtype} {tuple(x.shape)} strides "
                             f"{tuple(x.stride())} on {x.device}")
        cuda_lib.check_aligned(f"{what}: {name}", x, vec)
    for name, x in (("cos", cos), ("sin", sin)):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != (b, t, hd) \
                or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} [{b}, {t}, {hd}] on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        cuda_lib.check_aligned(f"{what}: {name}", x, vec)
    T = dest.k.shape[2]
    for name, x, shape, xdt in (("k", dest.k, (b, nkv, T, hd), torch.int8),
                                ("v", dest.v, (b, nkv, T, hd), torch.int8),
                                ("k_scale", dest.k_scale, (b, nkv, T), torch.float32),
                                ("v_scale", dest.v_scale, (b, nkv, T), torch.float32)):
        if x.device != dev or x.dtype != xdt or tuple(x.shape) != shape:
            raise ValueError(f"{what}: destination {name} must be {xdt} {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        cuda_lib.check_aligned(f"{what}: destination {name}", x, 4)
    if dest.k.stride() != dest.v.stride() or dest.k.stride(3) != 1 \
            or any(s % 4 for s in dest.k.stride()[:3]) \
            or dest.k_scale.stride() != dest.v_scale.stride():
        raise ValueError(f"{what}: the destination's payloads must share strides with hd "
                         f"contiguous and rows of 4-byte multiples, and its scales share "
                         f"strides, got {dest.k.stride()}, {dest.v.stride()}, "
                         f"{dest.k_scale.stride()}, {dest.v_scale.stride()}")
    if not (0 <= w0 and 0 <= n and w0 + n <= t):
        raise ValueError(f"{what}: window {dest.window} outside the {t} tokens")
    slot_ptr, slot = None, dest.slot
    if torch.is_tensor(slot):
        if slot.device != dev or slot.dtype != torch.int32 or slot.numel() != 1:
            raise ValueError(f"{what}: a slot tensor must be one int32 on {dev}, got "
                             f"{slot.dtype} {tuple(slot.shape)} on {slot.device}")
        slot_ptr, slot = slot.data_ptr(), 0
    elif not 0 <= slot <= T - n:
        raise ValueError(f"{what}: tokens [{slot}, {slot + n}) outside the destination's {T}")
    q_out = torch.empty((b, nh, t, hd), dtype=dt, device=dev)
    k_out = torch.empty((b, nkv, t, hd), dtype=dt, device=dev)
    v_out = torch.empty((b, nkv, t, hd), dtype=dt, device=dev) if t > 1 else None
    strides = (ctypes.c_longlong * 9)(
        rows["q"], rows["k"], rows["v"], *dest.k.stride()[:3], *dest.k_scale.stride())
    status = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
        None if v_out is None else v_out.data_ptr(), dest.k.data_ptr(), dest.v.data_ptr(),
        dest.k_scale.data_ptr(), dest.v_scale.data_ptr(), strides, b, t, nh, nkv, hd, T, w0, n,
        int(slot), slot_ptr, float(RECIP_127), threads_for(nh, nkv, hd),
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(status, what)
    cuda_lib.LAUNCHES["rope_kv_quant"] += 1
    if v_out is None:
        v_out = v.reshape(b, t, nkv, hd).transpose(1, 2)
    return q_out, k_out, v_out
