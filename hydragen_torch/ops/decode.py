"""Int8 decode attention over one layer of the BSHD unique cache, with the
step's own token and the shared-prefix partial merged in: the CUDA kernel of
``csrc/decode.cu`` and its plain PyTorch version.

Port of ``hydragen_tpu.ops.decode.decode_attention_cached`` at kv_bits=8.
The cache is ``[L, B, S, hkv, d]`` int8 with flat lane-major scales
``[L, B, S*hkv]`` (the scale of token j, head h at ``j*hkv + h``). The TPU
kernel re-quantizes q and p to s8 for its matrix unit; this port computes
both products in fp32 from the dequantized int8, which is the exact path the
JAX package runs off the TPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops.combine import combine_lse_with_stats
from hydragen_torch.ops.reference import attention_bhsd

HEAD_DIMS = (64, 128)
MAX_GROUP = 8


def _fn():
    f = cuda_lib.library("decode").hydragen_decode_attention
    f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def decode_attention_cached_plain(layer, q, k_all, v_all, *, kv_seq_lens, k_scale_all,
                                  v_scale_all, own_kv=None, shared_partial=None,
                                  scale=None):
    """Plain PyTorch version of ``decode_attention_cached``: the exact
    attention over the layer's slice, the own token as one more partial, and
    the LSE merge."""
    b, hq, _, d = q.shape
    _, _, S, hkv, _ = k_all.shape
    lens = torch.clamp(kv_seq_lens.to(torch.int32), max=S)
    o, l = attention_bhsd(
        q, k_all[layer, :b], v_all[layer, :b], kv_seq_lens=lens, scale=scale,
        k_scale=k_scale_all[layer, :b].reshape(b, S, hkv),
        v_scale=v_scale_all[layer, :b].reshape(b, S, hkv), kv_bshd=True,
    )
    outs, lses = [o], [l]
    if own_kv is not None:
        # Softmax over the single own column is the identity: out = v,
        # lse = scale * q.k.
        k1, v1 = own_kv
        group = hq // hkv
        sc = 1.0 / math.sqrt(d) if scale is None else scale
        qg = q.float().reshape(b, hkv, group, 1, d)
        outs.append(v1[:, :, None].expand(b, hkv, group, 1, d).reshape(b, hq, 1, d)
                    .to(q.dtype))
        lses.append((torch.einsum("bkgmd,bkmd->bkgm", qg, k1.float()) * sc)
                    .reshape(b, hq, 1))
    if shared_partial is not None:
        outs.insert(0, shared_partial[0])
        lses.insert(0, shared_partial[1])
    if len(outs) == 1:
        return o, l
    return combine_lse_with_stats(outs, lses)


def decode_attention_cached(
    layer: int,
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    *,
    kv_seq_lens: torch.Tensor,
    k_scale_all: torch.Tensor,
    v_scale_all: torch.Tensor,
    own_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    shared_partial: tuple[torch.Tensor, torch.Tensor] | None = None,
    scale: float | None = None,
):
    """Int8 decode attention reading ONE layer of the stacked BSHD cache.

    Args:
        layer: layer index; the kernel reads the buffers in place.
        q: ``[b, hq, 1, d]`` queries.
        k_all, v_all: ``[L, B, S, hkv, d]`` int8 cache buffers (B >= b).
        kv_seq_lens: ``[b]`` valid lengths (clamped to S).
        k_scale_all, v_scale_all: ``[L, B, S*hkv]`` f32 flat scales.
        own_kv: optional ``(k1, v1)`` each ``[b, hkv, 1, d]``: this step's own
            token, one more softmax column per row.
        shared_partial: optional ``(o_sh [b, hq, 1, d], lse_sh [b, hq, 1])``,
            merged exactly by LSE, so the result is the final attention.

    Returns out ``[b, hq, 1, d]`` (q.dtype) and lse ``[b, hq, 1]`` f32 of the
    merged result.
    """
    layer = int(layer)
    if not q.is_cuda:
        return decode_attention_cached_plain(
            layer, q, k_all, v_all, kv_seq_lens=kv_seq_lens, k_scale_all=k_scale_all,
            v_scale_all=v_scale_all, own_kv=own_kv, shared_partial=shared_partial,
            scale=scale,
        )
    b, hq, m, d = q.shape
    L, B, S, hkv, dk = k_all.shape
    dev = q.device
    if m != 1 or dk != d or hq % hkv or b > B or not 0 <= layer < L:
        raise ValueError(f"decode kernel: bad shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_all.shape)} layer {layer}")
    group = hq // hkv
    if d not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"decode kernel: needs head_dim in {HEAD_DIMS} and group <= "
                         f"{MAX_GROUP}, got {d} and {group}")
    for name, t, dt in (("k_all", k_all, torch.int8), ("v_all", v_all, torch.int8),
                        ("k_scale_all", k_scale_all, torch.float32),
                        ("v_scale_all", v_scale_all, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"decode kernel: {name} must be a contiguous {dt} tensor "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if v_all.shape != k_all.shape or k_scale_all.shape != (L, B, S * hkv) \
            or v_scale_all.shape != k_scale_all.shape:
        raise ValueError("decode kernel: cache and scale shapes disagree")
    cuda_lib.check_aligned("decode kernel: k_all", k_all)
    cuda_lib.check_aligned("decode kernel: v_all", v_all)

    def small(t, shape, dtype, name):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"decode kernel: {name} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        return t.contiguous()

    qc = small(q, (b, hq, 1, d), torch.bfloat16, "q")
    lens = small(kv_seq_lens.to(torch.int32), (b,), torch.int32, "kv_seq_lens")
    k1 = v1 = o_sh = lse_sh = None
    if own_kv is not None:
        k1 = small(own_kv[0], (b, hkv, 1, d), torch.bfloat16, "own k")
        v1 = small(own_kv[1], (b, hkv, 1, d), torch.bfloat16, "own v")
    if shared_partial is not None:
        o_sh = small(shared_partial[0], (b, hq, 1, d), torch.bfloat16, "shared out")
        lse_sh = small(shared_partial[1].float(), (b, hq, 1), torch.float32, "shared lse")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, hq, 1, d), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, hq, 1), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = _fn()(
        qc.data_ptr(),
        k_all.data_ptr() + layer * B * S * hkv * d,
        v_all.data_ptr() + layer * B * S * hkv * d,
        k_scale_all.data_ptr() + layer * B * S * hkv * 4,
        v_scale_all.data_ptr() + layer * B * S * hkv * 4,
        lens.data_ptr(), ptr(k1), ptr(v1), ptr(o_sh), ptr(lse_sh),
        out.data_ptr(), lse.data_ptr(), b, S, hkv, group, d, scale,
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(status, "decode_attention_cached")
    cuda_lib.LAUNCHES["decode_attention_cached"] += 1
    return out, lse
