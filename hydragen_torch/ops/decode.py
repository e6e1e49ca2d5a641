"""Int8 and int4 decode attention over one layer of the BSHD unique cache,
with the step's own token and the shared-prefix partial merged in, and the
in-place int4 decode write: the CUDA kernels of ``csrc/decode.cu`` and their
plain PyTorch versions.

Port of ``hydragen_tpu.ops.decode``: ``decode_attention_cached`` (kv_bits 8
and 4), its one-layer wrapper ``decode_attention_bshd`` with the scale
layouts ``chunk_kv_scales`` / ``unchunk_kv_scales``, and
``gather_token_row_cached``. The cache is ``[L, B, S, hkv, d]``
int8 with flat lane-major scales ``[L, B, S*hkv]`` (the scale of token j,
head h at ``j*hkv + h``). At kv_bits=4 it is token-planar: S byte rows, byte
row j holding token j in its low nibble and token j + S in its high nibble,
and the scales cover the 2S logical tokens. The TPU kernel re-quantizes q
and p to s8 for its matrix unit; this port computes both products in fp32
from the dequantized payload, which is the exact path the JAX package runs
off the TPU.

``write_token_int4_cached`` is the port of ``gather_token_row_cached``
together with the int4 write it serves: the TPU reads the byte row through a
kernel only to pin the buffer's layout, so here one kernel quantizes a
layer's new K and V token (``quantize_kv4``), merges the nibbles into byte
row ``slot % S`` and writes the scales.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops.combine import combine_lse_with_stats
from hydragen_torch.ops.quant import nibble_merge, quantize_kv4
from hydragen_torch.ops.reference import attention_bhsd

HEAD_DIMS = (64, 128)
MAX_GROUP = 8


def chunk_kv_scales(scale: torch.Tensor, c: int) -> torch.Tensor:
    """``[..., s, hkv]`` f32 -> ``[..., hkv/c, s*c]``, the lane-major chunk
    layout: element ``(j, t*c + i)`` holds the scale of token ``t``, kv head
    ``j*c + i``. With ``c == hkv`` this is the cache's flat-scale layout
    (``[..., 1, s*hkv]``)."""
    *lead, s, hkv = scale.shape
    if hkv % c:
        raise ValueError(f"chunk_kv_scales: {hkv} kv heads do not split into chunks of {c}")
    x = scale.reshape(*lead, s, hkv // c, c).movedim(-2, -3)  # [..., hkv/c, s, c]
    return x.reshape(*lead, hkv // c, s * c)


def unchunk_kv_scales(chunked: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`chunk_kv_scales`: ``[..., hkv/c, s*c]`` -> ``[...,
    s, hkv]``."""
    *lead, nc, sc = chunked.shape
    x = chunked.reshape(*lead, nc, sc // c, c).movedim(-3, -2)  # [..., s, hkv/c, c]
    return x.reshape(*lead, sc // c, nc * c)


def _fn():
    f = cuda_lib.library("decode").hydragen_decode_attention
    f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _write_fn():
    f = cuda_lib.library("decode").hydragen_write_int4
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    f.restype = ctypes.c_int
    return f


def decode_attention_cached_plain(layer, q, k_all, v_all, *, kv_seq_lens, k_scale_all,
                                  v_scale_all, own_kv=None, shared_partial=None,
                                  scale=None, kv_bits=8):
    """Plain PyTorch version of ``decode_attention_cached``: the exact
    attention over the layer's slice, the own token as one more partial, and
    the LSE merge."""
    b, hq, _, d = q.shape
    _, _, S, hkv, _ = k_all.shape
    s_logical = 2 * S if kv_bits == 4 else S  # S = byte rows at int4
    lens = torch.clamp(kv_seq_lens.to(torch.int32), max=s_logical)
    o, l = attention_bhsd(
        q, k_all[layer, :b], v_all[layer, :b], kv_seq_lens=lens, scale=scale,
        k_scale=k_scale_all[layer, :b].reshape(b, s_logical, hkv),
        v_scale=v_scale_all[layer, :b].reshape(b, s_logical, hkv), kv_bshd=True,
        kv_bits=kv_bits,
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
    kv_bits: int = 8,
):
    """Int8 or int4 decode attention reading ONE layer of the stacked BSHD
    cache.

    Args:
        layer: layer index; the kernel reads the buffers in place.
        q: ``[b, hq, 1, d]`` queries.
        k_all, v_all: ``[L, B, S, hkv, d]`` int8 cache buffers (B >= b); at
            ``kv_bits=4`` token-planar nibble packs of S byte rows.
        kv_seq_lens: ``[b]`` valid logical lengths (clamped to S, or 2S at
            int4).
        k_scale_all, v_scale_all: ``[L, B, S*hkv]`` f32 flat scales
            (``[L, B, 2S*hkv]`` at int4).
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
            scale=scale, kv_bits=kv_bits,
        )
    b, hq, m, d = q.shape
    L, B, S, hkv, dk = k_all.shape
    dev = q.device
    if kv_bits not in (8, 4):
        raise ValueError(f"decode kernel: kv_bits {kv_bits} not in (8, 4)")
    planes = 2 if kv_bits == 4 else 1
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
    if v_all.shape != k_all.shape or k_scale_all.shape != (L, B, planes * S * hkv) \
            or v_scale_all.shape != k_scale_all.shape:
        raise ValueError(f"decode kernel: cache {tuple(k_all.shape)} and scales "
                         f"{tuple(k_scale_all.shape)} disagree at kv_bits={kv_bits}")
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
    for name, t in (("q", qc), ("own k", k1), ("own v", v1), ("shared out", o_sh)):
        if t is not None:  # read as 16-byte vectors
            cuda_lib.check_aligned(f"decode kernel: {name}", t)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, hq, 1, d), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, hq, 1), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = _fn()(
        qc.data_ptr(),
        k_all.data_ptr() + layer * B * S * hkv * d,
        v_all.data_ptr() + layer * B * S * hkv * d,
        k_scale_all.data_ptr() + layer * B * planes * S * hkv * 4,
        v_scale_all.data_ptr() + layer * B * planes * S * hkv * 4,
        lens.data_ptr(), ptr(k1), ptr(v1), ptr(o_sh), ptr(lse_sh),
        out.data_ptr(), lse.data_ptr(), b, S, hkv, group, d, kv_bits, scale,
        cuda_lib.stream_ptr(dev),
    )
    counter = "decode_attention_cached" if kv_bits == 8 else "decode_attention_cached_int4"
    cuda_lib.check(status, counter)
    cuda_lib.LAUNCHES[counter] += 1
    return out, lse


def decode_attention_bshd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_seq_lens: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    scale: float | None = None,
    scales_chunked: bool = False,
    own_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    shared_partial: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """One layer's int8 decode read: :func:`decode_attention_cached` over a
    single-layer BSHD cache (K3 on a CUDA tensor, its plain version on a CPU
    tensor).

    q ``[b, hq, 1, d]``; k/v ``[b, s, hkv, d]`` int8; k_scale/v_scale ``[b,
    s, hkv]`` f32, or already flat (``[b, s*hkv]`` or ``[b, 1, s*hkv]``,
    :func:`chunk_kv_scales` with ``c = hkv``) when ``scales_chunked``;
    ``own_kv`` and ``shared_partial`` as in :func:`decode_attention_cached`.
    The JAX function's ``block_s`` and ``row_batch`` are TPU tilings: K3
    has no such parameter (a warp reads a (row, kv head) pair), so they are
    not taken."""
    b, s, hkv, _ = k.shape

    def flat(sc):
        sc = sc.float()
        if not scales_chunked:
            sc = chunk_kv_scales(sc, hkv)
        return sc.reshape(1, b, s * hkv).contiguous()

    return decode_attention_cached(
        0, q, k.contiguous()[None], v.contiguous()[None], kv_seq_lens=kv_seq_lens,
        k_scale_all=flat(k_scale), v_scale_all=flat(v_scale), own_kv=own_kv,
        shared_partial=shared_partial, scale=scale,
    )


def gather_token_row_cached(layer: int | None, row, buf: torch.Tensor) -> torch.Tensor:
    """Byte row ``row`` of layer ``layer`` of a stacked BSHD cache buffer
    ``[L, B, S, hkv, d]`` -> ``[B, hkv, d]`` (``layer=None``: every layer,
    ``[L, B, hkv, d]``), as a copy. ``row`` is a host int or a one-element
    device index. On the TPU this read is a kernel that pins the buffer's
    layout; here it is an index, read by the plain int4 write."""
    rows = buf if layer is None else buf[layer]
    if torch.is_tensor(row):
        return rows.index_select(-3, row.reshape(1).long()).squeeze(-3)
    return rows[..., row, :, :].clone()


def slot_index(slot, device) -> torch.Tensor:
    """A decode slot as a one-element int64 index on ``device``: a host int,
    or a device int scalar (a decode step's own, which a captured graph
    reads from device memory at every replay)."""
    if torch.is_tensor(slot):
        return slot.reshape(1).long()
    return torch.tensor([slot], dtype=torch.long, device=device)


def write_token_int4_cached_plain(layer, k, v, k_all, v_all, k_scale_all, v_scale_all,
                                  slot):
    """Plain PyTorch version of ``write_token_int4_cached``: ``quantize_kv4``,
    the nibble read-modify-write of byte row ``slot % S`` and the scale
    write, in place. ``slot`` is a host int or a device int scalar, indexed
    on the device (no host sync)."""
    b, hkv = k.shape[0], k.shape[1]
    S = k_all.shape[2]
    idx = slot_index(slot, k.device)
    row, is_hi = idx % S, idx >= S
    cols = idx * hkv + torch.arange(hkv, device=k.device)
    for x, buf, sbuf in ((k, k_all, k_scale_all), (v, v_all, v_scale_all)):
        q4, sc = quantize_kv4(x[:, :, 0])  # [b, hkv, d], [b, hkv]
        old = gather_token_row_cached(layer, row, buf)[:b]
        buf[layer, :b].index_copy_(1, row, nibble_merge(old, q4, is_hi)[:, None])
        sbuf[layer, :b].index_copy_(1, cols, sc)


def write_token_int4_cached(
    layer: int,
    k: torch.Tensor,
    v: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    k_scale_all: torch.Tensor,
    v_scale_all: torch.Tensor,
    slot,
) -> None:
    """Write one layer's decode token into the int4 BSHD cache, in place.

    Args:
        layer: layer index; the kernel writes the buffers in place.
        k, v: ``[b, hkv, 1, d]`` bf16, this step's token.
        k_all, v_all: ``[L, B, S, hkv, d]`` int8 token-planar caches (S byte
            rows; byte row j holds token j low and token j + S high).
        k_scale_all, v_scale_all: ``[L, B, 2S*hkv]`` f32 flat scales.
        slot: the logical token written, the same for every row
            (``0 <= slot < 2S``): a host int, checked here, or a one-element
            int32 tensor on the card, which the kernel reads from device
            memory where it runs (a captured graph's step writes the slot
            it computed). The kernel writes nothing for a device slot out of
            range; the caller checks it (``generate`` does, once a call).

    One kernel launch writes K and V: the quantized nibbles into byte row
    ``slot % S`` (the high nibble at ``slot >= S``, keeping the live low
    token; the low nibble below, clearing the stale high one; the kernel
    picks the plane from the slot it reads) and the scales at ``slot*hkv``.
    On a CUDA tensor it raises where ``k``, ``v`` or the layer's cache base
    is not 16-byte aligned.
    """
    layer = int(layer)
    if not k.is_cuda:
        return write_token_int4_cached_plain(layer, k, v, k_all, v_all, k_scale_all,
                                             v_scale_all, slot)
    b, hkv, m, d = k.shape
    L, B, S, hkv2, d2 = k_all.shape
    dev = k.device
    slot_ptr = None
    if torch.is_tensor(slot):
        if slot.device != dev or slot.dtype != torch.int32 or slot.numel() != 1:
            raise ValueError(f"int4 write kernel: a slot tensor must be one int32 on {dev}, "
                             f"got {slot.dtype} {tuple(slot.shape)} on {slot.device}")
        slot_ptr, slot = slot.data_ptr(), 0
    slot = int(slot)
    if m != 1 or (hkv2, d2) != (hkv, d) or b > B or not 0 <= layer < L \
            or not 0 <= slot < 2 * S or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"int4 write kernel: bad shapes k {tuple(k.shape)} cache "
                         f"{tuple(k_all.shape)} layer {layer} slot {slot}")
    if d not in HEAD_DIMS:
        raise ValueError(f"int4 write kernel: head_dim {d} not in {HEAD_DIMS}")
    for name, t, dt in (("k", k, torch.bfloat16), ("v", v, torch.bfloat16),
                        ("k_all", k_all, torch.int8), ("v_all", v_all, torch.int8),
                        ("k_scale_all", k_scale_all, torch.float32),
                        ("v_scale_all", v_scale_all, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"int4 write kernel: {name} must be a contiguous {dt} tensor "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if v_all.shape != k_all.shape or k_scale_all.shape != (L, B, 2 * S * hkv) \
            or v_scale_all.shape != k_scale_all.shape:
        raise ValueError("int4 write kernel: cache and scale shapes disagree")
    # 16-byte loads of k and v; 8-byte loads and stores of byte rows, which
    # start on 64-byte boundaries of an aligned layer base.
    for name, t in (("k", k), ("v", v), ("k_all", k_all[layer]), ("v_all", v_all[layer])):
        cuda_lib.check_aligned(f"int4 write kernel: {name}", t)
    row_bytes = B * S * hkv * d
    status = _write_fn()(
        k.data_ptr(), v.data_ptr(),
        k_all.data_ptr() + layer * row_bytes, v_all.data_ptr() + layer * row_bytes,
        k_scale_all.data_ptr() + layer * B * 2 * S * hkv * 4,
        v_scale_all.data_ptr() + layer * B * 2 * S * hkv * 4,
        b, S, hkv, d, slot, slot_ptr, cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(status, "write_token_int4_cached")
    cuda_lib.LAUNCHES["write_token_int4_cached"] += 1
