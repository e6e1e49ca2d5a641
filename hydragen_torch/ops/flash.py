"""Flash attention returning ``(out, lse)``: the two CUDA kernels of
``csrc/flash.cu`` behind two entries, each with its plain PyTorch version.

Port of ``hydragen_tpu.ops.flash``:
- ``flash_attention_bhsd``: causal prefill (diagonal aligned to the end) and
  non-causal reads, optional ``kv_seq_lens`` and int8 KV with per-token
  scales, GQA folded into the query rows; a non-causal call with at most 32
  folded query rows (a decode step's read of a BHSD cache) goes to the
  second kernel of ``csrc/flash.cu``, the small-M read (flash-decoding), which
  reads k/v through their strides;
- ``flash_attention_cached_bhsd``: non-causal read of ONE layer of the
  stacked shared-level buffers ``[L, SB, hkv, S, d]``, in place;
- ``flash_attention``: the BSHD wrapper.

A CUDA tensor goes to the kernel (bf16 queries, bf16 or int8 KV, head_dim 64
or 128) or raises; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops.reference import attention_bhsd

LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)
# K5 takes non-causal calls with at most this many folded query rows (the
# JAX package's decode-kernel threshold). It reads keys in tiles of
# DECODE_TILE, one warp a (row, split) item; decode_splits splits the keys
# (at most once for every DECODE_CHUNK of them) only where the rows cannot
# give each SM DECODE_WARPS_PER_SM[k/v dtype] items: half the warps an SM
# holds of each at D = 128 (csrc/flash.cu's DecCfg: 8 int8, 4 bf16), the
# best of 1-16 an SM at one 32,768-key sequence (kernel_times.py
# --split-policy).
DECODE_MAX_M = 32
DECODE_CHUNK = 512
DECODE_TILE = 32
DECODE_WARPS_PER_SM = {torch.int8: 4, torch.bfloat16: 2}
# K2/K4's block: query rows (two consumer warpgroups of 64) and keys a tile.
FLASH_BM = 128
FLASH_BN = 64
# flash_plan's cost of a block, in key tiles, over and above its own tiles:
# loading Q, filling the pipeline, writing out.
FLASH_BLOCK_TILES = 2


@functools.cache
def _fn():
    f = cuda_lib.library("flash").hydragen_flash_attention
    f.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    return f


@functools.cache
def flash_plan(BH: int, M: int, S: int, n_sm: int, causal: bool = False) -> tuple[int, int]:
    """K2/K4's KV split: (splits, keys a split covers, a multiple of
    ``FLASH_BN``). One block a (kv head, 128-row M block) and split, one
    block an SM at a time. No split for a causal call, where the pairs alone
    fill the ``n_sm`` SMs, or below 4 key tiles. Otherwise the split count
    (each split at least 2 tiles) whose grid finishes first: waves of
    ``n_sm`` blocks times each block's tiles plus ``FLASH_BLOCK_TILES``,
    the fewer splits on a tie. At the 7B and 8B decode reads (64 pairs,
    2,048 keys) that is 2 splits of 1,024 keys: 128 blocks, one wave."""
    tiles = -(-S // FLASH_BN)
    pairs = BH * -(-M // FLASH_BM)
    if causal or pairs >= n_sm or tiles < 4:
        return 1, max(tiles, 1) * FLASH_BN
    best_cost, splits = None, 1
    for s in range(1, tiles // 2 + 1):
        cost = -(-pairs * s // n_sm) * (-(-tiles // s) + FLASH_BLOCK_TILES)
        if best_cost is None or cost < best_cost:
            best_cost, splits = cost, s
    chunk = -(-tiles // splits) * FLASH_BN
    return -(-S // chunk), chunk


def _check(name, t, dev, dtypes):
    if t.device != dev or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(
            f"flash kernel: {name} must be a contiguous tensor of {dtypes} on {dev}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _launch(qf, k_rows, v_rows, ks_rows, vs_rows, lens, *, row_offset, BH, M, q_len,
            S, hkv, causal, scale):
    """qf [BH, M, d] bf16; k/v [..., S, d] (``rows`` = the product of the
    leading dims); scales [..., S] f32."""
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
        splits, chunk = flash_plan(BH, M, S, cuda_lib.sm_count(dev), causal)
        o_part = lse_part = None
        if splits > 1:
            # One f32 workspace: the partial outputs, then their lse.
            n = splits * BH * M
            ws = torch.empty(n * (d + 1), dtype=torch.float32, device=dev)
            o_part, lse_part = ws.data_ptr(), ws.data_ptr() + 4 * n * d
        status = _fn()(
            qf.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
            ks_rows.data_ptr() if int8 else None, vs_rows.data_ptr() if int8 else None,
            lens.data_ptr() if lens is not None else None,
            out.data_ptr(), lse.data_ptr(), o_part, lse_part,
            row_offset, math.prod(k_rows.shape[:-2]), BH, M, q_len, S, hkv, d,
            int(int8), int(causal), splits, chunk, scale * LOG2E, cuda_lib.stream_ptr(dev),
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
    ``[b, hq, m]`` f32), as ``ops.reference.attention_bhsd``.

    On a CUDA tensor a non-causal call with at most ``DECODE_MAX_M`` folded
    query rows (``hq // hkv * m``) launches the small-M read (K5), as the JAX
    package sends it to its decode kernel; every other call launches K2's
    kernel (K4 when causal)."""
    kw = dict(causal=causal, kv_seq_lens=kv_seq_lens, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
    if not q.is_cuda:
        return flash_attention_bhsd_plain(q, k, v, **kw)
    if not causal and q.shape[1] // k.shape[1] * q.shape[2] <= DECODE_MAX_M:
        return _flash_decode_bhsd(q, k, v, **kw)
    return _flash_bhsd(q, k, v, **kw)


def _flash_bhsd(q, k, v, *, causal, kv_seq_lens, scale, k_scale, v_scale):
    """K2's kernel (K4 when causal) on contiguous operands."""
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


def _decode_fn():
    f = cuda_lib.library("flash").hydragen_flash_decode
    f.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    return f


def decode_splits(BH: int, S: int, n_sm: int, per_sm: int) -> tuple[int, int]:
    """K5's KV split: (splits, keys a split covers). K5 gives each (row,
    split) item a warp of its own; one split when the ``BH`` rows alone give
    every one of the ``n_sm`` SMs ``per_sm`` items, or when ``S`` is at most
    ``DECODE_CHUNK``. Otherwise as many splits as that many items need, at
    most one for every ``DECODE_CHUNK`` keys, each chunk a multiple of
    ``DECODE_TILE``. At one 32,768-key sequence over 8 kv heads: 64 splits
    of 512 for int8 (4 an SM), 32 of 1,024 for bf16 (2)."""
    want = per_sm * n_sm
    if BH >= want or S <= DECODE_CHUNK:
        return 1, max(S, 1)
    splits = min(-(-S // DECODE_CHUNK), -(-want // BH))
    chunk = -(-S // (splits * DECODE_TILE)) * DECODE_TILE
    return -(-S // chunk), chunk


def _flash_decode_bhsd(q, k, v, *, causal, kv_seq_lens, scale, k_scale, v_scale):
    """K5: the small-M non-causal read, k/v and their scales read in place
    through their strides (a cache's per-layer view is not copied)."""
    assert not causal
    b, hq, m, d = q.shape
    _, hkv, s, _ = k.shape
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[-1] != d:
        raise ValueError(f"flash kernel (decode): q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    M = hq // hkv * m
    if M > DECODE_MAX_M:
        raise ValueError(f"flash kernel (decode): {M} folded query rows > {DECODE_MAX_M}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel (decode): head_dim {d} not in {HEAD_DIMS}")
    dev = q.device
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash kernel (decode): q must be bfloat16, got {q.dtype}")
    int8 = k.dtype == torch.int8
    if k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype:
        raise ValueError(f"flash kernel (decode): k/v must both be bfloat16 or int8, got "
                         f"{k.dtype} / {v.dtype}")
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("flash kernel (decode): int8 k/v need f32 scales, bf16 k/v none")
    elem = k.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.stride(-1) != 1 or any(x * elem % 16 for x in t.stride()[:3]):
            raise ValueError(f"flash kernel (decode): {name} must lie on {dev} with its last "
                             f"dim contiguous and 16-byte aligned rows, got strides "
                             f"{t.stride()} on {t.device}")
        cuda_lib.check_aligned(f"flash kernel (decode): {name}", t)
    strides = list(k.stride()[:3]) + list(v.stride()[:3])
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.device != dev or t.dtype != torch.float32 or t.shape != k.shape[:3]:
                raise ValueError(f"flash kernel (decode): {name} must be f32 {tuple(k.shape[:3])}"
                                 f" on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
            strides += list(t.stride())
    else:
        strides += [0] * 6
    lens = None
    if kv_seq_lens is not None:
        lens = kv_seq_lens.to(device=dev, dtype=torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError(f"flash kernel (decode): kv_seq_lens must be [{b}], got "
                             f"{tuple(lens.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    BH = b * hkv
    qf = q.contiguous().reshape(BH, M, d)  # GQA fold: a pure view of BHSD
    out = torch.empty((BH, M, d), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((BH, M), dtype=torch.float32, device=dev)
    if BH and M:
        splits, chunk = decode_splits(BH, s, cuda_lib.sm_count(dev),
                                      DECODE_WARPS_PER_SM[k.dtype])
        o_part = lse_part = None
        if splits > 1:
            o_part = torch.empty((splits, BH, M, d), dtype=torch.float32, device=dev)
            lse_part = torch.empty((splits, BH, M), dtype=torch.float32, device=dev)
        st = (ctypes.c_longlong * 12)(*strides)
        status = _decode_fn()(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
            lens.data_ptr() if lens is not None else None, ctypes.addressof(st),
            out.data_ptr(), lse.data_ptr(),
            o_part.data_ptr() if o_part is not None else None,
            lse_part.data_ptr() if lse_part is not None else None,
            BH, M, s, hkv, d, int(int8), splits, chunk, scale * LOG2E,
            cuda_lib.stream_ptr(dev),
        )
        cuda_lib.check(status, "flash decode")
        cuda_lib.LAUNCHES["flash_decode_bhsd"] += 1
    return out.reshape(b, hq, m, d), lse.reshape(b, hq, m)


def flash_attention_cached_plain(layer, q, k_all, v_all, *, kv_seq_lens=None,
                                 k_scale_all=None, v_scale_all=None, scale=None,
                                 row_start=0):
    """Plain PyTorch version of ``flash_attention_cached_bhsd``."""
    rows = slice(row_start, row_start + q.shape[0])
    return attention_bhsd(
        q, k_all[layer, rows], v_all[layer, rows], kv_seq_lens=kv_seq_lens, scale=scale,
        k_scale=None if k_scale_all is None else k_scale_all[layer, rows],
        v_scale=None if v_scale_all is None else v_scale_all[layer, rows],
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
    row_start: int = 0,
):
    """Non-causal flash attention reading ONE layer of stacked level buffers.

    q ``[b, hq, m, d]`` (folded); k_all/v_all ``[L, SB, hkv, S, d]`` with
    ``row_start + b <= SB``; scales ``[L, SB, hkv, S]`` f32; kv_seq_lens
    ``[b]``. Query row ``i`` reads prefix row ``row_start + i``: the kernel
    indexes kv row ``(layer * SB + row_start + i) * hkv + kv_head`` of the
    buffers as they are, so neither a layer nor a row is sliced out. Returns
    ``(out [b, hq, m, d], lse [b, hq, m])``, equal to ``flash_attention_bhsd``
    on that slice."""
    layer, row_start = int(layer), int(row_start)
    if not q.is_cuda:
        return flash_attention_cached_plain(
            layer, q, k_all, v_all, kv_seq_lens=kv_seq_lens, k_scale_all=k_scale_all,
            v_scale_all=v_scale_all, scale=scale, row_start=row_start,
        )
    b, hq, m, d = q.shape
    L, SB, hkv, s, dk = k_all.shape
    assert dk == d and hq % hkv == 0 and v_all.shape == k_all.shape
    assert 0 <= row_start and row_start + b <= SB, (
        f"prefix rows {row_start}..{row_start + b} exceed allocated level batch {SB}")
    assert 0 <= layer < L
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.contiguous().reshape(b * hkv, group * m, d)
    # The kernel reads the buffers as [L * SB * hkv, S, d] rows, in place.
    out, lse = _launch(
        qf, k_all, v_all, k_scale_all, v_scale_all, kv_seq_lens,
        row_offset=(layer * SB + row_start) * hkv, BH=b * hkv, M=group * m, q_len=m, S=s, hkv=hkv,
        causal=False, scale=scale,
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
