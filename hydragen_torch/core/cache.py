"""KV caches: the unique per-sequence cache and the stack of shared levels.

Port of ``hydragen_tpu.core.cache`` (int8 and float stores). Shapes, dtypes
and scale layouts are the JAX package's, so caches compare tensor by tensor:
- a shared level holds ``[L, sb, hkv, S, hd]`` payloads with ``[L, sb, hkv,
  S]`` f32 scales when quantized, plus ``seq_lens [sb]``;
- the unique cache is ``[L, B, hkv, U, hd]`` (BHSD) or ``[L, B, U, hkv, hd]``
  (BSHD, ``unique_bshd``), with scales ``[L, B, hkv, U]``, ``[L, B, U,
  hkv]`` or flat lane-major ``[L, B, U*hkv]`` (``flat_scales``; the decode
  kernel's layout).

Where the JAX package returns a new cache from a functional
``dynamic_update_slice``, these writers update the buffers IN PLACE and
return the (same) cache object, so callers keep the ``cache = write(cache,
...)`` form.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from hydragen_torch.ops.quant import quantize_kv


def _maybe_quantize(x: torch.Tensor, quantized: bool):
    """-> (payload, scale|None) in the cache's storage format."""
    if quantized:
        return quantize_kv(x)
    return x, None


class SharedLevel(NamedTuple):
    """One level of the shared-prefix hierarchy, all layers stacked."""

    k: torch.Tensor
    v: torch.Tensor
    seq_lens: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_batch_size(self) -> int:
        return self.k.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


@dataclasses.dataclass
class KVCache:
    """Full cache state: unique cache + allocated shared levels (how many
    are active is tracked by the engine)."""

    unique_k: torch.Tensor
    unique_v: torch.Tensor
    shared: Tuple[SharedLevel, ...]
    unique_k_scale: Optional[torch.Tensor] = None
    unique_v_scale: Optional[torch.Tensor] = None
    unique_bshd: bool = False
    flat_scales: bool = False

    @property
    def max_unique_batch_size(self) -> int:
        return self.unique_k.shape[1]

    @property
    def max_unique_seq_len(self) -> int:
        return self.unique_k.shape[2 if self.unique_bshd else 3]

    @property
    def quantized(self) -> bool:
        return self.unique_k_scale is not None


def allocate_cache(
    num_layers: int,
    max_unique_batch_size: int,
    max_unique_seq_length: int,
    max_shared_batch_sizes: Sequence[int],
    max_shared_seq_lengths: Sequence[int],
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    quantized: bool = False,
    unique_bshd: Optional[bool] = None,
    flat_scales: Optional[bool] = None,
    shared_quantized: Optional[bool] = None,
    device=None,
) -> KVCache:
    """Allocate zeroed cache buffers.

    ``unique_bshd`` None = the JAX package's rule: BSHD iff one token's KV of
    all heads is a whole number of 4 KiB (``hkv * hd * itemsize % 4096 ==
    0``). ``flat_scales`` None = on for a quantized BSHD unique cache.
    ``shared_quantized`` None = follow ``quantized``.
    """
    assert len(max_shared_batch_sizes) == len(max_shared_seq_lengths)
    itemsize = 1 if quantized else torch.empty((), dtype=dtype).element_size()
    if unique_bshd is None:
        unique_bshd = (num_kv_heads * head_dim * itemsize) % 4096 == 0
    if flat_scales is None:
        flat_scales = unique_bshd and quantized
    flat_scales = bool(flat_scales and unique_bshd and quantized)
    if shared_quantized is None:
        shared_quantized = quantized

    def bufs(b, s, bshd=False, flat=False, quant=quantized):
        shape = (
            (num_layers, b, s, num_kv_heads, head_dim) if bshd
            else (num_layers, b, num_kv_heads, s, head_dim)
        )
        k = torch.zeros(shape, dtype=torch.int8 if quant else dtype, device=device)
        sc = None
        if quant:
            if flat:
                sshape = (num_layers, b, s * num_kv_heads)
            elif bshd:
                sshape = (num_layers, b, s, num_kv_heads)
            else:
                sshape = (num_layers, b, num_kv_heads, s)
            sc = torch.zeros(sshape, dtype=torch.float32, device=device)
        return k, torch.zeros_like(k), sc, None if sc is None else torch.zeros_like(sc)

    uk, uv, uks, uvs = bufs(max_unique_batch_size, max_unique_seq_length,
                            bshd=unique_bshd, flat=flat_scales)
    shared = []
    for sb, sl in zip(max_shared_batch_sizes, max_shared_seq_lengths):
        k, v, ks, vs = bufs(sb, sl, quant=shared_quantized)
        shared.append(SharedLevel(
            k=k, v=v, k_scale=ks, v_scale=vs,
            seq_lens=torch.zeros((sb,), dtype=torch.int32, device=device),
        ))
    return KVCache(
        unique_k=uk, unique_v=uv, shared=tuple(shared), unique_k_scale=uks,
        unique_v_scale=uvs, unique_bshd=unique_bshd, flat_scales=flat_scales,
    )


def shared_len_for_batch(
    cache: KVCache, num_used_levels: int, batch_size: int,
    batch_sizes: Sequence[int] | None = None,
) -> torch.Tensor:
    """Total shared-prefix length per sequence, ``[batch_size]`` int32: each
    level's per-prefix lengths repeat-interleaved up to the batch and summed.
    ``batch_sizes`` gives each level's filled prefix count."""
    total = torch.zeros((batch_size,), dtype=torch.int32,
                        device=cache.unique_k.device)
    for i, level in enumerate(cache.shared[:num_used_levels]):
        sb = batch_sizes[i] if batch_sizes else level.max_batch_size
        assert batch_size % sb == 0, f"{batch_size} % {sb} != 0"
        total = total + level.seq_lens[:sb].repeat_interleave(batch_size // sb)
    return total


def fill_shared_level(cache: KVCache, level_idx: int, k, v,
                      seq_lens: torch.Tensor) -> KVCache:
    """Write a freshly prefilled level, in place.

    k, v: ``[L, sb, hkv, t, hd]`` (compute dtype; quantized here if the level
    stores int8) or pre-quantized ``(payload, scale)`` pairs.
    """
    level = cache.shared[level_idx]
    if isinstance(k, tuple):
        assert level.quantized
        (kq, ks), (vq, vs) = k, v
    else:
        kq, ks = _maybe_quantize(k, level.quantized)
        vq, vs = _maybe_quantize(v, level.quantized)
    sb, t = kq.shape[1], kq.shape[3]
    assert sb <= level.max_batch_size and t <= level.max_seq_len, (
        f"level {level_idx}: got [{sb},{t}] max [{level.max_batch_size},"
        f"{level.max_seq_len}]"
    )
    level.k[:, :sb, :, :t] = kq.to(level.k.dtype)
    level.v[:, :sb, :, :t] = vq.to(level.v.dtype)
    if ks is not None:
        level.k_scale[:, :sb, :, :t] = ks
        level.v_scale[:, :sb, :, :t] = vs
    level.seq_lens[:sb] = seq_lens.to(torch.int32)
    return cache


def set_shared_level_buffers(cache: KVCache, level_idx: int, seq_lens: torch.Tensor
                             ) -> KVCache:
    """Finish a level whose buffers the forward pass filled in place
    (``model_forward(fill_level=...)``): record its prefix lengths."""
    cache.shared[level_idx].seq_lens[: seq_lens.shape[0]] = seq_lens.to(torch.int32)
    return cache


def update_unique_prefill(cache: KVCache, k, v, start: int = 0,
                          row_start: int = 0) -> KVCache:
    """Write prefill KVs at unique positions ``[start, start+t)`` of rows
    ``[row_start, row_start+b)``, in place.

    k, v: ``[L, b, hkv, t, hd]`` or pre-quantized ``(payload, scale)`` pairs
    (scale ``[L, b, hkv, t]``).
    """
    if isinstance(k, tuple):
        assert cache.quantized
        (kq, ks), (vq, vs) = k, v
    else:
        kq, ks = _maybe_quantize(k, cache.quantized)
        vq, vs = _maybe_quantize(v, cache.quantized)
    L, bb, hkv, t = kq.shape[:4]
    rows = slice(row_start, row_start + bb)
    toks = slice(start, start + t)
    if cache.unique_bshd:
        cache.unique_k[:, rows, toks] = kq.transpose(2, 3).to(cache.unique_k.dtype)
        cache.unique_v[:, rows, toks] = vq.transpose(2, 3).to(cache.unique_v.dtype)
        if ks is not None:
            if cache.flat_scales:
                # [L, b, hkv, t] -> token-major head-minor [L, b, t*hkv].
                cols = slice(start * hkv, (start + t) * hkv)
                cache.unique_k_scale[:, rows, cols] = ks.transpose(2, 3).reshape(L, bb, -1)
                cache.unique_v_scale[:, rows, cols] = vs.transpose(2, 3).reshape(L, bb, -1)
            else:
                cache.unique_k_scale[:, rows, toks] = ks.transpose(2, 3)
                cache.unique_v_scale[:, rows, toks] = vs.transpose(2, 3)
    else:
        cache.unique_k[:, rows, :, toks] = kq.to(cache.unique_k.dtype)
        cache.unique_v[:, rows, :, toks] = vq.to(cache.unique_v.dtype)
        if ks is not None:
            cache.unique_k_scale[:, rows, :, toks] = ks
            cache.unique_v_scale[:, rows, :, toks] = vs
    return cache


def update_unique_decode(cache: KVCache, positions: torch.Tensor, k, v,
                         uniform: int | None = None) -> KVCache:
    """Write one decode-step token per row at per-row ``positions``, in place.

    positions: ``[b]`` int. k, v: ``[L, b, hkv, 1, hd]``. ``uniform``: the
    host-known position shared by all rows (a contiguous slice write), or
    None for the per-row scatter.
    """
    if uniform is not None:
        L, b = k.shape[:2]
        for li in range(L):
            write_decode_token_layer(cache, li, k[li], v[li], uniform)
        return cache
    kq, ks = _maybe_quantize(k, cache.quantized)
    vq, vs = _maybe_quantize(v, cache.quantized)
    b, hkv = k.shape[1], k.shape[2]
    rows = torch.arange(b, device=positions.device)
    pos = positions.long()
    if cache.unique_bshd:
        cache.unique_k[:, rows, pos] = kq[:, :, :, 0].to(cache.unique_k.dtype)
        cache.unique_v[:, rows, pos] = vq[:, :, :, 0].to(cache.unique_v.dtype)
        if ks is not None:
            if cache.flat_scales:
                cols = pos[:, None] * hkv + torch.arange(hkv, device=pos.device)[None, :]
                cache.unique_k_scale[:, rows[:, None], cols] = ks[:, :, :, 0]
                cache.unique_v_scale[:, rows[:, None], cols] = vs[:, :, :, 0]
            else:
                cache.unique_k_scale[:, rows, pos] = ks[:, :, :, 0]
                cache.unique_v_scale[:, rows, pos] = vs[:, :, :, 0]
    else:
        # Advanced indices on dims (1, 3) with a slice between: the indexed
        # dims move to the front, so the value is [b, L, hkv, hd].
        cache.unique_k[:, rows, :, pos] = kq[:, :, :, 0].transpose(0, 1).to(
            cache.unique_k.dtype)
        cache.unique_v[:, rows, :, pos] = vq[:, :, :, 0].transpose(0, 1).to(
            cache.unique_v.dtype)
        if ks is not None:
            cache.unique_k_scale[:, rows, :, pos] = ks[:, :, :, 0].transpose(0, 1)
            cache.unique_v_scale[:, rows, :, pos] = vs[:, :, :, 0].transpose(0, 1)
    return cache


def write_decode_token_layer(cache: KVCache, layer: int, k, v, slot: int) -> KVCache:
    """Write ONE layer's single decode token at the uniform ``slot``, in
    place. k, v: ``[b, hkv, 1, hd]``."""
    assert 0 <= slot < cache.max_unique_seq_len, (slot, cache.max_unique_seq_len)
    kq, ks = _maybe_quantize(k, cache.quantized)
    vq, vs = _maybe_quantize(v, cache.quantized)
    b, hkv = k.shape[0], k.shape[1]
    if cache.unique_bshd:
        cache.unique_k[layer, :b, slot] = kq[:, :, 0].to(cache.unique_k.dtype)
        cache.unique_v[layer, :b, slot] = vq[:, :, 0].to(cache.unique_v.dtype)
        if ks is not None:
            if cache.flat_scales:
                cols = slice(slot * hkv, (slot + 1) * hkv)
                cache.unique_k_scale[layer, :b, cols] = ks[:, :, 0]
                cache.unique_v_scale[layer, :b, cols] = vs[:, :, 0]
            else:
                cache.unique_k_scale[layer, :b, slot] = ks[:, :, 0]
                cache.unique_v_scale[layer, :b, slot] = vs[:, :, 0]
    else:
        cache.unique_k[layer, :b, :, slot] = kq[:, :, 0].to(cache.unique_k.dtype)
        cache.unique_v[layer, :b, :, slot] = vq[:, :, 0].to(cache.unique_v.dtype)
        if ks is not None:
            cache.unique_k_scale[layer, :b, :, slot] = ks[:, :, 0]
            cache.unique_v_scale[layer, :b, :, slot] = vs[:, :, 0]
    return cache


def repeat_unique_for_samples(cache: KVCache, current_size: int,
                              num_samples: int) -> KVCache:
    """repeat_interleave rows [0:current_size] -> [0:current_size*num_samples],
    in place."""
    if num_samples == 1:
        return cache
    n = current_size * num_samples
    for buf in (cache.unique_k, cache.unique_v, cache.unique_k_scale,
                cache.unique_v_scale):
        if buf is not None:
            buf[:, :n] = buf[:, :current_size].repeat_interleave(num_samples, dim=1)
    return cache
