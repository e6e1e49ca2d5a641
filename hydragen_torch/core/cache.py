"""KV caches: the unique per-sequence cache and the stack of shared levels.

Port of ``hydragen_tpu.core.cache`` (int8 and float stores). Shapes, dtypes
and scale layouts are the JAX package's, so caches compare tensor by tensor:
- a shared level holds ``[L, sb, hkv, S, hd]`` payloads with ``[L, sb, hkv,
  S]`` f32 scales when quantized, plus ``seq_lens [sb]``;
- the unique cache is ``[L, B, hkv, U, hd]`` (BHSD) or ``[L, B, U, hkv, hd]``
  (BSHD, ``unique_bshd``), with scales ``[L, B, hkv, U]``, ``[L, B, U,
  hkv]`` or flat lane-major ``[L, B, U*hkv]`` (``flat_scales``; the decode
  kernel's layout);
- at ``unique_bits=4`` the unique payload is token-planar int4: U/2 byte
  rows, byte row j holding token j in its low nibble and token j + U/2 in
  its high nibble, while the scales keep all U logical tokens.

Where the JAX package returns a new cache from a functional
``dynamic_update_slice``, these writers update the buffers IN PLACE and
return the (same) cache object, so callers keep the ``cache = write(cache,
...)`` form.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from hydragen_torch.ops import decode as decode_ops
from hydragen_torch.ops.quant import nibble_merge, quantize_kv, quantize_kv4
from hydragen_torch.parallel.shard_attn import fold_segments


def _maybe_quantize(x: torch.Tensor, quantized: bool, bits: int = 8):
    """-> (payload, scale|None) in the cache's storage format. ``bits=4``
    returns UNPACKED int4 values (``quantize_kv4``); the write paths pack
    them along the token axis."""
    if quantized:
        return quantize_kv4(x) if bits == 4 else quantize_kv(x)
    return x, None


def _nibble_rmw(view: torch.Tensor, dim: int, row: torch.Tensor, q4_val: torch.Tensor,
                is_hi: torch.Tensor):
    """Write one decode token's int4 values as a NIBBLE of byte row ``row``
    (a one-element index along ``dim`` of ``view``), in place: the low-plane
    write clears the stale high partner; the high-plane write merges over
    the live low partner. ``is_hi`` is a device bool."""
    old = view.index_select(dim, row)
    view.index_copy_(dim, row, nibble_merge(old, q4_val.unsqueeze(dim), is_hi))


class SharedLevel(NamedTuple):
    """One level of the shared-prefix hierarchy, all layers stacked. Under a
    mesh whose sp axis splits the level's sequence, the buffers hold shard
    ``seq_shard`` of ``seq_shards`` (tokens ``[seq_offset, seq_offset +
    max_seq_len)``), while ``seq_lens`` stay the global prefix lengths."""

    k: torch.Tensor
    v: torch.Tensor
    seq_lens: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    seq_shards: int = 1
    seq_shard: int = 0

    @property
    def max_batch_size(self) -> int:
        return self.k.shape[1]

    @property
    def max_seq_len(self) -> int:
        """The tokens these buffers hold (a shard's, under an sp split)."""
        return self.k.shape[3]

    @property
    def global_seq_len(self) -> int:
        return self.k.shape[3] * self.seq_shards

    @property
    def seq_offset(self) -> int:
        return self.k.shape[3] * self.seq_shard

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
    # Unique payload precision when quantized: 8, or 4 (token-planar nibble
    # pack: the payload's token dim is half the logical length).
    unique_bits: int = 8

    @property
    def max_unique_batch_size(self) -> int:
        return self.unique_k.shape[1]

    @property
    def max_unique_seq_len(self) -> int:
        """LOGICAL token capacity (int4 stores two tokens per byte row)."""
        rows = self.unique_k.shape[2 if self.unique_bshd else 3]
        return rows * 2 if self.unique_bits == 4 else rows

    @property
    def unique_rows(self) -> int:
        """Payload rows of the token dim (byte rows at int4)."""
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
    unique_bits: int = 8,
    device=None,
) -> KVCache:
    """Allocate zeroed cache buffers.

    ``unique_bshd`` None = the JAX package's rule: BSHD iff one token's KV of
    all heads is a whole number of 4 KiB (``hkv * hd * itemsize % 4096 ==
    0``). ``flat_scales`` None = on for a quantized BSHD unique cache.
    ``shared_quantized`` None = follow ``quantized``. ``unique_bits=4``
    (quantized only) stores the unique payload as token-planar int4: the
    length is rounded up to even and the payload holds half as many byte
    rows, while the scales cover every logical token.
    """
    assert len(max_shared_batch_sizes) == len(max_shared_seq_lengths)
    assert unique_bits in (8, 4) and (unique_bits == 8 or quantized)
    if unique_bits == 4:
        max_unique_seq_length = -(-max_unique_seq_length // 2) * 2
    unique_rows = max_unique_seq_length // 2 if unique_bits == 4 else max_unique_seq_length
    itemsize = 1 if quantized else torch.empty((), dtype=dtype).element_size()
    if unique_bshd is None:
        unique_bshd = (num_kv_heads * head_dim * itemsize) % 4096 == 0
    if flat_scales is None:
        flat_scales = unique_bshd and quantized
    flat_scales = bool(flat_scales and unique_bshd and quantized)
    if shared_quantized is None:
        shared_quantized = quantized

    def bufs(b, s, bshd=False, flat=False, quant=quantized, rows=None):
        # rows: payload token rows (int4: s // 2); scales cover all s tokens.
        rows = s if rows is None else rows
        shape = (
            (num_layers, b, rows, num_kv_heads, head_dim) if bshd
            else (num_layers, b, num_kv_heads, rows, head_dim)
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
                            bshd=unique_bshd, flat=flat_scales, rows=unique_rows)
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
        unique_bits=unique_bits,
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
    (scale ``[L, b, hkv, t]``; at int4 the payload holds unpacked int4
    values).
    """
    if isinstance(k, tuple):
        assert cache.quantized
        (kq, ks), (vq, vs) = k, v
    else:
        kq, ks = _maybe_quantize(k, cache.quantized, cache.unique_bits)
        vq, vs = _maybe_quantize(v, cache.quantized, cache.unique_bits)
    L, bb, hkv, t = kq.shape[:4]
    rows = slice(row_start, row_start + bb)
    toks = ptoks = slice(start, start + t)  # scale tokens, payload token rows
    if cache.unique_bits == 4:
        # Token-planar nibble pack from position 0: byte row j <- token j
        # (low) and token j + sp (high). Rows with no high token in range get
        # their stale high nibble cleared (those tokens stay masked until
        # their own write). The payloads then span min(t, sp) byte rows; the
        # scales keep all t logical tokens.
        assert start == 0, "int4 unique KV requires prefill at position 0"
        sp = cache.unique_rows
        assert t <= 2 * sp, (t, sp)

        def pack_layer(q4):  # [b, hkv, t, hd] -> [b, hkv, min(t, sp), hd]
            q32 = q4.to(torch.int32)
            lo = q32[:, :, :min(t, sp)] & 0xF
            if t > sp:
                both = lo[:, :, :t - sp] | (q32[:, :, sp:] << 4)
                lo = torch.cat([both, lo[:, :, t - sp:]], dim=2)
            return lo.to(torch.int8)

        def pack_t(q4):  # layer by layer: the int32 transient stays one layer's
            return torch.stack([pack_layer(x) for x in q4])

        kq, vq = pack_t(kq), pack_t(vq)
        ptoks = slice(0, kq.shape[3])
    if cache.unique_bshd:
        cache.unique_k[:, rows, ptoks] = kq.transpose(2, 3).to(cache.unique_k.dtype)
        cache.unique_v[:, rows, ptoks] = vq.transpose(2, 3).to(cache.unique_v.dtype)
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
        cache.unique_k[:, rows, :, ptoks] = kq.to(cache.unique_k.dtype)
        cache.unique_v[:, rows, :, ptoks] = vq.to(cache.unique_v.dtype)
        if ks is not None:
            cache.unique_k_scale[:, rows, :, toks] = ks
            cache.unique_v_scale[:, rows, :, toks] = vs
    return cache


def update_unique_decode(cache: KVCache, positions: torch.Tensor, k, v,
                         uniform=None, plain: bool = False) -> KVCache:
    """Write one decode-step token per row at per-row ``positions``, in place.

    positions: ``[b]`` int. k, v: ``[L, b, hkv, 1, hd]``. ``uniform``: the
    position shared by all rows, a host int or a device int scalar (a
    one-slot write, layer by layer through :func:`write_decode_token_layer`),
    or None for the per-row scatter, which an int4 cache refuses (a sub-byte
    scatter). ``plain``: the int4 write's plain version on any device.
    """
    if uniform is not None:
        L, b = k.shape[:2]
        uniform = decode_slot(cache, uniform, k.device)
        for li in range(L):
            write_decode_token_layer(cache, li, k[li], v[li], uniform, plain=plain)
        return cache
    if cache.unique_bits == 4:
        raise ValueError("int4 unique KV supports only uniform decode positions (ragged "
                         "suffix lengths need sub-byte scatters)")
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


class DecodeSlot(NamedTuple):
    """A decode step's uniform unique slot, indexed once for every layer's
    write (:func:`decode_slot`)."""

    slot: object  # a host int, or a device int32 scalar (the int4 kernel reads it)
    idx: Optional[torch.Tensor]  # one-element int64 index; None at int4
    cols: Optional[torch.Tensor]  # int8 flat scales: the slot's hkv columns


def decode_slot(cache: KVCache, slot, device) -> DecodeSlot:
    """Index ``slot`` (a host int, checked here, or a device int scalar) for
    :func:`write_decode_token_layer`. A step builds it once for all layers.
    An int4 cache's writes index the slot themselves (the int4 kernel reads
    it from device memory)."""
    if isinstance(slot, DecodeSlot):
        return slot
    if not torch.is_tensor(slot):
        assert 0 <= slot < cache.max_unique_seq_len, (slot, cache.max_unique_seq_len)
    if cache.unique_bits == 4:
        return DecodeSlot(slot, None, None)
    idx = decode_ops.slot_index(slot, device)
    cols = None
    if cache.flat_scales:
        # Token-major head-minor [b, S*hkv]: the slot's hkv columns.
        hkv = cache.unique_k.shape[3 if cache.unique_bshd else 2]
        cols = idx * hkv + torch.arange(hkv, device=device)
    return DecodeSlot(slot, idx, cols)


def write_decode_token_layer(cache: KVCache, layer: int, k, v, slot,
                             plain: bool = False) -> KVCache:
    """Write ONE layer's single decode token at the uniform ``slot``, in
    place. k, v: ``[b, hkv, 1, hd]``.

    ``slot`` is a :class:`DecodeSlot`, a host int (checked) or a device int32
    scalar, which is read where the write runs, so a captured graph writes
    the slot its step computed; the caller checks a device slot's range
    (``generate`` checks every step's slot on the host, once a call). Every
    write indexes with the slot as a device index (``index_copy_``): no host
    sync.

    An int4 BSHD cache with flat scales (the layout the decode kernel reads)
    is written by ``write_token_int4_cached``: its kernel on a CUDA tensor,
    or its plain version on a CPU tensor or with ``plain``. Other int4
    layouts take the same nibble read-modify-write in plain PyTorch."""
    slot = decode_slot(cache, slot, k.device)
    if cache.unique_bits == 4:
        return _write_decode_token_layer4(cache, layer, k, v, slot, plain)
    kq, ks = _maybe_quantize(k, cache.quantized)
    vq, vs = _maybe_quantize(v, cache.quantized)
    b = k.shape[0]
    idx = slot.idx
    # The token dim of a layer's rows: 1 in BSHD [b, S, hkv, hd], 2 in BHSD.
    dim = 1 if cache.unique_bshd else 2
    for buf, sbuf, q, s in ((cache.unique_k, cache.unique_k_scale, kq, ks),
                            (cache.unique_v, cache.unique_v_scale, vq, vs)):
        buf[layer, :b].index_copy_(dim, idx, q.transpose(1, 2).to(buf.dtype)
                                   if cache.unique_bshd else q.to(buf.dtype))
        if s is None:
            continue
        if cache.flat_scales:
            sbuf[layer, :b].index_copy_(1, slot.cols, s[:, :, 0])
        else:
            sbuf[layer, :b].index_copy_(dim, idx, s.transpose(1, 2) if cache.unique_bshd
                                        else s)
    return cache


def _write_decode_token_layer4(cache: KVCache, layer: int, k, v, slot: DecodeSlot,
                               plain: bool) -> KVCache:
    """The int4 branch of :func:`write_decode_token_layer`: one token is one
    NIBBLE of byte row ``slot % sp``, the high plane from ``slot >= sp`` on
    (over the live low token ``slot - sp``), the low plane below (the stale
    high partner cleared)."""
    if cache.unique_bshd and cache.flat_scales:
        write = decode_ops.write_token_int4_cached_plain if plain \
            else decode_ops.write_token_int4_cached
        write(layer, k, v, cache.unique_k, cache.unique_v, cache.unique_k_scale,
              cache.unique_v_scale, slot.slot)
        return cache
    kq, ks = quantize_kv4(k)
    vq, vs = quantize_kv4(v)
    b = k.shape[0]
    sp = cache.unique_rows
    idx = decode_ops.slot_index(slot.slot, k.device)
    row, is_hi = idx % sp, idx >= sp
    dim = 1 if cache.unique_bshd else 2
    for buf, sbuf, q4, s in ((cache.unique_k, cache.unique_k_scale, kq, ks),
                             (cache.unique_v, cache.unique_v_scale, vq, vs)):
        _nibble_rmw(buf[layer, :b], dim, row, q4[:, :, 0], is_hi)
        sbuf[layer, :b].index_copy_(dim, idx, s.transpose(1, 2) if cache.unique_bshd else s)
    return cache


def expand_unique_rows(cache: KVCache, current_size: int, index: torch.Tensor) -> KVCache:
    """Row ``i`` <- row ``index[i]`` of rows ``[0:current_size]``, for ``i``
    in ``[0, len(index))``, in place, layer by layer (a dp rank's share of
    :func:`repeat_unique_for_samples`, whose rows need not start or end at a
    whole group of samples)."""
    n = int(index.shape[0])
    for buf in (cache.unique_k, cache.unique_v, cache.unique_k_scale,
                cache.unique_v_scale):
        if buf is None:
            continue
        idx = index.to(buf.device)
        for li in range(buf.shape[0]):
            buf[li, :n] = buf[li, :current_size].index_select(0, idx)
    return cache


def repeat_unique_for_samples(cache: KVCache, current_size: int,
                              num_samples: int) -> KVCache:
    """repeat_interleave rows [0:current_size] -> [0:current_size*num_samples],
    in place. Layer by layer, as a broadcast copy of a clone of the source
    rows: the transient is one layer's source rows, not a repeated buffer
    (17.8 GB a buffer for the no-sharing baseline at 8B)."""
    if num_samples == 1:
        return cache
    n = current_size * num_samples
    for buf in (cache.unique_k, cache.unique_v, cache.unique_k_scale,
                cache.unique_v_scale):
        if buf is None:
            continue
        for li in range(buf.shape[0]):
            src = buf[li, :current_size].clone()
            buf[li, :n].unflatten(0, (current_size, num_samples)).copy_(src[:, None])
    return cache


def copy_shared_to_unique(cache: KVCache, total_num_sequences: int,
                          sb: int | None = None, rows: tuple | None = None,
                          level: SharedLevel | None = None) -> KVCache:
    """Write level 0 into the front of every unique row, in place, in the
    unique cache's storage format: the no-sharing (``disable_hydragen``)
    baseline, where each row holds its whole history. Prefix ``i`` of the
    level's ``sb`` filled prefixes goes to rows ``[i*rep, (i+1)*rep)``, rep =
    ``total_num_sequences // sb``; all ``S`` allocated level tokens are
    copied and later unique positions follow them. Layer by layer, so the
    transient is one layer's level (quantized or dequantized where the two
    formats differ). Port of ``hydragen_tpu.core.cache.copy_shared_to_unique``.

    Under a mesh the cache is a rank's: ``rows`` ``(first, count)`` are the
    global rows its unique rows ``[0, count)`` hold (a dp rank's share; all
    rows by default), and ``level`` is level 0 with every token of the
    rank's kv heads (the local level, or its sp slices gathered;
    ``parallel.shard_attn.gather_level``)."""
    if cache.unique_bits != 8:
        raise ValueError("copy_shared_to_unique: int4 unique KV cannot host the copied "
                         "prefix (run the no-sharing baseline with kv_quant='int8')")
    level = cache.shared[0] if level is None else level
    assert level.seq_shards == 1, "gather an sp-split level's tokens first"
    if sb is None:
        sb = level.max_batch_size
    assert total_num_sequences % sb == 0, (total_num_sequences, sb)
    row0, n = (0, total_num_sequences) if rows is None else rows
    S = level.max_seq_len
    hkv = level.k.shape[2]
    # Runs of rows that each take whole prefixes' groups, or part of one.
    runs = fold_segments(row0, n, total_num_sequences, sb)

    def stored(payload, scale):
        """One layer's level [sb, hkv, S, hd] in the unique cache's format."""
        if cache.quantized and scale is None:
            return quantize_kv(payload)
        if not cache.quantized and scale is not None:
            return (payload.float() * scale[..., None]).to(cache.unique_k.dtype), None
        return payload, scale

    def put(dst, src):
        """src [sb, ...] into dst [n, ...]: each run's rows from its prefixes."""
        r = 0
        for p, k, m in runs:
            dst[r:r + m].unflatten(0, (k, m // k)).copy_(src[p:p + k, None])
            r += m

    for li in range(level.k.shape[0]):
        for buf, sbuf, lp, ls in ((cache.unique_k, cache.unique_k_scale, level.k,
                                   level.k_scale),
                                  (cache.unique_v, cache.unique_v_scale, level.v,
                                   level.v_scale)):
            p, s = stored(lp[li, :sb], None if ls is None else ls[li, :sb])
            if cache.unique_bshd:
                put(buf[li, :n, :S], p.transpose(1, 2))
                if s is not None:
                    if cache.flat_scales:
                        # [sb, hkv, S] -> token-major head-minor [sb, S*hkv].
                        put(sbuf[li, :n, :S * hkv], s.transpose(1, 2).reshape(sb, S * hkv))
                    else:
                        put(sbuf[li, :n, :S], s.transpose(1, 2))
            else:
                put(buf[li, :n, :, :S], p)
                if s is not None:
                    put(sbuf[li, :n, :, :S], s)
    return cache
