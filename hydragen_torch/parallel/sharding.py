"""Parameter and KV-cache sharding: which dims split over which axis, and
this rank's slices.

Port of ``hydragen_tpu.parallel.sharding`` (gpt-fast-style tensor
parallelism, the reference's ``apply_tp``). Where JAX places global arrays
with ``NamedSharding``s, a rank here holds its slices only:

- q/k/v/gate/up are column-sharded over tp (output features), o/down
  row-sharded (input features), the LM head sharded over the vocab;
  embeddings and norms replicated; a family whose size tp does not divide
  stays replicated. Biases follow their weight (``bo`` is added once, after
  the all-reduce).
- A ``QuantizedTensor``'s payload ``[L, N, K]`` takes the swapped spec, and
  its per-column scale ``[L, N]`` is sliced with N or replicated over K.
- A ``Quantized4Tensor`` (planar int4 ``qp [L, N, K/2]``, group scales
  ``gscale [L, G, N]``) of a column family is sliced on N in both. A row
  family deviates from JAX in layout, not in value: JAX shards the packed
  axis, so a shard holds two strided K ranges (one of each nibble plane)
  and its dq path works on logical arrays; a port rank gets a contiguous K
  slice of the activation, so its payload is unpacked on the host, cut to
  the rank's contiguous logical K range and packed again as that slice's
  own planar pack (byte j: local feature j low, j + K/(2 tp) high). Its
  scales are the rank's groups where tp divides G (JAX's rule); else each
  group is split into ``gcd(group, K/tp)``-wide subgroups that repeat its
  scale, so every local group lies in one global group. A local group may
  straddle the two local planes; the dq product reads it over logical K
  (``ops/quant.py:qmatmul``). K6 never reads a row-parallel weight.
- When ``num_key_value_heads % tp != 0`` the k/v projections are replicated
  while q stays sharded, as in JAX; a rank's cache then holds the one kv
  head its query heads read (the JAX cache's replication, cut to what the
  rank reads). The port shards q only along whole heads: where tp divides
  the query features but not the heads, or a rank's query heads would read
  more than one replicated kv head, q and o stay replicated too.
- Caches: unique rows over dp, kv heads over tp; shared levels over kv
  heads (tp) and their sequence (sp, where it divides), replicated over dp.
  The unique layout (BSHD or BHSD) is chosen from the GLOBAL head count, as
  JAX allocates globally and then shards; the flat scales of a BSHD unique
  cache stay flat on the local shard (``[L, B/dp, S*hkv/tp]``, what K3
  reads), where JAX keeps 4-D scales under a mesh.

The int4 unique cache does not shard: the JAX reference's ``cache_pspecs``
builds its spec cache without ``unique_bits``, so its ``shard_cache`` fails
on one (``hydragen_tpu/parallel/sharding.py:123-127``), and the port waits
for it (``INT4_CACHE_WAITS``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from hydragen_torch.models.config import ModelConfig
from hydragen_torch.ops.quant import Quantized4Tensor, QuantizedTensor, pack4, unpack4
from hydragen_torch.parallel.mesh import Mesh

INT4_CACHE_WAITS = (
    "the int4 unique cache under a mesh waits for the JAX reference, whose cache_pspecs "
    "leaves unique_bits out of its spec cache, so its shard_cache cannot place one "
    "(hydragen_tpu/parallel/sharding.py:123-127)")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """What this rank's tp slice holds: which families split, and the local
    head and channel counts the model runs at."""

    tp: int
    rank: int
    heads: bool  # q (and o) split over tp
    kv: bool  # k/v split over tp
    mlp: bool
    vocab: bool
    nh: int  # local query heads
    nkv: int  # local kv heads (of the attention and the cache)
    kv_head0: Optional[int]  # replicated k/v: the first head this rank reads


def shard_plan(cfg: ModelConfig, mesh: Optional[Mesh]) -> ShardPlan:
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if mesh is None or not mesh.active("tp"):
        return ShardPlan(1, 0, False, False, False, False, nh, nkv, None)
    tp, r = mesh.size("tp"), mesh.index("tp")
    kv = nkv % tp == 0
    heads = nh % tp == 0 and (kv or (nh // nkv) % (nh // tp) == 0)
    kv = kv and heads
    nh_loc = nh // tp if heads else nh
    if kv:
        nkv_loc, head0 = nkv // tp, None
    elif heads:  # one replicated kv head serves all of this rank's q heads
        nkv_loc, head0 = 1, r * nh_loc // (nh // nkv)
    else:
        nkv_loc, head0 = nkv, None
    return ShardPlan(tp, r, heads, kv, cfg.intermediate_size % tp == 0,
                     cfg.vocab_size % tp == 0, nh_loc, nkv_loc, head0)


def param_pspecs(cfg: ModelConfig, mesh: Optional[Mesh]) -> dict:
    """The split dims of each parameter of the logical ``[L, in, out]``
    layout, as JAX's ``PartitionSpec`` entries: a tuple with ``"tp"`` at the
    split dim and None elsewhere (the shape of ``hydragen_tpu``'s
    ``param_pspecs``)."""
    plan = shard_plan(cfg, mesh)

    def on(split):
        return "tp" if split else None

    q, kv, mlp = on(plan.heads), on(plan.kv), on(plan.mlp)
    specs = {
        "embed_tokens": (None, None),
        "final_norm": (None,),
        "lm_head": (None, on(plan.vocab)),
        "layers": {
            "input_norm": (None, None),
            "post_attn_norm": (None, None),
            "wq": (None, None, q),
            "wk": (None, None, kv),
            "wv": (None, None, kv),
            "wo": (None, q, None),
            "gate": (None, None, mlp),
            "up": (None, None, mlp),
            "down": (None, mlp, None),
        },
    }
    if cfg.attention_bias:
        specs["layers"].update(bq=(None, q), bk=(None, kv), bv=(None, kv), bo=(None, None))
    return specs


def _take(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Piece ``i`` of ``n`` along ``dim``, as a contiguous copy (the global
    tensor can then be freed)."""
    size = x.shape[dim]
    assert size % n == 0, (size, n)
    return x.narrow(dim, i * (size // n), size // n).contiguous()


def shard_params(params: dict, cfg: ModelConfig, mesh: Optional[Mesh], device=None) -> dict:
    """This rank's slices of a GLOBAL parameter dict (on any device), moved
    to ``device`` slice by slice, so the global dict never goes there."""
    plan = shard_plan(cfg, mesh)
    specs = param_pspecs(cfg, mesh)
    n, i = plan.tp, plan.rank

    def place(x, spec):
        if isinstance(x, Quantized4Tensor):
            return _place4(x, spec, n, i, device)
        if isinstance(x, QuantizedTensor):
            # Payload [.., out, in]: the logical spec's last two entries swap.
            qspec = spec[:-2] + (spec[-1], spec[-2])
            q = x.q
            for d, s in enumerate(qspec):
                if s:
                    q = _take(q, d, n, i)
            scale = _take(x.scale, x.scale.dim() - 1, n, i) if spec[-1] else x.scale
            return QuantizedTensor(q=q.to(device), scale=scale.to(device))
        for d, s in enumerate(spec):
            if s:
                x = _take(x, d, n, i)
        return x.to(device)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return place(tree, spec)

    return walk(params, specs)


def _place4(x: Quantized4Tensor, spec, n: int, i: int, device) -> Quantized4Tensor:
    """Rank ``i`` of ``n``'s slice of a stacked int4 weight (module
    docstring): a column family on N; a row family on a contiguous logical
    K range, packed again locally, with its groups or their subgroups."""
    qp, gs = x.qp, x.gscale
    if spec[-1]:  # column-parallel: output features
        qp, gs = _take(qp, qp.dim() - 2, n, i), _take(gs, gs.dim() - 1, n, i)
    elif spec[-2]:  # row-parallel: input features
        K, G = x.in_features, gs.shape[-2]
        assert K % (2 * n) == 0, (K, n)
        q = torch.cat(unpack4(qp), dim=-1)  # [.., N, K] logical
        qp = pack4(_take(q, q.dim() - 1, n, i))
        if G % n:
            g = x.group_size
            sub = math.gcd(g, K // n)
            gs = gs.repeat_interleave(g // sub, dim=-2)
        gs = _take(gs, gs.dim() - 2, n, i)
    return Quantized4Tensor(qp=qp.contiguous().to(device), gscale=gs.contiguous().to(device))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheShapes:
    """The local allocation of a cache under a mesh."""

    unique_batch: int  # B / dp
    level_lens: tuple  # each level's local sequence (S / sp where it divides)
    level_split: tuple  # each level split over sp?
    num_kv_heads: int  # local kv heads
    unique_bshd: bool  # from the global head count


def global_unique_bshd(cfg: ModelConfig, quantized: bool, dtype) -> bool:
    """The JAX package's layout rule at the GLOBAL head count: BSHD iff one
    token's KV of all heads is a whole number of 4 KiB."""
    itemsize = 1 if quantized else torch.empty((), dtype=dtype).element_size()
    return (cfg.num_key_value_heads * cfg.head_dim * itemsize) % 4096 == 0


def cache_pspecs(cfg: ModelConfig, mesh: Optional[Mesh], unique_batch: int,
                 level_lens, quantized: bool, dtype,
                 unique_bshd: Optional[bool] = None) -> CacheShapes:
    dp = mesh.size("dp") if mesh is not None else 1
    sp = mesh.size("sp") if mesh is not None else 1
    if unique_batch % dp:
        raise ValueError(f"max_unique_batch_size {unique_batch} must divide over dp={dp}")
    split = tuple(sp > 1 and s % sp == 0 for s in level_lens)
    lens = tuple(s // sp if sp_ else s for s, sp_ in zip(level_lens, split))
    if unique_bshd is None:
        unique_bshd = global_unique_bshd(cfg, quantized, dtype)
    return CacheShapes(unique_batch // dp, lens, split, shard_plan(cfg, mesh).nkv,
                       unique_bshd)


def kv_head_slice(cfg: ModelConfig, mesh: Optional[Mesh]) -> slice:
    """The global kv heads this rank's cache holds."""
    plan = shard_plan(cfg, mesh)
    if plan.kv:
        return slice(plan.rank * plan.nkv, (plan.rank + 1) * plan.nkv)
    if plan.kv_head0 is not None:
        return slice(plan.kv_head0, plan.kv_head0 + 1)
    return slice(0, cfg.num_key_value_heads)


def shard_cache(cache, cfg: ModelConfig, mesh: Optional[Mesh]):
    """This rank's slices of a GLOBAL ``KVCache`` (freshly allocated, or
    written): unique rows over dp, kv heads over tp, each level's sequence
    over sp where it divides. Flat scales are re-flattened over the local
    heads."""
    from hydragen_torch.core.cache import KVCache, SharedLevel

    if cache.unique_bits == 4:
        raise NotImplementedError(INT4_CACHE_WAITS)
    heads = kv_head_slice(cfg, mesh)
    nkv = cfg.num_key_value_heads
    dp, dpi = mesh.size("dp"), mesh.index("dp")
    sp, spi = mesh.size("sp"), mesh.index("sp")
    B = cache.max_unique_batch_size
    if B % dp:
        raise ValueError(f"unique batch {B} must divide over dp={dp}")
    rows = slice(dpi * (B // dp), (dpi + 1) * (B // dp))

    def uniq(x, scale=False):
        if x is None:
            return None
        x = x[:, rows]
        if cache.unique_bshd:
            if scale and cache.flat_scales:
                L, b, n = x.shape
                return x.reshape(L, b, n // nkv, nkv)[..., heads].reshape(L, b, -1).clone()
            return x[:, :, :, heads].clone()
        return x[:, :, heads].clone()

    levels = []
    for lv in cache.shared:
        S = lv.max_seq_len
        split = sp > 1 and S % sp == 0
        toks = slice(spi * (S // sp), (spi + 1) * (S // sp)) if split else slice(0, S)

        def lvl(x):
            return None if x is None else x[:, :, heads, toks].clone()

        levels.append(SharedLevel(
            k=lvl(lv.k), v=lvl(lv.v), seq_lens=lv.seq_lens.clone(), k_scale=lvl(lv.k_scale),
            v_scale=lvl(lv.v_scale), seq_shards=sp if split else 1,
            seq_shard=spi if split else 0))
    return KVCache(
        unique_k=uniq(cache.unique_k), unique_v=uniq(cache.unique_v), shared=tuple(levels),
        unique_k_scale=uniq(cache.unique_k_scale, True),
        unique_v_scale=uniq(cache.unique_v_scale, True), unique_bshd=cache.unique_bshd,
        flat_scales=cache.flat_scales, unique_bits=cache.unique_bits)
