"""The Llama stack with Hydragen attention, in PyTorch.

Port of ``hydragen_tpu.models.llama``, with its mesh paths: under a
``parallel.Mesh`` each rank runs this stack on its shards (its heads and MLP
channels over tp, its unique rows over dp, its slice of each level over sp)
and the collectives of ``parallel/`` sit where the JAX program has them (see
``model_forward``'s ``mesh``). Parameters are a plain dict of stacked ``[L, ...]``
tensors, as in the JAX package, so a test can carry one parameter set into
both. In every mode attention is computed as LSE-mergeable partials: the
active shared levels, the previously written unique cache (length-masked),
and a causal self-attention over the current input's KV. RoPE is applied at
the global position while KV is stored at the position minus the shared
length.

On a CUDA tensor every kernel-eligible call goes to a hand-written kernel:
the s8 GEMMs for each projection under ``matmul="w8a8"`` (int8 weights) or
``"w4a8"`` (int4 weights), the cached flash read for each shared level, the
int8 or int4 decode read of a BSHD unique cache (with the own token and the
shared partial merged in) or the small-M flash read of a BHSD one (a GQA
model's layout; its per-layer view read in place), the in-place int4 decode
write, and causal flash attention for prefill. ``disable_hydragen`` (the
no-sharing baseline) skips the level reads: each row's history, the copied
prefix included, is in the unique cache.
``impl="torch"`` runs every op's plain PyTorch version instead, on any
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from hydragen_torch.core.cache import decode_slot, write_decode_token_layer
from hydragen_torch.models.config import ModelConfig
from hydragen_torch.ops import decode as decode_ops
from hydragen_torch.ops import flash
from hydragen_torch.ops.combine import combine_lse, combine_lse_with_stats
from hydragen_torch.ops.gemm import quantize_rows
from hydragen_torch.ops.hydragen import (
    _attention,
    fold_queries_for_shared,
    pick_impl,
    unfold_shared_lse,
    unfold_shared_out,
)
from hydragen_torch.ops.quant import (
    _I_PAD,
    Quantized4Tensor,
    QuantizedTensor,
    is_quantized_weight,
    pick_group4,
    qmatmul,
    qmatmul_stacked,
    quantize_kv,
    quantize_kv4,
    s8_stacked_eligible,
)
from hydragen_torch.parallel.mesh import all_gather
from hydragen_torch.parallel.shard_attn import fold_segments, sharded_level_attention
from hydragen_torch.parallel.shard_gemm import (
    sharded_qmatmul_stacked,
    sharded_qmatmul_stacked_row,
)
from hydragen_torch.parallel.sharding import shard_plan

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                quantized: bool | str = False, device=None) -> dict:
    """Random-init parameters from ``generator`` (for tests and benchmarks
    without checkpoints), made directly on ``device``.

    ``quantized`` (True, "int8" or "w8a8") creates INT8 weights directly: a
    random int8 payload with magnitude-matched bf16 scales. "int4" or "w4a8"
    creates planar-packed INT4 projections the same way (random packed bytes,
    group scales; the LM head stays INT8). "w8a8" and "w4a8" pad the MLP
    intermediate dim to an _I_PAD multiple, as ``quantize_params`` does for
    real checkpoints (exact: the padded channels are zero-scaled rows of
    ``down``'s input).
    """
    int4 = quantized in ("int4", "w4a8")
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    if quantized in ("w8a8", "w4a8") and I >= _I_PAD:
        I = -(-I // _I_PAD) * _I_PAD
    L = cfg.num_hidden_layers
    Hq = cfg.num_attention_heads * cfg.head_dim
    Hkv = cfg.num_key_value_heads * cfg.head_dim
    dt = cfg.torch_dtype
    kw = dict(generator=generator, device=device)

    def dense_fp(shape, fan_in):
        return torch.randn(shape, dtype=dt, **kw) / math.sqrt(fan_in)

    def dense(shape, fan_in, int4_ok=False):
        if int4 and int4_ok:
            K = shape[-2]
            g = pick_group4(K)
            # Packed payload stored [out, in/2] (see Quantized4Tensor).
            pshape = shape[:-2] + (shape[-1], K // 2)
            qp = torch.randint(-128, 128, pshape, dtype=torch.int8, **kw)
            gscale = torch.full(shape[:-2] + (K // g, shape[-1]),
                                1.0 / (4.0 * math.sqrt(fan_in)), dtype=torch.bfloat16,
                                device=device)
            return Quantized4Tensor(qp=qp, gscale=gscale)
        if quantized:
            # Payload stored [out, in] (see QuantizedTensor).
            tshape = shape[:-2] + (shape[-1], shape[-2])
            q = torch.randint(-127, 128, tshape, dtype=torch.int8, **kw)
            scale = torch.full(shape[:-2] + shape[-1:], 1.0 / (74.0 * math.sqrt(fan_in)),
                               dtype=torch.bfloat16, device=device)
            return QuantizedTensor(q=q, scale=scale)
        return dense_fp(shape, fan_in)

    params = {
        "embed_tokens": dense_fp((V, H), H),
        "final_norm": torch.ones((H,), dtype=dt, device=device),
        "lm_head": dense((H, V), H),
        "layers": {
            "input_norm": torch.ones((L, H), dtype=dt, device=device),
            "post_attn_norm": torch.ones((L, H), dtype=dt, device=device),
            "wq": dense((L, H, Hq), H, int4_ok=True),
            "wk": dense((L, H, Hkv), H, int4_ok=True),
            "wv": dense((L, H, Hkv), H, int4_ok=True),
            "wo": dense((L, Hq, H), Hq, int4_ok=True),
            "gate": dense((L, H, I), H, int4_ok=True),
            "up": dense((L, H, I), H, int4_ok=True),
            "down": dense((L, I, H), I, int4_ok=True),
        },
    }
    if cfg.attention_bias:
        for name, n in (("bq", Hq), ("bk", Hkv), ("bv", Hkv), ("bo", H)):
            params["layers"][name] = torch.zeros((L, n), dtype=dt, device=device)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_cos_sin(cfg: ModelConfig, position_ids: torch.Tensor):
    """cos/sin tables ``[b, t, head_dim]`` at ``position_ids [b, t]``, HF
    convention (half frequencies duplicated); vanilla, linear, dynamic-NTK
    and Llama-3 frequency smoothing."""
    d = cfg.head_dim
    base = cfg.rope_theta
    dev = position_ids.device
    pos = position_ids.float()
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d
    inv_freq = 1.0 / (base ** exps)
    if cfg.rope_scaling is not None:
        stype, factor = cfg.rope_scaling[0], cfg.rope_scaling[1]
        if stype == "linear":
            pos = pos / factor
        elif stype == "llama3":
            _, _, low_f, high_f, orig_max = cfg.rope_scaling
            wavelen = 2.0 * math.pi / inv_freq
            smooth = torch.clamp((orig_max / wavelen - low_f) / (high_f - low_f), 0.0, 1.0)
            scaled = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
            inv_freq = torch.where(
                wavelen > orig_max / low_f, inv_freq / factor,
                torch.where(wavelen < orig_max / high_f, inv_freq, scaled),
            )
        elif stype == "dynamic":
            seq_len = position_ids.max().float() + 1.0
            mpe = float(cfg.max_position_embeddings)
            grown = torch.clamp(factor * seq_len / mpe - (factor - 1.0), min=1.0)
            new_base = base * grown ** (d / (d - 2))
            inv_freq = 1.0 / (new_base ** exps)
        else:
            raise ValueError(f"unknown rope scaling {stype}")
    ang = pos[..., None] * inv_freq[None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[b, h, t, d]`` (BHSD); cos/sin ``[b, t, d]``. rotate_half
    convention, accumulated in f32."""
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    out = x.float() * cos[:, None].float() + rot.float() * sin[:, None].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


class ForwardSpec(NamedTuple):
    """What a forward call does: its mode and the cache state it reads."""

    mode: str  # "shared_prefill" | "unique_prefill" | "decode"
    num_used_levels: int
    level_filled: Tuple[int, ...]  # filled length per active level
    unique_history: bool  # attend over previously written unique cache?
    unique_filled: int  # upper bound of written unique positions
    disable_hydragen: bool
    disable_attention: bool
    impl: Optional[str] = None  # attention: "kernel" (default) | "torch"
    # Projection products: "dq" (weight-only), "w8a8" (per-row activation
    # quantization + the s8 GEMM; an int4 weight under it takes the w4a8
    # GEMM, the "mixed" mode) or "w4a8" (the same against int4 weights).
    matmul: str = "dq"
    # Filled prefix count per active level; () = all allocated rows.
    level_batch: Tuple[int, ...] = ()
    # First prefix row read per active level; () = row 0. A continuous
    # batcher's admission reads one prefix row of each level of an ``sb > 1``
    # pool (with ``level_batch`` all 1), where the JAX batcher slices it.
    level_row: Tuple[int, ...] = ()
    # Under a mesh: (first row, global rows) of this rank's rows of the
    # batch; () = all rows (every rank computes a shared prefill whole).
    rows: Tuple[int, ...] = ()


def model_forward(
    params: dict,
    cfg: ModelConfig,
    cache,
    input_ids: torch.Tensor,
    position_ids: torch.Tensor,
    unique_position_ids: torch.Tensor,
    spec: ForwardSpec,
    history_lens: torch.Tensor | None = None,
    history_mask: torch.Tensor | None = None,
    inplace_slot: int | torch.Tensor | None = None,
    quantize_new_kv: int | None = None,
    fill_level: int | None = None,
    mesh=None,
):
    """Run the decoder stack in one of the three cache modes.

    Args:
        cache: ``KVCache``; read, and written only by the two write paths.
        input_ids, position_ids: ``[b, t]`` tokens and global positions.
        unique_position_ids: ``[b, t]`` positions within the unique cache
            (kept for API parity; the engine uses them for its writes).
        history_lens: ``[b]`` valid unique-cache positions per row (required
            when ``spec.unique_history``).
        history_mask: optional ``[b, unique_filled]`` bool mask of valid
            unique-cache slots; overrides length masking.
        inplace_slot: decode write path (``t == 1``): the unique slot
            shared by all rows, a host int or a device int32 scalar (the
            decode step passes its own, ``unique_position_ids[0]``, as the
            JAX engine passes a traced value, so a captured step writes the
            slot each replay computes). Each layer writes its token's KV
            into the cache in place right after its attention. Returns
            ``(hidden, cache)``.
        quantize_new_kv: 8 (or 4) -> return each layer's new KV quantized
            (``quantize_kv``, or unpacked int4 from ``quantize_kv4``) instead
            of in the compute dtype.
        fill_level: shared-prefill write path: the index of the level being
            prefilled. Each layer writes its new KV (quantized if the level
            stores int8) straight into that level's buffers, in place.
            Returns ``(hidden, cache)``.
        mesh: a ``parallel.Mesh``: ``params`` and ``cache`` are this rank's
            shards and ``input_ids`` its rows (``spec.rows``). The heads are
            the rank's (``shard_plan``); column-parallel projections run on
            its output slice, o and down on its input slice with a sum
            all-reduce over tp after each; each level read covers the
            rank's rows (``fold_segments``) and merges its sp partials.

    Returns ``(hidden [b, t, H], new_k [L, b, hkv, t, hd], new_v)`` by
    default (new_k/new_v as ``(payload, scale)`` pairs under
    ``quantize_new_kv``), or ``(hidden, cache)`` for the two write paths.
    """
    impl = pick_impl(spec.impl)
    b, t = input_ids.shape
    plan = shard_plan(cfg, mesh)
    nh, nkv, hd = plan.nh, plan.nkv, cfg.head_dim
    dt = cfg.torch_dtype

    h = params["embed_tokens"][input_ids.long()].to(dt)
    cos, sin = rope_cos_sin(cfg, position_ids)
    cos, sin = cos.to(dt), sin.to(dt)

    active_levels = cache.shared[: spec.num_used_levels]
    level_sb = spec.level_batch or tuple(lv.max_batch_size for lv in active_levels)
    level_row = spec.level_row or (0,) * len(active_levels)
    level_lens = [lv.seq_lens[r:r + sb] for lv, r, sb in zip(active_levels, level_row, level_sb)]
    lp = params["layers"]
    has_bias = "bq" in lp
    L = cfg.num_hidden_layers

    # Under a mesh: the families split over tp, by their parallel kind.
    col_tp = {"wq": plan.heads, "wk": plan.kv, "wv": plan.kv, "gate": plan.mlp,
              "up": plan.mlp}
    row_tp = {"wo": plan.heads, "down": plan.mlp}

    def qmm(x, family, li, memo):
        w = lp[family]
        mm = spec.matmul
        if mm == "w8a8" and isinstance(w, Quantized4Tensor):
            mm = "w4a8"  # "mixed": an int4 family under the w8a8 mode
        sub = {"wo": "btd,dh->bth", "down": "bti,ih->bth"}.get(family, "bth,hd->btd")
        if row_tp.get(family):
            return sharded_qmatmul_stacked_row(x, w, li, sub, mm, mesh, plain=impl == "torch")
        a_pre = None
        if mm in ("w8a8", "w4a8") and s8_stacked_eligible(x, w, mm):
            # One per-row quantization shared by the projections reading the
            # same activation (q/k/v off one rmsnorm, gate/up off the other).
            hit = memo.get(id(x))
            if hit is None:
                hit = (x, quantize_rows(x.reshape(-1, x.shape[-1])))
                memo[id(x)] = hit
            a_pre = hit[1]
        if col_tp.get(family):
            return sharded_qmatmul_stacked(x, w, li, sub, mm, a_pre, plain=impl == "torch")
        if a_pre is not None:
            return qmatmul_stacked(x, w, li, "", impl=mm, a_pre=a_pre, plain=impl == "torch")
        return qmatmul_stacked(x, w, li, sub, impl="dq")

    if mesh is not None:  # this rank's rows against each level's prefixes
        row0, total = spec.rows or (0, b)
        segments = [fold_segments(row0, b, total, sb) for sb in level_sb]

    use_dec_kernel = (
        t == 1
        and cache.unique_bshd
        and cache.flat_scales
        and cache.quantized
        and spec.unique_history
        and history_mask is None
        and impl == "kernel"
    )
    kv_bits = cache.unique_bits

    def unique_view(li):
        """Layer li's written unique history as (payload, scale) pairs in the
        layout ``_attention`` reads (BSHD views keep ``kv_bshd``). Int4 views
        carry the full allocated window: a token slice would break the (j, j
        + S/2) byte pairing, and ``history_lens`` masks the unwritten tail."""
        U = cache.max_unique_seq_len if kv_bits == 4 else spec.unique_filled
        P = cache.unique_rows if kv_bits == 4 else U  # payload token rows

        def one(payload, scale):
            if cache.unique_bshd:
                p = payload[li, :b, :P]
                if scale is None:
                    return p
                s = scale[li, :b, : U * nkv].reshape(b, U, nkv) if cache.flat_scales \
                    else scale[li, :b, :U]
                return (p, s)
            p = payload[li, :b, :, :P]
            return p if scale is None else (p, scale[li, :b, :, :U])

        return (one(cache.unique_k, cache.unique_k_scale),
                one(cache.unique_v, cache.unique_v_scale))

    def layer(h, li):
        memo = {}
        resid = h
        x = rms_norm(h, lp["input_norm"][li], cfg.rms_norm_eps)
        q = qmm(x, "wq", li, memo)
        k = qmm(x, "wk", li, memo)
        v = qmm(x, "wv", li, memo)
        if has_bias:
            q, k, v = q + lp["bq"][li], k + lp["bk"][li], v + lp["bv"][li]
        if plan.kv_head0 is not None:  # replicated k/v: the one head this rank reads
            heads = slice(plan.kv_head0 * hd, (plan.kv_head0 + 1) * hd)
            k, v = k[..., heads], v[..., heads]
        q = apply_rope(q.reshape(b, t, nh, hd).transpose(1, 2), cos, sin)
        k = apply_rope(k.reshape(b, t, nkv, hd).transpose(1, 2), cos, sin)
        v = v.reshape(b, t, nkv, hd).transpose(1, 2)

        if spec.disable_attention:
            attn = q
        else:
            attn = None
            outs, lses = [], []
            if not spec.disable_hydragen:
                for j, lvl in enumerate(active_levels):
                    sb, fl, r = level_sb[j], spec.level_filled[j], level_row[j]
                    if mesh is not None:
                        o, l = sharded_level_attention(li, q, lvl, segments[j], fl, impl,
                                                       mesh)
                        outs.append(o)
                        lses.append(l)
                        continue
                    qf = fold_queries_for_shared(q, sb)
                    if impl == "kernel":
                        # The stacked level read in place, layer and row by index.
                        o, l = flash.flash_attention_cached_bhsd(
                            li, qf, lvl.k, lvl.v, kv_seq_lens=level_lens[j],
                            k_scale_all=lvl.k_scale, v_scale_all=lvl.v_scale, row_start=r,
                        )
                    else:
                        def view(p, s):
                            pv = p[li, r:r + sb, :, :fl]
                            return pv if s is None else (pv, s[li, r:r + sb, :, :fl])

                        o, l = _attention(
                            qf, view(lvl.k, lvl.k_scale), view(lvl.v, lvl.v_scale),
                            causal=False, kv_seq_lens=level_lens[j], impl=impl,
                        )
                    outs.append(unfold_shared_out(o, b, t))
                    lses.append(unfold_shared_lse(l, b, t))
            if spec.unique_history:
                if use_dec_kernel:
                    # The unique read with the own token and the shared
                    # partial merged in: the result is the final attention.
                    if len(outs) > 1:
                        sh = combine_lse_with_stats(outs, lses)
                    else:
                        sh = (outs[0], lses[0]) if outs else None
                    attn, _ = decode_ops.decode_attention_cached(
                        li, q, cache.unique_k, cache.unique_v,
                        kv_seq_lens=history_lens, k_scale_all=cache.unique_k_scale,
                        v_scale_all=cache.unique_v_scale, own_kv=(k, v),
                        shared_partial=sh, kv_bits=kv_bits,
                    )
                else:
                    uk, uv = unique_view(li)
                    o, l = _attention(
                        q, uk, uv, causal=False,
                        kv_seq_lens=None if history_mask is not None else history_lens,
                        kv_mask=history_mask, impl=impl, kv_bshd=cache.unique_bshd,
                        kv_bits=kv_bits,
                    )
                    outs.append(o)
                    lses.append(l)
            if attn is None:
                if t == 1:
                    # Softmax over the single own token is the identity:
                    # out = v, lse = scale * q.k.
                    group = nh // nkv
                    qg = q.float().reshape(b, nkv, group, 1, hd)
                    # Times the scale, as the JAX model computes it (a
                    # division by sqrt(hd) rounds differently).
                    l = (torch.einsum("bkgmd,bkmd->bkgm", qg, k.float())
                         * (1.0 / math.sqrt(hd))).reshape(b, nh, 1)
                    o = v[:, :, None].expand(b, nkv, group, 1, hd).reshape(b, nh, 1, hd)
                    o = o.to(q.dtype)
                else:
                    o, l = _attention(q, k, v, causal=True, kv_seq_lens=None, impl=impl)
                outs.append(o)
                lses.append(l)
                attn = combine_lse(outs, lses)

        attn = attn.transpose(1, 2).reshape(b, t, nh * hd)
        attn = qmm(attn, "wo", li, memo)
        if has_bias:
            attn = attn + lp["bo"][li]
        h = resid + attn
        resid = h
        x = rms_norm(h, lp["post_attn_norm"][li], cfg.rms_norm_eps)
        g = qmm(x, "gate", li, memo)
        u = qmm(x, "up", li, memo)
        m = qmm(torch.nn.functional.silu(g.float()).to(u.dtype) * u, "down", li, memo)
        return resid + m, k, v

    if fill_level is not None:
        assert inplace_slot is None
        lvl = cache.shared[fill_level]
        assert b <= lvl.max_batch_size and t <= lvl.global_seq_len
        # This rank's slice of the level's tokens (all of them unless sp splits it).
        off = lvl.seq_offset
        n = max(0, min(t, off + lvl.max_seq_len) - off)
        for li in range(L):
            h, k, v = layer(h, li)
            k, v = k[:, :, off:off + n], v[:, :, off:off + n]
            if lvl.quantized:
                (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
                lvl.k_scale[li, :b, :, :n] = ks
                lvl.v_scale[li, :b, :, :n] = vs
            lvl.k[li, :b, :, :n] = k.to(lvl.k.dtype)
            lvl.v[li, :b, :, :n] = v.to(lvl.v.dtype)
        return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache

    if inplace_slot is not None:
        assert t == 1, "inplace_slot is a single-token decode path"
        slot = decode_slot(cache, inplace_slot, h.device)
        for li in range(L):
            h, k, v = layer(h, li)
            # This step's token is never in its own history (lens mask it),
            # so writing it right after its layer's read is safe.
            write_decode_token_layer(cache, li, k, v, slot, plain=impl == "torch")
        return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache

    new_k, new_v = [], []
    for li in range(L):
        h, k, v = layer(h, li)
        if quantize_new_kv:
            # Each layer's KV is quantized as it comes out (the JAX package
            # quantizes inside its layer scan), so no stack of every layer's
            # compute-dtype KV is ever held.
            qkv = quantize_kv4 if quantize_new_kv == 4 else quantize_kv
            k, v = qkv(k), qkv(v)
        new_k.append(k)
        new_v.append(v)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if quantize_new_kv:
        def stack(pairs):
            return torch.stack([p for p, _ in pairs]), torch.stack([s for _, s in pairs])

        return h, stack(new_k), stack(new_v)
    return h, torch.stack(new_k), torch.stack(new_v)


def logits_from_hidden(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
                       seq_lens: torch.Tensor | None = None,
                       full_logits: bool = False, mesh=None) -> torch.Tensor:
    """LM head; last token only unless ``full_logits``. Always the
    weight-only path, even under w8a8: logits feed sampling directly. Under
    a mesh whose tp splits the vocab, the ranks' slices are all-gathered, so
    every rank holds the whole logits."""
    if full_logits:
        to_head = hidden
    elif seq_lens is not None:
        idx = (seq_lens.long() - 1).to(hidden.device)
        to_head = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx][:, None]
    else:
        to_head = hidden[:, -1:]
    logits = qmatmul(to_head, params["lm_head"], "bth,hv->btv").float()
    if shard_plan(cfg, mesh).vocab:
        logits = all_gather(logits, mesh, "tp", dim=-1)
    return logits


def is_quantized_params(params: dict) -> bool:
    return is_quantized_weight(params["layers"]["wq"])
