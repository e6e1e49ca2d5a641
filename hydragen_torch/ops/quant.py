"""INT8 and INT4 quantization of weights and KV.

Port of ``hydragen_tpu.ops.quant``.

Weights, int8: symmetric per-output-channel, payload stored transposed
``[..., out, in]`` with a bf16 scale ``[..., out]``. The payload is quantized
against the bf16-rounded scale, so storing bf16 costs no precision. Because
the scale is per output channel, dequantization commutes with the product:
``y = x @ (w_q * s) == (x @ w_q) * s``. Weights quantized on the host by the
HF loader (``models/hf.py``) keep an f32 scale, as the JAX package's do; every
consumer takes either.

Weights, int4 (:class:`Quantized4Tensor`): symmetric per-(K-group,
out-channel) scales ``[..., G, out]`` bf16, payload planar-packed
``[..., out, in/2]`` int8 (byte j holds in-feature j low and j + in/2 high).
Group scales do not commute with the product, so the weight-only path
dequantizes each nibble plane before its dot.

KV: symmetric per-(token, head) int8 with f32 scales (amax over head_dim),
or int4 values on a [-7, 7] grid (:func:`quantize_kv4`) that the cache
writers pack two tokens to a byte along the token axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class QuantizedTensor(NamedTuple):
    """int8 payload ``q [..., out, in]`` + bf16 (or, from the HF loader, f32)
    scale ``[..., out]``."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def dtype(self):
        return self.q.dtype


def quantize(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    """Symmetric int8 quantization, reducing over ``axis`` (in_features).

    w: ``[..., in, out]`` float; returns the payload (stored ``[..., out, in]``)
    and a scale such that ``w ~= swap(q) * scale[..., None, :]``.
    """
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = (torch.clamp(amax, min=1e-8) / 127.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(wf / scale.float()), -127, 127).to(torch.int8)
    return QuantizedTensor(
        q=q.transpose(-1, -2).contiguous(), scale=scale.squeeze(axis)
    )


def dequantize(t: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Back to the logical ``[..., in, out]`` layout."""
    q = t.q.transpose(-1, -2)
    return (q.float() * t.scale.float()[..., None, :]).to(dtype)


class Quantized4Tensor(NamedTuple):
    """int4 payload ``qp [..., out, in/2]`` int8, planar-packed (byte j holds
    in-feature j in its low nibble and j + in/2 in its high nibble), and
    bf16 group scales ``gscale [..., G, out]``. Each group lies inside one
    nibble plane (:func:`pick_group4`), except in a row-parallel rank's slice
    (``parallel/sharding.py``), whose local pack may split a group between
    its planes."""

    qp: torch.Tensor
    gscale: torch.Tensor

    @property
    def dtype(self):
        return self.qp.dtype

    @property
    def in_features(self) -> int:
        return self.qp.shape[-1] * 2

    @property
    def group_size(self) -> int:
        return self.in_features // self.gscale.shape[-2]


def pick_group4(in_features: int, group: int = 128) -> int:
    """Largest group size <= ``group`` that divides the nibble-plane width
    ``in/2`` (so groups never straddle the planar pack boundary)."""
    assert in_features % 2 == 0, f"odd in_features {in_features}"
    half = in_features // 2
    return math.gcd(half, min(group, half))


def pack4(q4: torch.Tensor) -> torch.Tensor:
    """int4 values in an int8 tensor ``[..., in]`` (range [-8, 7]) ->
    planar-packed ``[..., in/2]`` int8."""
    half = q4.shape[-1] // 2
    lo = q4[..., :half].to(torch.int32)
    hi = q4[..., half:].to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack4(qp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed int8 ``[..., in/2]`` -> (low, high) int8 nibble planes,
    sign-extended. The shifts run in int32: a packed byte of -128..127 holds
    the nibble -8, which random init writes."""
    q32 = qp.to(torch.int32)
    lo = ((q32 << 28) >> 28).to(torch.int8)
    hi = (q32 >> 4).to(torch.int8)  # byte sign extension == nibble sign
    return lo, hi


def nibble_merge(old: torch.Tensor, q4: torch.Tensor,
                 is_hi: torch.Tensor) -> torch.Tensor:
    """New packed bytes of a one-token int4 write: where the device bool
    ``is_hi`` holds, the token goes to the high nibble over the live low one;
    otherwise to the low nibble, and the stale high one is cleared. Both
    planes are computed and one kept, so no host sync. 32-bit arithmetic, as
    ``unpack4``."""
    o32, q32 = old.to(torch.int32), q4.to(torch.int32)
    return torch.where(is_hi, (o32 & 0xF) | (q32 << 4), q32 & 0xF).to(torch.int8)


def quantize4(w: torch.Tensor, group: int = 128) -> Quantized4Tensor:
    """Symmetric int4 group-wise quantization over in_features (axis -2).

    w: ``[..., in, out]`` float. Scales are rounded to bf16 first and the
    payload is quantized against them; range [-7, 7]."""
    *lead, K, N = w.shape
    g = pick_group4(K, group)
    G = K // g
    wf = w.float().reshape(*lead, G, g, N)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    gscale = (torch.clamp(amax, min=1e-8) / 7.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(wf / gscale.float()), -7, 7)
    q = q.to(torch.int8).reshape(*lead, K, N)
    return Quantized4Tensor(qp=pack4(q.transpose(-1, -2)).contiguous(),
                            gscale=gscale.squeeze(-2))


def dequantize4(t: Quantized4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Back to the logical ``[..., in, out]`` layout."""
    lo, hi = unpack4(t.qp)
    q = torch.cat([lo, hi], dim=-1).transpose(-1, -2)
    *lead, K, N = q.shape
    G = t.gscale.shape[-2]
    wf = q.float().reshape(*lead, G, K // G, N) * t.gscale.float()[..., :, None, :]
    return wf.reshape(*lead, K, N).to(dtype)


def _swap_weight_term(subscripts: str) -> str:
    """'bth,hd->btd' -> 'bth,dh->btd' (weight operand axes reversed)."""
    ins, out = subscripts.split("->")
    x_term, w_term = ins.split(",")
    w_term = w_term[:-2] + w_term[-1] + w_term[-2]
    return f"{x_term},{w_term}->{out}"


def s8_stacked_eligible(x: torch.Tensor, w_stacked, impl: str) -> bool:
    """Would :func:`qmatmul_stacked` route this call to an s8 GEMM?

    Lets the model quantize an activation ONCE and share the (payload, scale)
    pair across every projection consuming it (q/k/v off one rmsnorm,
    gate/up off the other). Only the structure decides: a stacked int8
    weight under ``impl="w8a8"`` always takes the w8a8 GEMM, a stacked int4
    weight under ``impl="w4a8"`` the w4a8 GEMM, and on a CUDA tensor the
    wrapper raises on a shape its kernel does not take rather than falling
    back to weight-only dq."""
    if impl == "w8a8" and isinstance(w_stacked, QuantizedTensor) and w_stacked.q.ndim == 3:
        return x.shape[-1] == w_stacked.q.shape[-1]
    if impl == "w4a8" and isinstance(w_stacked, Quantized4Tensor) and w_stacked.qp.ndim == 3:
        return x.shape[-1] == w_stacked.in_features
    return False


def _s8_gemm_2d(x: torch.Tensor, w, impl: str) -> torch.Tensor:
    """A 2-D weight on the s8 GEMMs' 2-D entries: per-row activation
    quantization, then ``w8a8_matmul`` or ``w4a8_matmul``."""
    from hydragen_torch.ops import gemm

    K = x.shape[-1]
    a_q, a_s = gemm.quantize_rows(x.reshape(-1, K))
    if impl == "w8a8":
        y = gemm.w8a8_matmul(a_q, a_s, w.q, w.scale, out_dtype=x.dtype)
    else:
        y = gemm.w4a8_matmul(a_q, a_s, w.qp, w.gscale, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def qmatmul(x: torch.Tensor, w, subscripts: str, impl: str = "dq") -> torch.Tensor:
    """einsum over a maybe-quantized weight (``subscripts`` written for the
    logical ``[in, out]`` orientation; every caller contracts x's last axis
    against the weight's ``in`` axis).

    ``impl="w8a8"`` on a 2-D QuantizedTensor and ``impl="w4a8"`` on a 2-D
    Quantized4Tensor run the s8 GEMMs' 2-D entries: their kernels on a CUDA
    tensor (which raise on a shape they do not take), their plain versions on
    a CPU tensor. Otherwise a QuantizedTensor is contracted through its int8
    payload cast to the activation dtype with the per-output-channel scale
    applied once on the result (weight-only int8), and a Quantized4Tensor is
    dequantized plane by plane, each plane's dot against its contiguous half
    of the activations (weight-only int4); where a group straddles the two
    planes (a row-parallel rank's slice), over the logical in-features.
    """
    if isinstance(w, Quantized4Tensor):
        if impl == "w4a8" and w.qp.ndim == 2:
            return _s8_gemm_2d(x, w, impl)
        if w.qp.ndim == 2 and w.qp.shape[-1] % w.group_size == 0:
            N, Kp = w.qp.shape
            G, g = w.gscale.shape[-2], w.group_size
            lo, hi = unpack4(w.qp)
            swapped = _swap_weight_term(subscripts)

            def plane(p, g0):
                # int4 values and bf16 group scales are exact in bf16.
                gs = w.gscale[g0:g0 + G // 2].to(x.dtype)  # [G/2, N]
                wf = p.to(x.dtype).reshape(N, G // 2, g) * gs.transpose(0, 1)[:, :, None]
                return wf.reshape(N, Kp)

            return (torch.einsum(swapped, x[..., :Kp], plane(lo, 0))
                    + torch.einsum(swapped, x[..., Kp:], plane(hi, G // 2)))
        return torch.einsum(subscripts, x, dequantize4(w, x.dtype))
    if isinstance(w, QuantizedTensor):
        if impl == "w8a8" and w.q.ndim == 2:
            return _s8_gemm_2d(x, w, impl)
        y = torch.einsum(_swap_weight_term(subscripts), x, w.q.to(x.dtype))
        return y * w.scale.to(x.dtype)
    return torch.einsum(subscripts, x, w)


def qmatmul_stacked(x, w_stacked, layer: int, subscripts: str, impl: str = "dq",
                    a_pre=None, plain: bool = False):
    """Layer-indexed einsum over STACKED ``[L, ...]`` maybe-quantized weights.

    ``impl="w8a8"`` routes to ``w8a8_matmul_cached`` and ``impl="w4a8"`` to
    ``w4a8_matmul_cached`` (ops/gemm.py), which read the layer straight out
    of the stacked buffer, or with ``plain`` to their plain versions on any
    device. ``a_pre``: optional pre-quantized activation ``(a_q [M, K] s8,
    a_scale [M, 1] f32)`` shared across projections consuming the same
    activation."""
    if s8_stacked_eligible(x, w_stacked, impl):
        from hydragen_torch.ops import gemm

        K = x.shape[-1]
        if a_pre is None:
            quantize = gemm.quantize_rows_plain if plain else gemm.quantize_rows
            a_pre = quantize(x.reshape(-1, K))
        a_q, a_s = a_pre
        if impl == "w8a8":
            fn = gemm.w8a8_cached_plain if plain else gemm.w8a8_matmul_cached
        else:
            fn = gemm.w4a8_cached_plain if plain else gemm.w4a8_matmul_cached
        y = fn(layer, a_q, a_s, *w_stacked, out_dtype=x.dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if is_quantized_weight(w_stacked):
        w_sliced = type(w_stacked)(*(t[layer] for t in w_stacked))
    else:
        w_sliced = w_stacked[layer]
    return qmatmul(x, w_sliced, subscripts, impl=impl)


# --- KV-cache quantization -------------------------------------------------


# The KV quantizers scale amax by these f32 reciprocals, not by a division:
# the JAX engine runs them under jax.jit, where XLA folds a division by a
# constant into a product with its f32 reciprocal. 0-dim CPU tensors enter a
# CUDA op as scalars, so the CPU and the card compute one function. ``x /
# scale`` stays an IEEE division on both sides.
RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
RECIP_7 = torch.tensor(1.0 / 7.0, dtype=torch.float32)


def quantize_kv(x: torch.Tensor):
    """x ``[..., d]`` float -> (q int8 ``[..., d]``, scale f32 ``[...]``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * RECIP_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


def quantize_kv4(x: torch.Tensor):
    """x ``[..., d]`` float -> (UNPACKED int4 values in int8 ``[..., d]``,
    scale f32 ``[...]``): the per-(token, head) scheme of :func:`quantize_kv`
    on a [-7, 7] grid. The cache writers pack two tokens to a byte along the
    TOKEN axis (byte row j holds token j low and token j + S/2 high)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # The product with the f32 reciprocal that jitted JAX and the int4 write
    # kernel compute (see RECIP_127).
    scale = torch.clamp(amax, min=1e-8) * RECIP_7
    q4 = torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int8)
    return q4, scale.squeeze(-1)


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down")

# MLP intermediate-dim padding for the s8 GEMM: zero-padding gate/up's out
# dim and down's in dim is exact (silu(0) * 0 = 0 feeds zero rows of down).
_I_PAD = 512


def pad_intermediate(layers: dict) -> dict:
    """Zero-pad the MLP intermediate dim of a (stacked) layer dict to an
    _I_PAD multiple. Called on FLOAT weights before quantization; models with
    I < _I_PAD are left alone."""
    I = layers["gate"].shape[-1]
    if I < _I_PAD or I % _I_PAD == 0:
        return layers
    pad = -I % _I_PAD
    out = dict(layers)
    out["gate"] = torch.nn.functional.pad(layers["gate"], (0, pad))
    out["up"] = torch.nn.functional.pad(layers["up"], (0, pad))
    out["down"] = torch.nn.functional.pad(layers["down"], (0, 0, 0, pad))
    return out


def quantize_params(params: dict, pad_mlp: bool = False, bits: int = 8,
                    bits4_families: tuple = ()) -> dict:
    """Quantize the projection matrices and the LM head of a Llama parameter
    dict: int8 with per-(layer, out-channel) scales (``bits=8``) or int4 with
    per-(layer, K-group, out-channel) scales (``bits=4``). ``bits4_families``
    names projection families quantized at int4 whatever ``bits`` says (the
    "mixed" mode: int8 everywhere, int4 ``down``). The LM head stays int8:
    its logits feed sampling directly. Embeddings, norms and biases stay."""
    assert bits in (8, 4), bits
    out = dict(params)
    layers = dict(params["layers"])
    if pad_mlp:
        layers = pad_intermediate(layers)
    for k in _QUANT_KEYS:
        layers[k] = quantize4(layers[k]) if bits == 4 or k in bits4_families \
            else quantize(layers[k])
    out["layers"] = layers
    out["lm_head"] = quantize(params["lm_head"])
    return out


def is_quantized_weight(x) -> bool:
    """An int8 or int4 weight node."""
    return isinstance(x, (QuantizedTensor, Quantized4Tensor))
