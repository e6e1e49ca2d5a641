"""INT8 quantization of weights and KV.

Port of the int8 parts of ``hydragen_tpu.ops.quant``.

Weights: symmetric per-output-channel int8, payload stored transposed
``[..., out, in]`` with a bf16 scale ``[..., out]``. The payload is quantized
against the bf16-rounded scale, so storing bf16 costs no precision. Because
the scale is per output channel, dequantization commutes with the product:
``y = x @ (w_q * s) == (x @ w_q) * s``.

KV: symmetric per-(token, head) int8 with f32 scales (amax over head_dim).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedTensor(NamedTuple):
    """int8 payload ``q [..., out, in]`` + bf16 scale ``[..., out]``."""

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


def _swap_weight_term(subscripts: str) -> str:
    """'bth,hd->btd' -> 'bth,dh->btd' (weight operand axes reversed)."""
    ins, out = subscripts.split("->")
    x_term, w_term = ins.split(",")
    w_term = w_term[:-2] + w_term[-1] + w_term[-2]
    return f"{x_term},{w_term}->{out}"


def s8_stacked_eligible(x: torch.Tensor, w_stacked, impl: str) -> bool:
    """Would :func:`qmatmul_stacked` route this call to the s8 GEMM?

    Lets the model quantize an activation ONCE and share the (payload, scale)
    pair across every projection consuming it (q/k/v off one rmsnorm,
    gate/up off the other). Only the structure decides: a stacked int8
    weight under ``impl="w8a8"`` always takes the s8 GEMM, and on a CUDA
    tensor its wrapper raises on a shape the kernel does not take rather
    than falling back to weight-only dq."""
    if impl == "w8a8" and isinstance(w_stacked, QuantizedTensor) and w_stacked.q.ndim == 3:
        return x.shape[-1] == w_stacked.q.shape[-1]
    return False


def qmatmul(x: torch.Tensor, w, subscripts: str, impl: str = "dq") -> torch.Tensor:
    """einsum over a maybe-quantized weight (``subscripts`` written for the
    logical ``[in, out]`` orientation).

    A QuantizedTensor is contracted through its int8 payload cast to the
    activation dtype, and the per-output-channel scale is applied once on the
    result (weight-only int8). The s8 GEMM serves only stacked weights
    (:func:`qmatmul_stacked`); a 2D weight under ``impl="w8a8"`` takes this
    path, as the JAX package does wherever its s8 kernel is ineligible.
    """
    if isinstance(w, QuantizedTensor):
        y = torch.einsum(_swap_weight_term(subscripts), x, w.q.to(x.dtype))
        return y * w.scale.to(x.dtype)
    return torch.einsum(subscripts, x, w)


def qmatmul_stacked(x, w_stacked, layer: int, subscripts: str, impl: str = "dq",
                    a_pre=None, plain: bool = False):
    """Layer-indexed einsum over STACKED ``[L, ...]`` maybe-quantized weights.

    ``impl="w8a8"`` routes to ``w8a8_matmul_cached`` (ops/gemm.py), which
    reads the layer straight out of the stacked buffer, or with ``plain`` to
    its plain version on any device. ``a_pre``: optional pre-quantized
    activation ``(a_q [M, K] s8, a_scale [M, 1] f32)`` shared across
    projections consuming the same activation."""
    if s8_stacked_eligible(x, w_stacked, impl):
        from hydragen_torch.ops.gemm import (
            quantize_rows,
            w8a8_cached_plain,
            w8a8_matmul_cached,
        )

        L, N, K = w_stacked.q.shape
        lead = x.shape[:-1]
        a_q, a_s = a_pre if a_pre is not None else quantize_rows(x.reshape(-1, K))
        gemm = w8a8_cached_plain if plain else w8a8_matmul_cached
        y = gemm(layer, a_q, a_s, w_stacked.q, w_stacked.scale, out_dtype=x.dtype)
        return y.reshape(*lead, N)
    if isinstance(w_stacked, QuantizedTensor):
        w_sliced = QuantizedTensor(w_stacked.q[layer], w_stacked.scale[layer])
    else:
        w_sliced = w_stacked[layer]
    return qmatmul(x, w_sliced, subscripts, impl=impl)


# --- KV-cache quantization -------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """x ``[..., d]`` float -> (q int8 ``[..., d]``, scale f32 ``[...]``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


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


def quantize_params(params: dict, pad_mlp: bool = False) -> dict:
    """Quantize the projection matrices and the LM head of a Llama parameter
    dict to int8 (per-(layer, out-channel) scales). Embeddings, norms and
    biases stay."""
    out = dict(params)
    layers = dict(params["layers"])
    if pad_mlp:
        layers = pad_intermediate(layers)
    for k in _QUANT_KEYS:
        layers[k] = quantize(layers[k])
    out["layers"] = layers
    out["lm_head"] = quantize(params["lm_head"])
    return out


def is_quantized_weight(x) -> bool:
    return isinstance(x, QuantizedTensor)
