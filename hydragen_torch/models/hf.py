"""HuggingFace Llama checkpoints into the port's parameter dict.

Port of ``hydragen_tpu.models.hf``: take a transformers ``LlamaForCausalLM``
(or its state dict, or a local checkpoint directory) and produce the stacked
``[L, ...]`` parameter dict of ``hydragen_torch.models.llama``.

- Orientation: a torch ``nn.Linear`` stores ``[out, in]``; the model's float
  weights are ``[in, out]`` and are transposed once here. A quantized
  payload is stored ``[out, in]``, HF's own orientation, so the quantizers
  below work on HF's tensors as they are.
- Quantization runs on the host, layer by layer, into preallocated int8
  stacks, before any weight reaches the device: bf16 originals never
  occupy device memory. ``_quantize_host`` and ``_quantize4_host`` compute
  what the JAX package's ``_np_quantize`` and ``_np_quantize4`` compute,
  bit for bit: int8 keeps its per-channel scale in f32 (a true division by
  127), int4 rounds its group scales to bf16. Neither pads the MLP.
- ``from_pretrained`` reads a local directory only (``config.json`` and
  ``*.safetensors`` or ``pytorch_model*.bin``). It reads safetensors files
  itself, through ``mmap``, and imports neither ``transformers`` nor
  ``safetensors``; it never goes to a hub.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
import sys
import types
from pathlib import Path

import torch

from hydragen_torch.models.config import ModelConfig
from hydragen_torch.ops.quant import Quantized4Tensor, QuantizedTensor, pack4, pick_group4

QUANTIZATIONS = (None, "int8", "w8a8", "int4", "w4a8", "mixed")

# transformers.LlamaConfig's defaults, for the keys a config.json leaves out
# (num_key_value_heads None means one kv head a query head).
LLAMA_DEFAULTS = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=None, hidden_act="silu",
    max_position_embeddings=2048, rms_norm_eps=1e-6, tie_word_embeddings=False,
    rope_theta=10000.0, rope_scaling=None, attention_bias=False, mlp_bias=False,
    head_dim=None,
)


def _quantize_host(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric int8 quantization of a ``[..., out, in]`` weight over its
    in-features: payload ``[..., out, in]`` and an f32 scale ``[..., out]``
    (``max(amax, 1e-8) / 127``, a true division). On the CPU."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    x = wf / scale
    x.round_().clamp_(-127, 127)
    return QuantizedTensor(q=x.to(torch.int8), scale=scale.squeeze(-1))


def _quantize4_host(w: torch.Tensor, group: int = 128) -> Quantized4Tensor:
    """Symmetric int4 group-wise quantization of a ``[..., out, in]`` weight
    over its in-features (``ops/quant.quantize4``'s scheme): bf16 group
    scales ``[..., G, out]`` (``pick_group4``), the payload quantized against
    them on a [-7, 7] grid and planar-packed ``[..., out, in/2]``. On the
    CPU."""
    *lead, N, K = w.shape
    g = pick_group4(K, group)
    G = K // g
    wf = w.float().reshape(*lead, N, G, g)
    amax = wf.abs().amax(dim=-1, keepdim=True)
    gscale = (torch.clamp(amax, min=1e-8) / 7.0).to(torch.bfloat16)
    x = wf / gscale.float()
    x.round_().clamp_(-7, 7)
    return Quantized4Tensor(qp=pack4(x.to(torch.int8).reshape(*lead, N, K)),
                            gscale=gscale.squeeze(-1).transpose(-1, -2).contiguous())


def params_from_hf_state_dict(state_dict, cfg: ModelConfig, quantization=None) -> dict:
    """A HF Llama state dict (CPU tensors) -> the stacked parameter dict, on
    the CPU.

    ``"int8"`` and ``"w8a8"`` (the same int8 storage; the engine picks the
    product) quantize the projections and the LM head; ``"int4"`` and
    ``"w4a8"`` pack the projections to int4 groups and keep the LM head int8;
    ``"mixed"`` is int8 with an int4 ``down`` (the engine's mode of that
    name; the JAX loader has no such mode).
    A tied head is the embedding's transpose and is never quantized."""
    assert quantization in QUANTIZATIONS, f"unknown quantization {quantization!r}"
    dt = cfg.torch_dtype
    L = cfg.num_hidden_layers
    quant = quantization is not None
    get = state_dict.__getitem__

    def stack(fmt, transpose=False, quantize=False, int4=quantization in ("int4", "w4a8")):
        """Layer i of every stack is written in place: host memory holds one
        layer's f32 copy at a time beside the stacks."""
        first = get(fmt.format(0))
        if quantize and quant:
            N, K = first.shape
            if int4:
                G = K // pick_group4(K)
                out = Quantized4Tensor(qp=torch.empty((L, N, K // 2), dtype=torch.int8),
                                       gscale=torch.empty((L, G, N), dtype=torch.bfloat16))
                fn = _quantize4_host
            else:
                out = QuantizedTensor(q=torch.empty((L, N, K), dtype=torch.int8),
                                      scale=torch.empty((L, N), dtype=torch.float32))
                fn = _quantize_host
            for i in range(L):
                for dst, src in zip(out, fn(get(fmt.format(i)))):
                    dst[i].copy_(src)
            return out
        shape = first.shape[::-1] if transpose else first.shape
        out = torch.empty((L, *shape), dtype=dt)
        for i in range(L):
            w = get(fmt.format(i))
            out[i].copy_(w.t() if transpose else w)
        return out

    def proj(fmt, **kw):
        return stack(fmt, transpose=True, quantize=True, **kw)

    prefix = "model.layers.{}."
    params = {
        "embed_tokens": get("model.embed_tokens.weight").to(dt, copy=True),
        "final_norm": get("model.norm.weight").to(dt, copy=True),
        "layers": {
            "input_norm": stack(prefix + "input_layernorm.weight"),
            "post_attn_norm": stack(prefix + "post_attention_layernorm.weight"),
            "wq": proj(prefix + "self_attn.q_proj.weight"),
            "wk": proj(prefix + "self_attn.k_proj.weight"),
            "wv": proj(prefix + "self_attn.v_proj.weight"),
            "wo": proj(prefix + "self_attn.o_proj.weight"),
            "gate": proj(prefix + "mlp.gate_proj.weight"),
            "up": proj(prefix + "mlp.up_proj.weight"),
            "down": proj(prefix + "mlp.down_proj.weight",
                         **({"int4": True} if quantization == "mixed" else {})),
        },
    }
    if cfg.attention_bias:
        for name, proj_name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj"),
                                ("bo", "o_proj")):
            params["layers"][name] = stack(prefix + f"self_attn.{proj_name}.bias")

    if "lm_head.weight" in state_dict:
        head = get("lm_head.weight")
        params["lm_head"] = _quantize_host(head) if quant else head.t().to(dt).contiguous()
    else:
        assert cfg.tie_word_embeddings
        params["lm_head"] = params["embed_tokens"].t()
    return params


def from_hf_model(hf_model, dtype: str = "bfloat16", quantization=None):
    """(config, params) from an in-memory transformers ``LlamaForCausalLM``."""
    cfg = ModelConfig.from_hf_config(hf_model.config, dtype=dtype)
    params = params_from_hf_state_dict(hf_model.state_dict(), cfg, quantization=quantization)
    return cfg, params


# --- Reading a checkpoint directory ------------------------------------------


def config_from_json(path, dtype: str = "bfloat16") -> ModelConfig:
    """A HF ``config.json`` of a Llama model, with ``LlamaConfig``'s defaults
    for the keys it leaves out. Raises on another ``model_type`` and on what
    the port's model does not compute (an MLP bias, a head size other than
    hidden / heads)."""
    raw = json.loads(Path(path).read_text())
    if raw.get("model_type") != "llama":
        raise ValueError(f"{path}: model_type {raw.get('model_type')!r}; only 'llama' "
                         "checkpoints load")
    c = dict(LLAMA_DEFAULTS, **raw)
    if c["num_key_value_heads"] is None:
        c["num_key_value_heads"] = c["num_attention_heads"]
    if c["mlp_bias"]:
        raise ValueError(f"{path}: mlp_bias is not supported")
    if c["head_dim"] not in (None, c["hidden_size"] // c["num_attention_heads"]):
        raise ValueError(f"{path}: head_dim {c['head_dim']} is not hidden_size / "
                         "num_attention_heads")
    if c["hidden_act"] != "silu":
        raise ValueError(f"{path}: hidden_act {c['hidden_act']!r} is not supported")
    return ModelConfig.from_hf_config(types.SimpleNamespace(**c), dtype=dtype)


_SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}


def read_safetensors(path) -> dict:
    """``{name: tensor}`` of one ``.safetensors`` file: an 8-byte
    little-endian header length, a JSON header, then the raw little-endian
    tensors. The tensors are views of a copy-on-write ``mmap`` of the file,
    read from disk as they are touched. BF16, F16 and F32 only."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian; this host is not")
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; the reader takes "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        begin, end = info["data_offsets"]
        count = math.prod(info["shape"])
        if end - begin != count * dt.itemsize or base + end > len(buf):
            raise ValueError(f"{path}: {name}'s data_offsets {info['data_offsets']} do not "
                             f"hold {info['shape']} {info['dtype']}")
        t = (torch.frombuffer(buf, dtype=dt, count=count, offset=base + begin) if count
             else torch.empty(0, dtype=dt))
        out[name] = t.reshape(info["shape"])
    return out


def _weight_files(path: Path) -> list:
    """The weight files of a checkpoint directory, safetensors first."""
    for index, single in (("model.safetensors.index.json", "model.safetensors"),
                          ("pytorch_model.bin.index.json", "pytorch_model.bin")):
        if (path / index).exists():
            names = json.loads((path / index).read_text())["weight_map"].values()
            return [path / n for n in sorted(set(names))]
        if (path / single).exists():
            return [path / single]
    raise FileNotFoundError(f"{path}: no model.safetensors, model.safetensors.index.json, "
                            "pytorch_model.bin or pytorch_model.bin.index.json")


def read_state_dict(path) -> dict:
    """The state dict of a checkpoint directory, every file's tensors in one
    dict (safetensors through :func:`read_safetensors`, ``.bin`` through
    ``torch.load(weights_only=True, mmap=True)``)."""
    state = {}
    for f in _weight_files(Path(path)):
        if f.suffix == ".safetensors":
            state.update(read_safetensors(f))
        else:
            state.update(torch.load(f, map_location="cpu", weights_only=True, mmap=True))
    return state


def checkpoint_bytes(path) -> int:
    """Bytes of the weight files :func:`read_state_dict` reads."""
    return sum(f.stat().st_size for f in _weight_files(Path(path)))


def from_pretrained(path, dtype: str = "bfloat16", quantization=None):
    """(config, params) of a local HF Llama checkpoint directory, the params
    on the CPU (quantized there when ``quantization`` is set)."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"{path} is not a directory: the port loads a local "
                                "checkpoint directory (config.json and weights), never a hub")
    cfg = config_from_json(path / "config.json", dtype=dtype)
    params = params_from_hf_state_dict(read_state_dict(path), cfg, quantization=quantization)
    return cfg, params
