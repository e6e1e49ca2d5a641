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
  itself, each tensor into a fresh buffer when the conversion looks it up
  (``LazyTensors``), so the host holds the layer being converted, not the
  checkpoint; it imports neither ``transformers`` nor ``safetensors`` and
  never goes to a hub.
"""

from __future__ import annotations

import json
import math
import struct
import sys
import types
from collections.abc import Mapping
from pathlib import Path
from typing import Optional

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


def params_from_hf_state_dict(state_dict, cfg: ModelConfig, quantization=None, mesh=None,
                              stats: Optional[dict] = None) -> dict:
    """A HF Llama state dict (CPU tensors) -> the stacked parameter dict, on
    the CPU.

    ``"int8"`` and ``"w8a8"`` (the same int8 storage; the engine picks the
    product) quantize the projections and the LM head; ``"int4"`` and
    ``"w4a8"`` pack the projections to int4 groups and keep the LM head int8;
    ``"mixed"`` is int8 with an int4 ``down`` (the engine's mode of that
    name; the JAX loader has no such mode).
    A tied head is the embedding's transpose and is never quantized.

    With ``mesh`` (a ``parallel.Mesh``) the dict holds this rank's slices
    only, as a ``parallel.sharding.RankParams``: each layer is read, quantized
    whole (so a row-parallel int8 family keeps its global per-channel scale)
    and cut by ``shard_leaf``, the rule ``shard_params`` cuts by, into stacks
    allocated at the rank's shapes. Ranks that differ only in dp or sp hold
    the same slices. ``stats``, where given, gets ``"host_param_bytes"``: the
    bytes of every tensor the loader allocated to keep."""
    assert quantization in QUANTIZATIONS, f"unknown quantization {quantization!r}"
    from hydragen_torch.parallel.sharding import (
        RankParams,
        param_pspecs,
        shard_leaf,
        shard_plan,
    )

    dt = cfg.torch_dtype
    L = cfg.num_hidden_layers
    quant = quantization is not None
    get = state_dict.__getitem__
    plan = shard_plan(cfg, mesh)
    specs = param_pspecs(cfg, mesh)
    kept = [0]

    def keep(t: torch.Tensor) -> torch.Tensor:
        kept[0] += t.numel() * t.element_size()
        return t

    def stack(fmt, spec, transpose=False, quantize=False,
              int4=quantization in ("int4", "w4a8")):
        """Layer i of every stack is written in place: host memory holds one
        layer's f32 copy and quantized whole layer at a time beside the
        stacks, which have the rank's shapes."""
        out = None
        for i in range(L):
            w = get(fmt.format(i))
            if quantize and quant:
                w = (_quantize4_host if int4 else _quantize_host)(w)
            elif transpose:
                w = w.t()
            piece = shard_leaf(w, spec[1:], plan.tp, plan.rank)
            if out is None:
                if isinstance(piece, tuple):
                    out = type(piece)(*(keep(torch.empty((L, *t.shape), dtype=t.dtype))
                                        for t in piece))
                else:
                    out = keep(torch.empty((L, *piece.shape), dtype=dt))
            if isinstance(piece, tuple):
                for dst, src in zip(out, piece):
                    dst[i].copy_(src)
            else:
                out[i].copy_(piece)
        return out

    lspec = specs["layers"]

    def proj(name, fmt, **kw):
        return stack(fmt, lspec[name], transpose=True, quantize=True, **kw)

    prefix = "model.layers.{}."
    params = {
        "embed_tokens": keep(get("model.embed_tokens.weight").to(dt, copy=True)),
        "final_norm": keep(get("model.norm.weight").to(dt, copy=True)),
        "layers": {
            "input_norm": stack(prefix + "input_layernorm.weight", lspec["input_norm"]),
            "post_attn_norm": stack(prefix + "post_attention_layernorm.weight",
                                    lspec["post_attn_norm"]),
            "wq": proj("wq", prefix + "self_attn.q_proj.weight"),
            "wk": proj("wk", prefix + "self_attn.k_proj.weight"),
            "wv": proj("wv", prefix + "self_attn.v_proj.weight"),
            "wo": proj("wo", prefix + "self_attn.o_proj.weight"),
            "gate": proj("gate", prefix + "mlp.gate_proj.weight"),
            "up": proj("up", prefix + "mlp.up_proj.weight"),
            "down": proj("down", prefix + "mlp.down_proj.weight",
                         **({"int4": True} if quantization == "mixed" else {})),
        },
    }
    if cfg.attention_bias:
        for name, proj_name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj"),
                                ("bo", "o_proj")):
            params["layers"][name] = stack(prefix + f"self_attn.{proj_name}.bias",
                                           lspec[name])

    hspec = specs["lm_head"]
    if "lm_head.weight" in state_dict:
        head = get("lm_head.weight")
        head = _quantize_host(head) if quant else head.t().to(dt).contiguous()
        # A slice is a copy; the whole head is then this call's transient.
        head = shard_leaf(head, hspec, plan.tp, plan.rank)
        params["lm_head"] = type(head)(*(keep(t) for t in head)) \
            if isinstance(head, tuple) else keep(head)
    else:
        assert cfg.tie_word_embeddings
        params["lm_head"] = shard_leaf(params["embed_tokens"].t(), hspec, plan.tp, plan.rank)
        if plan.vocab:
            keep(params["lm_head"])
    if stats is not None:
        stats["host_param_bytes"] = kept[0]
    return RankParams(params, plan) if mesh is not None else params


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


class LazyTensors(Mapping):
    """``{name: tensor}`` over checkpoint files: a safetensors tensor is read
    from its file into a new CPU tensor each time it is looked up, so a
    caller that converts one layer at a time holds one layer's tensors, not
    the checkpoint (a memory map would keep every page it touched resident
    in the process); other tensors are held as given."""

    def __init__(self):
        self._where: dict = {}  # name: tensor, or (path, offset, dtype, shape)

    def add_file(self, path, entries: dict) -> None:
        """``entries``: ``{name: (offset, dtype, shape)}`` of the file at
        ``path``."""
        for name, (offset, dt, shape) in entries.items():
            self._where[name] = (str(path), offset, dt, tuple(shape))

    def add_tensors(self, tensors: dict) -> None:
        self._where.update(tensors)

    def __getitem__(self, name: str) -> torch.Tensor:
        where = self._where[name]
        if torch.is_tensor(where):
            return where
        path, offset, dt, shape = where
        t = torch.empty(shape, dtype=dt)
        buf = t.reshape(-1).view(torch.uint8).numpy()
        with open(path, "rb") as f:
            f.seek(offset)
            got = f.readinto(buf)
        if got != buf.nbytes:
            raise ValueError(f"{path}: {name} ends past the file ({got} of {buf.nbytes} bytes)")
        return t

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def _safetensors_entries(path) -> dict:
    """``{name: (offset, dtype, shape)}`` of one ``.safetensors`` file (an
    8-byte little-endian header length, a JSON header, then the raw
    little-endian tensors), its header checked. BF16, F16 and F32 only."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian; this host is not")
    size = Path(path).stat().st_size
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    base = 8 + n
    entries = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; the reader takes "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        begin, end = info["data_offsets"]
        count = math.prod(info["shape"])
        if end - begin != count * dt.itemsize or base + end > size:
            raise ValueError(f"{path}: {name}'s data_offsets {info['data_offsets']} do not "
                             f"hold {info['shape']} {info['dtype']}")
        entries[name] = (base + begin, dt, info["shape"])
    return entries


def read_safetensors(path) -> LazyTensors:
    """The tensors of one ``.safetensors`` file, each read from the file when
    it is looked up (:class:`LazyTensors`); the header is read and checked
    here."""
    out = LazyTensors()
    out.add_file(path, _safetensors_entries(path))
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


def read_state_dict(path) -> LazyTensors:
    """The state dict of a checkpoint directory, every file's tensors in one
    mapping (safetensors through :func:`read_safetensors`, read when looked
    up; ``.bin`` through ``torch.load(weights_only=True, mmap=True)``)."""
    state = LazyTensors()
    for f in _weight_files(Path(path)):
        if f.suffix == ".safetensors":
            state.add_file(f, _safetensors_entries(f))
        else:
            state.add_tensors(torch.load(f, map_location="cpu", weights_only=True, mmap=True))
    return state


def checkpoint_bytes(path) -> int:
    """Bytes of the weight files :func:`read_state_dict` reads."""
    return sum(f.stat().st_size for f in _weight_files(Path(path)))


def from_pretrained(path, dtype: str = "bfloat16", quantization=None, mesh=None,
                    stats: Optional[dict] = None):
    """(config, params) of a local HF Llama checkpoint directory, the params
    on the CPU (quantized there when ``quantization`` is set; with ``mesh``,
    this rank's slices: :func:`params_from_hf_state_dict`)."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"{path} is not a directory: the port loads a local "
                                "checkpoint directory (config.json and weights), never a hub")
    cfg = config_from_json(path / "config.json", dtype=dtype)
    params = params_from_hf_state_dict(read_state_dict(path), cfg, quantization=quantization,
                                       mesh=mesh, stats=stats)
    return cfg, params
