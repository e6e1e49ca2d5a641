"""Native checkpoint save and load.

Port of ``hydragen_tpu.models.checkpoint``, with torch's own serialisation in
place of Orbax: a parameter dict (quantized ones included) round-trips as
saved, so a quantized 7B model loads without the HF conversion and its
quantization. A checkpoint directory holds

- ``config.json``: ``dataclasses.asdict(cfg)``, as the JAX package writes it;
- ``params.pt``: one flat ``{dotted name: tensor}`` dict (a quantized weight
  as its fields, ``layers.wq.q`` and ``layers.wq.scale``), which
  ``torch.load(weights_only=True)`` reads. It pickles no NamedTuple.

Padded MLPs, f32 or bf16 weight scales and the ``rope_scaling`` tuple come
back exactly as saved.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from hydragen_torch.models.config import ModelConfig
from hydragen_torch.ops.quant import Quantized4Tensor, QuantizedTensor

# A quantized weight node by its field names.
_WEIGHT_CLASSES = {frozenset(cls._fields): cls for cls in (QuantizedTensor, Quantized4Tensor)}


def flatten(params, prefix: str = "") -> dict:
    """``{dotted name: tensor}`` of a parameter dict, a quantized weight by
    its fields (``layers.wq.q``, ``layers.wq.scale``)."""
    if isinstance(params, dict):
        return {k: t for n, sub in params.items() for k, t in flatten(sub, f"{prefix}{n}.").items()}
    if isinstance(params, tuple):
        return {prefix + f: t for f, t in zip(params._fields, params)}
    return {prefix[:-1]: params}


def _restore_quantized(node):
    """Nested dicts back from the dotted names; a dict whose keys are
    ``{q, scale}`` or ``{qp, gscale}`` becomes its quantized weight."""
    if not isinstance(node, dict):
        return node
    cls = _WEIGHT_CLASSES.get(frozenset(node))
    if cls is not None:
        return cls(**node)
    return {k: _restore_quantized(v) for k, v in node.items()}


def save_checkpoint(path, cfg: ModelConfig, params: dict) -> None:
    """Write ``config.json`` and ``params.pt`` under the directory ``path``."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(flatten(params), path / "params.pt")
    (path / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=1))


def load_checkpoint(path):
    """-> (cfg, params), the params on the CPU, mapped from the file."""
    path = Path(path).absolute()
    meta = json.loads((path / "config.json").read_text())
    if meta.get("rope_scaling") is not None:
        meta["rope_scaling"] = tuple(meta["rope_scaling"])
    cfg = ModelConfig(**meta)
    flat = torch.load(path / "params.pt", map_location="cpu", weights_only=True, mmap=True)
    tree: dict = {}
    for name, t in flat.items():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return cfg, _restore_quantized(tree)
