"""What the benchmark takes from the program under test (``hydragen_torch``):
its model configuration, its parameter layout, the engine and its launch
counter. Every other module of the benchmark reaches the program through
the drivers, which call this one."""

from __future__ import annotations

import gc

import torch

from portbench.cell import MODEL_KEYS


def model_config(config: dict):
    """``hydragen_torch.ModelConfig`` of a configuration file, in the
    compute type it serves in."""
    from hydragen_torch import ModelConfig

    fields = {k: config[k] for k in MODEL_KEYS}
    return ModelConfig(**fields, dtype=config["serving"]["compute_dtype"])


def port_params(w: dict) -> dict:
    """The program's parameter dict over the benchmark's weights (the
    tensors themselves, not copies): stacked ``[L, ...]`` leaves, each
    projection and the LM head an int8 ``QuantizedTensor`` with its f32
    scales."""
    from hydragen_torch.ops.quant import QuantizedTensor

    fams = ("wq", "wk", "wv", "wo", "gate", "up", "down")
    layers = {f: QuantizedTensor(q=w[f][0], scale=w[f][1]) for f in fams}
    layers["input_norm"] = w["input_norm"]
    layers["post_attn_norm"] = w["post_attn_norm"]
    return {"embed_tokens": w["embed"], "final_norm": w["final_norm"],
            "lm_head": QuantizedTensor(q=w["lm_head"][0], scale=w["lm_head"][1]),
            "layers": layers}


def engine(config: dict, w: dict, device):
    """A ``HydragenLlama`` over the weights, as the configuration serves it
    (``serving.weights``: ``"w8a8"`` runs the s8 GEMMs on the int8 weights
    as given)."""
    from hydragen_torch import HydragenLlama

    return HydragenLlama(model_config(config), port_params(w),
                         quantization=config["serving"]["weights"], device=device)


def launches() -> dict:
    """A copy of the program's kernel launch counts."""
    from hydragen_torch.ops import cuda_lib

    return dict(cuda_lib.LAUNCHES)


def build_kernels() -> dict:
    """Build (or find built) the program's kernel libraries; seconds each."""
    from hydragen_torch.ops import cuda_lib

    return cuda_lib.build()


def free() -> None:
    """After the caller dropped its references to the program's state:
    collect the state's reference cycles and return its device memory."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
