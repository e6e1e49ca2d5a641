"""The port's native checkpoints (``hydragen_torch/models/checkpoint.py``), on
the CPU: a parameter dict saved and loaded comes back tensor by tensor as
saved (dtypes, padded MLPs, f32 or bf16 scales, the ``rope_scaling``
tuple), and an engine over it gives the original engine's tokens and
logits bit for bit. Covered: bf16, int8, w8a8 with a padded MLP, a HF-loaded
w8a8 model (f32 scales, unpadded) and w4a8. The file is one flat dict of
tensors that ``torch.load(weights_only=True)`` reads, and its
``config.json`` is ``dataclasses.asdict`` of the config, as the JAX package
writes it. Small models (2 layers, hidden 64); the MLP is 640 wide so that
w8a8 and w4a8 pad it (to 1,024).
"""

import dataclasses
import json

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import torch
import transformers

from hydragen_tpu.models.config import ModelConfig as JConfig

from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
from hydragen_torch.models import hf
from hydragen_torch.models.checkpoint import flatten, load_checkpoint, save_checkpoint
from hydragen_torch.models.llama import init_params
from hydragen_torch.ops.quant import Quantized4Tensor, QuantizedTensor, quantize_params

torch.set_num_threads(1)

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=640, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
           rope_scaling=("llama3", 8.0, 1.0, 4.0, 256))


def _hf_params(cfg):
    torch.manual_seed(1)
    hf_cfg = transformers.LlamaConfig(
        **{k: v for k, v in dataclasses.asdict(cfg).items()
           if k not in ("rope_scaling", "dtype")},
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 256})
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    assert ModelConfig.from_hf_config(hf_cfg, dtype=cfg.dtype) == cfg
    return hf.params_from_hf_state_dict(model.state_dict(), cfg, "w8a8")


def _params(kind):
    """(config, params, engine quantization) of each kind."""
    if kind == "bf16":
        cfg = ModelConfig(**CFG, dtype="bfloat16")
        return cfg, init_params(cfg, torch.Generator().manual_seed(0)), None
    cfg = ModelConfig(**CFG, dtype="float32")
    if kind == "hf_w8a8":
        return cfg, _hf_params(cfg), "w8a8"
    fp = init_params(cfg, torch.Generator().manual_seed(0))
    bits, pad, quant = {"int8": (8, False, "int8"), "w8a8_padded": (8, True, "w8a8"),
                        "w4a8": (4, True, "w4a8")}[kind]
    return cfg, quantize_params(fp, pad_mlp=pad, bits=bits), quant


KINDS = ["bf16", "int8", "w8a8_padded", "hf_w8a8", "w4a8"]


def _run(cfg, params, quant, kv_quant):
    eng = HydragenLlama(cfg, params, quantization=quant, device="cpu")
    eng.setup_caches(4, 16, [1, 2], [16, 8], kv_quant=kv_quant)
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 128, (1, 10)).astype(np.int32)
    suffix = rng.randint(1, 128, (2, 5)).astype(np.int32)
    return eng.generate(input_ids=[prompt, suffix], num_return_sequences=2, max_new_tokens=5,
                        temperature=0.0, return_logits=True, shared_cache_op=SharedCacheOp.WIPE)


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_roundtrip(tmp_path, kind):
    cfg, params, quant = _params(kind)
    save_checkpoint(tmp_path / "ckpt", cfg, params)
    cfg2, params2 = load_checkpoint(tmp_path / "ckpt")
    assert cfg2 == cfg and isinstance(cfg2.rope_scaling, tuple)
    a, b = flatten(params), flatten(params2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k
    wq, gate = params2["layers"]["wq"], params2["layers"]["gate"]
    if kind == "bf16":
        assert wq.dtype == torch.bfloat16
    elif kind == "w4a8":
        assert isinstance(wq, Quantized4Tensor) and wq.gscale.dtype == torch.bfloat16
        assert gate.qp.shape[1] == 1024
    else:
        assert isinstance(wq, QuantizedTensor)
        assert wq.scale.dtype == (torch.float32 if kind == "hf_w8a8" else torch.bfloat16)
        assert gate.q.shape[1] == (1024 if kind == "w8a8_padded" else 640)
    # The reloaded engine computes what the original does, bit for bit.
    kv = "int8" if quant else None
    tok1, log1 = _run(cfg, params, quant, kv)
    tok2, log2 = _run(cfg2, params2, quant, kv)
    assert torch.equal(tok1, tok2)
    assert len(log1) == len(log2) == 5
    for x, y in zip(log1, log2):
        assert torch.equal(x, y)


def test_checkpoint_file_is_flat_and_its_config_is_jaxs(tmp_path):
    cfg, params, _ = _params("hf_w8a8")
    save_checkpoint(tmp_path, cfg, params)
    flat = torch.load(tmp_path / "params.pt", weights_only=True)
    assert isinstance(flat, dict) and all(torch.is_tensor(t) for t in flat.values())
    assert {"embed_tokens", "lm_head.q", "lm_head.scale", "layers.wq.q", "layers.wq.scale",
            "layers.input_norm"} <= set(flat)
    meta = json.loads((tmp_path / "config.json").read_text())
    jcfg = JConfig(**dict(meta, rope_scaling=tuple(meta["rope_scaling"])))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
