"""Model configuration for the Llama family.

A frozen, hashable dataclass (usable as a key of cached specializations),
holding the same fields and presets as ``hydragen_tpu.models.config`` with a
torch dtype in place of the JAX one. The port keeps its own copy so that it
never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    # RoPE scaling: None, ("linear"|"dynamic", factor), or ("llama3", factor,
    # low_freq_factor, high_freq_factor, original_max_position_embeddings).
    rope_scaling: Optional[Tuple] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def from_hf_config(cls, hf_config, dtype: str = "bfloat16") -> "ModelConfig":
        """Build from a transformers LlamaConfig (or compatible)."""
        scaling = getattr(hf_config, "rope_scaling", None)
        if scaling is not None:
            stype = scaling.get("type", scaling.get("rope_type"))
            if stype == "llama3":
                scaling = (
                    stype,
                    float(scaling["factor"]),
                    float(scaling.get("low_freq_factor", 1.0)),
                    float(scaling.get("high_freq_factor", 4.0)),
                    int(scaling.get("original_max_position_embeddings", 8192)),
                )
            elif stype in ("default", None):
                scaling = None
            else:
                scaling = (stype, float(scaling["factor"]))
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_hidden_layers=hf_config.num_hidden_layers,
            num_attention_heads=hf_config.num_attention_heads,
            num_key_value_heads=getattr(
                hf_config, "num_key_value_heads", hf_config.num_attention_heads
            ),
            rms_norm_eps=hf_config.rms_norm_eps,
            rope_theta=getattr(hf_config, "rope_theta", 10000.0),
            max_position_embeddings=hf_config.max_position_embeddings,
            rope_scaling=scaling,
            attention_bias=getattr(hf_config, "attention_bias", False),
            tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
            dtype=dtype,
        )


# Published configurations of the tracked model families.
PRESETS = {
    "sheared-llama-1.3b": ModelConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5504,
        num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
        rms_norm_eps=1e-5, max_position_embeddings=4096,
    ),
    "llama-2-7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
    ),
    "llama-2-13b": ModelConfig(
        vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_hidden_layers=40, num_attention_heads=40, num_key_value_heads=40,
    ),
    "codellama-7b": ModelConfig(
        vocab_size=32016, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        rope_theta=1000000.0, max_position_embeddings=16384,
    ),
    "codellama-13b": ModelConfig(
        vocab_size=32016, hidden_size=5120, intermediate_size=13824,
        num_hidden_layers=40, num_attention_heads=40, num_key_value_heads=40,
        rope_theta=1000000.0, max_position_embeddings=16384,
    ),
    "codellama-34b": ModelConfig(
        vocab_size=32016, hidden_size=8192, intermediate_size=22016,
        num_hidden_layers=48, num_attention_heads=64, num_key_value_heads=8,
        rope_theta=1000000.0, max_position_embeddings=16384,
    ),
    "yi-6b-200k": ModelConfig(
        vocab_size=64000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=4,
        rms_norm_eps=1e-5, rope_theta=5000000.0, max_position_embeddings=200000,
    ),
    "llama-2-70b": ModelConfig(
        vocab_size=32000, hidden_size=8192, intermediate_size=28672,
        num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
    ),
    "llama-3-8b": ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        rope_theta=500000.0, max_position_embeddings=8192,
    ),
    "llama-3.2-1b": ModelConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        rope_theta=500000.0, max_position_embeddings=131072,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192),
        tie_word_embeddings=True,
    ),
    "llama-3.2-3b": ModelConfig(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=28, num_attention_heads=24, num_key_value_heads=8,
        rope_theta=500000.0, max_position_embeddings=131072,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192),
        tie_word_embeddings=True,
    ),
}
