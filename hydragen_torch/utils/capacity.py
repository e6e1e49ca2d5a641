"""Device-memory accounting for pre-flight fit checks (H100, 80 GB).

Port of ``hydragen_tpu.utils.capacity``: device-resident bytes, not traffic.
"""

from __future__ import annotations

from hydragen_torch.models.config import ModelConfig
from hydragen_torch.ops.quant import _I_PAD

# H100 SXM: 80 GB of HBM minus headroom for the CUDA context, the caching
# allocator's slack and activations.
HBM_BYTES = 76e9


def param_bytes(cfg: ModelConfig, quant) -> int:
    """Device bytes of the parameters under a quantization mode: None/""
    (model dtype, 2 bytes), or "int8"/"w8a8" (int8 payload; bf16 channel
    scales are counted in the payload's rounding). "w8a8" pads the MLP
    intermediate dim to an _I_PAD multiple."""
    I = cfg.intermediate_size
    if quant == "w8a8" and I >= _I_PAD:
        I = -(-I // _I_PAD) * _I_PAD
    per_layer = 4 * cfg.hidden_size * cfg.hidden_size + 3 * cfg.hidden_size * I
    body = per_layer * cfg.num_hidden_layers
    head = cfg.hidden_size * cfg.vocab_size
    embed = cfg.vocab_size * cfg.hidden_size * 2  # bf16 gather table
    w = 1 if quant else 2
    return (body + head) * w + embed
