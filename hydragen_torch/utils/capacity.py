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
    (model dtype, 2 bytes), "int8"/"w8a8" (int8 payload; bf16 channel
    scales are counted in the payload's rounding), or "int4"/"w4a8"
    (nibble-packed payload and bf16 group scales at group 128; the LM head
    stays int8). "w8a8" and "w4a8" pad the MLP intermediate dim to an _I_PAD
    multiple."""
    I = cfg.intermediate_size
    if quant in ("w8a8", "w4a8") and I >= _I_PAD:
        I = -(-I // _I_PAD) * _I_PAD
    per_layer = 4 * cfg.hidden_size * cfg.hidden_size + 3 * cfg.hidden_size * I
    body = per_layer * cfg.num_hidden_layers
    head = cfg.hidden_size * cfg.vocab_size
    embed = cfg.vocab_size * cfg.hidden_size * 2  # bf16 gather table
    if quant in ("int4", "w4a8"):
        return int(body * (0.5 + 2 / 128)) + head + embed
    w = 1 if quant else 2
    return (body + head) * w + embed


def kv_cache_bytes(cfg: ModelConfig, max_unique_batch_size: int,
                   max_unique_seq_length: int, shared_batch_sizes=(), shared_seq_lengths=(),
                   kv_quant=None) -> int:
    """Device bytes ``HydragenLlama.setup_caches`` allocates for its
    buffers: payloads (int8, or int4 packed two tokens a byte in the unique
    cache, or 2-byte compute dtype) and f32 scales of the unique cache and of
    each shared level (int8 under ``kv_quant`` "int8" or "int4"), plus the
    levels' int32 lengths."""
    L, hkv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    S = -(-max_unique_seq_length // 16) * 16
    quant = kv_quant in ("int8", "int4")
    item = 1 if quant else 2
    unique = L * max_unique_batch_size * S * hkv * hd * item
    if kv_quant == "int4":
        unique //= 2
    total = 2 * unique + (2 * L * max_unique_batch_size * S * hkv * 4 if quant else 0)
    for sb, sl in zip(shared_batch_sizes, shared_seq_lengths):
        total += 2 * L * sb * hkv * sl * (hd * item + (4 if quant else 0)) + 4 * sb
    return total
