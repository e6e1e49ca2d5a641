"""hydragen-torch: the shared-prefix (Hydragen) LLM inference engine in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``hydragen_tpu`` (the JAX/Pallas package beside it, which stays
the reference): exact shared-prefix attention decomposition with
inter-sequence batching over multi-level prefix hierarchies, the Llama stack,
int8 / w8a8 / int4 / w4a8 weights, an int8 or token-planar int4 KV cache and
continuous batching over a ring-slot pool, and tensor, data and sequence
parallelism over ``torch.distributed`` (``hydragen_torch.parallel``), the
continuous batcher included. The kernels live in ``csrc/`` and are built
with ``nvcc`` at first use; importing this package builds nothing.
"""

from hydragen_torch.ops.combine import combine_lse
from hydragen_torch.ops.hydragen import hydragen_attention
from hydragen_torch.ops.reference import attention_with_lse
from hydragen_torch.models.config import ModelConfig
from hydragen_torch.core.engine import HydragenLlama, SharedCacheOp
from hydragen_torch.core.batching import ContinuousBatcher
from hydragen_torch.parallel import launch, make_mesh

__version__ = "0.1.0"

__all__ = [
    "combine_lse",
    "hydragen_attention",
    "attention_with_lse",
    "ModelConfig",
    "HydragenLlama",
    "SharedCacheOp",
    "ContinuousBatcher",
    "make_mesh",
    "launch",
]
