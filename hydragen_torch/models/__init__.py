"""Model configuration, the Llama stack, parameter conversion, HF loading and
native checkpoints."""
