"""Model configuration, the Llama stack and parameter conversion."""
