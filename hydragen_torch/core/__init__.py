"""KV caches and the generation engine."""
