"""Attention, quantization and GEMM ops, and the kernels' loader."""
