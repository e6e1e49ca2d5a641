"""The projections under tensor parallelism: column- and row-parallel
stacked GEMMs over K1 (``w8a8_matmul_cached``), K6 (``w4a8_matmul_cached``)
or the weight-only product.

Port of ``hydragen_tpu.parallel.shard_gemm``. A rank holds its slice of each
stacked weight, so K1 runs on that slice as it is:

- COLUMN-parallel (q/k/v/gate/up, output features over tp): the activation
  is replicated over tp, so the one ``quantize_rows`` shared by q/k/v (and
  by gate/up) is bit-equal to the single-device one; K1 runs on the local N
  slice and no collective follows. Its output is bf16, as the JAX shard
  bodies emit it. An int4 family under w4a8 runs K6 the same way on its N
  slice of the packed weight and group scales.
- ROW-parallel (o/down, input features over tp): each rank quantizes its own
  K slice of the activation per row (a per-shard row scale, not the global
  one), K1 gives a fully dequantized bf16 partial, and an exact sum
  all-reduce over tp follows. These are the two all-reduces of a layer.
  Under weight-only int8 the row-parallel family is the local dq partial and
  the same all-reduce. An int4 row-parallel family is always that dq
  partial, on the rank's locally repacked slice (``sharding.py``), as JAX
  keeps int4 row-parallel on dq.

Where JAX's routing sends a family to dq on TPU block rules
(``_w8a8_blocks``, ``_w4a8_blocks``), the port runs K1 for every w8a8
family and K6 for every column-parallel w4a8 family: their kernels take
every shape the 7B and 8B paths give them under tp, and on the card they
raise on a shape they do not take rather than fall back. Weights are replicated
over sp and dp; each sp rank repeats the GEMM, as in JAX.
"""

from __future__ import annotations

import torch

from hydragen_torch.ops import gemm
from hydragen_torch.ops.quant import qmatmul_stacked, s8_stacked_eligible
from hydragen_torch.parallel.mesh import Mesh, all_reduce


def _quantize(x, plain: bool):
    """The per-row quantization of ``x``'s rows: K8 on a CUDA tensor, the
    plain version on the CPU or with ``plain``."""
    quantize = gemm.quantize_rows_plain if plain else gemm.quantize_rows
    return quantize(x.reshape(-1, x.shape[-1]))


def _s8(layer, a_q, a_s, w, impl: str, plain: bool) -> torch.Tensor:
    """K1 (w8a8) or K6 (w4a8) on this rank's slice, bf16 out."""
    if impl == "w8a8":
        fn = gemm.w8a8_cached_plain if plain else gemm.w8a8_matmul_cached
    else:
        fn = gemm.w4a8_cached_plain if plain else gemm.w4a8_matmul_cached
    return fn(layer, a_q, a_s, *w, out_dtype=torch.bfloat16)


def sharded_qmatmul_stacked(x, w, layer: int, subscripts: str, impl: str, a_pre=None,
                            plain: bool = False) -> torch.Tensor:
    """Column-parallel ``x @ w[layer]`` on this rank's output slice: K1
    (w8a8) or K6 (w4a8), bf16 out, then ``x``'s dtype, with ``a_pre`` the
    shared row quantization of ``x``; else the weight-only product. No
    collective."""
    if impl in ("w8a8", "w4a8") and s8_stacked_eligible(x, w, impl):
        a_q, a_s = a_pre if a_pre is not None else _quantize(x, plain)
        y = _s8(layer, a_q, a_s, w, impl, plain)
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)
    return qmatmul_stacked(x, w, layer, subscripts, impl="dq")


def sharded_qmatmul_stacked_row(x, w, layer: int, subscripts: str, impl: str, mesh: Mesh,
                                plain: bool = False) -> torch.Tensor:
    """Row-parallel ``x @ w[layer]`` from this rank's K slice: under w8a8
    the slice quantized per row here, K1's bf16 partial; else (an int4
    weight under any mode, its ``impl`` "w4a8" or "dq") the weight-only
    partial in ``x``'s dtype; then the sum over tp."""
    if impl == "w8a8" and s8_stacked_eligible(x, w, impl):
        a_q, a_s = _quantize(x, plain)
        y = _s8(layer, a_q, a_s, w, impl, plain)
        y = all_reduce(y, "sum", mesh, "tp")
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)
    return all_reduce(qmatmul_stacked(x, w, layer, subscripts, impl="dq"), "sum", mesh, "tp")
