"""W8A8 and W4A8 GEMMs: s8 activations x s8 or int4 weights -> i32
products with a fused dequant epilogue.

Port of ``hydragen_tpu.ops.gemm``. Scheme:
- int8 weights: per-output-channel s8, stored ``[out, in]``
  (``ops/quant.py``), stacked ``[L, N, K]`` with bf16 scales ``[L, N]``
  (f32 when loaded from a HF checkpoint, ``models/hf.py``);
- int4 weights: planar-packed ``[L, N, K/2]`` int8 (byte j holds
  in-feature j low and j + K/2 high) with bf16 group scales ``[L, G, N]``;
- activations: per-row dynamic s8 (one f32 scale per token row).

``w8a8_matmul_cached`` computes ``a_s8 @ w_all[layer]^T * (row x col
scales)`` and ``w4a8_matmul_cached`` sums each K-group's i32 product times
its group scale in f32, then applies the row scale. Both read the layer
straight out of the stacked weight. ``w8a8_matmul`` and ``w4a8_matmul`` are
their 2-D entries: the same kernels at one layer. A CUDA tensor goes to the
kernels of ``csrc/gemm.cu`` (or raises); a CPU tensor to the plain versions.
``gemm_plan`` picks the w8a8 kernel's tile and K split, ``w4a8_tile`` the
w4a8 kernel's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops.quant import RECIP_127


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic activation quantization: [M, K] -> (s8, f32 [M, 1]).
    On a CUDA tensor K8 with no prologue (``ops/act.py``, the same codes),
    else the plain version."""
    if not x.is_cuda:
        return quantize_rows_plain(x)
    from hydragen_torch.ops import act

    return act.quantize_rows_kernel(x)


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``quantize_rows``: amax times the f32 reciprocal of
    127, as the jitted JAX engine computes it (XLA folds the division by a
    constant; ``quant.RECIP_127``), on any device."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-20) * RECIP_127
    q = torch.round(xf / scale).to(torch.int8)
    return q, scale


def w8a8_reference(a_q, a_scale, w_q, w_scale, out_dtype=torch.bfloat16):
    """f32 oracle of the product (exact while the i32 sums fit f32's 24-bit
    mantissa; beyond that it rounds where the kernel's i32 sum does not)."""
    acc = torch.einsum("mk,nk->mn", a_q.float(), w_q.float())
    return (acc * a_scale.float() * w_scale.float()[None, :]).to(out_dtype)


def w8a8_cached_plain(layer: int, a_q, a_scale, w_all, w_scale_all,
                      out_dtype=torch.bfloat16):
    """Plain PyTorch version of ``w8a8_matmul_cached``."""
    return w8a8_reference(a_q, a_scale, w_all[layer], w_scale_all[layer], out_dtype)


# The column-scale types K1 takes: bf16 (quantize_params) and f32 (the host
# quantizer of models/hf.py, as the JAX package's HF transplant keeps them).
W8A8_SCALE_DTYPES = (torch.bfloat16, torch.float32)


def w8a8_supported(N: int, K: int) -> bool:
    """Shapes the w8a8 kernel takes: rows a whole number of 16 bytes (the
    tensor maps' strides), paired columns."""
    return K % 16 == 0 and N % 2 == 0


# K1's launch plan (csrc/gemm.cu: w8a8_kernel).
GEMM_BK = 128            # bytes of K a stage of the ring
GEMM_SPLITS = (1, 2, 4)  # K splits: the blocks of one cluster
GEMM_GROUP_M = 16        # the kernel's raster: M fastest within groups of this many M tiles
# The plan's cost model, fitted by least squares (on log time) to K1's device
# times at every (bm, bn, split) at the paths' decode and prefill shapes
# (kernel_times.py --gemm-plans, which prints the fit; NVIDIA H100 80GB HBM3,
# 700 W). A 128-byte K step of a block takes the longer of its inflow to
# shared memory (bm + bn rows of 128 bytes) and its products; a block adds a
# fixed cost (ring fill, epilogue, launch), and more with a split (the
# cluster's syncs and the exchange of partials). Microseconds.
GEMM_STEP_US_A_ROW = 0.0020
GEMM_STEP_US_BASE = -0.0861
GEMM_STEP_US_PRODUCTS = 0.7826  # a 256 x 128 tile's step of products
GEMM_BLOCK_US = 2.4832
GEMM_SPLIT_US = 3.7417
# Share of the SMs that clusters of 4 blocks can hold at once: the blocks of
# a cluster share a GPC, and on the H100 the card holds 30 such clusters
# (120 SMs; 66 of 2, 132 of 1), read with cudaOccupancyMaxActiveClusters
# (the library's hydragen_w8a8_max_clusters).
GEMM_CLUSTER4_SM_SHARE = 120 / 132


class GemmPlan(NamedTuple):
    """K1's launch: ``bm`` x ``bn`` output tiles, each computed by a cluster
    of ``splits`` blocks along K, block s taking the K steps ``[s *
    split_steps, (s + 1) * split_steps)`` of ``GEMM_BK`` bytes (the last
    split the rest). The i32 partials are summed in the cluster's shared
    memory, so none goes to device memory."""

    bm: int
    bn: int
    splits: int
    split_steps: int

    def blocks(self, M: int, N: int) -> int:
        return -(-M // self.bm) * -(-N // self.bn) * self.splits


def gemm_cluster_slots(splits: int, n_sm: int) -> int:
    """Clusters of ``splits`` blocks the card holds at once (one block an
    SM)."""
    share = GEMM_CLUSTER4_SM_SHARE if splits >= 4 else 1.0
    return max(1, int(n_sm * share) // splits)


def gemm_plan_us(plan: GemmPlan, M: int, N: int, n_sm: int) -> float:
    """The cost model's time of a launch: waves of clusters times a block's
    steps and fixed cost."""
    waves = -(-plan.blocks(M, N) // plan.splits // gemm_cluster_slots(plan.splits, n_sm))
    step = max(GEMM_STEP_US_A_ROW * (plan.bm + plan.bn) + GEMM_STEP_US_BASE,
               GEMM_STEP_US_PRODUCTS * plan.bm * plan.bn / (256 * 128))
    fixed = GEMM_BLOCK_US + (GEMM_SPLIT_US if plan.splits > 1 else 0.0)
    return waves * (plan.split_steps * step + fixed)


@functools.cache
def gemm_plan(M: int, N: int, K: int, n_sm: int) -> GemmPlan:
    """K1's tile and split for ``a [M, K] . w [N, K]^T`` on ``n_sm`` SMs:
    the plan ``gemm_plan_us`` finds fastest among ``bm`` 128 or 256 (256
    only above 128 rows), ``bn`` 128 or 64 and the splits of
    ``GEMM_SPLITS`` (none that would leave a split without a K step); on a
    tie the larger tile, then the fewer splits. At M <= 256 every weight
    tile is read by at most two blocks, M tiles side by side in the raster,
    so the second read can find the tile in L2."""
    k_steps = -(-K // GEMM_BK)
    best = None
    for bm in (256, 128):
        if bm == 256 and M <= 128:
            continue
        for bn in (128, 64):
            for splits in GEMM_SPLITS:
                per = -(-k_steps // splits)
                if -(-k_steps // per) != splits:
                    continue
                plan = GemmPlan(bm, bn, splits, per)
                key = (gemm_plan_us(plan, M, N, n_sm), -bm * bn, splits)
                if best is None or key < best[0]:
                    best = (key, plan)
    return best[1]


@functools.cache
def _w8a8_fn():
    f = cuda_lib.library("gemm").hydragen_w8a8_gemm
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


@functools.cache
def _w4a8_fn():
    f = cuda_lib.library("gemm").hydragen_w4a8_gemm
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check_operands(what, operands, out_dtype):
    """Device, dtype and contiguity of each ``(name, tensor, dtype)``, the
    output dtype, and 16-byte alignment of the two payloads."""
    dev = operands[0][1].device
    for name, t, dt in operands:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: out_dtype {out_dtype} not supported")
    cuda_lib.check_aligned(f"{what}: a_q", operands[0][1])
    cuda_lib.check_aligned(f"{what}: weight", operands[2][1])
    return dev


def map_encodes() -> int:
    """Tensor maps K1 and K6 have encoded since their library was loaded:
    its map cache's misses (the card only)."""
    f = cuda_lib.library("gemm").hydragen_gemm_map_encodes
    f.restype = ctypes.c_longlong
    return int(f())


def _launch_w8a8(counter, a_q, a_scale, w, w_scale, layer, out_dtype, plan=None, out=None):
    """One K1 launch on layer ``layer`` of ``w [L, N, K]`` (a 2-D weight is
    the stack of one). ``plan`` (default ``gemm_plan``) and ``out`` (default
    a new tensor) let the tests force a split and poison the output. A launch
    with f32 column scales counts under ``counter + "_f32_scales"``."""
    M, K = a_q.shape
    L, N, K2 = w.shape
    if K != K2 or not 0 <= layer < L:
        raise ValueError(f"w8a8 kernel: a {tuple(a_q.shape)} against weight "
                         f"{tuple(w.shape)} at layer {layer}")
    if w_scale.dtype not in W8A8_SCALE_DTYPES:
        raise ValueError(f"w8a8 kernel: weight scale must be bf16 or f32, got {w_scale.dtype}")
    dev = _check_operands("w8a8 kernel", (
        ("a_q", a_q, torch.int8), ("a_scale", a_scale, torch.float32),
        ("weight", w, torch.int8), ("weight scale", w_scale, w_scale.dtype)), out_dtype)
    if a_scale.numel() != M or w_scale.shape != (L, N):
        raise ValueError(f"w8a8 kernel: scale shapes {tuple(a_scale.shape)} "
                         f"{tuple(w_scale.shape)} do not match M={M} L={L} N={N}")
    if not w8a8_supported(N, K):
        raise ValueError(f"w8a8 kernel: needs K % 16 == 0 and N % 2 == 0, got N={N} K={K}")
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0:
        return out
    plan = plan or gemm_plan(M, N, K, cuda_lib.sm_count(dev))
    status = _w8a8_fn()(
        a_q.data_ptr(), a_scale.data_ptr(), w.data_ptr(),
        w_scale.data_ptr() + layer * N * w_scale.element_size(),
        out.data_ptr(), M, N, K, L, layer, *plan, int(out_dtype == torch.bfloat16),
        int(w_scale.dtype == torch.float32), cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(status, counter)
    cuda_lib.LAUNCHES[counter + ("_f32_scales" if w_scale.dtype == torch.float32 else "")] += 1
    return out


def w8a8_matmul_cached(
    layer: int,
    a_q: torch.Tensor,          # [M, K] s8 activations (quantize_rows)
    a_scale: torch.Tensor,      # [M, 1] f32
    w_all: torch.Tensor,        # [L, N, K] s8 stacked weights
    w_scale_all: torch.Tensor,  # [L, N] bf16 or f32 per-(layer, out-channel) scales
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``a @ w_all[layer]^T`` read straight out of the stacked weight: the
    kernel gets the layer's base pointer, so no per-layer slice is copied."""
    layer = int(layer)
    if not a_q.is_cuda:
        return w8a8_cached_plain(layer, a_q, a_scale, w_all, w_scale_all, out_dtype)
    return _launch_w8a8("w8a8_matmul_cached", a_q, a_scale, w_all, w_scale_all, layer,
                        out_dtype)


def w8a8_matmul(a_q, a_scale, w_q, w_scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """2-D entry of K1: ``a @ w_q^T`` for one ``[N, K]`` s8 weight with bf16
    or f32 scales ``[N]``, the same kernel at layer stride 0."""
    if not a_q.is_cuda:
        return w8a8_reference(a_q, a_scale, w_q, w_scale, out_dtype)
    if w_q.ndim != 2:
        raise ValueError(f"w8a8 kernel: 2-D entry got a weight of shape {tuple(w_q.shape)}")
    return _launch_w8a8("w8a8_matmul", a_q, a_scale, w_q[None], w_scale[None], 0, out_dtype)


# --- W4A8 --------------------------------------------------------------------


def w4a8_reference(a_q, a_scale, w_qp, w_gscale, out_dtype=torch.bfloat16):
    """f32 oracle: dequantize the int4 weight group-wise, f32 product, row
    scale. Each group's sum is exact in f32 (at most 128 * 127 * 8 < 2^24);
    the kernel sums the scaled groups in another order."""
    from hydragen_torch.ops.quant import unpack4

    lo, hi = unpack4(w_qp)
    w = torch.cat([lo, hi], dim=-1).float()  # [N, K]
    N, K = w.shape
    G = w_gscale.shape[0]
    w = w.reshape(N, G, K // G) * w_gscale.float().transpose(0, 1)[:, :, None]
    acc = torch.einsum("mk,nk->mn", a_q.float(), w.reshape(N, K))
    return (acc * a_scale.float()).to(out_dtype)


def w4a8_cached_plain(layer: int, a_q, a_scale, w_qp_all, w_gscale_all,
                      out_dtype=torch.bfloat16):
    """Plain PyTorch version of ``w4a8_matmul_cached``."""
    return w4a8_reference(a_q, a_scale, w_qp_all[layer], w_gscale_all[layer], out_dtype)


def w4a8_supported(N: int, Kp: int, group: int) -> bool:
    """Shapes the w4a8 kernel takes: a scale group a multiple of 64
    in-features inside one nibble plane (``Kp`` a whole number of groups),
    paired columns."""
    return group % 64 == 0 and Kp % group == 0 and N % 2 == 0


# K6's tile (csrc/gemm.cu: w4a8_kernel): a block computes the transposed
# product of W4A8_BW weight rows (wgmma's M) and ``w4a8_tile`` activation
# rows over the whole of K (no split).
W4A8_BW = 64
W4A8_TILES = (128, 256)  # activation rows a block: 64 or 128 a consumer warpgroup
W4A8_GROUP_M = 16        # the raster: M fastest within groups of this many M tiles


def w4a8_blocks(M: int, N: int, ba: int) -> int:
    """K6's grid: one block an (activation tile, weight tile)."""
    return -(-M // ba) * -(-N // W4A8_BW)


def w4a8_tile(M: int, N: int, n_sm: int) -> int:
    """Activation rows a K6 block: 256 where that tile still gives every SM
    two blocks (the prefills), else 128, which fills the card at decode
    (M = 256: 128 blocks at N = 4,096, 352 at 11,264)."""
    return 256 if w4a8_blocks(M, N, 256) >= 2 * n_sm else 128


def _launch_w4a8(counter, a_q, a_scale, w_qp, w_gscale, layer, out_dtype, ba=None,
                 out=None):
    """One K6 launch on layer ``layer`` of ``w_qp [L, N, K/2]``, group
    scales ``w_gscale [L, G, N]`` (a 2-D weight is the stack of one).
    ``ba`` (default ``w4a8_tile``) and ``out`` (default a new tensor) let
    the tests force a tile and poison the output."""
    M, K = a_q.shape
    L, N, Kp = w_qp.shape
    if K != 2 * Kp or not 0 <= layer < L:
        raise ValueError(f"w4a8 kernel: a {tuple(a_q.shape)} against packed weight "
                         f"{tuple(w_qp.shape)} at layer {layer}")
    dev = _check_operands("w4a8 kernel", (
        ("a_q", a_q, torch.int8), ("a_scale", a_scale, torch.float32),
        ("packed weight", w_qp, torch.int8),
        ("group scales", w_gscale, torch.bfloat16)), out_dtype)
    if a_scale.numel() != M or w_gscale.ndim != 3 or w_gscale.shape[0] != L \
            or w_gscale.shape[2] != N or K % w_gscale.shape[1]:
        raise ValueError(f"w4a8 kernel: scale shapes {tuple(a_scale.shape)} "
                         f"{tuple(w_gscale.shape)} do not match M={M} L={L} N={N} K={K}")
    G = w_gscale.shape[1]
    group = K // G
    if not w4a8_supported(N, Kp, group):
        raise ValueError(f"w4a8 kernel: needs a group size that is a multiple of 64 "
                         f"within one nibble plane and N % 2 == 0, got N={N} K={K} "
                         f"group={group}")
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0:
        return out
    ba = ba or w4a8_tile(M, N, cuda_lib.sm_count(dev))
    status = _w4a8_fn()(
        a_q.data_ptr(), a_scale.data_ptr(), w_qp.data_ptr(),
        w_gscale.data_ptr() + layer * G * N * w_gscale.element_size(),
        out.data_ptr(), M, N, K, L, layer, group, ba, int(out_dtype == torch.bfloat16),
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(status, counter)
    cuda_lib.LAUNCHES[counter] += 1
    return out


def w4a8_matmul_cached(
    layer: int,
    a_q: torch.Tensor,           # [M, K] s8 activations (quantize_rows)
    a_scale: torch.Tensor,       # [M, 1] f32
    w_qp_all: torch.Tensor,      # [L, N, K/2] s8 planar-packed int4
    w_gscale_all: torch.Tensor,  # [L, G, N] bf16 group scales
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``a @ unpack(w_qp_all[layer])^T`` with group and row scales, read
    straight out of the stacked packed weight."""
    layer = int(layer)
    if not a_q.is_cuda:
        return w4a8_cached_plain(layer, a_q, a_scale, w_qp_all, w_gscale_all, out_dtype)
    return _launch_w4a8("w4a8_matmul_cached", a_q, a_scale, w_qp_all, w_gscale_all,
                        layer, out_dtype)


def w4a8_matmul(a_q, a_scale, w_qp, w_gscale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """2-D entry of K6: one ``[N, K/2]`` packed weight with group scales
    ``[G, N]``, the same kernel at L = 1."""
    if not a_q.is_cuda:
        return w4a8_reference(a_q, a_scale, w_qp, w_gscale, out_dtype)
    if w_qp.ndim != 2:
        raise ValueError(f"w4a8 kernel: 2-D entry got a weight of shape {tuple(w_qp.shape)}")
    return _launch_w4a8("w4a8_matmul", a_q, a_scale, w_qp[None], w_gscale[None], 0,
                        out_dtype)
