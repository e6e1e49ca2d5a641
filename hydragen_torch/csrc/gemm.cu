// W8A8 and W4A8 GEMMs for Hopper.
//
// w8a8_kernel: y[M,N] = i32(a_s8[M,K] . w_s8[N,K]^T) * row_scale[M] * col_scale[N].
// Replaces the TPU kernels hydragen_tpu/ops/gemm.py:_w8a8_cached_kernel
// (entry w8a8_matmul_cached) and _w8a8_kernel (entry w8a8_matmul). The
// weight is one layer of the stacked [L, N, K] buffer: the wrapper passes
// the layer's base pointer, so no slice is ever copied; a 2-D weight is the
// same call at layer stride 0.
//
// What bounds it on the H100: at decode (M = 256) each weight byte is used
// 256 times, i.e. 512 int8 operations per byte, just under the card's ~590
// op/byte ridge (1,979 TOP/s over 3.35 TB/s): reading the weight bounds it,
// with the int8 tensor-core rate close behind. At prefill (M = 2,048) the
// tensor-core rate bounds it by a wide margin.
// Design: tensor cores through mma.sync m16n8k32 s8 with i32 accumulators in
// registers; a 64x128 block tile in shared memory, K in steps of 64 bytes,
// two stages filled by cp.async so the next tile loads while this one is
// multiplied. Rows padded by 16 bytes make the fragment reads free of bank
// conflicts. Ragged M, N and K tails are zero-filled by cp.async's source
// size and masked at the store. The row x column dequant epilogue is fused
// into the store. wgmma, TMA and deeper pipelines are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // padded smem row, bytes
constexpr int THREADS = 128;  // 4 warps: 2 along M x 2 along N, 32x64 each

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(float* out, float x, float y) {
  *reinterpret_cast<float2*>(out) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store1(float* out, float x) { *out = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* out, float x) { *out = __float2bfloat16_rn(x); }

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(const int8_t* __restrict__ a, const float* __restrict__ row_scale,
            const int8_t* __restrict__ w, const __nv_bfloat16* __restrict__ col_scale,
            OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;

  auto load_tile = [&](int stage, int k0) {
    // A: BM rows x 64 bytes = 4 chunks of 16 bytes a row.
#pragma unroll
    for (int i = 0; i < (BM * BK / 16) / THREADS; ++i) {
      int c = tid + i * THREADS;
      int row = c >> 2, col = (c & 3) * 16;
      int gm = m0 + row, gk = k0 + col;
      bool ok = gm < M && gk < K;
      const int8_t* src = ok ? a + (size_t)gm * K + gk : a;
      cp_async16(smem_u32(&As[stage][row][col]), src, ok);
    }
#pragma unroll
    for (int i = 0; i < (BN * BK / 16) / THREADS; ++i) {
      int c = tid + i * THREADS;
      int row = c >> 2, col = (c & 3) * 16;
      int gn = n0 + row, gk = k0 + col;
      bool ok = gn < N && gk < K;
      const int8_t* src = ok ? w + (size_t)gn * K + gk : w;
      cp_async16(smem_u32(&Bs[stage][row][col]), src, ok);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int ktiles = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < ktiles) load_tile(s ^ 1, (kt + 1) * BK);
    cp_async_commit();  // possibly empty group keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[2][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(&As[s][r][kk + t * 4]);
        af[mi][1] = *reinterpret_cast<const unsigned*>(&As[s][r + 8][kk + t * 4]);
        af[mi][2] = *reinterpret_cast<const unsigned*>(&As[s][r][kk + 16 + t * 4]);
        af[mi][3] = *reinterpret_cast<const unsigned*>(&As[s][r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int r = wn + ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(&Bs[s][r][kk + t * 4]);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(&Bs[s][r][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Epilogue: (float(acc) * row_scale) * col_scale, the TPU kernel's order.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float rs = row_scale[row];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn + ni * 8 + t * 2;
        if (col >= N) continue;
        const float x = (float)acc[mi][ni][half * 2] * rs * __bfloat162float(col_scale[col]);
        OutT* dst = out + (size_t)row * N + col;
        if (col + 1 < N) {
          const float y =
              (float)acc[mi][ni][half * 2 + 1] * rs * __bfloat162float(col_scale[col + 1]);
          store2(dst, x, y);
        } else {
          store1(dst, x);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// w4a8_kernel: y[M,N] = row_scale[M] * sum_g gscale[g,N] * i32(a_s8[M, K_g] .
// w4[N, K_g]^T), the int4 weight planar-packed [N, K/2] (byte j: in-feature j
// in the low nibble, j + K/2 in the high one) with bf16 group scales [G, N].
// Replaces the TPU kernels hydragen_tpu/ops/gemm.py:_w4a8_cached_kernel
// (entry w4a8_matmul_cached) and _w4a8_kernel (entry w4a8_matmul).
//
// What bounds it on the H100: at decode (M = 256) each packed weight byte is
// two int4 weights used 256 times each, 1,024 int8 operations a byte, above
// the card's ~590 op/byte ridge: the int8 tensor-core rate bounds it, with
// the weight read (half of w8a8's) close behind. At prefill the tensor cores
// bound it by far.
// Design: K1's structure (mma.sync s8 m16n8k32, a 64x128 block tile, a
// two-stage cp.async ring) over the PACKED K: each step loads 64 packed
// bytes of 128 weight rows, and the two matching 64-byte column tiles of the
// activations, at column k and at column K/2 + k. The weight fragments are
// unpacked in registers as they are read from shared memory: four packed
// bytes in one 32-bit word give four sign-extended low nibbles and four high
// ones (mask, then (u ^ 8) - 8 per byte), so both planes come from one load.
// The low plane's products go to one i32 accumulator and the high plane's to
// another; at the end of each scale group (a whole number of 64-byte steps,
// inside one plane) each is multiplied by its group's scale into the f32
// accumulator and cleared, and the row scale is applied at the store: the
// TPU kernel's order (i32 group sum x group scale, summed in f32, x row
// scale). 8 warps of 32x32 keep the three accumulators in registers.

namespace w4 {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BKP = 64;        // packed bytes (= in-features of one plane) per step
constexpr int LDS = BKP + 16;  // padded smem row, bytes
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N, 32x32 each

// Four packed bytes -> four sign-extended int4 values as s8, per plane.
__device__ __forceinline__ unsigned nibbles_lo(unsigned x) {
  return __vsub4((x & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ unsigned nibbles_hi(unsigned x) {
  return __vsub4(((x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

}  // namespace w4

template <typename OutT>
__global__ void __launch_bounds__(w4::THREADS)
w4a8_kernel(const int8_t* __restrict__ a, const float* __restrict__ row_scale,
            const int8_t* __restrict__ w, const __nv_bfloat16* __restrict__ gscale,
            OutT* __restrict__ out, int M, int N, int K, int group) {
  constexpr int BM = w4::BM, BN = w4::BN, BKP = w4::BKP, LDS = w4::LDS;
  constexpr int THREADS = w4::THREADS;
  __shared__ __align__(16) int8_t As[2][2][BM][LDS];  // [stage][plane]
  __shared__ __align__(16) int8_t Ws[2][BN][LDS];

  const int Kp = K / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 32;
  const int wn = (warp & 3) * 32;

  auto load_tile = [&](int stage, int kp0) {
    // Activations: 2 planes x BM rows x 4 chunks of 16 bytes.
#pragma unroll
    for (int i = 0; i < (2 * BM * BKP / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int plane = c / (BM * BKP / 16);
      const int cc = c % (BM * BKP / 16);
      const int row = cc >> 2, col = (cc & 3) * 16;
      const int gm = m0 + row;
      const bool ok = gm < M;
      const int8_t* src = ok ? a + (size_t)gm * K + plane * Kp + kp0 + col : a;
      cp_async16(smem_u32(&As[stage][plane][row][col]), src, ok);
    }
    // Packed weights: BN rows x 4 chunks.
#pragma unroll
    for (int i = 0; i < (BN * BKP / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, col = (c & 3) * 16;
      const int gn = n0 + row;
      const bool ok = gn < N;
      const int8_t* src = ok ? w + (size_t)gn * Kp + kp0 + col : w;
      cp_async16(smem_u32(&Ws[stage][row][col]), src, ok);
    }
  };

  int acc[2][2][4][4];  // [plane][mi][ni][r]: this group's i32 sums
  float accf[2][4][4];  // scaled sums of the groups done
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[0][mi][ni][r] = acc[1][mi][ni][r] = 0;
        accf[mi][ni][r] = 0.f;
      }

  const int ktiles = Kp / BKP;
  const int tiles_per_group = group / BKP;
  const int half_groups = Kp / group;  // groups in one plane
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < ktiles) load_tile(s ^ 1, (kt + 1) * BKP);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKP; kk += 32) {
      unsigned af[2][2][4], bl[4][2], bh[4][2];
#pragma unroll
      for (int plane = 0; plane < 2; ++plane)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm + mi * 16 + g;
          af[plane][mi][0] = *reinterpret_cast<const unsigned*>(&As[s][plane][r][kk + t * 4]);
          af[plane][mi][1] = *reinterpret_cast<const unsigned*>(&As[s][plane][r + 8][kk + t * 4]);
          af[plane][mi][2] = *reinterpret_cast<const unsigned*>(&As[s][plane][r][kk + 16 + t * 4]);
          af[plane][mi][3] =
              *reinterpret_cast<const unsigned*>(&As[s][plane][r + 8][kk + 16 + t * 4]);
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wn + ni * 8 + g;
        const unsigned x0 = *reinterpret_cast<const unsigned*>(&Ws[s][r][kk + t * 4]);
        const unsigned x1 = *reinterpret_cast<const unsigned*>(&Ws[s][r][kk + 16 + t * 4]);
        bl[ni][0] = w4::nibbles_lo(x0);
        bl[ni][1] = w4::nibbles_lo(x1);
        bh[ni][0] = w4::nibbles_hi(x0);
        bh[ni][1] = w4::nibbles_hi(x1);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_s8(acc[0][mi][ni], af[0][mi], bl[ni]);
          mma_s8(acc[1][mi][ni], af[1][mi], bh[ni]);
        }
    }
    __syncthreads();
    if ((kt + 1) % tiles_per_group == 0) {
      // End of group gi of each plane: low plane group gi, high plane group
      // gi + G/2 of the [G, N] scales.
      const int gi = kt / tiles_per_group;
      const __nv_bfloat16* gs_lo = gscale + (size_t)gi * N;
      const __nv_bfloat16* gs_hi = gscale + (size_t)(gi + half_groups) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + t * 2;
        float slo[2], shi[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = col + c < N;
          slo[c] = ok ? __bfloat162float(gs_lo[col + c]) : 0.f;
          shi[c] = ok ? __bfloat162float(gs_hi[col + c]) : 0.f;
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            accf[mi][ni][r] += (float)acc[0][mi][ni][r] * slo[r & 1];
            accf[mi][ni][r] += (float)acc[1][mi][ni][r] * shi[r & 1];
            acc[0][mi][ni][r] = acc[1][mi][ni][r] = 0;
          }
      }
    }
  }

  // Epilogue: acc * row_scale, the TPU kernel's emit.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float rs = row_scale[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + t * 2;
        if (col >= N) continue;
        const float x = accf[mi][ni][half * 2] * rs;
        OutT* dst = out + (size_t)row * N + col;
        if (col + 1 < N) {
          store2(dst, x, accf[mi][ni][half * 2 + 1] * rs);
        } else {
          store1(dst, x);
        }
      }
    }
  }
}

}  // namespace

extern "C" int hydragen_w8a8_gemm(const void* a, const void* row_scale, const void* w,
                                  const void* col_scale, void* out, int M, int N, int K,
                                  int out_bf16, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    w8a8_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(a), static_cast<const float*>(row_scale),
        static_cast<const int8_t*>(w), static_cast<const __nv_bfloat16*>(col_scale),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    w8a8_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(a), static_cast<const float*>(row_scale),
        static_cast<const int8_t*>(w), static_cast<const __nv_bfloat16*>(col_scale),
        static_cast<float*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hydragen_w4a8_gemm(const void* a, const void* row_scale, const void* w,
                                  const void* gscale, void* out, int M, int N, int K,
                                  int group, int out_bf16, void* stream) {
  if (K % 2 || group % w4::BKP || (K / 2) % group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((N + w4::BN - 1) / w4::BN, (M + w4::BM - 1) / w4::BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    w4a8_kernel<__nv_bfloat16><<<grid, w4::THREADS, 0, st>>>(
        static_cast<const int8_t*>(a), static_cast<const float*>(row_scale),
        static_cast<const int8_t*>(w), static_cast<const __nv_bfloat16*>(gscale),
        static_cast<__nv_bfloat16*>(out), M, N, K, group);
  } else {
    w4a8_kernel<float><<<grid, w4::THREADS, 0, st>>>(
        static_cast<const int8_t*>(a), static_cast<const float*>(row_scale),
        static_cast<const int8_t*>(w), static_cast<const __nv_bfloat16*>(gscale),
        static_cast<float*>(out), M, N, K, group);
  }
  return static_cast<int>(cudaGetLastError());
}
