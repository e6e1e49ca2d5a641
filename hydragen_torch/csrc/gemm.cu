// W8A8 GEMM for Hopper: y[M,N] = i32(a_s8[M,K] . w_s8[N,K]^T) * row_scale[M] * col_scale[N].
//
// Replaces the TPU kernel hydragen_tpu/ops/gemm.py:_w8a8_cached_kernel
// (entry w8a8_matmul_cached). The weight is one layer of the stacked
// [L, N, K] buffer: the wrapper passes the layer's base pointer, so no slice
// is ever copied.
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

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // padded smem row, bytes
constexpr int THREADS = 128;  // 4 warps: 2 along M x 2 along N, 32x64 each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

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
      cp_async16(&As[stage][row][col], src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < (BN * BK / 16) / THREADS; ++i) {
      int c = tid + i * THREADS;
      int row = c >> 2, col = (c & 3) * 16;
      int gn = n0 + row, gk = k0 + col;
      bool ok = gn < N && gk < K;
      const int8_t* src = ok ? w + (size_t)gn * K + gk : w;
      cp_async16(&Bs[stage][row][col], src, ok ? 16 : 0);
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
    cp_async_wait1();
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
