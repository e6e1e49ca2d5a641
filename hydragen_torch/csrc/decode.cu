// One-token decode attention over one layer of the int8 BSHD unique cache,
// with the step's own token and the shared-prefix partial merged in.
//
// Replaces the TPU kernel hydragen_tpu/ops/decode.py:_decode_cached_kernel
// (entry decode_attention_cached) at kv_bits = 8.
//
// Function, per row b and query head h (kv head h // group):
//   scores over the row's first lens[b] cached tokens, s_j = (q * scale) . k_j
//   * k_scale[j * hkv + kvh] (flat lane-major scales, decode.py:42-47), plus
//   one more column for the own token (k1, v1); softmax in fp32; values
//   v_j * v_scale; then an exact LSE merge with (o_sh, lse_sh). The TPU
//   kernel's s8 re-quantization of q and p is not copied: both products run
//   in fp32 on the dequantized int8, the exact path.
//
// What bounds it on the H100: every cached byte is read once and used for
// `group` multiply-adds (1 for Llama-2-7B): memory bound, ~2 FLOP a byte
// against a ~20 FLOP/byte fp32 ridge.
// Design: one block of 4 warps per (row, kv head). Each warp walks every 4th
// token; a lane holds D/32 consecutive head_dim elements, so one token's K
// (and V) row is one coalesced 128-byte read per warp. Scores are reduced by
// warp shuffles and each warp keeps its own online softmax; the 4 states,
// the own-token column and the shared partial are merged in shared memory at
// the end, one thread per head_dim element. Rows past lens are never read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;  // query heads per kv head this build takes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;  // [b, hq, D]
  const int8_t* k;         // layer base of [B, S, hkv, D]
  const int8_t* v;
  const float* k_scale;    // layer base of [B, S * hkv]
  const float* v_scale;
  const int* lens;         // [b]
  const __nv_bfloat16* k1;  // [b, hkv, D] or null
  const __nv_bfloat16* v1;
  const __nv_bfloat16* o_sh;  // [b, hq, D] or null
  const float* lse_sh;        // [b, hq]
  __nv_bfloat16* out;         // [b, hq, D]
  float* lse;                 // [b, hq]
  int S;
  int hkv;
  int group;
  float scale;
};

template <int EPL>
__device__ __forceinline__ void load_i8(const int8_t* src, float* dst) {
  if (EPL == 4) {
    const char4 c = *reinterpret_cast<const char4*>(src);
    dst[0] = c.x; dst[1] = c.y; dst[2] = c.z; dst[3] = c.w;
  } else {
    const char2 c = *reinterpret_cast<const char2*>(src);
    dst[0] = c.x; dst[1] = c.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(const Params p) {
  constexpr int EPL = D / 32;  // head_dim elements a lane
  __shared__ float m_s[WARPS][GMAX];
  __shared__ float l_s[WARPS][GMAX];
  __shared__ float acc_s[WARPS][GMAX][D];
  __shared__ float own_s[GMAX];

  const int kvh = blockIdx.x;
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hq = p.hkv * p.group;
  const int limit = min(max(p.lens[row], 0), p.S);
  const float qscale = p.scale * LOG2E;  // exp2 space; lse is converted back

  float qf[GMAX][EPL];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < p.group) {
      const __nv_bfloat16* qrow = p.q + ((size_t)row * hq + kvh * p.group + gi) * D;
#pragma unroll
      for (int i = 0; i < EPL; ++i) qf[gi][i] = __bfloat162float(qrow[lane * EPL + i]) * qscale;
    }
  }

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[gi][i] = 0.f;
  }

  const size_t tok_stride = (size_t)p.hkv * D;
  const int8_t* kb = p.k + (size_t)row * p.S * tok_stride + (size_t)kvh * D + lane * EPL;
  const int8_t* vb = p.v + (size_t)row * p.S * tok_stride + (size_t)kvh * D + lane * EPL;
  const float* ksb = p.k_scale + (size_t)row * p.S * p.hkv + kvh;
  const float* vsb = p.v_scale + (size_t)row * p.S * p.hkv + kvh;

  for (int j = warp; j < limit; j += WARPS) {
    float kf[EPL], vf[EPL];
    load_i8<EPL>(kb + (size_t)j * tok_stride, kf);
    load_i8<EPL>(vb + (size_t)j * tok_stride, vf);
    const float ks = ksb[(size_t)j * p.hkv];
    const float vs = vsb[(size_t)j * p.hkv];
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi >= p.group) break;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) d += qf[gi][i] * kf[i];
      const float s = warp_sum(d) * ks;
      const float m_new = fmaxf(m[gi], s);
      const float alpha = exp2f(m[gi] - m_new);
      const float pj = exp2f(s - m_new);
      l[gi] = l[gi] * alpha + pj;
      const float pv = pj * vs;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[gi][i] = acc[gi][i] * alpha + pv * vf[i];
      m[gi] = m_new;
    }
  }

#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi >= p.group) break;
    if (lane == 0) {
      m_s[warp][gi] = m[gi];
      l_s[warp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc_s[warp][gi][lane * EPL + i] = acc[gi][i];
  }
  // Own-token score (exp2 space), one warp.
  if (warp == 0 && p.k1 != nullptr) {
    const __nv_bfloat16* k1 = p.k1 + ((size_t)row * p.hkv + kvh) * D;
    for (int gi = 0; gi < p.group; ++gi) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) d += qf[gi][i] * __bfloat162float(k1[lane * EPL + i]);
      d = warp_sum(d);
      if (lane == 0) own_s[gi] = d;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < p.group * D; e += THREADS) {
    const int gi = e / D, dd = e % D;
    const int h = kvh * p.group + gi;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_s[w][gi]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = exp2f(m_s[w][gi] - M);
        L += l_s[w][gi] * c;
        A += acc_s[w][gi][dd] * c;
      }
    }
    if (p.k1 != nullptr) {
      const float s_own = own_s[gi];
      const float M2 = fmaxf(M, s_own);
      const float alpha = exp2f(M - M2);
      const float po = exp2f(s_own - M2);
      L = L * alpha + po;
      A = A * alpha + po * __bfloat162float(p.v1[((size_t)row * p.hkv + kvh) * D + dd]);
      M = M2;
    }
    float o = L > 0.f ? A / L : 0.f;
    float lse = L > 0.f ? M * LN2 + logf(L) : -INFINITY;
    if (p.o_sh != nullptr) {
      const float lsh = p.lse_sh[(size_t)row * hq + h];
      const float mm = fmaxf(lse, lsh);
      if (mm == -INFINITY) {
        o = 0.f;
        lse = -INFINITY;
      } else {
        const float e1 = expf(lse - mm);
        const float e2 = expf(lsh - mm);
        const float den = e1 + e2;
        const float osh = __bfloat162float(p.o_sh[((size_t)row * hq + h) * D + dd]);
        o = (e1 * o + e2 * osh) / den;
        lse = mm + logf(den);
      }
    }
    p.out[((size_t)row * hq + h) * D + dd] = __float2bfloat16_rn(o);
    if (dd == 0) p.lse[(size_t)row * hq + h] = lse;
  }
}

}  // namespace

extern "C" int hydragen_decode_attention(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* lens, const void* k1, const void* v1,
                                         const void* o_sh, const void* lse_sh, void* out,
                                         void* lse, int b, int S, int hkv, int group, int D,
                                         float scale, void* stream) {
  if (group < 1 || group > GMAX) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lens = static_cast<const int*>(lens);
  p.k1 = static_cast<const __nv_bfloat16*>(k1);
  p.v1 = static_cast<const __nv_bfloat16*>(v1);
  p.o_sh = static_cast<const __nv_bfloat16*>(o_sh);
  p.lse_sh = static_cast<const float*>(lse_sh);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.S = S;
  p.hkv = hkv;
  p.group = group;
  p.scale = scale;
  dim3 grid(hkv, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    decode_kernel<128><<<grid, THREADS, 0, st>>>(p);
  } else if (D == 64) {
    decode_kernel<64><<<grid, THREADS, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
