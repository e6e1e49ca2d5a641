// One-token decode attention over one layer of the int8 or int4 BSHD unique
// cache, with the step's own token and the shared-prefix partial merged in;
// and the in-place int4 decode write of one layer.
//
// decode_kernel replaces the TPU kernel
// hydragen_tpu/ops/decode.py:_decode_cached_kernel (entry
// decode_attention_cached) at kv_bits = 8 and kv_bits = 4.
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
// int4 (BITS = 4): the cache is token-planar, S byte rows where byte row j
// holds token j in its low nibble and token j + S in its high nibble, and the
// flat scales run over the 2S logical tokens (the high plane's start at
// S * hkv). A warp reads byte row j once, unpacks both nibbles with 32-bit
// shifts, and folds token j, then token j + S where j + S < len, into its
// online softmax: rows [0, min(len, S)) are read, half the bytes of int8.
//
// write_int4_kernel replaces hydragen_tpu/ops/decode.py:gather_token_row_cached
// (the byte-row read of the int4 decode write) together with the write it
// serves (hydragen_tpu/core/cache.py write_decode_token_layer at
// unique_bits = 4): the TPU reads the row through a kernel only to pin its
// layout, so here one launch does the whole write of one layer's token, K
// and V. Per (row, kv head), one warp each for K and V: amax over head_dim
// by shuffles, scale = max(amax, 1e-8) / 7, q = clamp(rint(x / scale), -7,
// 7) (IEEE division and round-half-even, as quantize_kv4), then the nibble
// merge into byte row slot % S: at slot >= S the low nibble (the live token
// slot - S) is kept and the high one written; below S the low nibble is
// written and the stale high one cleared. The f32 scale goes to the flat
// scales at slot * hkv + head. Bytes bound: it moves one token's K and V.

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
  const int8_t* k;         // layer base of [B, S, hkv, D] (S byte rows)
  const int8_t* v;
  const float* k_scale;    // layer base of [B, S * hkv] (int4: [B, 2S * hkv])
  const float* v_scale;
  const int* lens;         // [b] logical lengths
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

// EPL packed bytes -> the sign-extended low and high nibbles, with the shifts
// in 32 bits.
template <int EPL>
__device__ __forceinline__ void load_i4(const int8_t* src, float* lo, float* hi) {
  int x[EPL];
  if (EPL == 4) {
    const char4 c = *reinterpret_cast<const char4*>(src);
    x[0] = c.x; x[1] = c.y; x[2] = c.z; x[3] = c.w;
  } else {
    const char2 c = *reinterpret_cast<const char2*>(src);
    x[0] = c.x; x[1] = c.y;
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    lo[i] = static_cast<float>(static_cast<int>(static_cast<unsigned>(x[i]) << 28) >> 28);
    hi[i] = static_cast<float>(x[i] >> 4);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  return x;
}

// One token folded into a warp's online softmax (exp2 space): score
// (q . k) * ks, values v * vs.
template <int EPL>
__device__ __forceinline__ void online_step(int group, const float (&qf)[GMAX][EPL],
                                            const float* kf, const float* vf, float ks,
                                            float vs, float (&m)[GMAX], float (&l)[GMAX],
                                            float (&acc)[GMAX][EPL]) {
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi >= group) break;
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

template <int D, int BITS>
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
  constexpr int PLANES = BITS == 4 ? 2 : 1;
  const int len = min(max(p.lens[row], 0), PLANES * p.S);  // logical tokens
  const int limit = min(len, p.S);                          // byte rows read
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
  const float* ksb = p.k_scale + (size_t)row * PLANES * p.S * p.hkv + kvh;
  const float* vsb = p.v_scale + (size_t)row * PLANES * p.S * p.hkv + kvh;

  for (int j = warp; j < limit; j += WARPS) {
    if (BITS == 8) {
      float kf[EPL], vf[EPL];
      load_i8<EPL>(kb + (size_t)j * tok_stride, kf);
      load_i8<EPL>(vb + (size_t)j * tok_stride, vf);
      online_step<EPL>(p.group, qf, kf, vf, ksb[(size_t)j * p.hkv], vsb[(size_t)j * p.hkv],
                       m, l, acc);
    } else {
      float klo[EPL], khi[EPL], vlo[EPL], vhi[EPL];
      load_i4<EPL>(kb + (size_t)j * tok_stride, klo, khi);
      load_i4<EPL>(vb + (size_t)j * tok_stride, vlo, vhi);
      online_step<EPL>(p.group, qf, klo, vlo, ksb[(size_t)j * p.hkv], vsb[(size_t)j * p.hkv],
                       m, l, acc);
      const int jh = j + p.S;  // the high plane's token: warp-uniform test
      if (jh < len) {
        online_step<EPL>(p.group, qf, khi, vhi, ksb[(size_t)jh * p.hkv],
                         vsb[(size_t)jh * p.hkv], m, l, acc);
      }
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

template <int D>
__global__ void __launch_bounds__(64)
write_int4_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                  int8_t* __restrict__ ck, int8_t* __restrict__ cv, float* __restrict__ cks,
                  float* __restrict__ cvs, int S, int hkv, int slot) {
  constexpr int EPL = D / 32;
  const int kvh = blockIdx.x;
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const bool is_v = threadIdx.x >= 32;
  const __nv_bfloat16* src = (is_v ? v : k) + ((size_t)row * hkv + kvh) * D + lane * EPL;
  int8_t* dst = (is_v ? cv : ck) + (((size_t)row * S + slot % S) * hkv + kvh) * D + lane * EPL;
  float* sc = (is_v ? cvs : cks) + (size_t)row * 2 * S * hkv + (size_t)slot * hkv + kvh;

  float x[EPL];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    x[i] = __bfloat162float(src[i]);
    amax = fmaxf(amax, fabsf(x[i]));
  }
  const float scale = fmaxf(warp_max(amax), 1e-8f) / 7.0f;
  const bool hi = slot >= S;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int q = static_cast<int>(fminf(fmaxf(rintf(x[i] / scale), -7.f), 7.f));
    const int old = dst[i];
    const unsigned nv = hi ? ((old & 0xF) | (static_cast<unsigned>(q) << 4)) : (q & 0xF);
    dst[i] = static_cast<int8_t>(nv & 0xFF);
  }
  if (lane == 0) *sc = scale;
}

}  // namespace

extern "C" int hydragen_decode_attention(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* lens, const void* k1, const void* v1,
                                         const void* o_sh, const void* lse_sh, void* out,
                                         void* lse, int b, int S, int hkv, int group, int D,
                                         int bits, float scale, void* stream) {
  if (group < 1 || group > GMAX || (bits != 8 && bits != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (D == 128 && bits == 8) {
    decode_kernel<128, 8><<<grid, THREADS, 0, st>>>(p);
  } else if (D == 64 && bits == 8) {
    decode_kernel<64, 8><<<grid, THREADS, 0, st>>>(p);
  } else if (D == 128) {
    decode_kernel<128, 4><<<grid, THREADS, 0, st>>>(p);
  } else if (D == 64) {
    decode_kernel<64, 4><<<grid, THREADS, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// k, v: [b, hkv, D] bf16, this step's token of one layer. ck, cv: the layer's
// base of the [B, S, hkv, D] int4 cache (S byte rows); cks, cvs: the layer's
// base of its [B, 2S * hkv] flat scales. Writes logical token `slot` of rows
// [0, b) in place.
extern "C" int hydragen_write_int4(const void* k, const void* v, void* ck, void* cv,
                                   void* cks, void* cvs, int b, int S, int hkv, int D,
                                   int slot, void* stream) {
  if (slot < 0 || slot >= 2 * S) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(hkv, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* ckk = static_cast<int8_t*>(ck);
  auto* cvv = static_cast<int8_t*>(cv);
  auto* cks_ = static_cast<float*>(cks);
  auto* cvs_ = static_cast<float*>(cvs);
  if (D == 128) {
    write_int4_kernel<128><<<grid, 64, 0, st>>>(kk, vv, ckk, cvv, cks_, cvs_, S, hkv, slot);
  } else if (D == 64) {
    write_int4_kernel<64><<<grid, 64, 0, st>>>(kk, vv, ckk, cvv, cks_, cvs_, S, hkv, slot);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
