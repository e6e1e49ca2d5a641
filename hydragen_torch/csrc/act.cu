// K8: the per-row s8 quantization of an activation (ops/gemm.py:quantize_rows)
// with the op that produces the activation fused in front of it: the RMS norm
// (its residual add folded in, where there is one) or the SiLU product of the
// MLP. It writes only what K1 and K6 read: s8 codes and one f32 scale a row.
//
// Replaces no Pallas kernel. On the TPU, XLA fuses these ops inside jit
// (hydragen_tpu/models/llama.py: rms_norm, the SiLU product and
// hydragen_tpu/ops/gemm.py:quantize_rows). Eagerly, in PyTorch, each is a
// chain of 7-9 elementwise and reduction kernels, several over f32 copies of
// [M, K] that only the next op reads (ops/act.py has those chains as the plain
// versions).
//
// Function, per row of K elements, by op:
//   kRows     y = x
//   kNorm     y = T((x * rsqrt(sum(x * x) * inv_k + eps)) * w)
//   kNormAdd  h = T(x + d), written out (the next residual); y as kNorm on h
//   kSiluMul  y = T(T(g / (1 + exp(-g))) * u)
// where T() rounds to the activation type (bf16, or f32 for an f32 model) as
// PyTorch's .to() does, and then
//   scale = max(amax(|y|), 1e-20) * recip_127,  q = rint(y / scale)
// The arithmetic is the plain chains' own, step for step: IEEE division,
// rsqrtf and expf without fast-math (PyTorch's rsqrt and silu call them),
// products and sums rounded separately (__fmul_rn, __fadd_rn: no FMA
// contraction), round-half-even. A max does not depend on the order of
// reduction, so kRows and kSiluMul give the plain versions' codes bit for
// bit; kNorm's sum of squares is taken in another order than torch.mean's,
// and may round to a neighbouring float.
//
// What bounds it on the H100: bytes. Each element is read once and meets a
// few operations. One block a row: a thread holds NU units of 16 elements in
// registers, loaded with 16-byte loads (all of a thread's loads are issued
// before any arithmetic), reduces them there (the sum of squares, then the
// amax) with warp shuffles and one step through shared memory, and writes a
// unit's 16 codes with one 16-byte store. ops/act.py:act_plan picks the
// threads and NU for K (kernel_times.py --k8-plans times every block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnit = 16;       // elements a thread takes at a time: one 16-byte store of codes
constexpr int kMaxThreads = 1024;

// The most threads a block of NU units a thread runs: registers for 16 NU
// elements (and a second input's) fit under the bound without spilling.
__host__ __device__ constexpr int max_threads(int nu) { return nu == 1 ? 1024 : nu == 2 ? 512 : 256; }
constexpr float kAmaxFloor = 1e-20f;  // quantize_rows's clamp

enum Op { kRows = 0, kNorm = 1, kNormAdd = 2, kSiluMul = 3 };

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// v rounded to T and read back as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// kUnit elements of T in registers.
template <typename T>
struct Unit {
  static constexpr int kVecs = kUnit * sizeof(T) / 16;
  alignas(16) T e[kUnit];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) reinterpret_cast<uint4*>(e)[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      reinterpret_cast<uint4*>(e)[i] = reinterpret_cast<const uint4*>(p)[i];
    }
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(e)[i];
    }
  }
  __device__ __forceinline__ float get(int i) const { return to_float(e[i]); }
  __device__ __forceinline__ void set(int i, float v) { e[i] = from_float<T>(v); }
};

// The block's sum (kMax false) or max of v, returned to every thread. `red`
// holds one slot a warp and serves one reduction.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  const int warps = blockDim.x >> 5;
  for (int i = 1; i < warps; ++i) v = kMax ? fmaxf(v, red[i]) : __fadd_rn(v, red[i]);
  return v;
}

template <int kOp, typename T, int kNU>
__global__ void __launch_bounds__(kNU == 1 ? 1024 : kNU == 2 ? 512 : 256)  // max_threads(kNU)
    act_quant_kernel(
    const T* __restrict__ x,       // [M, K]: the activation; the residual (kNormAdd); g (kSiluMul)
    const T* __restrict__ x2,      // [M, K]: the residual's delta (kNormAdd); u (kSiluMul)
    const T* __restrict__ weight,  // [K]: the norm's weight (kNorm, kNormAdd)
    T* __restrict__ h_out,         // [M, K]: x + delta (kNormAdd)
    int8_t* __restrict__ q,        // [M, K] codes
    float* __restrict__ scale,     // [M] row scales
    int K, float eps, float inv_k, float recip_127) {
  constexpr bool kTwo = kOp == kNormAdd || kOp == kSiluMul;
  constexpr bool kIsNorm = kOp == kNorm || kOp == kNormAdd;
  __shared__ float red[2][kMaxThreads / 32];
  const int units = K / kUnit;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * K;

  // Every load of the thread in flight before any arithmetic. Units past the
  // row's end stay 0: they add nothing to either reduction.
  Unit<T> y[kNU], b[kTwo ? kNU : 1], w[kIsNorm ? kNU : 1];
#pragma unroll
  for (int i = 0; i < kNU; ++i) {
    const int u = threadIdx.x + i * blockDim.x;
    y[i].zero();
    if constexpr (kTwo) b[i].zero();
    if constexpr (kIsNorm) w[i].zero();
    if (u >= units) continue;
    y[i].load(x + row + u * kUnit);
    if constexpr (kTwo) b[i].load(x2 + row + u * kUnit);
    if constexpr (kIsNorm) w[i].load(weight + u * kUnit);
  }

  float sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < kNU; ++i) {
    const int u = threadIdx.x + i * blockDim.x;
    if (u >= units) continue;
#pragma unroll
    for (int e = 0; e < kUnit; ++e) {
      if constexpr (kOp == kNormAdd) y[i].set(e, __fadd_rn(y[i].get(e), b[i].get(e)));
      if constexpr (kOp == kSiluMul) {
        const float g = y[i].get(e);
        const float s = round_to<T>(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))));
        y[i].set(e, __fmul_rn(s, b[i].get(e)));
      }
      if constexpr (kIsNorm) sumsq = __fadd_rn(sumsq, __fmul_rn(y[i].get(e), y[i].get(e)));
    }
    if constexpr (kOp == kNormAdd) y[i].store(h_out + row + u * kUnit);
  }

  if constexpr (kIsNorm) {
    const float var = __fmul_rn(block_reduce<false>(sumsq, red[0]), inv_k);
    const float r = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
    for (int i = 0; i < kNU; ++i) {
#pragma unroll
      for (int e = 0; e < kUnit; ++e) {
        y[i].set(e, __fmul_rn(__fmul_rn(y[i].get(e), r), w[i].get(e)));
      }
    }
  }

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kNU; ++i) {
#pragma unroll
    for (int e = 0; e < kUnit; ++e) amax = fmaxf(amax, fabsf(y[i].get(e)));
  }
  amax = block_reduce<true>(amax, red[1]);
  const float s = __fmul_rn(fmaxf(amax, kAmaxFloor), recip_127);

#pragma unroll
  for (int i = 0; i < kNU; ++i) {
    const int u = threadIdx.x + i * blockDim.x;
    if (u >= units) continue;
    uint32_t c[kUnit / 4] = {};
#pragma unroll
    for (int e = 0; e < kUnit; ++e) {
      const int code = __float2int_rn(__fdiv_rn(y[i].get(e), s));
      c[e / 4] |= (static_cast<uint32_t>(code) & 0xffu) << (8 * (e % 4));
    }
    *reinterpret_cast<uint4*>(q + row + u * kUnit) = make_uint4(c[0], c[1], c[2], c[3]);
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

template <int kOp, typename T>
int launch(int nu, const void* x, const void* x2, const void* w, void* h, void* q, void* sc,
           int M, int K, float eps, float inv_k, float recip_127, int threads,
           cudaStream_t st) {
  const auto* xx = static_cast<const T*>(x);
  const auto* xx2 = static_cast<const T*>(x2);
  const auto* ww = static_cast<const T*>(w);
  auto* hh = static_cast<T*>(h);
  auto* qq = static_cast<int8_t*>(q);
  auto* ss = static_cast<float*>(sc);
#define HYDRAGEN_ACT_LAUNCH(NU)                                                          \
  act_quant_kernel<kOp, T, NU><<<M, threads, 0, st>>>(xx, xx2, ww, hh, qq, ss, K, eps, \
                                                       inv_k, recip_127)
  switch (nu) {
    case 1: HYDRAGEN_ACT_LAUNCH(1); break;
    case 2: HYDRAGEN_ACT_LAUNCH(2); break;
    case 4: HYDRAGEN_ACT_LAUNCH(4); break;
    case 8: HYDRAGEN_ACT_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HYDRAGEN_ACT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_op(int op, int nu, const void* x, const void* x2, const void* w, void* h, void* q,
              void* sc, int M, int K, float eps, float inv_k, float recip_127, int threads,
              cudaStream_t st) {
  switch (op) {
    case kRows:
      return launch<kRows, T>(nu, x, x2, w, h, q, sc, M, K, eps, inv_k, recip_127, threads, st);
    case kNorm:
      return launch<kNorm, T>(nu, x, x2, w, h, q, sc, M, K, eps, inv_k, recip_127, threads, st);
    case kNormAdd:
      return launch<kNormAdd, T>(nu, x, x2, w, h, q, sc, M, K, eps, inv_k, recip_127, threads,
                                 st);
    case kSiluMul:
      return launch<kSiluMul, T>(nu, x, x2, w, h, q, sc, M, K, eps, inv_k, recip_127, threads,
                                 st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// op: 0 rows, 1 norm, 2 norm with the residual add, 3 SiLU product; f32: the
// activation type is float (else bf16). threads a multiple of 32, at most
// max_threads(nu); K a multiple of 16 with K / 16 <= threads * nu.
extern "C" int hydragen_act_quant(int op, int f32, const void* x, const void* x2, const void* w,
                                  void* h, void* q, void* scale, int M, int K, float eps,
                                  float inv_k, float recip_127, int threads, int nu,
                                  void* stream) {
  if (M < 1 || K < kUnit || K % kUnit || threads < 32 || threads > max_threads(nu) ||
      threads % 32 || K / kUnit > threads * nu) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(x2) |
       reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(h) |
       reinterpret_cast<uintptr_t>(q)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch_op<float>(op, nu, x, x2, w, h, q, scale, M, K, eps, inv_k, recip_127,
                                threads, st)
             : launch_op<__nv_bfloat16>(op, nu, x, x2, w, h, q, scale, M, K, eps, inv_k,
                                        recip_127, threads, st);
}
