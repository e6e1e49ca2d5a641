// K9: a decoder layer's rotary embedding and its int8 KV write, in one pass
// over the q, k and v rows the projections wrote. It writes the rotated q and
// k (and, where the attention reads it contiguous, v) head-major, and k and v
// quantized per (token, head) straight into their destination in the cache:
// a shared level's buffers, the unique cache's prefill tokens, or the decode
// slot.
//
// Replaces no Pallas kernel. On the TPU, XLA fuses apply_rope, quantize_kv and
// the cache's dynamic_update_slice inside jit (hydragen_tpu/models/llama.py:
// apply_rope and the layer scan's writes; hydragen_tpu/ops/quant.py:
// quantize_kv). Eagerly, in PyTorch, RoPE is about ten kernels a tensor over
// f32 copies, the quantization about eight, and the writes a copy or four
// index_copy_ calls (ops/rope.py has that chain as the plain version).
//
// Function, per token j of row r and per head, over the head's hd elements
// (lo: the first half, hi: the second):
//   q', k':  lo' = bf16(lo cos_lo + (-hi) sin_lo),  hi' = bf16(hi cos_hi + lo sin_hi)
// with each product and the sum rounded to f32 apart (no FMA contraction),
// as apply_rope's eager ops round them, and bf16() rounding to nearest even;
// then for k' and v, if j lies in the window [w0, w0 + wn):
//   scale = max(amax(|x|), 1e-8) * recip_127,  code = clamp(rint(x / scale), +-127)
// with an IEEE division and round-half-even, as quantize_kv computes it. The
// codes and the scale go to destination token slot + j - w0, through the
// payload's and the scales' (row, head, token) strides, so one kernel writes
// BHSD levels, a BHSD or BSHD unique cache and flat scales. The slot comes by
// value or, in a captured decode step, from device memory; a destination
// token out of range writes nothing. The codes, scales and rotated values are
// the chain's bit for bit.
//
// What bounds it on the H100: bytes. Per token and layer it reads q, k, v and
// the token's cos/sin rows once and writes each output once. One block a
// token; a group of hd / 8 lanes takes a head at a time (4 elements of each
// half a lane, so a lane holds each rotation pair), loops over the token's q,
// k and v heads, and reduces the head's amax with shuffles inside its group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 256;
constexpr float kAmaxFloor = 1e-8f;  // quantize_kv's clamp

struct Params {
  const void* q;  // [b t, row stride]: the token's nh heads of hd
  const void* k;  // [b t, row stride]: nkv heads
  const void* v;
  const void* cos;  // [b t, hd]
  const void* sin;
  void* q_out;  // [b, nh, t, hd]
  void* k_out;  // [b, nkv, t, hd]
  void* v_out;  // [b, nkv, t, hd], or null: v is not copied
  int8_t* ck;   // payload of (row 0, head 0, token 0)
  int8_t* cv;
  float* cks;  // scales of (row 0, head 0, token 0)
  float* cvs;
  long long q_rs, k_rs, v_rs;        // input row strides (elements)
  long long p_row, p_head, p_tok;    // payload strides (bytes)
  long long s_row, s_head, s_tok;    // scale strides (elements)
  int t, nh, nkv, t_dst, w0, wn, slot;
  const int* slot_ptr;  // the slot in device memory, or null
  float recip_127;
};

// v rounded to bf16 and read back as a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4 consecutive bf16 elements: one 8-byte access.
struct Four {
  alignas(8) bf16 e[4];
};

__device__ __forceinline__ void load4(const bf16* p, float* out) {
  Four f = *reinterpret_cast<const Four*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(f.e[i]);
}

// x holds bf16 values: stored exactly.
__device__ __forceinline__ void store4(bf16* p, const float* x) {
  Four f;
#pragma unroll
  for (int i = 0; i < 4; ++i) f.e[i] = __float2bfloat16_rn(x[i]);
  *reinterpret_cast<Four*>(p) = f;
}

__device__ __forceinline__ uint32_t codes4(const float* x, float s) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int code = min(max(__float2int_rn(__fdiv_rn(x[i], s)), -127), 127);
    c |= (static_cast<uint32_t>(code) & 0xffu) << (8 * i);
  }
  return c;
}

template <int HD>
__global__ void __launch_bounds__(kMaxThreads) rope_kv_quant_kernel(const Params p) {
  constexpr int G = HD / 8;  // lanes a head
  const int tok = blockIdx.x;  // row * t + j
  const int row = tok / p.t, j = tok - row * p.t;
  const int lane = threadIdx.x % G, group = threadIdx.x / G, groups = blockDim.x / G;
  const int items = p.nh + 2 * p.nkv;
  const int e_lo = 4 * lane, e_hi = HD / 2 + 4 * lane;

  int dst = -1;  // the destination token of this one's KV, if it has one
  if (j >= p.w0 && j < p.w0 + p.wn) {
    dst = (p.slot_ptr != nullptr ? __ldg(p.slot_ptr) : p.slot) + j - p.w0;
    if (dst < 0 || dst >= p.t_dst) dst = -1;
  }

  float c_lo[4], c_hi[4], s_lo[4], s_hi[4];
  {
    const bf16* cs = static_cast<const bf16*>(p.cos) + static_cast<long long>(tok) * HD;
    const bf16* sn = static_cast<const bf16*>(p.sin) + static_cast<long long>(tok) * HD;
    load4(cs + e_lo, c_lo);
    load4(cs + e_hi, c_hi);
    load4(sn + e_lo, s_lo);
    load4(sn + e_hi, s_hi);
  }

  // The block's item loop is uniform, so every lane reaches each shuffle.
  for (int base = 0; base < items; base += groups) {
    const int it = base + group;
    const bool live = it < items;
    const int kind = it < p.nh ? 0 : it < p.nh + p.nkv ? 1 : 2;  // q, k, v
    const int head = kind == 0 ? it : kind == 1 ? it - p.nh : it - p.nh - p.nkv;
    const int heads = kind == 0 ? p.nh : p.nkv;
    float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const bf16* src = kind == 0 ? static_cast<const bf16*>(p.q) + tok * p.q_rs
                        : kind == 1 ? static_cast<const bf16*>(p.k) + tok * p.k_rs
                                    : static_cast<const bf16*>(p.v) + tok * p.v_rs;
      src += head * HD;
      load4(src + e_lo, lo);
      load4(src + e_hi, hi);
      if (kind != 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float l = lo[i], h = hi[i];
          lo[i] = round_bf16(__fadd_rn(__fmul_rn(l, c_lo[i]), __fmul_rn(-h, s_lo[i])));
          hi[i] = round_bf16(__fadd_rn(__fmul_rn(h, c_hi[i]), __fmul_rn(l, s_hi[i])));
        }
      }
      void* out = kind == 0 ? p.q_out : kind == 1 ? p.k_out : p.v_out;
      if (out != nullptr) {
        bf16* o = static_cast<bf16*>(out) +
               ((static_cast<long long>(row) * heads + head) * p.t + j) * HD;
        store4(o + e_lo, lo);
        store4(o + e_hi, hi);
      }
    }

    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) a = fmaxf(a, fmaxf(fabsf(lo[i]), fabsf(hi[i])));
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));

    if (live && kind != 0 && dst >= 0) {
      const float s = __fmul_rn(fmaxf(a, kAmaxFloor), p.recip_127);
      int8_t* c = (kind == 1 ? p.ck : p.cv) + row * p.p_row + head * p.p_head + dst * p.p_tok;
      *reinterpret_cast<uint32_t*>(c + e_lo) = codes4(lo, s);
      *reinterpret_cast<uint32_t*>(c + e_hi) = codes4(hi, s);
      if (lane == 0) {
        (kind == 1 ? p.cks : p.cvs)[row * p.s_row + head * p.s_head + dst * p.s_tok] = s;
      }
    }
  }
}

int launch(int hd, int blocks, int threads, const Params& p, cudaStream_t st) {
  if (hd == 128) {
    rope_kv_quant_kernel<128><<<blocks, threads, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v (bf16): rows of b * t tokens at row strides strides[0..2]
// (elements); cos, sin: [b * t, hd]; q_out, k_out, v_out (null: not
// written): [b, heads, t, hd]; ck, cv, cks,
// cvs: the destination's (row 0, head 0, token 0), reached through the
// payload strides strides[3..5] (bytes) and the scale strides strides[6..8]
// (elements) of (row, head, token). Input tokens [w0, w0 + wn) go to
// destination tokens from the slot on (slot_ptr: read in device memory),
// those out of [0, t_dst) nowhere. hd: 128; threads: a multiple of 32,
// at most 256.
extern "C" int hydragen_rope_kv_quant(const void* q, const void* k, const void* v,
                                      const void* cos, const void* sin, void* q_out,
                                      void* k_out, void* v_out, void* ck, void* cv, void* cks,
                                      void* cvs, const long long* strides, int b, int t,
                                      int nh, int nkv, int hd, int t_dst, int w0, int wn,
                                      int slot, const void* slot_ptr, float recip_127,
                                      int threads, void* stream) {
  if (b < 1 || t < 1 || nh < 1 || nkv < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || w0 < 0 || wn < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t vec = 7;  // the 8-byte accesses of 4 elements
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(cos) |
       reinterpret_cast<uintptr_t>(sin) | reinterpret_cast<uintptr_t>(q_out) |
       reinterpret_cast<uintptr_t>(k_out) | reinterpret_cast<uintptr_t>(v_out)) & vec ||
      (reinterpret_cast<uintptr_t>(ck) | reinterpret_cast<uintptr_t>(cv)) & 3 ||
      (reinterpret_cast<uintptr_t>(cks) | reinterpret_cast<uintptr_t>(cvs)) & 3) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.cos = cos;
  p.sin = sin;
  p.q_out = q_out;
  p.k_out = k_out;
  p.v_out = v_out;
  p.ck = static_cast<int8_t*>(ck);
  p.cv = static_cast<int8_t*>(cv);
  p.cks = static_cast<float*>(cks);
  p.cvs = static_cast<float*>(cvs);
  p.q_rs = strides[0];
  p.k_rs = strides[1];
  p.v_rs = strides[2];
  p.p_row = strides[3];
  p.p_head = strides[4];
  p.p_tok = strides[5];
  p.s_row = strides[6];
  p.s_head = strides[7];
  p.s_tok = strides[8];
  p.t = t;
  p.nh = nh;
  p.nkv = nkv;
  p.t_dst = t_dst;
  p.w0 = w0;
  p.wn = wn;
  p.slot = slot;
  p.slot_ptr = static_cast<const int*>(slot_ptr);
  p.recip_127 = recip_127;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(hd, b * t, threads, p, st);
}
