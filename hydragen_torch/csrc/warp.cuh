// Warp-level pieces shared by the port's short-row reads, K5 (flash.cu) and
// K3 (decode.cu), and by K2/K4 (flash.cu): the bf16 mma.sync shape, exp2 on
// the special-function unit, bf16 packing, and the exact int8 and int4 to
// bf16 conversions on the ALUs (cvt runs at a sixteenth of the FMA rate).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// c[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product where A's rows 8-15 are zero (a[1], a[3] are not read):
// only the accumulators of rows 0-7, c[0] and c[1], are kept.
__device__ __forceinline__ void mma_bf16_rows8(float* c, const unsigned* a, unsigned b0,
                                               unsigned b1) {
  float d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(0u), "r"(a[2]), "r"(0u), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned*>(&h);
}

// 2^x on the special-function unit, flushing denormals (-inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Two int8 in the low bytes of 16-bit lanes to bf16x2, exactly: each byte v
// gives the bf16 pair 128 + (v & 127) and 128 + (v & 128) (the exponent of
// 128 and v's bits as mantissa); their difference is v.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t lanes) {
  return bf16x2_sub((lanes & 0x007F007Fu) | 0x43004300u, (lanes & 0x00800080u) | 0x43004300u);
}

// Four int8 (one word) to four bf16 (two words), in order.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  return make_uint2(i8x2_to_bf16x2(__byte_perm(w, 0, 0x4140)),
                    i8x2_to_bf16x2(__byte_perm(w, 0, 0x4342)));
}

// Byte e of x and byte e of y as two int8 in 16-bit lanes, to bf16x2 (x low).
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t x, uint32_t y, int e) {
  return i8x2_to_bf16x2(__byte_perm(x, y, 0x4400 + 0x1111 * e));
}

// The signed low nibbles of bits 0-3 and 16-19 to bf16x2, exactly: nibble n
// (two's complement s) XOR 8 is s + 8 in [0, 15], put into the mantissa of
// 128 (0x4300: the mantissa's unit is 1 there); 136 off that is s. One
// logic op and one bf16x2 subtract a pair.
__device__ __forceinline__ uint32_t i4x2_to_bf16x2(uint32_t lanes) {
  return bf16x2_sub((lanes & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

// Four packed bytes (byte i: element i of one token in its low nibble and
// element i of another in its high nibble) to bf16 pairs: lo[0] elements
// (0, 2) and lo[1] elements (1, 3) of the low nibbles' token, hi[0] and
// hi[1] likewise of the high nibbles'. Three shifts, four logic ops and four
// subtracts for eight elements.
__device__ __forceinline__ void i4x8_to_bf16x8(uint32_t w, uint32_t (&lo)[2],
                                               uint32_t (&hi)[2]) {
  lo[0] = i4x2_to_bf16x2(w);
  lo[1] = i4x2_to_bf16x2(w >> 8);
  hi[0] = i4x2_to_bf16x2(w >> 4);
  hi[1] = i4x2_to_bf16x2(w >> 12);
}

// Byte e of x and byte e of y to bf16x2 pairs (x low) of their low nibbles
// (lo) and of their high nibbles (hi).
__device__ __forceinline__ void i4pair_to_bf16x2(uint32_t x, uint32_t y, int e, uint32_t& lo,
                                                 uint32_t& hi) {
  const uint32_t lanes = __byte_perm(x, y, 0x4400 + 0x1111 * e);
  lo = i4x2_to_bf16x2(lanes);
  hi = i4x2_to_bf16x2(lanes >> 4);
}

}  // namespace
