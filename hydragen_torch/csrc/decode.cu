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
//   v_j * v_scale; then an exact LSE merge with (o_sh, lse_sh); lse is the
//   natural log, -inf with out 0 on an empty row. int4 (BITS = 4): the cache
//   is token-planar, S byte rows where byte row j holds token j in its low
//   nibble and token j + S in its high nibble, and the flat scales run over
//   the 2S logical tokens (the high plane's start at S * hkv). The TPU
//   kernel's s8 re-quantization of q and p is not copied: the payload is
//   converted to bf16 exactly and both products accumulate in fp32; P, times
//   its v scale, enters the second as two bf16 terms (16 bits of it).
//
// What bounds it on the H100: bytes. Each cached byte meets the `group` <= 8
// query heads of its kv head, 2-16 FLOP a byte against a ~295 FLOP/byte
// ridge; the rows are short (the unique history of a decode step, tens to
// a few hundred tokens), so the design keeps many bytes in flight and the
// work per byte small.
// - Work item: one warp a (row, kv head), with its own online-softmax state
//   and its own ring in shared memory: no barrier but __syncwarp, no merge
//   across warps, no KV split (Llama-2-7B at bs 256 has 8,192 items). A
//   block is Cfg::WARPS such warps and nothing more; the kv head is the
//   fastest index, so the 32-byte sector of flat scales one head fetches
//   serves its neighbours from L2.
// - The ring: Cfg::ST = 2 stages of TK = 32 byte rows (K, V, and the k and
//   v scales of every logical token of the rows: at int4, the low and the
//   high plane's), filled by cp.async 16 bytes a lane (4 for a scale), one
//   tile ahead of the one computed, so a 63-token row has all of its bytes
//   in flight at once. Measured on the card (kernel_times.py --k3-variants,
//   PERF.md): two stages read faster than three or four (a shallower ring
//   leaves room for more items an SM, which covers more latency here than
//   depth does); one, two and four warps a block read within 3 %, eight
//   slower. Rows and scales past the item's end are zero-filled
//   (source size 0), never read: a stale scale may hold anything, and 0
//   times NaN is NaN. K and V rows are padded by 16 bytes so that the reads
//   below are free of bank conflicts at D = 128.
// - A tile at a time: the query heads are rows 0-7 of an m16 tile, scores
//   S = Q K^T and O += P V by mma.sync m16n8k16 in bf16 with f32
//   accumulators, one max and one rescale of the online softmax (exp2 space)
//   a tile and head. Q's rows 8-15 are zero; P's rows 8-15 carry what
//   rounding P * v_scale to bf16 left over, so rows 0-7 and 8-15 of O summed
//   hold P V to 16 bits of P at no extra product (one bf16 term failed the
//   int4 path's fp32-yardstick gate in chip_smoke.py). Q K^T permutes its k
//   dimension so that a lane's K bytes are contiguous (lane t takes d in
//   [t D/4, (t + 1) D/4); Q's fragments follow); P V permutes O's columns (in
//   n-tile j lane g holds d = g D/8 + j), so a lane reads D/8 contiguous
//   bytes of each of its 4 keys a k16 step (warp.cuh's pair conversions).
// - Conversion on the ALUs, exact, after the wait: int8 by i8x4_to_bf16x4 /
//   i8pair_to_bf16x2 (2 ops an element); int4 by i4x8_to_bf16x8 /
//   i4pair_to_bf16x2 (a nibble XOR 8 put into the mantissa of 128, then one
//   bf16x2 subtract a pair: 1.4-1.5 ops an element). A byte row is read and
//   converted once for both of its tokens; the high plane's products run
//   only in tiles that hold one of its live tokens, so a row with len <= S
//   never touches it.
// - Epilogue in the warp's registers: the own token's column (a dot product
//   of Q's fragments with the lane's quarter of k1, summed by two shuffles),
//   the normalisation and the LSE merge with the shared partial; each lane
//   writes 2 x D/8 contiguous outputs of its query head. Its operands (k1,
//   v1, the group's o_sh rows and lse) come by cp.async into shared memory
//   after the ring, one commit group ahead of the first tile, so their
//   latency hides behind the tiles' (epi_bytes: sized by the group).
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

#include "ptx.cuh"
#include "warp.cuh"

namespace {

constexpr int GMAX = 8;  // query heads per kv head: rows 0-7 of the m16 tile
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
  int b;
  int S;
  int hkv;
  int group;
  float scale;
};

// A warp's ring and a block's shape. A stage: K and V tiles of TK byte rows
// (ROW bytes each, 16 of them padding), then the k and v scales of the
// tile's logical tokens, plane by plane. At D = 128: int8 9,472 bytes a
// stage, int4 9,728.
template <int D, int BITS>
struct Cfg {
  static constexpr int TK = 32;
  static constexpr int ST = 2;
  static constexpr int WARPS = 2;
  static constexpr int PLANES = BITS == 4 ? 2 : 1;
  static constexpr int ROW = D + 16;
  static constexpr int K = 0;
  static constexpr int V = K + TK * ROW;
  static constexpr int KS = V + TK * ROW;  // [PLANES][TK] f32
  static constexpr int VS = KS + PLANES * TK * 4;
  static constexpr int STAGE = VS + PLANES * TK * 4;
  static constexpr int RING = ST * STAGE;
  static_assert(TK == 32, "one scale a lane");
  static_assert(STAGE % 16 == 0, "16-byte copies");
};

// Bytes of a warp's epilogue operands in shared memory, after its ring: the
// own token's k and v rows, the group's shared-partial rows and their lse.
template <int D>
__host__ __device__ constexpr int epi_bytes(int group) {
  return (2 + group) * D * 2 + (group * 4 + 15) / 16 * 16;
}

__device__ __forceinline__ float bf16x2_dot(uint32_t a, uint32_t b, float acc) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return fmaf(x.y, y.y, fmaf(x.x, y.x, acc));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  return x;
}

// The 4 lanes of a row group (lane & 3) summed / maximised.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

// 8 bf16 (16-byte aligned) to f32.
__device__ __forceinline__ void load_bf16x8(const __nv_bfloat16* src, float* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// One tile of the ring folded into the warp's online softmax. valid: the
// tile's low-plane columns below the item's end (may pass TK); valid_hi the
// high plane's (HIGH: at least one). ksc: the softmax scale times log2(e).
template <int D, int BITS, bool HIGH>
__device__ __forceinline__ void fold_tile(const unsigned char* stage,
                                          const uint32_t (&qa)[D / 16][4], int valid,
                                          int valid_hi, float ksc, float (&o)[D / 8][4],
                                          float& m_run, float& l_run, int g, int t) {
  using C = Cfg<D, BITS>;
  constexpr int TK = C::TK, NK = TK / 8, KC = D / 16, NT = D / 8;
  constexpr int P = HIGH ? 2 : 1;  // planes computed

  // S = Q K^T: rows 0-7 x TK columns a plane (NK n8 tiles).
  float s[P][NK][2];
#pragma unroll
  for (int nt = 0; nt < NK; ++nt) {
    const uint4* kr =
        reinterpret_cast<const uint4*>(stage + C::K + (nt * 8 + g) * C::ROW + t * (D / 4));
    uint32_t kw[KC];
#pragma unroll
    for (int w = 0; w < KC / 4; ++w) {
      const uint4 x = kr[w];
      kw[4 * w] = x.x;
      kw[4 * w + 1] = x.y;
      kw[4 * w + 2] = x.z;
      kw[4 * w + 3] = x.w;
    }
#pragma unroll
    for (int pl = 0; pl < P; ++pl) s[pl][nt][0] = s[pl][nt][1] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if constexpr (BITS == 8) {
        const uint2 kb = i8x4_to_bf16x4(kw[kc]);
        mma_bf16_rows8(s[0][nt], qa[kc], kb.x, kb.y);
      } else {
        uint32_t lo[2], hi[2];
        i4x8_to_bf16x8(kw[kc], lo, hi);
        mma_bf16_rows8(s[0][nt], qa[kc], lo[0], lo[1]);
        if constexpr (HIGH) mma_bf16_rows8(s[P - 1][nt], qa[kc], hi[0], hi[1]);
      }
    }
  }

  // Online softmax: k scales on the score columns, v scales on P's columns
  // before P is rounded to bf16. Columns past the end are -inf (their
  // scales are 0, so the product is finite first).
  float mx = -INFINITY;
#pragma unroll
  for (int pl = 0; pl < P; ++pl) {
    const int vld = pl ? valid_hi : valid;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      const float2 ks =
          *reinterpret_cast<const float2*>(stage + C::KS + (pl * TK + nt * 8 + 2 * t) * 4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[pl][nt][e] * (e ? ks.y : ks.x) * ksc;
        if (nt * 8 + 2 * t + e >= vld) x = -INFINITY;
        s[pl][nt][e] = x;
        mx = fmaxf(mx, x);
      }
    }
  }
  const float m_new = fmaxf(m_run, quad_max(mx));
  const float m_use = m_new == -INFINITY ? 0.f : m_new;
  const float alpha = fast_exp2(m_run - m_use);
  m_run = m_new;
  float lsum = 0.f;
  // A fragments of P * v_scale as two bf16 terms: rows 0-7 hold it rounded
  // ([0], [2]), rows 8-15 the rest, rounded ([1], [3]). O's rows 0-7 and
  // 8-15 summed keep 16 bits of it, so P V loses next to nothing to the
  // rounding, in products the padded m16 tile computes anyway.
  uint32_t pa[P][TK / 16][4];
#pragma unroll
  for (int pl = 0; pl < P; ++pl) {
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      const float2 vs =
          *reinterpret_cast<const float2*>(stage + C::VS + (pl * TK + nt * 8 + 2 * t) * 4);
      const float p0 = fast_exp2(s[pl][nt][0] - m_use);
      const float p1 = fast_exp2(s[pl][nt][1] - m_use);
      lsum += p0 + p1;
      // k16 step nt / 2: n-tile 2kk gives k 2t.., 2kk + 1 k 2t + 8..
      const float x0 = p0 * vs.x, x1 = p1 * vs.y;
      const uint32_t hi = pack_bf16(x0, x1);
      const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
      pa[pl][nt >> 1][(nt & 1) * 2] = hi;
      pa[pl][nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
  }
  l_run = l_run * alpha + lsum;
  // After the first tiles most rows' maximum stays: skip the rescale.
  if (__any_sync(0xffffffff, alpha != 1.f)) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha;
    }
  }

  // O += P V, one k16 step (16 byte rows) at a time: byte rows 16kk + 2t,
  // + 1, + 8, + 9, D/8 bytes each from column g D/8.
  constexpr int W = NT / 4;  // words a byte row
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    uint32_t vw[4][W];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned char* src =
          stage + C::V + (16 * kk + 2 * t + (r & 1) + 8 * (r >> 1)) * C::ROW + g * NT;
      if constexpr (W == 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(src);
        vw[r][0] = x.x;
        vw[r][1] = x.y;
        vw[r][2] = x.z;
        vw[r][3] = x.w;
      } else {
        const uint2 x = *reinterpret_cast<const uint2*>(src);
        vw[r][0] = x.x;
        vw[r][1] = x.y;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (BITS == 8) {
        const uint32_t b0 = i8pair_to_bf16x2(vw[0][j >> 2], vw[1][j >> 2], j & 3);
        const uint32_t b1 = i8pair_to_bf16x2(vw[2][j >> 2], vw[3][j >> 2], j & 3);
        mma_bf16(o[j], pa[0][kk], b0, b1);
      } else {
        uint32_t lo0, hi0, lo1, hi1;
        i4pair_to_bf16x2(vw[0][j >> 2], vw[1][j >> 2], j & 3, lo0, hi0);
        i4pair_to_bf16x2(vw[2][j >> 2], vw[3][j >> 2], j & 3, lo1, hi1);
        mma_bf16(o[j], pa[0][kk], lo0, lo1);
        if constexpr (HIGH) mma_bf16(o[j], pa[P - 1][kk], hi0, hi1);
      }
    }
  }
}

// The bound's second argument (one block an SM) leaves ptxas free to take
// the registers it needs: without it, D = 128 spilled at 168.
template <int D, int BITS>
__global__ void __launch_bounds__(Cfg<D, BITS>::WARPS * 32, 1) decode_kernel(const Params p) {
  using C = Cfg<D, BITS>;
  constexpr int TK = C::TK, ST = C::ST, KC = D / 16, NT = D / 8, PLANES = C::PLANES;
  constexpr int CPR = D / 16;  // 16-byte chunks a byte row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x * C::WARPS + warp;
  if (item >= p.b * p.hkv) return;  // no block barrier follows
  const int row = item / p.hkv, kvh = item % p.hkv;
  const int hq = p.hkv * p.group;
  const int len = min(max(p.lens[row], 0), PLANES * p.S);  // logical tokens
  const int limit = min(len, p.S);                          // byte rows read
  const int n_tiles = (limit + TK - 1) / TK;

  unsigned char* ring = smem_raw + warp * (C::RING + epi_bytes<D>(p.group));
  const uint32_t ring_s = smem_u32(ring);
  const unsigned char* epi = ring + C::RING;
  const size_t tok = (size_t)p.hkv * D;  // bytes between byte rows
  const int8_t* kb = p.k + (size_t)row * p.S * tok + (size_t)kvh * D;
  const int8_t* vb = p.v + (size_t)row * p.S * tok + (size_t)kvh * D;
  const float* ksb = p.k_scale + (size_t)row * PLANES * p.S * p.hkv + kvh;
  const float* vsb = p.v_scale + (size_t)row * PLANES * p.S * p.hkv + kvh;

  // Tile i into stage i % ST (nothing past the last tile), then one commit:
  // an empty group keeps the wait count in step.
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int j0 = i * TK;
      const uint32_t stage = ring_s + (i % ST) * C::STAGE;
#pragma unroll
      for (int it = 0; it < TK * CPR / 32; ++it) {
        const int c = lane + 32 * it;
        const int r = c / CPR, col = (c % CPR) * 16;
        const bool ok = j0 + r < limit;
        const size_t off = (size_t)(ok ? j0 + r : 0) * tok + col;  // mapped; unread if !ok
        cp_async16(stage + C::K + r * C::ROW + col, kb + off, ok);
        cp_async16(stage + C::V + r * C::ROW + col, vb + off, ok);
      }
#pragma unroll
      for (int pl = 0; pl < PLANES; ++pl) {
        const int j = j0 + lane + pl * p.S;  // logical token
        const bool ok = pl ? j < len : j < limit;
        const size_t off = (size_t)(ok ? j : 0) * p.hkv;
        cp_async4(stage + C::KS + (pl * TK + lane) * 4, ksb + off, ok);
        cp_async4(stage + C::VS + (pl * TK + lane) * 4, vsb + off, ok);
      }
    }
    cp_async_commit();
  };

  // The epilogue's operands, copied while the ring fills: one commit group
  // ahead of the tiles'.
  constexpr int RC = D / 8;  // 16-byte chunks a bf16 row
  const size_t kv1 = ((size_t)row * p.hkv + kvh) * D;
  const size_t hrow = (size_t)row * hq + kvh * p.group;  // the group's first head
  if (p.k1 != nullptr) {
    for (int c = lane; c < 2 * RC; c += 32)
      cp_async16(ring_s + C::RING + c * 16, (c < RC ? p.k1 : p.v1) + kv1 + (c % RC) * 8, true);
  }
  if (p.o_sh != nullptr) {
    for (int c = lane; c < p.group * RC; c += 32)
      cp_async16(ring_s + C::RING + (2 * RC + c) * 16, p.o_sh + hrow * D + c * 8, true);
    if (lane < p.group)
      cp_async4(ring_s + C::RING + (2 + p.group) * D * 2 + lane * 4, p.lse_sh + hrow + lane,
                true);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) issue(i);

  // Q as A fragments of rows 0-7 (the group's query heads; rows past the
  // group read as zero). Step kc takes d0 = t D/4 + 4 kc .. + 3: int8 a[0] =
  // (d0, d0 + 1), a[2] = (d0 + 2, d0 + 3), as i8x4_to_bf16x4 pairs K; int4
  // a[0] = (d0, d0 + 2), a[2] = (d0 + 1, d0 + 3), as i4x8_to_bf16x8 does.
  const bool has_q = g < p.group;
  const int h = kvh * p.group + g;
  const __nv_bfloat16* qrow = p.q + ((size_t)row * hq + (has_q ? h : 0)) * D + t * (D / 4);
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint2 w = has_q ? *reinterpret_cast<const uint2*>(qrow + 4 * kc) : make_uint2(0u, 0u);
    qa[kc][0] = BITS == 8 ? w.x : __byte_perm(w.x, w.y, 0x5410);
    qa[kc][2] = BITS == 8 ? w.y : __byte_perm(w.x, w.y, 0x7632);
    qa[kc][1] = qa[kc][3] = 0u;
  }

  // O of row g, column (2t + e) NT + j: o[j][e] + o[j][2 + e] (the two
  // terms of P).
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const float ksc = p.scale * LOG2E;

  for (int i = 0; i < n_tiles; ++i) {
    __syncwarp();             // every lane is done with the stage tile i - 1 used
    issue(i + ST - 1);        // which now takes tile i + ST - 1
    cp_async_wait<ST - 1>();  // this lane's copies of tile i have landed
    __syncwarp();             // and every lane's
    const unsigned char* stage = ring + (i % ST) * C::STAGE;
    const int valid = limit - i * TK;
    const int valid_hi = len - p.S - i * TK;  // warp-uniform
    if constexpr (BITS == 4) {
      if (valid_hi > 0) {
        fold_tile<D, BITS, true>(stage, qa, valid, valid_hi, ksc, o, m_run, l_run, g, t);
        continue;
      }
    }
    fold_tile<D, BITS, false>(stage, qa, valid, 0, ksc, o, m_run, l_run, g, t);
  }
  l_run = quad_sum(l_run);

  cp_async_wait<0>();  // the epilogue's operands (and, with no tile, all)
  __syncwarp();
  const __nv_bfloat16* k1s = reinterpret_cast<const __nv_bfloat16*>(epi);
  const __nv_bfloat16* v1s = k1s + D;
  const __nv_bfloat16* oshs = k1s + 2 * D;
  const float* lshs = reinterpret_cast<const float*>(epi + (2 + p.group) * D * 2);

  // The own token: one more column, its score from Q's fragments (the lane's
  // quarter of head_dim, in their order) summed over the row group.
  if (p.k1 != nullptr) {
    float dot = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint2 w = *reinterpret_cast<const uint2*>(k1s + t * (D / 4) + 4 * kc);
      dot = bf16x2_dot(qa[kc][0], BITS == 8 ? w.x : __byte_perm(w.x, w.y, 0x5410), dot);
      dot = bf16x2_dot(qa[kc][2], BITS == 8 ? w.y : __byte_perm(w.x, w.y, 0x7632), dot);
    }
    const float s_own = quad_sum(dot) * ksc;
    const float m_new = fmaxf(m_run, s_own);
    const float alpha = fast_exp2(m_run - m_new);
    const float po = fast_exp2(s_own - m_new);
    l_run = l_run * alpha + po;
    m_run = m_new;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int j = 0; j < NT; j += 8) {
        float vf[8];
        load_bf16x8(v1s + (2 * t + e) * NT + j, vf);
#pragma unroll
        for (int i = 0; i < 8; ++i) o[j + i][e] = o[j + i][e] * alpha + po * vf[i];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][2] *= alpha;
      o[j][3] *= alpha;
    }
  }

  // Normalise, merge with the shared partial, write.
  // __fdividef: no slow-path call (its register saves spill); l_run is at
  // most the row's token count plus one, den in [1, 2].
  const float inv = l_run > 0.f ? __fdividef(1.f, l_run) : 0.f;
  float lse = l_run > 0.f ? m_run * LN2 + logf(l_run) : -INFINITY;
  float c_own = inv, c_sh = 0.f;  // out = c_own * o + c_sh * o_sh
  if (p.o_sh != nullptr && has_q) {
    const float lsh = lshs[g];
    const float mm = fmaxf(lse, lsh);
    if (mm == -INFINITY) {
      c_own = 0.f;
      lse = -INFINITY;
    } else {
      const float e1 = expf(lse - mm);
      const float e2 = expf(lsh - mm);
      const float den = e1 + e2;
      c_own = __fdividef(e1 * inv, den);
      c_sh = __fdividef(e2, den);
      lse = mm + logf(den);
    }
  }
  if (!has_q) return;
  const size_t orow = ((size_t)row * hq + h) * D;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = (2 * t + e) * NT;
#pragma unroll
    for (int j = 0; j < NT; j += 8) {
      float sh[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c_sh != 0.f) load_bf16x8(oshs + g * D + col + j, sh);
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = c_own * (o[j + i][e] + o[j + i][2 + e]) + c_sh * sh[i];
      uint4 w;
      w.x = pack_bf16(r[0], r[1]);
      w.y = pack_bf16(r[2], r[3]);
      w.z = pack_bf16(r[4], r[5]);
      w.w = pack_bf16(r[6], r[7]);
      *reinterpret_cast<uint4*>(p.out + orow + col + j) = w;
    }
  }
  if (t == 0) p.lse[(size_t)row * hq + h] = lse;
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

template <int D, int BITS>
int launch(const Params& p, cudaStream_t st) {
  using C = Cfg<D, BITS>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<D, BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::WARPS * (C::RING + epi_bytes<D>(GMAX)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int items = p.b * p.hkv;
  if (items == 0) return static_cast<int>(cudaSuccess);
  const int bytes = C::WARPS * (C::RING + epi_bytes<D>(p.group));
  decode_kernel<D, BITS><<<(items + C::WARPS - 1) / C::WARPS, C::WARPS * 32, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  p.b = b;
  p.S = S;
  p.hkv = hkv;
  p.group = group;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return bits == 8 ? launch<128, 8>(p, st) : launch<128, 4>(p, st);
  if (D == 64) return bits == 8 ? launch<64, 8>(p, st) : launch<64, 4>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
