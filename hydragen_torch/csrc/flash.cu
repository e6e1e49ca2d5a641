// Flash attention for Hopper returning (out, lse), with optional int8 KV.
//
// K2/K4, flash_kernel, replaces the TPU kernel hydragen_tpu/ops/flash.py:_kernel
// (:94), reached through two entries: flash_attention_cached_bhsd (the
// pallas_call of _kernel_cached, :924: one layer of the stacked shared-level
// buffers read in place, row = layer * SB * hkv + b * hkv + kv_head) and
// flash_attention_bhsd (the pallas_call at :608: causal prefill, and the
// non-causal reads of more than 32 folded query rows). The second kernel of
// this file, K5 (flash_decode_kernel, below), replaces _decode_kernel for the
// small-M non-causal calls of flash_attention_bhsd.
//
// Function: q [BH, M, D] bf16 holds the GQA-folded queries of one kv head
// (head-major, position-minor, so folded row r is query position r % q_len);
// k/v [rows, S, D] bf16 or int8 with per-token f32 scales [rows, S] that
// commute onto the score columns (k) and the probability columns (v). Keys
// at or past the row's length, and past the causal diagonal (aligned to the
// end: j <= i + S - q_len), are masked. Online softmax in fp32; lse is the
// natural log, -inf on rows whose keys are all masked (out is 0 there).
//
// What bounds it on the H100: operations, at every shape the paths run. At
// the 7B decode read (M = 256 folded rows a kv head, S = 2,048 int8 keys,
// D = 128) each key's 264 bytes (k, v, two scales) meet 4 * 256 * 128 bf16
// FLOP, ~500 FLOP a byte; at the 8B decode read (M = 1,024) four times that;
// at the 2,048-token causal prefill (bf16) ~1,000; all above the ~295
// FLOP/byte ridge (only the 7B suffix prefill, 128 x 128 causal blocks, is
// bound by bytes). So the design aims at the tensor cores' rate.
//
// Design.
// - One block of 3 warpgroups (384 threads) an SM. Warpgroups 0-1 consume:
//   each owns 64 query rows (FBM = 128 a block), holds its Q as wgmma A
//   fragments in registers, and its S (64 x 64) and O (64 x D) f32
//   accumulators. Warpgroup 2 produces. ptxas gives every instantiation 168
//   registers at entry (no spills); setmaxnreg then moves them from the
//   producer (88 a thread) to the consumers (208).
// - K and V tiles of BN = 64 keys arrive by TMA: 3-D tensor maps over
//   [rows, S, D], built by cuTensorMapEncodeTiled (reached through the
//   runtime's driver entry point, so no -lcuda) and cached on the host by
//   pointer, shape and dtype; passed as __grid_constant__ parameters.
//   bf16 tiles land straight in a ring of 6 stages (192 KB at D = 128), each
//   guarded by a full and an empty mbarrier, as 64-column boxes with the
//   128-byte swizzle the wgmma descriptors name (boxes past S come back
//   zero-filled). int8 tiles land unswizzled in a raw ring of 5 stages; the
//   producer warpgroup converts them to bf16 (exact, on the ALUs: see
//   i8x2_to_bf16x2) into a swizzled ring of 4 stages (211 KB in all at
//   D = 128), loads the tile's f32 scales with plain loads, and zeroes every
//   key row at or past the row's length (payload and scales). For bf16 the
//   consumers zero V's rows between the length and S in the one tile that
//   holds them: P = 0 times a NaN there would still be NaN. The conversion
//   sits in the producer so that the consumers issue only wgmma and the
//   softmax; converting in the consumers was not built, so which costs less
//   is not measured. What the producer's conversion costs is: the 7B decode
//   read takes 18 % longer on int8 k/v than on the same k/v in bf16
//   (chip_smoke.py's bf16_device_ms, PERF.md §6).
// - S = Q K^T: wgmma m64n64k16, A (Q) from registers, B (K) from shared
//   memory, K-major. Online softmax in exp2 space, f32 row state in the
//   accumulator layout (the 4 threads of a row group reduce by shuffles); k
//   scales on the score columns, v scales on P's columns before P is
//   rounded to bf16. O += P V: wgmma m64nDk16, A (P) from registers, B (V)
//   from shared memory MN-major (the transpose flag). Each warpgroup issues
//   tile i's Q K^T with tile i-1's P V and computes tile i's softmax while
//   the latter runs; the two warpgroups take turns to issue (named
//   barriers), so one's products overlap the other's softmax. Causal blocks
//   stop at their diagonal; only tiles that cross the length or a diagonal
//   run the mask.
// - Grid (b * hkv, M blocks, KV splits), the M blocks highest first, so the
//   causal blocks with the most keys start first. Where the (head, M block)
//   pairs cannot fill the card, the keys split into chunks
//   (ops/flash.py:flash_plan: 2 splits of 1,024 keys at the 7B and 8B decode
//   reads, 128 blocks in one wave); each split writes an f32 partial (o
//   normalised, natural-log lse) and split_combine merges them by
//   combine_lse's rule (an empty split adds nothing).
// Measured, the tensor cores do not hold it back: at the 2,048-token causal
// prefill they run at 38 % of peak, and head_dim 64 (half the
// products) takes 70 % of head_dim 128's time, so the per-tile and
// per-score work (softmax, masks, barriers, the waits on each product) does
// (PERF.md §6). Later work: a persistent grid, Q in shared memory and
// 128-key tiles (half the per-tile overhead), and TMA multicast of K/V over
// a cluster (every 128-row block reads its K/V tiles from L2 again).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ptx.cuh"

namespace {

constexpr int BN = 64;        // keys a tile of K2/K4
constexpr float LN2 = 0.6931471805599453f;

// K2/K4's block.
constexpr int NC = 2;                 // consumer warpgroups
constexpr int FBM = 64 * NC;          // query rows a block
constexpr int FTHREADS = 128 * (NC + 1);
constexpr int PRODUCER_REGS = 88;
constexpr int CONSUMER_REGS = 208;
// Named barriers: 0 is __syncthreads, 1 + wg a consumer warpgroup's own, NC + 1
// the producer's, TURN + wg the consumers' turns to issue.
constexpr int TURN = NC + 2;

struct Params {
  const __nv_bfloat16* q;
  const float* k_scale;
  const float* v_scale;
  const int* lens;  // [b] or null
  __nv_bfloat16* out;
  float* lse;
  float* o_part;    // [splits, BH, M, D] f32 when the keys split, else null
  float* lse_part;  // [splits, BH, M]
  long long row_offset;  // first kv row of this call (layer * SB * hkv)
  int M;                 // folded query rows per (b, kv head)
  int q_len;             // query positions (causal position = r % q_len)
  int S;                 // kv length (row stride of k/v/scales)
  int hkv;
  int causal;
  int BH;
  int chunk;  // keys a split covers (a multiple of BN)
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned*>(&h);
}

// ---------------------------------------------------------------------------
// K2/K4's own Hopper pieces (the shared ones are in hopper.cuh): exp2 and
// the bf16 wgmma shapes.

// 2^x on the special-function unit, flushing denormals (-inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define ACC8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= a[64 x 16] (registers, bf16) * B[16 x 64] (descriptor);
// TB = 1 reads B MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64(float* d, const uint32_t* a, uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

// d[64 x 128] (+)= a[64 x 16] (registers, bf16) * B[16 x 128] (descriptor).
template <int TB>
__device__ __forceinline__ void wgmma_m64n128(float* d, const uint32_t* a, uint64_t desc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

#undef ACC8

// Shared memory of one K2/K4 block, in bytes from a 1,024-byte boundary.
// A bf16 tile is D / 64 swizzle atoms of [BN keys x 64 columns], each BN x
// 128 bytes; an int8 raw tile is [BN x D] bytes, unswizzled.
// Stages: a bf16 ring of ST stages; for int8 also a raw ring of RST stages,
// the tiles TMA keeps in flight (the consumers hold two bf16 stages at a
// time, so the bf16 ring itself needs only a few).
template <int D, bool INT8>
struct Smem {
  static constexpr int ST = INT8 ? 4 : 6;
  static constexpr int RST = INT8 ? 5 : 1;
  static constexpr int TILE = BN * D * 2;
  static constexpr int RAW = INT8 ? BN * D : 0;
  static constexpr int K = 0;
  static constexpr int V = K + ST * TILE;
  static constexpr int KR = V + ST * TILE;
  static constexpr int VR = KR + RST * RAW;
  static constexpr int SCALES = VR + RST * RAW;  // [ST][2][BN] f32: k, v
  static constexpr int BARS = SCALES + (INT8 ? ST * 2 * BN * 4 : 0);
  static constexpr int BYTES = BARS + (2 * ST + RST) * 8;  // full, empty, raw full
  static constexpr int ALLOC = BYTES + 1024;  // room to round the base up
  static_assert(ALLOC <= 232448, "shared memory of one block");
};

// Four int8 (one word) to four bf16 (two words), exactly, without the
// conversion unit (a sixteenth of the FMA rate): each byte v, moved into a
// 16-bit lane, gives the bf16 pair 128 + (v & 127) and 128 + (v & 128) (the
// exponent of 128 and v's bits as mantissa); their difference is v.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t lanes) {
  const uint32_t a = (lanes & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (lanes & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  return make_uint2(i8x2_to_bf16x2(__byte_perm(w, 0, 0x4140)),
                    i8x2_to_bf16x2(__byte_perm(w, 0, 0x4342)));
}

// The int8 K and V tiles [BN x D] (raw, rows D bytes apart) to bf16 in the
// swizzled layout; rows at or past `valid` become 0. The producer
// warpgroup's 128 threads (pt) each take 16-byte chunks: all loads first,
// then branch-free conversion and stores, so the chunks overlap.
template <int D>
__device__ __forceinline__ void convert_tiles(const unsigned char* raw_k,
                                              const unsigned char* raw_v, unsigned char* dst_k,
                                              unsigned char* dst_v, int valid, int pt) {
  constexpr int CPR = D / 16;
  constexpr int IT = BN * CPR / 128;  // chunks a thread, per tile
  uint4 in[2][IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int c = pt + it * 128;
    in[0][it] = *reinterpret_cast<const uint4*>(raw_k + c * 16);
    in[1][it] = *reinterpret_cast<const uint4*>(raw_v + c * 16);
  }
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int c = pt + it * 128;
      const int r = c / CPR, j = c % CPR;
      const uint32_t keep = r < valid ? 0xFFFFFFFFu : 0u;
      const uint4 v = in[kv][it];
      const uint2 a = i8x4_to_bf16x4(v.x & keep), b = i8x4_to_bf16x4(v.y & keep);
      const uint2 c2 = i8x4_to_bf16x4(v.z & keep), d2 = i8x4_to_bf16x4(v.w & keep);
      const int col = j * 16;
      const int grp = (col % 64) / 8;  // 16-byte group within the 128-byte row
      unsigned char* row = (kv ? dst_v : dst_k) + (col / 64) * (BN * 128) + r * 128;
      *reinterpret_cast<uint4*>(row + ((grp ^ (r & 7)) * 16)) = make_uint4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<uint4*>(row + (((grp + 1) ^ (r & 7)) * 16)) =
          make_uint4(c2.x, c2.y, d2.x, d2.y);
    }
  }
}

template <int D, bool INT8>
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const Params& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, uint64_t* rfull, int kv_row, int start,
                                        int limit, int n_tiles) {
  using L = Smem<D, INT8>;
  const int pt = threadIdx.x - NC * 128;
  if (!INT8) {
    if (pt != 0) return;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % L::ST;
      mbar_wait(&empty[s], ((i / L::ST) & 1) ^ 1);
      mbar_expect_tx(&full[s], 2 * L::TILE);
      const int n0 = start + i * BN;
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(smem + L::K + s * L::TILE + c * BN * 128, kmap, &full[s], c * 64, n0, kv_row);
        tma_load_3d(smem + L::V + s * L::TILE + c * BN * 128, vmap, &full[s], c * 64, n0, kv_row);
      }
    }
    return;
  }
  auto issue_raw = [&](int i) {
    const int s = i % L::RST;
    const int n0 = start + i * BN;
    mbar_expect_tx(&rfull[s], 2 * L::RAW);
    tma_load_3d(smem + L::KR + s * L::RAW, kmap, &rfull[s], 0, n0, kv_row);
    tma_load_3d(smem + L::VR + s * L::RAW, vmap, &rfull[s], 0, n0, kv_row);
  };
  if (pt == 0) {
    for (int i = 0; i < L::RST && i < n_tiles; ++i) issue_raw(i);
  }
  // A tile's scales (k's times the softmax scale, 0 past the length) are
  // loaded one tile ahead, so their latency hides behind the waits.
  float* scales = reinterpret_cast<float*>(smem + L::SCALES);
  const float* ksrc = p.k_scale + (long long)kv_row * p.S;
  const float* vsrc = p.v_scale + (long long)kv_row * p.S;
  float ks_next = 0.f, vs_next = 0.f;
  if (pt < BN && start + pt < limit) {
    ks_next = ksrc[start + pt];
    vs_next = vsrc[start + pt];
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % L::ST, rs = i % L::RST;
    const int n0 = start + i * BN;
    const int valid = min(BN, limit - n0);
    mbar_wait(&rfull[rs], (i / L::RST) & 1);
    mbar_wait(&empty[s], ((i / L::ST) & 1) ^ 1);
    convert_tiles<D>(smem + L::KR + rs * L::RAW, smem + L::VR + rs * L::RAW,
                     smem + L::K + s * L::TILE, smem + L::V + s * L::TILE, valid, pt);
    if (pt < BN) {
      scales[(s * 2) * BN + pt] = ks_next * p.scale_log2;
      scales[(s * 2 + 1) * BN + pt] = vs_next;
    }
    fence_async_shared();  // also waits for this thread's loads
    named_sync(NC + 1, 128);  // the raw stage is read and the bf16 stage written
    if (pt == 0) {
      mbar_arrive(&full[s]);
      if (i + L::RST < n_tiles) issue_raw(i + L::RST);
    }
    // The next tile's scales, loaded after the fence so that it does not
    // wait for them.
    if (pt < BN) {
      const int key = n0 + BN + pt;
      const bool ok = i + 1 < n_tiles && key < limit;
      ks_next = ok ? ksrc[key] : 0.f;
      vs_next = ok ? vsrc[key] : 0.f;
    }
  }
}

template <int D, bool INT8>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int bh, int mb, int split, int start,
                                        int limit, int n_tiles) {
  using L = Smem<D, INT8>;
  constexpr int KC = D / 16;  // k16 steps of Q K^T
  constexpr int NO = D / 2;   // O accumulators a thread
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = mb * FBM + wg * 64 + warp * 16 + g;  // rows r0 and r0 + 8

  // Q as A fragments: [kc][0] row r0 cols 16kc+2t.., [1] row r0+8, [2]/[3] +8 cols.
  uint32_t qa[KC][4];
  const __nv_bfloat16* qb = p.q + (size_t)bh * p.M * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const bool ok = row < p.M;
    const __nv_bfloat16* qr = qb + (size_t)(ok ? row : 0) * D + 2 * t;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qa[kc][h] = ok ? *reinterpret_cast<const uint32_t*>(qr + kc * 16) : 0u;
      qa[kc][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(qr + kc * 16 + 8) : 0u;
    }
  }
  const int diag_off = p.S - p.q_len;
  const int qpos[2] = {r0 % p.q_len, (r0 + 8) % p.q_len};
  const int qmin = min(qpos[0], qpos[1]);

  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const uint32_t kbase = smem_u32(smem + L::K), vbase = smem_u32(smem + L::V);
  const float* scales = reinterpret_cast<const float*>(smem + L::SCALES);

  // S = Q K^T of tile i (64 rows x 64 keys), issued, not waited for. For
  // bf16, V's rows between the length and S are zeroed first (both
  // warpgroups write the same zeros) so P = 0 never meets a NaN there.
  float sc[32];
  uint32_t pa[4][4];
  auto issue_qk = [&](int i) {
    const int s = i % L::ST;
    const int n0 = start + i * BN;
    mbar_wait(&full[s], (i / L::ST) & 1);
    if (!INT8 && n0 + BN > limit && limit < p.S) {
      unsigned char* vt = smem + L::V + s * L::TILE;
      const int lo = limit - n0, rows = min(BN, p.S - n0) - lo;
      for (int c = tid % 128; c < rows * (D / 8); c += 128) {
        const int r = lo + c / (D / 8), j = c % (D / 8);
        *reinterpret_cast<uint4*>(vt + (j / 8) * (BN * 128) + r * 128 + (j % 8) * 16) =
            make_uint4(0, 0, 0, 0);
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {  // the first step overwrites sc
      const uint32_t addr = kbase + s * L::TILE + (kc / 4) * (BN * 128) + (kc % 4) * 32;
      wgmma_m64n64<0>(sc, qa[kc], sw128_desc(addr, 16, 1024), kc > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile i: V MN-major, 16 keys a step; issued, not waited for.
  auto issue_pv = [&](int i) {
    const int s = i % L::ST;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t desc = sw128_desc(vbase + s * L::TILE + kk * 16 * 128, BN * 128, 1024);
      if constexpr (D == 128) {
        wgmma_m64n128<1>(o, pa[kk], desc, 1);
      } else {
        wgmma_m64n64<1>(o, pa[kk], desc, 1);
      }
    }
    wgmma_commit();
  };
  // Tile i's softmax in place: scale, mask, the row maxima (rows g and g + 8
  // of the warp's 16), sc = exp2(s - m) unnormalised, the running max and
  // sum; alpha rescales what O holds.
  float alpha[2];
  auto softmax = [&](int i) {
    const int s = i % L::ST;
    const int n0 = start + i * BN;
    const bool masked = n0 + BN > limit || (p.causal && n0 + BN - 1 > qmin + diag_off);
    const float* ks = scales + (s * 2) * BN;  // k scales times the softmax scale
    if (INT8) {  // bf16 scores take the softmax scale inside the exponent
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kj = *reinterpret_cast<const float2*>(ks + j * 8 + t * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j * 4 + e] *= (e & 1) ? kj.y : kj.x;
      }
    }
    // The mask, only in tiles that cross the length or a diagonal (a
    // warp-uniform branch, so the other tiles run none of it).
    if (__any_sync(0xffffffff, masked)) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int key = n0 + (j >> 2) * 8 + t * 2 + (j & 1);
        bool ok = key < limit;
        if (p.causal) ok = ok && key <= qpos[(j >> 1) & 1] + diag_off;
        sc[j] = ok ? sc[j] : -INFINITY;
      }
    }
    // Row maxima as trees (rows g and g + 8: elements with (j >> 1) & 1 = h).
    float mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        m4[u] = fmaxf(fmaxf(sc[u * 8 + h * 2], sc[u * 8 + h * 2 + 1]),
                      fmaxf(sc[u * 8 + 4 + h * 2], sc[u * 8 + 4 + h * 2 + 1]));
      mx[h] = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
      if (!INT8) mx[h] *= p.scale_log2;
    }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = fast_exp2(m_run[h] - m_use[h]);
      m_run[h] = m_new;
    }
    float part[2][4] = {};  // four partial sums a row, short chains
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = fast_exp2(INT8 ? sc[j] - m_use[(j >> 1) & 1]
                             : fmaf(sc[j], p.scale_log2, -m_use[(j >> 1) & 1]));
      part[(j >> 1) & 1][j >> 3] += sc[j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l_run[h] = l_run[h] * alpha[h] + ((part[h][0] + part[h][1]) + (part[h][2] + part[h][3]));
  };
  // P as bf16 A fragments, v scales on its columns.
  auto pack = [&](int i) {
    const float* vs = scales + ((i % L::ST) * 2 + 1) * BN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 vj = INT8 ? *reinterpret_cast<const float2*>(vs + j * 8 + t * 2)
                             : make_float2(1.f, 1.f);
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[e] = sc[j * 4 + e] * ((e & 1) ? vj.y : vj.x);
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }
  };

  // Tile i's softmax overlaps tile i-1's P V on the tensor cores: Q K^T(i)
  // and P V(i-1) are issued together, the softmax waits only for the first.
  // The two warpgroups take turns to issue (named barriers TURN + wg, each
  // synced by its own warpgroup and arrived at by the other), so one's
  // products run while the other computes its softmax. Each warpgroup has
  // n_tiles + 1 turns; warpgroup 1 opens warpgroup 0's first.
  const int other = TURN + (1 - wg);
  auto take_turn = [&]() { named_sync(TURN + wg, 256); };
  auto pass_turn = [&](bool last) {
    if (!(last && wg == 1)) named_arrive(other, 256);
  };
  if (n_tiles > 0) {
    if (wg == 1) named_arrive(TURN, 256);
    take_turn();
    issue_qk(0);
    pass_turn(false);
    wgmma_wait<0>();
    softmax(0);
    pack(0);
    for (int i = 1; i < n_tiles; ++i) {
      take_turn();
      issue_qk(i);
      issue_pv(i - 1);
      pass_turn(false);
      wgmma_wait<1>();
      softmax(i);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % L::ST]);
      // Rows whose maximum moved (alpha < 1) rescale O; after the first
      // tiles most warps skip it.
      if (__any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];
      }
      pack(i);
    }
    take_turn();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    pass_turn(true);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(n_tiles - 1) % L::ST]);
  }

  // Row sums live split over the 4 threads of a row group.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffff, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffff, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= p.M) continue;
    const float l = l_run[h];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const float lse = l == 0.f ? -INFINITY : m_run[h] * LN2 + logf(l);
    if (p.o_part != nullptr) {
      const size_t prow = ((size_t)split * p.BH + bh) * p.M + row;
      float* dst = p.o_part + prow * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8 + t * 2) =
            make_float2(o[j * 4 + h * 2] * inv, o[j * 4 + h * 2 + 1] * inv);
      if (t == 0) p.lse_part[prow] = lse;
    } else {
      __nv_bfloat16* dst = p.out + ((size_t)bh * p.M + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + t * 2) =
            __floats2bfloat162_rn(o[j * 4 + h * 2] * inv, o[j * 4 + h * 2 + 1] * inv);
      if (t == 0) p.lse[(size_t)bh * p.M + row] = lse;
    }
  }
}

template <int D, bool INT8>
__global__ void __launch_bounds__(FTHREADS, 1)
    flash_kernel(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Smem<D, INT8>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + L::ST;
  uint64_t* rfull = empty + L::ST;

  const int bh = blockIdx.x;
  const int mb = gridDim.y - 1 - blockIdx.y;
  const int split = blockIdx.z;
  const int b = bh / p.hkv;
  const int kv_row = (int)(p.row_offset + bh);

  int limit = p.S;
  if (p.lens != nullptr) limit = min(max(p.lens[b], 0), p.S);
  // Keys this block can see: the length, and for causal blocks the diagonal
  // of its highest query position; then this split's chunk of them.
  int kv_end = limit;
  if (p.causal) {
    const int lo = mb * FBM;
    const int hi = min(lo + FBM, p.M) - 1;
    const int max_qpos = (lo / p.q_len == hi / p.q_len) ? hi % p.q_len : p.q_len - 1;
    kv_end = max(0, min(kv_end, max_qpos + p.S - p.q_len + 1));
  }
  const int start = split * p.chunk;
  const int end = min(start + p.chunk, kv_end);
  const int n_tiles = end > start ? (end - start + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < L::RST; ++s) mbar_init(&rfull[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    produce<D, INT8>(&kmap, &vmap, p, smem, full, empty, rfull, kv_row, start, limit, n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<D, INT8>(p, smem, full, empty, bh, mb, split, start, limit, n_tiles);
  }
}

// Host side of the tensor maps: a small cache over encode_fn() (hopper.cuh;
// the level buffers are fixed allocations, so the shared-level read encodes
// its maps once).
struct MapEntry {
  const void* ptr;
  long long rows;
  int S, D, int8;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 64;
MapEntry g_maps[MAP_CACHE];
int g_map_count = 0, g_map_next = 0;

// The map of k or v [rows, S, D]: boxes of [1, BN, 64] bf16 with the
// 128-byte swizzle, or [1, BN, D] int8 unswizzled.
int tensor_map(CUtensorMap* out, const void* ptr, long long rows, int S, int D, bool int8) {
  for (int i = 0; i < g_map_count; ++i) {
    const MapEntry& m = g_maps[i];
    if (m.ptr == ptr && m.rows == rows && m.S == S && m.D == D && m.int8 == (int)int8) {
      *out = m.map;
      return 0;
    }
  }
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t elem = int8 ? 1 : 2;
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)rows};
  cuuint64_t strides[2] = {D * elem, (cuuint64_t)S * D * elem};
  cuuint32_t box[3] = {(cuuint32_t)(int8 ? D : 64), (cuuint32_t)BN, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  MapEntry& m = g_maps[g_map_next];
  CUresult r = fn(&m.map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  m.ptr = ptr;
  m.rows = rows;
  m.S = S;
  m.D = D;
  m.int8 = int8;
  *out = m.map;
  g_map_next = (g_map_next + 1) % MAP_CACHE;
  if (g_map_count < MAP_CACHE) ++g_map_count;
  return 0;
}

// KV splits (K2/K4's and K5's) merged by exact LSE (combine_lse's rule; an
// empty split, lse -inf, adds nothing): one thread per 4 columns of a row.
// Partials are [splits, rows, D] f32 and [splits, rows], rows = BH * M.
// Small blocks: K5's split shapes merge only BH * M = 32 rows.
constexpr int COMBINE_THREADS = 64;

template <int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
    split_combine(const float* o_part, const float* lse_part, __nv_bfloat16* out, float* lse,
                  int rows, int splits) {
  constexpr int V4 = D / 4;
  const long long idx = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (idx >= (long long)rows * V4) return;
  const long long row = idx / V4;
  const int c4 = (int)(idx % V4);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, lse_part[s * (long long)rows + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const long long prow = s * (long long)rows + row;
      const float w = expf(lse_part[prow] - mx);
      const float4 o = reinterpret_cast<const float4*>(o_part + prow * D)[c4];
      l += w;
      acc.x += w * o.x;
      acc.y += w * o.y;
      acc.z += w * o.z;
      acc.w += w * o.w;
    }
  }
  const float inv = l == 0.f ? 0.f : 1.f / l;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + row * D + c4 * 4);
  dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  if (c4 == 0) lse[row] = l == 0.f ? -INFINITY : mx + logf(l);
}

template <int D, bool INT8>
int launch(const Params& p, const void* k, const void* v, long long rows, int splits,
           cudaStream_t st) {
  using L = Smem<D, INT8>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<D, INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap kmap = {}, vmap = {};
  if (p.S > 0) {  // S = 0: no tile is read, and no map can be encoded
    int e = tensor_map(&kmap, k, rows, p.S, D, INT8);
    if (e == 0) e = tensor_map(&vmap, v, rows, p.S, D, INT8);
    if (e != 0) return e;
  }
  dim3 grid(p.BH, (p.M + FBM - 1) / FBM, splits);
  flash_kernel<D, INT8><<<grid, FTHREADS, L::ALLOC, st>>>(kmap, vmap, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int out_rows = p.BH * p.M;
  split_combine<D><<<(int)(((long long)out_rows * (D / 4) + COMBINE_THREADS - 1) /
                            COMBINE_THREADS),
                      COMBINE_THREADS, 0, st>>>(p.o_part, p.lse_part, p.out, p.lse, out_rows,
                                                splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5: the small-M non-causal read (flash-decoding).
//
// Replaces hydragen_tpu/ops/flash.py:_decode_kernel, launched by
// _flash_decode_call (:715), which flash_attention_bhsd reaches for non-causal
// calls with M = group * m <= 32 folded query rows: the unique-cache read of
// a decode step over a BHSD cache (GQA models, the no-sharing baseline).
//
// Function: flash_kernel's without the causal mask, over k/v read where they
// lie, through batch / head / token strides (the last dim contiguous): the
// cache's per-layer view is never copied. Per-token f32 scales (any strides)
// commute onto the score (k) and probability (v) columns. lse is the natural
// log, -inf (out 0) on a row of length 0.
//
// What bounds it on the H100: bytes. Each KV byte meets M <= 32 query rows,
// at most 64 bf16 FLOP a byte (8 at the GQA path's M = 4), far below the
// ~295 FLOP/byte ridge. So the design keeps HBM busy and the SM's work per
// byte small:
// - Work unit: one warp a (b * hkv row, KV split) item, with its own online
//   softmax state and its own ring in shared memory, so no barrier but
//   __syncwarp and no merge across warps. A block is DecCfg::WARPS such
//   warps and nothing more; blocks are small, so the card holds 4-8 items an
//   SM, the hardware hands a free slot the next block, and a short row (the
//   gqa path's 191 keys) pays only its own prologue. The M rows are padded
//   to MT m16 tiles (mma.sync m16n8k16); Q's A fragments are loaded once,
//   straight from global memory.
// - The ring: DecCfg::ST = 3 stages of TK = 32 keys (K, V and, for int8,
//   both scales) filled by cp.async, 16 bytes a lane (4 for a scale), 2
//   tiles ahead of the one computed: 17 KB of int8 at D = 128 in flight a
//   warp, ~135 KB an SM. Keys at or past the item's end are zero-filled
//   (src-size 0), never read. Rows are padded by 16 bytes so that every
//   read below is free of bank conflicts at D = 128.
// - int8 lands raw and is converted in registers after the wait, exactly,
//   on the ALUs (i8x4_to_bf16x4: 2 ops an element; cvt runs at 1/16 of the
//   FMA rate). Neither product needs a bf16 tile. Q K^T permutes its k
//   dimension: lane t takes d in [t D/4, (t + 1) D/4) (Q's fragments follow),
//   so a lane's K bytes are contiguous. P V permutes its output columns: in
//   n-tile j lane g holds d = g D/8 + j, so a lane reads D/8 contiguous bytes
//   of each of its 4 keys a k16 step, and a byte permute pairs two keys'
//   bytes of one column into a bf16x2 B register. bf16 k/v go through
//   ldmatrix (V transposed) as they lie.
// - Splits (ops/flash.py:decode_splits): only where the rows cannot keep
//   half the warps an SM holds of the dtype (4 int8, 2 bf16) busy on every
//   SM. The gqa and no-sharing reads (2,048 rows) do not split; one
//   32,768-key sequence over 8 kv heads takes 64 splits of 512 (int8) or 32
//   of 1,024 (bf16). Each split writes an f32 partial (o normalised,
//   natural-log lse) and split_combine merges them by combine_lse's rule.

struct DecParams {
  const __nv_bfloat16* q;  // [BH, M, D], folded
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* lens;  // [b] or null
  long long st[12];  // strides in elements: k, v, k_scale, v_scale x (batch, head, token)
  __nv_bfloat16* out;  // [BH, M, D]       (one split)
  float* lse;          // [BH, M]
  float* o_part;       // [splits, BH, M, D] (several splits), else null
  float* lse_part;     // [splits, BH, M]
  int BH, M, S, hkv, chunk, splits;
  float scale_log2;
};

// A warp's ring and a block's shape. Bytes of a stage: K and V tiles of TK
// key rows (ROW bytes each, 16 of them padding), then for int8 the k and v
// scales of the TK keys. At D = 128: int8 9,472 bytes a stage, 28 KB a warp,
// 8 warps an SM; bf16 17,408 a stage, 51 KB a warp, 4 warps an SM. Chosen
// on the chip against 2, 4 and 6 stages, 1 or 4 warps a block, and
// persistent warps that stream several rows through one ring (PERF.md §6).
template <int D, bool INT8>
struct DecCfg {
  static constexpr int TK = 32;
  static constexpr int ST = 3;
  static constexpr int WARPS = INT8 ? 2 : 1;
  static constexpr int ROW = (INT8 ? D : 2 * D) + 16;
  static constexpr int K = 0;
  static constexpr int V = K + TK * ROW;
  static constexpr int KS = V + TK * ROW;
  static constexpr int VS = KS + (INT8 ? TK * 4 : 0);
  static constexpr int STAGE = VS + (INT8 ? TK * 4 : 0);
  static constexpr int RING = ST * STAGE;
  static constexpr int BYTES = WARPS * RING;
  static_assert(TK == 32, "one scale a lane");
  static_assert(STAGE % 16 == 0, "16-byte copies");
};

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

// Byte e of x and byte e of y as two int8 in 16-bit lanes, to bf16x2 (x low).
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t x, uint32_t y, int e) {
  return i8x2_to_bf16x2(__byte_perm(x, y, 0x4400 + 0x1111 * e));
}

template <int D, bool INT8, int MT>
__global__ void __launch_bounds__(DecCfg<D, INT8>::WARPS * 32)
    flash_decode_kernel(const DecParams p) {
  using C = DecCfg<D, INT8>;
  constexpr int TK = C::TK, ST = C::ST, NK = TK / 8;
  constexpr int KC = D / 16;  // k16 steps of Q K^T
  constexpr int NT = D / 8;   // n8 tiles of O
  constexpr int ELEM = INT8 ? 1 : 2;
  constexpr int CPR = D * ELEM / 16;  // 16-byte chunks a key row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x * C::WARPS + warp;
  if (item >= p.BH * p.splits) return;  // no block barrier follows
  const int bh = item % p.BH, split = item / p.BH;
  const int b = bh / p.hkv, h = bh % p.hkv;

  int limit = p.S;
  if (p.lens != nullptr) limit = min(max(p.lens[b], 0), p.S);
  const int start = split * p.chunk;
  const int end = min(start + p.chunk, limit);
  const int n_tiles = end > start ? (end - start + TK - 1) / TK : 0;

  unsigned char* ring = smem_raw + warp * C::RING;
  const uint32_t ring_s = smem_u32(ring);
  const long long* st = p.st;
  const char* kbase = static_cast<const char*>(p.k) + (b * st[0] + h * st[1]) * ELEM;
  const char* vbase = static_cast<const char*>(p.v) + (b * st[3] + h * st[4]) * ELEM;
  const long long ktok = st[2] * ELEM, vtok = st[5] * ELEM;  // bytes between tokens
  const float* ksrow = INT8 ? p.k_scale + b * st[6] + h * st[7] : nullptr;
  const float* vsrow = INT8 ? p.v_scale + b * st[9] + h * st[10] : nullptr;

  // Tile i into stage i % ST (nothing past the last tile), then one commit:
  // an empty group keeps the wait count in step.
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int n0 = start + i * TK;
      const uint32_t stage = ring_s + (i % ST) * C::STAGE;
#pragma unroll
      for (int it = 0; it < TK * CPR / 32; ++it) {
        const int c = lane + 32 * it;
        const int r = c / CPR, col = (c % CPR) * 16;
        const bool ok = n0 + r < end;
        const long long tok = ok ? n0 + r : start;  // a valid address; unread when !ok
        cp_async16(stage + C::K + r * C::ROW + col, kbase + tok * ktok + col, ok);
        cp_async16(stage + C::V + r * C::ROW + col, vbase + tok * vtok + col, ok);
      }
      if (INT8) {
        const bool ok = n0 + lane < end;
        const long long tok = ok ? n0 + lane : start;
        cp_async4(stage + C::KS + lane * 4, ksrow + tok * st[8], ok);
        cp_async4(stage + C::VS + lane * 4, vsrow + tok * st[11], ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) issue(i);

  // Q as A fragments, [kc][0] row g, [1] row g + 8, [2]/[3] the second pair
  // of k indices. int8: step kc takes d = t D/4 + 4 kc .. + 3 (the k
  // permutation above); bf16: the plain order.
  uint32_t qa[MT][KC][4];
  const __nv_bfloat16* qb = p.q + (size_t)bh * p.M * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mt * 16 + g + 8 * hh;
      const bool ok = row < p.M;
      const __nv_bfloat16* qr = qb + (size_t)(ok ? row : 0) * D;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int d0 = INT8 ? t * (D / 4) + 4 * kc : 16 * kc + 2 * t;
        const int d1 = INT8 ? d0 + 2 : d0 + 8;
        qa[mt][kc][hh] = ok ? *reinterpret_cast<const uint32_t*>(qr + d0) : 0u;
        qa[mt][kc][2 + hh] = ok ? *reinterpret_cast<const uint32_t*>(qr + d1) : 0u;
      }
    }
  }

  float o[MT][NT][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    __syncwarp();           // every lane is done with the stage tile i - 1 used
    issue(i + ST - 1);      // which now takes tile i + ST - 1
    cp_async_wait<ST - 1>();  // this lane's copies of tile i have landed
    __syncwarp();           // and every lane's
    const unsigned char* stage = ring + (i % ST) * C::STAGE;
    const int valid = end - (start + i * TK);  // keys of the tile below the end (may pass TK)

    // S = Q K^T: MT x 16 rows x TK keys (NK n8 tiles).
    float s[MT][NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
      }
      if constexpr (INT8) {
        const uint4* kr = reinterpret_cast<const uint4*>(stage + C::K + (nt * 8 + g) * C::ROW +
                                                         t * (D / 4));
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
        for (int kc = 0; kc < KC; ++kc) {
          const uint2 kb = i8x4_to_bf16x4(kw[kc]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(s[mt][nt], qa[mt][kc], kb.x, kb.y);
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < KC; kc += 2) {
          unsigned kb[4];
          ldmatrix_x4(kb, stage + C::K + (nt * 8 + (lane & 7)) * C::ROW +
                              (16 * kc + (lane >> 3) * 8) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][nt], qa[mt][kc], kb[0], kb[1]);
            mma_bf16(s[mt][nt], qa[mt][kc + 1], kb[2], kb[3]);
          }
        }
      }
    }

    // Online softmax in exp2 space; k scales (times the softmax scale) on
    // the score columns, v scales on P's columns before it is rounded.
    float2 kf[NK], vf[NK];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      if constexpr (INT8) {
        const float2 ks = *reinterpret_cast<const float2*>(stage + C::KS + (nt * 8 + 2 * t) * 4);
        kf[nt] = make_float2(ks.x * p.scale_log2, ks.y * p.scale_log2);
        vf[nt] = *reinterpret_cast<const float2*>(stage + C::VS + (nt * 8 + 2 * t) * 4);
      } else {
        kf[nt] = make_float2(p.scale_log2, p.scale_log2);
        vf[nt] = make_float2(1.f, 1.f);
      }
    }
    const bool masked = valid < TK;
    uint32_t pa[MT][TK / 16][4];
    bool moved = false;
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][nt][e] * ((e & 1) ? kf[nt].y : kf[nt].x);
          if (masked && nt * 8 + 2 * t + (e & 1) >= valid) x = -INFINITY;
          s[mt][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float m_use[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffff, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffff, mx[hh], 2));
        const float m_new = fmaxf(m_run[mt][hh], mx[hh]);
        m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
        alpha[mt][hh] = fast_exp2(m_run[mt][hh] - m_use[hh]);
        moved = moved || alpha[mt][hh] != 1.f;
        m_run[mt][hh] = m_new;
      }
      float lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = fast_exp2(s[mt][nt][e] - m_use[e >> 1]);
          lsum[e >> 1] += pe;
          pv[e] = pe * ((e & 1) ? vf[nt].y : vf[nt].x);
        }
        // A fragment of k16 step nt / 2: n-tile 2kk gives k 2t.., 2kk + 1 k 2t + 8..
        pa[mt][nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(pv[0], pv[1]);
        pa[mt][nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[mt][hh] = l_run[mt][hh] * alpha[mt][hh] + lsum[hh];
    }
    // Rows whose maximum moved rescale O; after the first tiles most skip it.
    if (__any_sync(0xffffffff, moved)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          o[mt][j][0] *= alpha[mt][0];
          o[mt][j][1] *= alpha[mt][0];
          o[mt][j][2] *= alpha[mt][1];
          o[mt][j][3] *= alpha[mt][1];
        }
      }
    }

    // O += P V, one k16 step (16 keys) at a time.
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      if constexpr (INT8) {
        // Keys 16kk + 2t, + 1, + 8, + 9: D/8 bytes each from column g D/8.
        constexpr int W = NT / 4;  // words a key
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
          const uint32_t b0 = i8pair_to_bf16x2(vw[0][j >> 2], vw[1][j >> 2], j & 3);
          const uint32_t b1 = i8pair_to_bf16x2(vw[2][j >> 2], vw[3][j >> 2], j & 3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(o[mt][j], pa[mt][kk], b0, b1);
        }
      } else {
        const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, stage + C::V + (16 * kk + (mi & 1) * 8 + rr) * C::ROW +
                                    (j + (mi >> 1)) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][j], pa[mt][kk], vb[0], vb[1]);
            mma_bf16(o[mt][j + 1], pa[mt][kk], vb[2], vb[3]);
          }
        }
      }
    }
  }

  // Row sums live split over the 4 threads of a row group; then out (or the
  // split's f32 partial) and lse. Column of O element e of n-tile j: int8
  // (2t + (e & 1)) D/8 + j, bf16 8j + 2t + (e & 1).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[mt][hh];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      const int row = mt * 16 + g + 8 * hh;
      if (row >= p.M) continue;
      const float inv = l == 0.f ? 0.f : 1.f / l;
      const float lse = l == 0.f ? -INFINITY : m_run[mt][hh] * LN2 + logf(l);
      const int e0 = 2 * hh;
      if (p.o_part != nullptr) {
        const size_t prow = ((size_t)split * p.BH + bh) * p.M + row;
        float* dst = p.o_part + prow * D;
        if constexpr (INT8) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int j = 0; j < NT; j += 4)
              *reinterpret_cast<float4*>(dst + (2 * t + e) * NT + j) =
                  make_float4(o[mt][j][e0 + e] * inv, o[mt][j + 1][e0 + e] * inv,
                              o[mt][j + 2][e0 + e] * inv, o[mt][j + 3][e0 + e] * inv);
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            *reinterpret_cast<float2*>(dst + j * 8 + 2 * t) =
                make_float2(o[mt][j][e0] * inv, o[mt][j][e0 + 1] * inv);
        }
        if (t == 0) p.lse_part[prow] = lse;
      } else {
        const size_t orow = (size_t)bh * p.M + row;
        __nv_bfloat16* dst = p.out + orow * D;
        if constexpr (INT8) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int j = 0; j < NT; j += 8) {
              uint4 w;
              w.x = pack_bf16(o[mt][j][e0 + e] * inv, o[mt][j + 1][e0 + e] * inv);
              w.y = pack_bf16(o[mt][j + 2][e0 + e] * inv, o[mt][j + 3][e0 + e] * inv);
              w.z = pack_bf16(o[mt][j + 4][e0 + e] * inv, o[mt][j + 5][e0 + e] * inv);
              w.w = pack_bf16(o[mt][j + 6][e0 + e] * inv, o[mt][j + 7][e0 + e] * inv);
              *reinterpret_cast<uint4*>(dst + (2 * t + e) * NT + j) = w;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * t) =
                pack_bf16(o[mt][j][e0] * inv, o[mt][j][e0 + 1] * inv);
        }
        if (t == 0) p.lse[orow] = lse;
      }
    }
  }
}

template <int D, bool INT8, int MT>
int launch_decode(const DecParams& p, cudaStream_t st) {
  using C = DecCfg<D, INT8>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<D, INT8, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long items = (long long)p.BH * p.splits;
  const int blocks = (int)((items + C::WARPS - 1) / C::WARPS);
  flash_decode_kernel<D, INT8, MT><<<blocks, C::WARPS * 32, C::BYTES, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const int rows = p.BH * p.M;
  split_combine<D><<<(rows * (D / 4) + COMBINE_THREADS - 1) / COMBINE_THREADS, COMBINE_THREADS,
                      0, st>>>(p.o_part, p.lse_part, p.out, p.lse, rows, p.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool INT8>
int launch_decode_mt(const DecParams& p, cudaStream_t st) {
  return p.M <= 16 ? launch_decode<D, INT8, 1>(p, st) : launch_decode<D, INT8, 2>(p, st);
}

}  // namespace

// K2/K4. k/v: [rows, S, D] (the call reads rows row_offset .. + BH);
// o_part/lse_part: f32 workspace [splits, BH, M, D] / [splits, BH, M] when
// splits > 1, else null; chunk: keys a split covers, a multiple of 64.
extern "C" int hydragen_flash_attention(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* lens, void* out, void* lse, void* o_part,
                                        void* lse_part, long long row_offset, long long rows,
                                        int BH, int M, int q_len, int S, int hkv, int D,
                                        int kv_int8, int causal, int splits, int chunk,
                                        float scale_log2, void* stream) {
  if (splits < 1 || (splits > 1 && o_part == nullptr) || chunk < 1 || chunk % BN ||
      (long long)splits * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_part = splits > 1 ? static_cast<float*>(o_part) : nullptr;
  p.lse_part = splits > 1 ? static_cast<float*>(lse_part) : nullptr;
  p.row_offset = row_offset;
  p.M = M;
  p.q_len = q_len;
  p.S = S;
  p.hkv = hkv;
  p.causal = causal;
  p.BH = BH;
  p.chunk = chunk;
  p.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return kv_int8 ? launch<128, true>(p, k, v, rows, splits, st)
                   : launch<128, false>(p, k, v, rows, splits, st);
  if (D == 64)
    return kv_int8 ? launch<64, true>(p, k, v, rows, splits, st)
                   : launch<64, false>(p, k, v, rows, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5. strides: 12 int64 (elements) = k, v, k_scale, v_scale x (batch, head,
// token); o_part/lse_part: f32 workspace [splits, BH, M, D] / [splits, BH, M]
// when splits > 1, else null. chunk: keys a split covers.
extern "C" int hydragen_flash_decode(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* lens, const long long* strides, void* out,
                                     void* lse, void* o_part, void* lse_part, int BH, int M,
                                     int S, int hkv, int D, int kv_int8, int splits, int chunk,
                                     float scale_log2, void* stream) {
  if (M < 1 || M > 32 || splits < 1 || (splits > 1 && o_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DecParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lens = static_cast<const int*>(lens);
  for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_part = splits > 1 ? static_cast<float*>(o_part) : nullptr;
  p.lse_part = splits > 1 ? static_cast<float*>(lse_part) : nullptr;
  p.BH = BH;
  p.M = M;
  p.S = S;
  p.hkv = hkv;
  p.chunk = chunk;
  p.splits = splits;
  p.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return kv_int8 ? launch_decode_mt<128, true>(p, st) : launch_decode_mt<128, false>(p, st);
  if (D == 64)
    return kv_int8 ? launch_decode_mt<64, true>(p, st) : launch_decode_mt<64, false>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
