// Flash attention for Hopper returning (out, lse), with optional int8 KV.
//
// Replaces the TPU kernel hydragen_tpu/ops/flash.py:_kernel, reached through
// two entries: flash_attention_bhsd (causal prefill and non-causal reads) and
// flash_attention_cached_bhsd (one layer of the stacked shared-level buffers,
// read in place: row = layer * SB * hkv + b * hkv + kv_head). The second
// kernel of this file, K5 (flash_decode_kernel, below), replaces
// _decode_kernel for the small-M non-causal calls of flash_attention_bhsd.
//
// Function: q [BH, M, D] bf16 holds the GQA-folded queries of one kv head
// (head-major, position-minor, so folded row r is query position r % q_len);
// k/v [rows, S, D] bf16 or int8 with per-token f32 scales [rows, S] that
// commute onto the score columns (k) and the probability columns (v). Keys
// at or past the row's length, and past the causal diagonal (aligned to the
// end: j <= i + S - q_len), are masked. Online softmax in fp32; lse is the
// natural log, -inf on rows whose keys are all masked (out is 0 there).
//
// What bounds it on the H100: at the shared-level read (M = 256 folded rows,
// S = 2,048, D = 128, int8 KV) each KV byte meets 256 query rows, ~512
// bf16 FLOP per byte, above the ~295 FLOP/byte ridge: tensor-core bound, as
// causal prefill (M = S = 2,048) is by a wide margin.
// Design: mma.sync m16n8k16 bf16 for both products with fp32 accumulators in
// registers; 64 query rows a block (16 a warp, kept as A fragments in
// registers), 64 keys a step. K and V tiles are staged in shared memory as
// bf16 (int8 converted on the way in, exact), with rows past the length
// never loaded but zero-filled, so no padding byte reaches a product. The P
// fragments of the first product are the A fragments of the second, and V's
// B fragments come from ldmatrix.trans. Causal blocks stop at their diagonal.
// Pipelining, TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int THREADS = 128;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* lens;  // [b] or null
  __nv_bfloat16* out;
  float* lse;
  long long row_offset;  // first kv row of this call (layer * SB * hkv)
  int M;                 // folded query rows per (b, kv head)
  int q_len;             // query positions (causal position = r % q_len)
  int S;                 // kv length (row stride of k/v/scales)
  int hkv;
  int causal;
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

// Stage `rows_valid` rows of a [BN, D] tile into bf16 shared memory (row
// stride LD elements); source rows lie `src_stride` elements apart; rows at
// or past rows_valid are zero-filled and never loaded.
template <int D, int LD, bool INT8>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const void* src_rows,
                                           int rows_valid, int tid, size_t src_stride = D) {
  if (INT8) {
    constexpr int CPR = D / 16;  // 16-byte chunks a row
    const int8_t* src = static_cast<const int8_t*>(src_rows);
    for (int c = tid; c < BN * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 16;
      uint4 out[2];
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
      if (r < rows_valid) {
        int4 raw = *reinterpret_cast<const int4*>(src + (size_t)r * src_stride + col);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i) o[i] = __float2bfloat16_rn((float)b[i]);
      } else {
        out[0] = make_uint4(0, 0, 0, 0);
        out[1] = out[0];
      }
      uint4* d = reinterpret_cast<uint4*>(dst + r * LD + col);
      d[0] = out[0];
      d[1] = out[1];
    }
  } else {
    constexpr int CPR = D / 8;
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(src_rows);
    for (int c = tid; c < BN * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * src_stride + col);
      *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
    }
  }
}

template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS) flash_kernel(const Params p) {
  constexpr int LD = D + 8;  // padded bf16 row: conflict-free fragment reads
  constexpr int KC = D / 16;  // k16 chunks along D
  constexpr int NT = D / 8;   // n8 tiles along D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;
  float* ks_s = reinterpret_cast<float*>(Vs + BN * LD);
  float* vs_s = ks_s + BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int mb = blockIdx.x;
  const int b = bh / p.hkv;
  const long long kv_row = p.row_offset + bh;

  int limit = p.S;
  if (p.lens != nullptr) limit = min(max(p.lens[b], 0), p.S);

  // Keys this block can see: the length, and for causal blocks the diagonal
  // of its highest query position.
  int kv_end = limit;
  const int diag_off = p.S - p.q_len;
  if (p.causal) {
    const int lo = mb * BM;
    const int hi = min(lo + BM, p.M) - 1;
    const int max_qpos = (lo / p.q_len == hi / p.q_len) ? hi % p.q_len : p.q_len - 1;
    kv_end = max(0, min(kv_end, max_qpos + diag_off + 1));
  }

  // Stage this block's query rows and keep them as A fragments.
  const __nv_bfloat16* qsrc = p.q + ((size_t)bh * p.M + (size_t)mb * BM) * D;
  {
    constexpr int CPR = D / 8;
    const int rows_valid = min(BM, p.M - mb * BM);
    for (int c = tid; c < BM * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows_valid) val = *reinterpret_cast<const uint4*>(qsrc + (size_t)r * D + col);
      *reinterpret_cast<uint4*>(Qs + r * LD + col) = val;
    }
  }
  __syncthreads();
  unsigned qa[KC][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qa[kc][0] = *reinterpret_cast<const unsigned*>(Qs + r0 * LD + kc * 16 + t * 2);
    qa[kc][1] = *reinterpret_cast<const unsigned*>(Qs + (r0 + 8) * LD + kc * 16 + t * 2);
    qa[kc][2] = *reinterpret_cast<const unsigned*>(Qs + r0 * LD + kc * 16 + 8 + t * 2);
    qa[kc][3] = *reinterpret_cast<const unsigned*>(Qs + (r0 + 8) * LD + kc * 16 + 8 + t * 2);
  }

  // Causal query positions of this thread's two rows.
  const int qrow0 = mb * BM + r0;
  const int qpos[2] = {qrow0 % p.q_len, (qrow0 + 8) % p.q_len};

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const size_t elem = INT8 ? 1 : 2;
  const char* kbase = static_cast<const char*>(p.k) + (size_t)kv_row * p.S * D * elem;
  const char* vbase = static_cast<const char*>(p.v) + (size_t)kv_row * p.S * D * elem;

  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    const int rows_valid = min(BN, limit - n0);
    __syncthreads();  // previous tile fully consumed
    stage_tile<D, LD, INT8>(Ks, kbase + (size_t)n0 * D * elem, rows_valid, tid);
    stage_tile<D, LD, INT8>(Vs, vbase + (size_t)n0 * D * elem, rows_valid, tid);
    if (INT8 && tid < BN) {
      const bool ok = tid < rows_valid;
      ks_s[tid] = ok ? p.k_scale[kv_row * p.S + n0 + tid] : 0.f;
      vs_s[tid] = ok ? p.v_scale[kv_row * p.S + n0 + tid] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (nt * 8 + g) * LD;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const unsigned b0 = *reinterpret_cast<const unsigned*>(krow + kc * 16 + t * 2);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(krow + kc * 16 + 8 + t * 2);
        mma_bf16(s[nt], qa[kc], b0, b1);
      }
    }

    // Scale, mask, and the row maxima (rows g and g + 8 of the warp tile).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const int key = n0 + col;
        const int h = e >> 1;
        float x = s[nt][e] * p.scale_log2;
        if (INT8) x *= ks_s[col];
        bool ok = key < limit;
        if (p.causal) ok = ok && key <= qpos[h] + diag_off;
        x = ok ? x : -INFINITY;
        s[nt][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m_run[h] - m_use[h]);
      m_run[h] = m_new;
    }

    // P (unnormalised), the row sums, and P's bf16 A fragments (with the
    // v scales folded onto the probability columns).
    unsigned pa[BN / 16][4];
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_use[e >> 1]);
        lsum[e >> 1] += pe;
        pv[e] = INT8 ? pe * vs_s[nt * 8 + t * 2 + (e & 1)] : pe;
      }
      const int kc = nt >> 1, hi = nt & 1;
      pa[kc][hi * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pa[kc][hi * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + lsum[h];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: V's B fragments by ldmatrix.trans, two n8 tiles a load.
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned vb[4];
        const int key = kc * 16 + (mi & 1) * 8 + rr;
        const int col = (j + (mi >> 1)) * 8;
        ldmatrix_x4_trans(vb, Vs + key * LD + col);
        mma_bf16(o[j], pa[kc], vb[0], vb[1]);
        mma_bf16(o[j + 1], pa[kc], vb[2], vb[3]);
      }
    }
  }

  // Row sums live split over the 4 threads of a row group.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffff, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffff, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = mb * BM + r0 + h * 8;
    if (row >= p.M) continue;
    const float l = l_run[h];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    __nv_bfloat16* dst = p.out + ((size_t)bh * p.M + row) * D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + t * 2) =
          __floats2bfloat162_rn(o[j][h * 2] * inv, o[j][h * 2 + 1] * inv);
    }
    if (t == 0) {
      p.lse[(size_t)bh * p.M + row] = l == 0.f ? -INFINITY : m_run[h] * LN2 + logf(l);
    }
  }
}

template <int D, bool INT8>
int launch(const Params& p, int BH, cudaStream_t st) {
  constexpr int LD = D + 8;
  const int smem = (BM + 2 * BN) * LD * 2 + 2 * BN * 4;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<D, INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((p.M + BM - 1) / BM, BH);
  flash_kernel<D, INT8><<<grid, THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5: the small-M non-causal read (flash-decoding).
//
// Replaces hydragen_tpu/ops/flash.py:_decode_kernel, launched by
// _flash_decode_call, which flash_attention_bhsd reaches for non-causal calls
// with M = group * m <= 32 folded query rows: the unique-cache read of a
// decode step over a BHSD cache (GQA models, the no-sharing baseline).
//
// Function: flash_kernel's without the causal mask, over k/v read where they
// lie, through batch / head / token strides (the last dim contiguous): the
// cache's per-layer view is never copied. Per-token f32 scales (any strides)
// commute onto the score (k) and probability (v) columns. lse is the natural
// log, -inf (out 0) on a row of length 0.
//
// What bounds it on the H100: bytes. Each KV byte meets M <= 32 query rows,
// at most 64 bf16 FLOP a byte (8 at the GQA path's M = 4), far below the
// ~295 FLOP/byte ridge.
// Design: one block of 4 warps per (b * hkv row, KV split). The M rows are
// padded to MT m16 tiles, held as mma.sync A fragments by every warp. Each
// 64-key tile is staged in shared memory as bf16 (int8 converted on the way
// in, exact; rows past the row's length zero-filled and never loaded) and
// each warp takes 16 of its keys: m16n8k16 products for QK^T and PV and an
// online softmax in exp2 space, per warp. At the end the 4 warps' states are
// merged through shared memory by exact LSE. When b * hkv rows cannot fill
// the card, the keys are split into chunks (grid y); each split writes an f32
// partial (o normalised, natural-log lse) and decode_combine merges them by
// combine_lse's rule (an empty partial adds nothing). No pipelining yet.

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
  int BH, M, S, hkv, chunk;
  float scale_log2;
};

constexpr int WARPS = THREADS / 32;
constexpr int WK = BN / WARPS;  // keys of a tile each warp takes
static_assert(WK == 16, "one k16 chunk of keys a warp");

template <int D, int MT>
constexpr int decode_smem_bytes() {
  constexpr int LD = D + 8, MP = MT * 16;
  constexpr int stage = (MP + 2 * BN) * LD * 2 + 2 * BN * 4;
  constexpr int merge = (WARPS * MP * D + 2 * WARPS * MP) * 4;
  return stage > merge ? stage : merge;
}

template <int D, bool INT8, int MT>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(const DecParams p) {
  constexpr int LD = D + 8;
  constexpr int KC = D / 16;
  constexpr int NT = D / 8;
  constexpr int MP = MT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MP * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;
  float* ks_s = reinterpret_cast<float*>(Vs + BN * LD);
  float* vs_s = ks_s + BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bh / p.hkv, h = bh % p.hkv;

  int limit = p.S;
  if (p.lens != nullptr) limit = min(max(p.lens[b], 0), p.S);
  const int start = split * p.chunk;
  const int end = min(start + p.chunk, limit);

  {
    constexpr int CPR = D / 8;
    const __nv_bfloat16* qsrc = p.q + (size_t)bh * p.M * D;
    for (int c = tid; c < MP * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < p.M) val = *reinterpret_cast<const uint4*>(qsrc + (size_t)r * D + col);
      *reinterpret_cast<uint4*>(Qs + r * LD + col) = val;
    }
  }
  __syncthreads();
  unsigned qa[MT][KC][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = mt * 16 + g;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qa[mt][kc][0] = *reinterpret_cast<const unsigned*>(Qs + r0 * LD + kc * 16 + t * 2);
      qa[mt][kc][1] = *reinterpret_cast<const unsigned*>(Qs + (r0 + 8) * LD + kc * 16 + t * 2);
      qa[mt][kc][2] = *reinterpret_cast<const unsigned*>(Qs + r0 * LD + kc * 16 + 8 + t * 2);
      qa[mt][kc][3] =
          *reinterpret_cast<const unsigned*>(Qs + (r0 + 8) * LD + kc * 16 + 8 + t * 2);
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

  const size_t elem = INT8 ? 1 : 2;
  const long long* st = p.st;
  const char* kbase = static_cast<const char*>(p.k) + (size_t)(b * st[0] + h * st[1]) * elem;
  const char* vbase = static_cast<const char*>(p.v) + (size_t)(b * st[3] + h * st[4]) * elem;
  const float* ksrow = INT8 ? p.k_scale + b * st[6] + h * st[7] : nullptr;
  const float* vsrow = INT8 ? p.v_scale + b * st[9] + h * st[10] : nullptr;
  const int kw = warp * WK;  // this warp's first key within a tile

  for (int n0 = start; n0 < end; n0 += BN) {
    const int rows_valid = min(BN, end - n0);
    __syncthreads();  // previous tile fully consumed
    stage_tile<D, LD, INT8>(Ks, kbase + (size_t)n0 * st[2] * elem, rows_valid, tid, st[2]);
    stage_tile<D, LD, INT8>(Vs, vbase + (size_t)n0 * st[5] * elem, rows_valid, tid, st[5]);
    if (INT8 && tid < BN) {
      const bool ok = tid < rows_valid;
      ks_s[tid] = ok ? ksrow[(long long)(n0 + tid) * st[8]] : 0.f;
      vs_s[tid] = ok ? vsrow[(long long)(n0 + tid) * st[11]] : 0.f;
    }
    __syncthreads();
    if (kw >= rows_valid) continue;  // warp-uniform: all of this warp's keys are past the end

    unsigned pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // S = Q K^T: 16 rows x this warp's 16 keys (two n8 tiles).
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* krow = Ks + (kw + nt * 8 + g) * LD;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const unsigned b0 = *reinterpret_cast<const unsigned*>(krow + kc * 16 + t * 2);
          const unsigned b1 = *reinterpret_cast<const unsigned*>(krow + kc * 16 + 8 + t * 2);
          mma_bf16(s[nt], qa[mt][kc], b0, b1);
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kw + nt * 8 + t * 2 + (e & 1);
          float x = s[nt][e] * p.scale_log2;
          if (INT8) x *= ks_s[col];
          x = col < rows_valid ? x : -INFINITY;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffff, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffff, mx[hh], 2));
        const float m_new = fmaxf(m_run[mt][hh], mx[hh]);
        m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
        alpha[hh] = exp2f(m_run[mt][hh] - m_use[hh]);
        m_run[mt][hh] = m_new;
      }
      float lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[nt][e] - m_use[e >> 1]);
          lsum[e >> 1] += pe;
          pv[e] = INT8 ? pe * vs_s[kw + nt * 8 + t * 2 + (e & 1)] : pe;
        }
        pa[mt][nt * 2 + 0] = pack_bf16(pv[0], pv[1]);
        pa[mt][nt * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[mt][hh] = l_run[mt][hh] * alpha[hh] + lsum[hh];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[mt][j][0] *= alpha[0];
        o[mt][j][1] *= alpha[0];
        o[mt][j][2] *= alpha[1];
        o[mt][j][3] *= alpha[1];
      }
    }

    // O += P V over this warp's 16 keys: V's B fragments by ldmatrix.trans.
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      unsigned vb[4];
      ldmatrix_x4_trans(vb, Vs + (kw + (mi & 1) * 8 + rr) * LD + (j + (mi >> 1)) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][j], pa[mt], vb[0], vb[1]);
        mma_bf16(o[mt][j + 1], pa[mt], vb[2], vb[3]);
      }
    }
  }

  // Merge the 4 warps' states through shared memory (aliasing the tiles).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l_run[mt][hh] += __shfl_xor_sync(0xffffffff, l_run[mt][hh], 1);
      l_run[mt][hh] += __shfl_xor_sync(0xffffffff, l_run[mt][hh], 2);
    }
  }
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem_raw);  // [WARPS][MP][D]
  float* mm = mo + WARPS * MP * D;                 // [WARPS][MP]
  float* ml = mm + WARPS * MP;                     // [WARPS][MP]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + g + 8 * (e >> 1);
        mo[(warp * MP + row) * D + j * 8 + t * 2 + (e & 1)] = o[mt][j][e];
      }
    }
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mt * 16 + g + 8 * hh;
        mm[warp * MP + row] = m_run[mt][hh];
        ml[warp * MP + row] = l_run[mt][hh];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < p.M * D; idx += THREADS) {
    const int row = idx / D, col = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mm[w * MP + row]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f(mm[w * MP + row] - mu);
      l += ml[w * MP + row] * c;
      acc += mo[(w * MP + row) * D + col] * c;
    }
    const float val = l == 0.f ? 0.f : acc / l;
    const float lse = l == 0.f ? -INFINITY : mu * LN2 + logf(l);
    if (p.o_part != nullptr) {
      const size_t prow = ((size_t)split * p.BH + bh) * p.M + row;
      p.o_part[prow * D + col] = val;
      if (col == 0) p.lse_part[prow] = lse;
    } else {
      const size_t orow = (size_t)bh * p.M + row;
      p.out[orow * D + col] = __float2bfloat16_rn(val);
      if (col == 0) p.lse[orow] = lse;
    }
  }
}

// The splits' partials merged by exact LSE (combine_lse's rule): one block
// per b * hkv row.
__global__ void __launch_bounds__(THREADS) decode_combine(const float* o_part,
                                                          const float* lse_part,
                                                          __nv_bfloat16* out, float* lse,
                                                          int BH, int M, int D, int splits) {
  const int bh = blockIdx.x;
  for (int idx = threadIdx.x; idx < M * D; idx += THREADS) {
    const int row = idx / D, col = idx % D;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, lse_part[((size_t)s * BH + bh) * M + row]);
    float l = 0.f, acc = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < splits; ++s) {
        const size_t prow = ((size_t)s * BH + bh) * M + row;
        const float w = expf(lse_part[prow] - mx);
        l += w;
        acc += w * o_part[prow * D + col];
      }
    }
    const size_t orow = (size_t)bh * M + row;
    out[orow * D + col] = __float2bfloat16_rn(l == 0.f ? 0.f : acc / l);
    if (col == 0) lse[orow] = l == 0.f ? -INFINITY : mx + logf(l);
  }
}

template <int D, bool INT8, int MT>
int launch_decode(const DecParams& p, int splits, cudaStream_t st) {
  constexpr int smem = decode_smem_bytes<D, MT>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<D, INT8, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  flash_decode_kernel<D, INT8, MT><<<dim3(p.BH, splits), THREADS, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  decode_combine<<<p.BH, THREADS, 0, st>>>(p.o_part, p.lse_part, p.out, p.lse, p.BH, p.M, D,
                                           splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool INT8>
int launch_decode_mt(const DecParams& p, int splits, cudaStream_t st) {
  return p.M <= 16 ? launch_decode<D, INT8, 1>(p, splits, st)
                   : launch_decode<D, INT8, 2>(p, splits, st);
}

}  // namespace

extern "C" int hydragen_flash_attention(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* lens, void* out, void* lse,
                                        long long row_offset, int BH, int M, int q_len, int S,
                                        int hkv, int D, int kv_int8, int causal,
                                        float scale_log2, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.row_offset = row_offset;
  p.M = M;
  p.q_len = q_len;
  p.S = S;
  p.hkv = hkv;
  p.causal = causal;
  p.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return kv_int8 ? launch<128, true>(p, BH, st) : launch<128, false>(p, BH, st);
  if (D == 64) return kv_int8 ? launch<64, true>(p, BH, st) : launch<64, false>(p, BH, st);
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
  p.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return kv_int8 ? launch_decode_mt<128, true>(p, splits, st)
                   : launch_decode_mt<128, false>(p, splits, st);
  if (D == 64)
    return kv_int8 ? launch_decode_mt<64, true>(p, splits, st)
                   : launch_decode_mt<64, false>(p, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
