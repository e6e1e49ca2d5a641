// W8A8 and W4A8 GEMMs for Hopper.
//
// K1, w8a8_kernel: y[M,N] = (f32(i32(a_s8[M,K] . w_s8[layer][N,K]^T)) *
// row_scale[M]) * col_scale[N], rounded once to bf16 or f32; col_scale is
// bf16 (quantize_params) or f32 (the HF loader's host quantizer), converted
// to f32 where the epilogue stages it and nowhere else. Replaces the
// TPU kernels hydragen_tpu/ops/gemm.py:_w8a8_cached_kernel (entry
// w8a8_matmul_cached) and _w8a8_kernel (entry w8a8_matmul, the same kernel
// at L = 1).
//
// What bounds it on the H100: at decode (M = 256) each weight byte meets 256
// activation rows, 512 int8 operations a byte, just under the card's ~590
// op/byte ridge (1,979 TOP/s over 3.35 TB/s): reading the weight bounds it,
// with the tensor cores' rate close behind, so both the HBM stream and every
// SM's tensor cores have to be kept busy. At M >= 2,048 (the prefills) the
// operations bound it by far.
//
// Design.
// - A block is 3 warpgroups. Warpgroup 2 produces: one thread keeps a ring
//   of ST stages in flight by TMA, each an A tile [BM rows x 128 bytes of K]
//   and a weight tile [BN rows x 128 bytes], both with the 128-byte swizzle
//   the wgmma descriptors name, each stage guarded by a full and an empty
//   mbarrier. The weight comes through one 3-D tensor map over the whole
//   stacked [L, N, K] buffer, the layer a coordinate, so one map serves
//   every layer (K1' is the same map at L = 1). Maps are cached on the host
//   by pointer and shape; an activation a_q is a fresh tensor each call, but
//   PyTorch's caching allocator hands the same blocks to the same-sized
//   activations step after step, so its map is encoded once and found
//   again (hydragen_gemm_map_encodes counts the encodes). Ragged M, N and K
//   come back from TMA zero-filled and are masked at the store.
// - Warpgroups 0-1 consume: each owns BM / 2 rows (MW m64 tiles) and issues
//   wgmma m64nBNk32 s32.s8.s8 with A and B from shared memory, both K-major,
//   one commit group a stage, releasing a stage once the next one's group is
//   issued. setmaxnreg moves registers from the producer (40) to them (232).
// - At decode (M <= 256) a weight tile is read by one block (BM = 256) or by
//   two whose M tiles are side by side in the raster (BM = 128), so the
//   second read can find it in L2. More blocks come from splitting K over a
//   thread block cluster of `splits` blocks (ops/gemm.py:gemm_plan picks BM,
//   BN, the split and its steps by a cost model fitted to the measured
//   times: a K step's time follows the bytes a block takes into shared
//   memory, (BM + BN) x 128). The blocks of a cluster reduce their
//   i32 partials through distributed shared memory, so no partial goes to
//   device memory: block r owns rows [r BM / splits, (r + 1) BM / splits)
//   of the tile; each block pushes the accumulators of the rows it does not
//   own into their owner's idle ring, the cluster syncs, and each owner adds
//   the other blocks' parts to its registers in rank order and stores its
//   rows with the epilogue fused, straight from registers (scales staged in
//   shared memory by the producer's idle warps). Integer sums are
//   associative, so every split gives the same i32 sum and the output is
//   bit-identical to an unsplit product. One launch a call; no atomics, no
//   counters, no workspace.
// - The grid raster runs M fastest within groups of 16 M tiles, so the
//   blocks in flight share weight tiles (and, at the 32,768-row prefill, a
//   band of A) in L2.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ptx.cuh"

namespace {

__device__ __forceinline__ void store2(float* out, float x, float y) {
  *reinterpret_cast<float2*>(out) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x, y);
}

namespace w8 {

constexpr int BK = 128;            // bytes of K a stage: one 128-byte swizzle atom
constexpr int THREADS = 384;       // consumer warpgroups 0-1, producer 2
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int RING = 196608;       // bytes of the ring
constexpr int GROUP_M = 16;        // M tiles a raster group
constexpr int SCALES_BAR = 1;      // named barrier: the scales are staged
constexpr int STAGE_BAR = 2;       // named barrier: the output tile is staged

// MW: m64 tiles a consumer warpgroup owns (BM = 128 MW); BN: weight rows.
template <int MW, int BN>
struct Cfg {
  static constexpr int BM = 128 * MW;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE = A_BYTES + BN * BK;
  static constexpr int ST = RING / STAGE < 8 ? RING / STAGE : 8;
  static constexpr int BARS = ST * STAGE;      // full, then empty barriers
  static constexpr int SCALES = BARS + 2 * ST * 8;  // f32 row scales [BM], column scales [BN]
  static constexpr int ALLOC = SCALES + (BM + BN) * 4 + 1024;  // room to round the base up
  static_assert(ALLOC <= 232448, "shared memory of one block");
};

// Bytes of the other ranks' parts a rank receives: (splits - 1) x its 8 MW /
// splits row groups x 32 lanes x BN / 2 i32.
template <int MW, int BN>
__host__ __device__ constexpr int recv_bytes(int splits) {
  return (splits - 1) * (8 * MW / splits) * 64 * BN;
}

// The received parts and the staged output tile (f32 at most) fit in the ring
// at every split.
template <int MW, int BN>
__host__ __device__ constexpr bool epilogue_fits() {
  for (int s = 1; s <= 4; s *= 2)
    if (recv_bytes<MW, BN>(s) + 128 * MW / s * (BN * 4 + 16) > Cfg<MW, BN>::BARS) return false;
  return true;
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 128) {
    wgmma_s8_m64n128(d, a, b, 1);
  } else {
    wgmma_s8_m64n64(d, a, b, 1);
  }
}

// (f32(acc) * row scale) * column scale, the TPU kernel's order.
__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), rs), cs);
}


}  // namespace w8

// Grid: one block a (tile, split), the `splits` blocks of a tile adjacent
// and forming one cluster. split_tiles: 128-byte K steps a split covers (the
// last split takes the rest).
__device__ __forceinline__ float to_f32_scale(float s) { return s; }
__device__ __forceinline__ float to_f32_scale(__nv_bfloat16 s) { return __bfloat162float(s); }

template <int MW, int BN, typename OutT, typename ScaleT>
__global__ void __launch_bounds__(w8::THREADS, 1)
    w8a8_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ row_scale, const ScaleT* __restrict__ col_scale,
                OutT* __restrict__ out, int M, int N, int K, int layer, int splits,
                int split_tiles) {
  using C = w8::Cfg<MW, BN>;
  constexpr int BM = C::BM;
  static_assert(w8::epilogue_fits<MW, BN>(), "the epilogue fits in the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + C::ST;
  float* srs = reinterpret_cast<float*>(smem + C::SCALES);
  float* scs = srs + BM;

  // Tile of this block: M fastest within groups of GROUP_M M tiles.
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int first_m = tile / (w8::GROUP_M * n_tiles) * w8::GROUP_M;
  const int group_m = min(m_tiles - first_m, w8::GROUP_M);
  const int in_group = tile % (w8::GROUP_M * n_tiles);
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int k_tiles = (K + w8::BK - 1) / w8::BK;
  const int kt0 = split * split_tiles;
  const int n_k = max(0, min(kt0 + split_tiles, k_tiles) - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(w8::PRODUCER_REGS));
    const int pt = threadIdx.x - 256;
    if (pt >= 32) {
      // Warps 1-3 of the producer stage the tile's scales in f32 (0 past M
      // and N) while the ring fills, for the epilogue.
      for (int i = pt - 32; i < BM + BN; i += 96) {
        if (i < BM) {
          srs[i] = m0 + i < M ? row_scale[m0 + i] : 0.f;
        } else {
          scs[i - BM] = n0 + i - BM < N ? to_f32_scale(col_scale[n0 + i - BM]) : 0.f;
        }
      }
    } else if (pt == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&amap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      for (int i = 0; i < n_k; ++i) {
        const int s = i % C::ST;
        mbar_wait(&empty[s], ((i / C::ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE);
        const int k0 = (kt0 + i) * w8::BK;
        unsigned char* st = smem + s * C::STAGE;
        tma_load_2d(st, &amap, &full[s], k0, m0);
        tma_load_3d(st + C::A_BYTES, &wmap, &full[s], k0, n0, layer);
      }
    }
    __syncwarp();
    named_arrive(w8::SCALES_BAR, w8::THREADS);  // the scales are staged
    if (splits > 1) {  // the cluster's two syncs of the reduction, below
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(w8::CONSUMER_REGS));

  // Rows [wg * 64 MW, (wg + 1) * 64 MW) of the tile; the m64n BN accumulator
  // layout: thread (warp, g = lane / 4, t = lane % 4) holds rows 16 warp + g
  // (d[4j], d[4j + 1]) and + 8 (d[4j + 2], d[4j + 3]), columns 8j + 2t, + 1.
  constexpr int NA = BN / 2;
  int acc[MW][NA];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw)
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[mw][j] = 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const uint32_t ring = smem_u32(smem);
  for (int i = 0; i < n_k; ++i) {
    const int s = i % C::ST;
    mbar_wait(&full[s], (i / C::ST) & 1);
    const uint32_t a_base = ring + s * C::STAGE + wg * (64 * MW) * w8::BK;
    const uint32_t b_base = ring + s * C::STAGE + C::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < w8::BK / 32; ++kc) {
      const uint64_t bd = sw128_desc(b_base + kc * 32, 16, 1024);
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
        w8::wgmma_s8<BN>(acc[mw], sw128_desc(a_base + mw * 64 * w8::BK + kc * 32, 16, 1024),
                         bd);
    }
    wgmma_commit();
    // Stage i - 1's products are done once at most this stage's are pending.
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % C::ST]);
  }
  wgmma_wait<0>();

  // The K split's reduction. A row group of 16 (warp `warp` of warpgroup wg,
  // m64 tile mw) is a unit, u = (wg MW + mw) 4 + warp, owned by cluster rank
  // u / (8 MW / splits). Each thread pushes its part of every unit it does
  // not own into the owner's (idle) ring, in register order with the lanes
  // interleaved (16-byte vectors, no bank conflicts); the owner's thread of
  // the same index adds the other ranks' parts in rank order to its
  // registers and stores its units.
  const int warp = (tid % 128) / 32, g = lane >> 2, t = lane & 3;
  constexpr int V4 = NA / 4;  // 16-byte vectors of a thread's accumulator
  const int rank = splits > 1 ? static_cast<int>(cluster_ctarank()) : 0;
  const int per_rank = 8 * MW / splits;  // units a rank owns
  if (splits > 1) {
    const uint32_t recv = smem_u32(smem);
    // Slot of (sender q != owner o, unit u): [o's other ranks in rank
    // order][o's units][V4][32 lanes] x 16 bytes.
    auto slot = [&](int q, int o, int u) {
      return recv + ((((q < o ? q : q - 1) * per_rank + u % per_rank) * V4) * 32 + lane) * 16;
    };
    cluster_sync();  // every block of the cluster is done with its ring
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      const int u = (wg * MW + mw) * 4 + warp, o = u / per_rank;
      if (o == rank) continue;
      const uint32_t dst = cluster_map(slot(rank, o, u), o);
#pragma unroll
      for (int v = 0; v < V4; ++v)
        st_cluster_v4(dst + v * 512, make_int4(acc[mw][4 * v], acc[mw][4 * v + 1],
                                               acc[mw][4 * v + 2], acc[mw][4 * v + 3]));
    }
    cluster_sync();  // every part has arrived
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      const int u = (wg * MW + mw) * 4 + warp;
      if (u / per_rank != rank) continue;
      for (int q = 0; q < splits; ++q) {
        if (q == rank) continue;
        const int4* src = reinterpret_cast<const int4*>(smem + (slot(q, rank, u) - recv));
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const int4 x = src[v * 32];
          acc[mw][4 * v] += x.x;
          acc[mw][4 * v + 1] += x.y;
          acc[mw][4 * v + 2] += x.z;
          acc[mw][4 * v + 3] += x.w;
        }
      }
    }
  }

  // The epilogue: each owner scales its rows in registers into a row-major
  // tile of this rank's rows in OutT (after the received parts), then the
  // consumer threads store it 16 bytes a thread, rows contiguous.
  const int rows = BM / splits;
  constexpr int PITCH = BN * static_cast<int>(sizeof(OutT)) + 16;  // bytes a staged row
  unsigned char* stage = smem + w8::recv_bytes<MW, BN>(splits);
  named_sync(w8::SCALES_BAR, w8::THREADS);
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) {
    const int u = (wg * MW + mw) * 4 + warp;
    if (u / per_rank != rank) continue;
    const int r = (wg * MW + mw) * 64 + warp * 16 + g;  // row of the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float rs = srs[r + 8 * h];
      OutT* row = reinterpret_cast<OutT*>(stage + (r + 8 * h - rank * rows) * PITCH);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + t * 2;
        store2(row + c, w8::dequant(acc[mw][j * 4 + 2 * h], rs, scs[c]),
               w8::dequant(acc[mw][j * 4 + 2 * h + 1], rs, scs[c + 1]));
      }
    }
  }
  named_sync(w8::STAGE_BAR, 256);
  constexpr int CH = 16 / static_cast<int>(sizeof(OutT));  // elements a 16-byte chunk
  const bool vec = (N * static_cast<int>(sizeof(OutT))) % 16 == 0;
  for (int i = tid; i < rows * (BN / CH); i += 256) {
    const int lr = i / (BN / CH), c = (i % (BN / CH)) * CH;
    const int row = m0 + rank * rows + lr, col = n0 + c;
    if (row >= M || col >= N) continue;
    const unsigned char* src = stage + lr * PITCH + c * static_cast<int>(sizeof(OutT));
    OutT* dst = out + (size_t)row * N + col;
    if (vec && col + CH <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < CH && col + e < N; ++e) dst[e] = reinterpret_cast<const OutT*>(src)[e];
    }
  }
}

// ---------------------------------------------------------------------------
// w4a8_kernel: y[M,N] = row_scale[M] * sum_g gscale[layer][g,N] * i32(a_s8[M,
// K_g] . w4[layer][N, K_g]^T), the int4 weight planar-packed [L, N, K/2]
// (byte j: in-feature j in the low nibble, j + K/2 in the high one) with bf16
// group scales [L, G, N]. Replaces the TPU kernels
// hydragen_tpu/ops/gemm.py:_w4a8_cached_kernel (entry w4a8_matmul_cached) and
// _w4a8_kernel (entry w4a8_matmul, the same kernel at L = 1).
//
// What bounds it on the H100: at decode (M = 256) each packed weight byte is
// two int4 weights used 256 times each, 1,024 int8 operations a byte, above
// the card's ~590 op/byte ridge: the int8 tensor-core rate bounds it, with
// the weight read (half of w8a8's) close behind. At prefill the tensor cores
// bound it by far.
//
// Design.
// - The product is computed transposed, D^T[n, m] = W[n, :] . A[m, :]^T:
//   the weight rows are wgmma's M (BW = 64 a block) and the activation rows
//   its N, so a block tile of 64 weight rows x BA activation rows fills the
//   card at decode without a K split (M = 256, BA = 128: 128 blocks at
//   N = 4,096, 352 at 11,264), and the group scales, which belong to weight
//   rows, belong to accumulator rows.
// - A block is 3 warpgroups. Warpgroup 2 produces: one thread keeps a ring
//   of stages in flight by TMA, each the packed weight tile [64 rows x 128
//   packed bytes] (one 3-D map over [L, N, K/2], the layer a coordinate) and
//   the two activation tiles it meets, [BA rows x 128 bytes] at column k0
//   and at K/2 + k0, all with the 128-byte swizzle, each stage guarded by a
//   full and an empty mbarrier. TMA zero-fills what lies past N, M and K/2;
//   a zero packed byte is two zero weights, so ragged packed K needs no mask.
// - Warpgroups 0-1 consume, each BA / 2 activation rows against all 64
//   weight rows, with wgmma m64nNk32 s32.s8.s8 in its register-A form: at a
//   stage's start each lane reads its sixteen packed words of the weight
//   tile through the swizzle (conflict-free), and each k32 step unpacks four
//   of them in registers into the A fragments of both planes, 16 x each int4
//   value in two logic ops a plane (a sign extension takes six); B is the
//   activation tile, K-major, from shared memory. A k32 step (one wgmma a
//   plane) is a commit group, and PIPE of them stay in flight, each with
//   its own A registers.
// - The low plane's products go to one i32 accumulator and the high plane's
//   to another. At the end of each scale group (a whole number of k32 steps,
//   inside one plane, ending in both planes at the same packed column) the
//   warpgroup waits for its products, converts each sum to f32 and adds it
//   x its group's scale / 16 to the f32 sum: the TPU kernel's order (i32
//   group sum x group scale, summed in f32, x row scale), bit for bit as
//   with unscaled sums. The next group's first products overwrite the i32
//   sums. This flush, one conversion and one FMA an output element a plane
//   a group, is the kernel's largest cost after the products; it cannot
//   overlap them (ptxas serialises every wgmma where a second accumulator
//   set is read while the first is in flight). The group scales come by
//   cp.async into shared memory two groups ahead of their flush.
// - Epilogue: x row scale (staged in shared memory by the producer's idle
//   warps), rounded once to the output type, transposed through the idle
//   ring and stored 16 bytes a thread along N.
// - The grid raster runs M fastest within groups of 16 M tiles, so the
//   blocks that read one weight tile are side by side and its second read
//   finds it in L2.

namespace w4 {

constexpr int BW = 64;             // weight rows a block: wgmma's M
constexpr int BKP = 128;           // packed bytes a stage: one 128-byte swizzle atom
constexpr int THREADS = 384;       // consumer warpgroups 0-1, producer 2
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int RING = 225280;       // bytes of the ring at most
constexpr int GROUP_M = 16;        // M tiles a raster group
constexpr int SCALES_BAR = 1;      // named barrier: the row scales are staged
constexpr int STAGE_BAR = 2;       // named barrier: the consumers' ring / output tile

// NA: activation rows a consumer warpgroup (wgmma's N); BA = 2 NA a block.
template <int NA>
struct Cfg {
  static constexpr int BA = 2 * NA;
  // k32 steps in flight a warpgroup: one A buffer (8 registers) each.
  static constexpr int PIPE = NA == 64 ? 4 : 2;
  static constexpr int W_BYTES = BW * BKP;
  static constexpr int A_BYTES = BA * BKP;  // one plane's activation tile
  static constexpr int STAGE = W_BYTES + 2 * A_BYTES;
  static constexpr int ST = RING / STAGE < 8 ? RING / STAGE : 8;
  static constexpr int BARS = ST * STAGE;       // full, then empty barriers
  static constexpr int SCALES = BARS + 2 * ST * 8;  // f32 row scales [BA]
  // Group scales: a slot of bf16 [2 planes][16 rows] for each consumer warp
  // and each of 3 groups in flight.
  static constexpr int GSCALES = SCALES + BA * 4;
  static constexpr int ALLOC = GSCALES + 8 * 3 * 64 + 1024;  // room to round the base up
  static_assert(ALLOC <= 232448, "shared memory of one block");
  // The staged output tile (f32 at most) fits in the ring.
  static_assert(BA * (BW * 4 + 16) <= BARS, "the output tile fits in the ring");
};

// Four packed bytes -> 16 x their four int4 values as s8, per plane: the
// nibble lands in the high half of its byte, its sign bit in the byte's.
// Two logic ops where a sign extension takes six; the group sums are 16 x
// the true ones, and the scales are taken / 16 (exact in f32).
__device__ __forceinline__ unsigned nibbles16_lo(unsigned x) { return (x << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ unsigned nibbles16_hi(unsigned x) { return x & 0xF0F0F0F0u; }

template <int NA>
__device__ __forceinline__ void wgmma_rs(int* d, const unsigned* a, uint64_t b, int scale_d) {
  if constexpr (NA == 128) {
    wgmma_s8_m64n128_rs(d, a, b, scale_d);
  } else {
    wgmma_s8_m64n64_rs(d, a, b, scale_d);
  }
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

}  // namespace w4

// Grid: one block a (BA x 64) tile of the output. gscale is the layer's
// [G, N]; group: in-features a scale group (a multiple of 64 dividing K/2).
template <int NA, typename OutT>
__global__ void __launch_bounds__(w4::THREADS, 1)
    w4a8_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ row_scale, const __nv_bfloat16* __restrict__ gscale,
                OutT* __restrict__ out, int M, int N, int K, int layer, int group) {
  using W = w4::Cfg<NA>;
  constexpr int BA = W::BA, BW = w4::BW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::BARS);
  uint64_t* empty = full + W::ST;
  float* srs = reinterpret_cast<float*>(smem + W::SCALES);

  // Tile of this block: M fastest within groups of GROUP_M M tiles.
  const int m_tiles = (M + BA - 1) / BA, n_tiles = (N + BW - 1) / BW;
  const int first_m = blockIdx.x / (w4::GROUP_M * n_tiles) * w4::GROUP_M;
  const int group_m = min(m_tiles - first_m, w4::GROUP_M);
  const int in_group = blockIdx.x % (w4::GROUP_M * n_tiles);
  const int m0 = (first_m + in_group % group_m) * BA;
  const int n0 = (in_group / group_m) * BW;
  const int Kp = K / 2;
  const int n_k = (Kp + w4::BKP - 1) / w4::BKP;

  if (threadIdx.x == 0) {
    for (int st = 0; st < W::ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(w4::PRODUCER_REGS));
    const int pt = threadIdx.x - 256;
    if (pt >= 32) {
      // Warps 1-3 of the producer stage the tile's row scales (0 past M)
      // while the ring fills, for the epilogue.
      for (int i = pt - 32; i < BA; i += 96) srs[i] = m0 + i < M ? row_scale[m0 + i] : 0.f;
    } else if (pt == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&amap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      for (int i = 0; i < n_k; ++i) {
        const int st = i % W::ST;
        mbar_wait(&empty[st], ((i / W::ST) & 1) ^ 1);
        mbar_expect_tx(&full[st], W::STAGE);
        const int k0 = i * w4::BKP;
        unsigned char* dst = smem + st * W::STAGE;
        tma_load_3d(dst, &wmap, &full[st], k0, n0, layer);
        tma_load_2d(dst + W::W_BYTES, &amap, &full[st], k0, m0);
        tma_load_2d(dst + W::W_BYTES + W::A_BYTES, &amap, &full[st], Kp + k0, m0);
      }
    }
    __syncwarp();
    named_arrive(w4::SCALES_BAR, w4::THREADS);  // the row scales are staged
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(w4::CONSUMER_REGS));

  // The m64nNA accumulator layout, transposed: thread (warp, g = lane / 4,
  // t = lane % 4) holds weight rows 16 warp + g (d[4j], d[4j + 1]) and + 8
  // (d[4j + 2], d[4j + 3]), activation rows wg NA + 8j + 2t, + 1.
  constexpr int NR = NA / 2;
  int acc_lo[NR], acc_hi[NR];
  float accf[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    acc_lo[j] = acc_hi[j] = 0;
    accf[j] = 0.f;
  }
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % 128) / 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // the thread's first weight row in the tile
  const int group_steps = group / 32, half_groups = Kp / group;
  const uint32_t ring = smem_u32(smem);
  unsigned afrag[W::PIPE][8];  // [buffer][low plane a0-a3, high plane a0-a3]

  // The group scales, staged by cp.async two groups ahead of their flush
  // (a load into registers would stall the warp at its first use): lanes
  // 0-15 of each consumer warp copy its 16 weight rows' scales of both
  // planes (0 past N) into the warp's slot for the group.
  const unsigned char* gslot0 = smem + W::GSCALES + (threadIdx.x / 32) * 3 * 64;
  const uint32_t gslots = smem_u32(gslot0);
  auto stage_scales = [&](int gi) {
    if (lane < 16 && gi < half_groups) {
      const int n = n0 + warp * 16 + 2 * (lane & 7);
      const __nv_bfloat16* src = gscale + (size_t)(gi + (lane >> 3) * half_groups) * N + n;
      cp_async4(gslots + (gi % 3) * 64 + lane * 4, n < N ? src : gscale, n < N);
    }
    cp_async_commit();
  };
  stage_scales(0);
  stage_scales(1);

  int gstep = 0, gi = 0, scale_d = 1;
  for (int i = 0; i < n_k; ++i) {
    const int st = i % W::ST;
    mbar_wait(&full[st], (i / W::ST) & 1);
    const unsigned char* wt = smem + st * W::STAGE;
    const uint32_t lo_base = ring + st * W::STAGE + W::W_BYTES + wg * NA * w4::BKP;
    const uint32_t hi_base = lo_base + W::A_BYTES;
    // The stage's packed words at the A-fragment positions, read at once (the
    // wgmmas' fences keep a read from moving past them): step kc's rows r0
    // and r0 + 8 (both = g mod 8), 16-byte chunks 2 kc and 2 kc + 1 of the
    // swizzled row, chunk c lying at c ^ (row mod 8).
    unsigned packed[w4::BKP / 32][4];
#pragma unroll
    for (int kc = 0; kc < w4::BKP / 32; ++kc)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        packed[kc][q] = *reinterpret_cast<const unsigned*>(
            wt + (r0 + 8 * (q & 1)) * w4::BKP + (((2 * kc + (q >> 1)) ^ g) << 4) + 4 * t);
#pragma unroll
    for (int kc = 0; kc < w4::BKP / 32; ++kc) {
      unsigned* a = afrag[kc % W::PIPE];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = w4::nibbles16_lo(packed[kc][q]);
        a[4 + q] = w4::nibbles16_hi(packed[kc][q]);
      }
      wgmma_fence();
      w4::wgmma_rs<NA>(acc_lo, a, sw128_desc(lo_base + kc * 32, 16, 1024), scale_d);
      w4::wgmma_rs<NA>(acc_hi, a + 4, sw128_desc(hi_base + kc * 32, 16, 1024), scale_d);
      wgmma_commit();
      scale_d = 1;
      // Past K/2 (a last stage half zero) no group ends.
      if (++gstep == group_steps && gi < half_groups) {
        // End of group gi of each plane: low plane group gi, high plane
        // group gi + G/2 of the [G, N] scales, / 16 for the unpacked x16.
        // The next group's first products overwrite the i32 sums.
        gstep = 0;
        cp_async_wait<1>();  // group gi's scales are in (gi + 1's may not be)
        __syncwarp();
        const __nv_bfloat16* gsc =
            reinterpret_cast<const __nv_bfloat16*>(gslot0 + (gi % 3) * 64);
        const float sc[4] = {__bfloat162float(gsc[g]) * 0.0625f,
                             __bfloat162float(gsc[g + 8]) * 0.0625f,
                             __bfloat162float(gsc[16 + g]) * 0.0625f,
                             __bfloat162float(gsc[16 + g + 8]) * 0.0625f};
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int h = (j >> 1) & 1;  // d[4j + 2], d[4j + 3]: row + 8
          accf[j] = __fmaf_rn(static_cast<float>(acc_lo[j]), sc[h], accf[j]);
          accf[j] = __fmaf_rn(static_cast<float>(acc_hi[j]), sc[2 + h], accf[j]);
        }
        __syncwarp();  // every lane has read the slot group gi + 3 will take
        stage_scales(++gi + 1);
        scale_d = 0;
      } else {
        // The step PIPE - 1 back is done: its A buffer takes the next step.
        wgmma_wait<W::PIPE - 1>();
      }
      // Stage i - 1's last step (PIPE - 1 steps back) is done: release it.
      if (kc == W::PIPE - 2 && i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % W::ST]);
    }
  }
  wgmma_wait<0>();

  // Epilogue: x row scale, staged transposed as a row-major [BA, 64] tile of
  // OutT in the idle ring, then stored 16 bytes a thread, rows contiguous.
  constexpr int PITCH = BW * static_cast<int>(sizeof(OutT)) + 16;  // bytes a staged row
  named_sync(w4::SCALES_BAR, w4::THREADS);
  named_sync(w4::STAGE_BAR, 256);  // both consumer warpgroups are done with the ring
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int ml = wg * NA + (j >> 2) * 8 + 2 * t + (j & 1);
    const int nl = r0 + 8 * ((j >> 1) & 1);
    w4::put(reinterpret_cast<OutT*>(smem + ml * PITCH) + nl, accf[j] * srs[ml]);
  }
  named_sync(w4::STAGE_BAR, 256);
  constexpr int VEC = 16 / static_cast<int>(sizeof(OutT));  // elements a 16-byte store
  const bool vec = (N * static_cast<int>(sizeof(OutT))) % 16 == 0;
  for (int i = threadIdx.x; i < BA * (BW / VEC); i += 256) {
    const int lr = i / (BW / VEC), c = (i % (BW / VEC)) * VEC;
    const int row = m0 + lr, col = n0 + c;
    if (row >= M || col >= N) continue;
    const unsigned char* src = smem + lr * PITCH + c * static_cast<int>(sizeof(OutT));
    OutT* dst = out + (size_t)row * N + col;
    if (vec && col + VEC <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < VEC && col + e < N; ++e) dst[e] = reinterpret_cast<const OutT*>(src)[e];
    }
  }
}

// The GEMMs' tensor maps, cached by pointer and shape: a weight [L, N, K]
// (K1) or [L, N, K/2] (K6) with boxes [1, rows, 128] and an activation
// [M, K] with boxes [rows, 128], bytes with the 128-byte swizzle. An entry is
// only an address and a shape, so a stale one is harmless.
struct GemmMap {
  const void* ptr;
  long long dims[3];
  int box;
  CUtensorMap map;
};
constexpr int GEMM_MAP_CACHE = 64;
GemmMap g_gemm_maps[GEMM_MAP_CACHE];
int g_gemm_map_count = 0, g_gemm_map_next = 0;
long long g_gemm_encodes = 0;

// rank 2: [d1, d0]; rank 3: [d2, d1, d0] (d0 = K innermost).
int gemm_map(CUtensorMap* out, const void* ptr, int rank, long long d0, long long d1,
             long long d2, int box) {
  for (int i = 0; i < g_gemm_map_count; ++i) {
    const GemmMap& m = g_gemm_maps[i];
    if (m.ptr == ptr && m.dims[0] == d0 && m.dims[1] == d1 && m.dims[2] == d2 && m.box == box) {
      *out = m.map;
      return 0;
    }
  }
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  cuuint64_t strides[2] = {(cuuint64_t)d0, (cuuint64_t)(d0 * d1)};
  cuuint32_t boxes[3] = {(cuuint32_t)w8::BK, (cuuint32_t)box, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  GemmMap& m = g_gemm_maps[g_gemm_map_next];
  CUresult r = fn(&m.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims,
                  strides, boxes, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  ++g_gemm_encodes;
  m.ptr = ptr;
  m.dims[0] = d0;
  m.dims[1] = d1;
  m.dims[2] = d2;
  m.box = box;
  *out = m.map;
  g_gemm_map_next = (g_gemm_map_next + 1) % GEMM_MAP_CACHE;
  if (g_gemm_map_count < GEMM_MAP_CACHE) ++g_gemm_map_count;
  return 0;
}

struct W8a8Call {
  const void* a;
  const void* row_scale;
  const void* w;
  const void* col_scale;
  void* out;
  int M, N, K, L, layer, splits, split_tiles;
};

// The launch of one (MW, BN, OutT, ScaleT) instantiation: grid and cluster,
// or, with `max_clusters` set, only how many of its clusters the card holds at
// once.
template <int MW, int BN, typename OutT, typename ScaleT>
int launch_w8a8(const W8a8Call& c, cudaStream_t st, int* max_clusters = nullptr) {
  using C = w8::Cfg<MW, BN>;
  auto kernel = w8a8_kernel<MW, BN, OutT, ScaleT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles = ((c.M + C::BM - 1) / C::BM) * ((c.N + BN - 1) / BN);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c.splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * c.splits);
  cfg.blockDim = dim3(w8::THREADS);
  cfg.dynamicSmemBytes = C::ALLOC;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg));
  CUtensorMap amap, wmap;
  int e = gemm_map(&amap, c.a, 2, c.K, c.M, 1, C::BM);
  if (e == 0) e = gemm_map(&wmap, c.w, 3, c.K, c.N, c.L, BN);
  if (e != 0) return e;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, amap, wmap, static_cast<const float*>(c.row_scale),
      static_cast<const ScaleT*>(c.col_scale), static_cast<OutT*>(c.out), c.M, c.N, c.K,
      c.layer, c.splits, c.split_tiles));
}

template <typename OutT, typename ScaleT>
int dispatch_w8a8(const W8a8Call& c, int bm, int bn, cudaStream_t st, int* max_clusters) {
  if (bm == 256 && bn == 128) return launch_w8a8<2, 128, OutT, ScaleT>(c, st, max_clusters);
  if (bm == 256 && bn == 64) return launch_w8a8<2, 64, OutT, ScaleT>(c, st, max_clusters);
  if (bm == 128 && bn == 128) return launch_w8a8<1, 128, OutT, ScaleT>(c, st, max_clusters);
  if (bm == 128 && bn == 64) return launch_w8a8<1, 64, OutT, ScaleT>(c, st, max_clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename OutT>
int dispatch_w8a8_scale(const W8a8Call& c, int bm, int bn, int scale_f32, cudaStream_t st) {
  return scale_f32 ? dispatch_w8a8<OutT, float>(c, bm, bn, st, nullptr)
                   : dispatch_w8a8<OutT, __nv_bfloat16>(c, bm, bn, st, nullptr);
}

// One K6 launch of the (NA, OutT) instantiation; gscale is the layer's [G, N].
template <int NA, typename OutT>
int launch_w4a8(const void* a, const void* row_scale, const void* w, const void* gscale,
                void* out, int M, int N, int K, int L, int layer, int group, cudaStream_t st) {
  using W = w4::Cfg<NA>;
  auto kernel = w4a8_kernel<NA, OutT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap amap, wmap;
  int e = gemm_map(&amap, a, 2, K, M, 1, W::BA);
  if (e == 0) e = gemm_map(&wmap, w, 3, K / 2, N, L, w4::BW);
  if (e != 0) return e;
  const int blocks = ((M + W::BA - 1) / W::BA) * ((N + w4::BW - 1) / w4::BW);
  kernel<<<blocks, w4::THREADS, W::ALLOC, st>>>(
      amap, wmap, static_cast<const float*>(row_scale),
      static_cast<const __nv_bfloat16*>(gscale), static_cast<OutT*>(out), M, N, K, layer, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int dispatch_w4a8(const void* a, const void* row_scale, const void* w, const void* gscale,
                  void* out, int M, int N, int K, int L, int layer, int group, int ba,
                  cudaStream_t st) {
  if (ba == 128)
    return launch_w4a8<64, OutT>(a, row_scale, w, gscale, out, M, N, K, L, layer, group, st);
  if (ba == 256)
    return launch_w4a8<128, OutT>(a, row_scale, w, gscale, out, M, N, K, L, layer, group, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int hydragen_w8a8_gemm(const void* a, const void* row_scale, const void* w,
                                  const void* col_scale, void* out, int M, int N, int K, int L,
                                  int layer, int bm, int bn, int splits, int split_tiles,
                                  int out_bf16, int scale_f32, void* stream) {
  const int k_tiles = (K + w8::BK - 1) / w8::BK;
  if (M < 1 || N < 2 || N % 2 || K < 16 || K % 16 || layer < 0 || layer >= L ||
      (splits != 1 && splits != 2 && splits != 4) || split_tiles < 1 ||
      (splits - 1) * split_tiles >= k_tiles || splits * split_tiles < k_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const W8a8Call c{a, row_scale, w, col_scale, out, M, N, K, L, layer, splits, split_tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch_w8a8_scale<__nv_bfloat16>(c, bm, bn, scale_f32, st)
                  : dispatch_w8a8_scale<float>(c, bm, bn, scale_f32, st);
}

// How many clusters of K1's (bm, bn, splits) launch the card holds at once
// (0 with an error code in `status`): the cluster's blocks must share a GPC.
extern "C" int hydragen_w8a8_max_clusters(int bm, int bn, int splits, int* status) {
  const W8a8Call c{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 2, 128, 1, 0, splits, 1};
  int n = 0;
  *status = dispatch_w8a8<__nv_bfloat16, __nv_bfloat16>(c, bm, bn, nullptr, &n);
  return n;
}

// Tensor maps K1 and K6 have encoded since the library was loaded (cache
// misses).
extern "C" long long hydragen_gemm_map_encodes() { return g_gemm_encodes; }

// K6 on layer `layer` of the packed weight w [L, N, K/2]; gscale is that
// layer's [G, N]; ba: activation rows a block (128 or 256, ops/gemm.py:
// w4a8_tile).
extern "C" int hydragen_w4a8_gemm(const void* a, const void* row_scale, const void* w,
                                  const void* gscale, void* out, int M, int N, int K, int L,
                                  int layer, int group, int ba, int out_bf16, void* stream) {
  if (M < 1 || N < 2 || N % 2 || K % 2 || group < 64 || group % 64 || (K / 2) % group ||
      layer < 0 || layer >= L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch_w4a8<__nv_bfloat16>(a, row_scale, w, gscale, out, M, N, K, L,
                                                 layer, group, ba, st)
                  : dispatch_w4a8<float>(a, row_scale, w, gscale, out, M, N, K, L, layer,
                                         group, ba, st);
}
