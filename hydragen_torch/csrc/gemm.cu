// W8A8 and W4A8 GEMMs for Hopper.
//
// K1, w8a8_kernel: y[M,N] = (f32(i32(a_s8[M,K] . w_s8[layer][N,K]^T)) *
// row_scale[M]) * col_scale[N], rounded once to bf16 or f32. Replaces the
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
template <int MW, int BN, typename OutT>
__global__ void __launch_bounds__(w8::THREADS, 1)
    w8a8_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ row_scale, const __nv_bfloat16* __restrict__ col_scale,
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
          scs[i - BM] = n0 + i - BM < N ? __bfloat162float(col_scale[n0 + i - BM]) : 0.f;
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
// w4a8_kernel: y[M,N] = row_scale[M] * sum_g gscale[g,N] * i32(a_s8[M, K_g] .
// w4[N, K_g]^T), the int4 weight planar-packed [N, K/2] (byte j: in-feature j
// in the low nibble, j + K/2 in the high one) with bf16 group scales [G, N].
// Replaces the TPU kernels hydragen_tpu/ops/gemm.py:_w4a8_cached_kernel
// (entry w4a8_matmul_cached) and _w4a8_kernel (entry w4a8_matmul).
//
// What bounds it on the H100: at decode (M = 256) each packed weight byte is
// two int4 weights used 256 times each, 1,024 int8 operations a byte, above
// the card's ~590 op/byte ridge: the int8 tensor-core rate bounds it, with
// the weight read (half of w8a8's) close behind. At prefill the tensor cores
// bound it by far.
// Design: mma.sync s8 m16n8k32, a 64x128 block tile and a two-stage
// cp.async ring over the PACKED K: each step loads 64 packed
// bytes of 128 weight rows, and the two matching 64-byte column tiles of the
// activations, at column k and at column K/2 + k. The weight fragments are
// unpacked in registers as they are read from shared memory: four packed
// bytes in one 32-bit word give four sign-extended low nibbles and four high
// ones (mask, then (u ^ 8) - 8 per byte), so both planes come from one load.
// The low plane's products go to one i32 accumulator and the high plane's to
// another; at the end of each scale group (a whole number of 64-byte steps,
// inside one plane) each is multiplied by its group's scale into the f32
// accumulator and cleared, and the row scale is applied at the store: the
// TPU kernel's order (i32 group sum x group scale, summed in f32, x row
// scale). 8 warps of 32x32 keep the three accumulators in registers.

namespace w4 {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BKP = 64;        // packed bytes (= in-features of one plane) per step
constexpr int LDS = BKP + 16;  // padded smem row, bytes
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N, 32x32 each

// Four packed bytes -> four sign-extended int4 values as s8, per plane.
__device__ __forceinline__ unsigned nibbles_lo(unsigned x) {
  return __vsub4((x & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ unsigned nibbles_hi(unsigned x) {
  return __vsub4(((x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

}  // namespace w4

template <typename OutT>
__global__ void __launch_bounds__(w4::THREADS)
w4a8_kernel(const int8_t* __restrict__ a, const float* __restrict__ row_scale,
            const int8_t* __restrict__ w, const __nv_bfloat16* __restrict__ gscale,
            OutT* __restrict__ out, int M, int N, int K, int group) {
  constexpr int BM = w4::BM, BN = w4::BN, BKP = w4::BKP, LDS = w4::LDS;
  constexpr int THREADS = w4::THREADS;
  __shared__ __align__(16) int8_t As[2][2][BM][LDS];  // [stage][plane]
  __shared__ __align__(16) int8_t Ws[2][BN][LDS];

  const int Kp = K / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 32;
  const int wn = (warp & 3) * 32;

  auto load_tile = [&](int stage, int kp0) {
    // Activations: 2 planes x BM rows x 4 chunks of 16 bytes.
#pragma unroll
    for (int i = 0; i < (2 * BM * BKP / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int plane = c / (BM * BKP / 16);
      const int cc = c % (BM * BKP / 16);
      const int row = cc >> 2, col = (cc & 3) * 16;
      const int gm = m0 + row;
      const bool ok = gm < M;
      const int8_t* src = ok ? a + (size_t)gm * K + plane * Kp + kp0 + col : a;
      cp_async16(smem_u32(&As[stage][plane][row][col]), src, ok);
    }
    // Packed weights: BN rows x 4 chunks.
#pragma unroll
    for (int i = 0; i < (BN * BKP / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, col = (c & 3) * 16;
      const int gn = n0 + row;
      const bool ok = gn < N;
      const int8_t* src = ok ? w + (size_t)gn * Kp + kp0 + col : w;
      cp_async16(smem_u32(&Ws[stage][row][col]), src, ok);
    }
  };

  int acc[2][2][4][4];  // [plane][mi][ni][r]: this group's i32 sums
  float accf[2][4][4];  // scaled sums of the groups done
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[0][mi][ni][r] = acc[1][mi][ni][r] = 0;
        accf[mi][ni][r] = 0.f;
      }

  const int ktiles = Kp / BKP;
  const int tiles_per_group = group / BKP;
  const int half_groups = Kp / group;  // groups in one plane
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < ktiles) load_tile(s ^ 1, (kt + 1) * BKP);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKP; kk += 32) {
      unsigned af[2][2][4], bl[4][2], bh[4][2];
#pragma unroll
      for (int plane = 0; plane < 2; ++plane)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm + mi * 16 + g;
          af[plane][mi][0] = *reinterpret_cast<const unsigned*>(&As[s][plane][r][kk + t * 4]);
          af[plane][mi][1] = *reinterpret_cast<const unsigned*>(&As[s][plane][r + 8][kk + t * 4]);
          af[plane][mi][2] = *reinterpret_cast<const unsigned*>(&As[s][plane][r][kk + 16 + t * 4]);
          af[plane][mi][3] =
              *reinterpret_cast<const unsigned*>(&As[s][plane][r + 8][kk + 16 + t * 4]);
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wn + ni * 8 + g;
        const unsigned x0 = *reinterpret_cast<const unsigned*>(&Ws[s][r][kk + t * 4]);
        const unsigned x1 = *reinterpret_cast<const unsigned*>(&Ws[s][r][kk + 16 + t * 4]);
        bl[ni][0] = w4::nibbles_lo(x0);
        bl[ni][1] = w4::nibbles_lo(x1);
        bh[ni][0] = w4::nibbles_hi(x0);
        bh[ni][1] = w4::nibbles_hi(x1);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_s8(acc[0][mi][ni], af[0][mi], bl[ni]);
          mma_s8(acc[1][mi][ni], af[1][mi], bh[ni]);
        }
    }
    __syncthreads();
    if ((kt + 1) % tiles_per_group == 0) {
      // End of group gi of each plane: low plane group gi, high plane group
      // gi + G/2 of the [G, N] scales.
      const int gi = kt / tiles_per_group;
      const __nv_bfloat16* gs_lo = gscale + (size_t)gi * N;
      const __nv_bfloat16* gs_hi = gscale + (size_t)(gi + half_groups) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + t * 2;
        float slo[2], shi[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = col + c < N;
          slo[c] = ok ? __bfloat162float(gs_lo[col + c]) : 0.f;
          shi[c] = ok ? __bfloat162float(gs_hi[col + c]) : 0.f;
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            accf[mi][ni][r] += (float)acc[0][mi][ni][r] * slo[r & 1];
            accf[mi][ni][r] += (float)acc[1][mi][ni][r] * shi[r & 1];
            acc[0][mi][ni][r] = acc[1][mi][ni][r] = 0;
          }
      }
    }
  }

  // Epilogue: acc * row_scale, the TPU kernel's emit.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float rs = row_scale[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + t * 2;
        if (col >= N) continue;
        const float x = accf[mi][ni][half * 2] * rs;
        OutT* dst = out + (size_t)row * N + col;
        if (col + 1 < N) {
          store2(dst, x, accf[mi][ni][half * 2 + 1] * rs);
        } else {
          store1(dst, x);
        }
      }
    }
  }
}

// K1's tensor maps, cached by pointer and shape: the weight [L, N, K] with
// boxes [1, BN, 128] and an activation [M, K] with boxes [BM, 128], bytes
// with the 128-byte swizzle. An entry is only an address and a shape, so a
// stale one is harmless.
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

// The launch of one (MW, BN, OutT) instantiation: grid and cluster, or, with
// `max_clusters` set, only how many of its clusters the card holds at once.
template <int MW, int BN, typename OutT>
int launch_w8a8(const W8a8Call& c, cudaStream_t st, int* max_clusters = nullptr) {
  using C = w8::Cfg<MW, BN>;
  auto kernel = w8a8_kernel<MW, BN, OutT>;
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
      static_cast<const __nv_bfloat16*>(c.col_scale), static_cast<OutT*>(c.out), c.M, c.N, c.K,
      c.layer, c.splits, c.split_tiles));
}

template <typename OutT>
int dispatch_w8a8(const W8a8Call& c, int bm, int bn, cudaStream_t st, int* max_clusters) {
  if (bm == 256 && bn == 128) return launch_w8a8<2, 128, OutT>(c, st, max_clusters);
  if (bm == 256 && bn == 64) return launch_w8a8<2, 64, OutT>(c, st, max_clusters);
  if (bm == 128 && bn == 128) return launch_w8a8<1, 128, OutT>(c, st, max_clusters);
  if (bm == 128 && bn == 64) return launch_w8a8<1, 64, OutT>(c, st, max_clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int hydragen_w8a8_gemm(const void* a, const void* row_scale, const void* w,
                                  const void* col_scale, void* out, int M, int N, int K, int L,
                                  int layer, int bm, int bn, int splits, int split_tiles,
                                  int out_bf16, void* stream) {
  const int k_tiles = (K + w8::BK - 1) / w8::BK;
  if (M < 1 || N < 2 || N % 2 || K < 16 || K % 16 || layer < 0 || layer >= L ||
      (splits != 1 && splits != 2 && splits != 4) || split_tiles < 1 ||
      (splits - 1) * split_tiles >= k_tiles || splits * split_tiles < k_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const W8a8Call c{a, row_scale, w, col_scale, out, M, N, K, L, layer, splits, split_tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch_w8a8<__nv_bfloat16>(c, bm, bn, st, nullptr)
                  : dispatch_w8a8<float>(c, bm, bn, st, nullptr);
}

// How many clusters of K1's (bm, bn, splits) launch the card holds at once
// (0 with an error code in `status`): the cluster's blocks must share a GPC.
extern "C" int hydragen_w8a8_max_clusters(int bm, int bn, int splits, int* status) {
  const W8a8Call c{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 2, 128, 1, 0, splits, 1};
  int n = 0;
  *status = dispatch_w8a8<__nv_bfloat16>(c, bm, bn, nullptr, &n);
  return n;
}

// Tensor maps K1 has encoded since the library was loaded (cache misses).
extern "C" long long hydragen_gemm_map_encodes() { return g_gemm_encodes; }

extern "C" int hydragen_w4a8_gemm(const void* a, const void* row_scale, const void* w,
                                  const void* gscale, void* out, int M, int N, int K,
                                  int group, int out_bf16, void* stream) {
  if (K % 2 || group % w4::BKP || (K / 2) % group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((N + w4::BN - 1) / w4::BN, (M + w4::BM - 1) / w4::BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    w4a8_kernel<__nv_bfloat16><<<grid, w4::THREADS, 0, st>>>(
        static_cast<const int8_t*>(a), static_cast<const float*>(row_scale),
        static_cast<const int8_t*>(w), static_cast<const __nv_bfloat16*>(gscale),
        static_cast<__nv_bfloat16*>(out), M, N, K, group);
  } else {
    w4a8_kernel<float><<<grid, w4::THREADS, 0, st>>>(
        static_cast<const int8_t*>(a), static_cast<const float*>(row_scale),
        static_cast<const int8_t*>(w), static_cast<const __nv_bfloat16*>(gscale),
        static_cast<float*>(out), M, N, K, group);
  }
  return static_cast<int>(cudaGetLastError());
}
