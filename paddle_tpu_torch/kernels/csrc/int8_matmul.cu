// Weight-only dequant-matmul for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/int8_matmul.py:124
// (_pallas_matmul :103, bodies _kernel_int8 :61 and _kernel_int4 :80):
//
//   out[M, N] = x[M, K] @ (w_q[K, N] * scale[N])     (out in x's type)
//
// w_q is int8 per out channel ([K, N], unit column stride, row stride
// ldw >= N: a column slice of a wider weight is read in place), or int4
// packed two per byte along K ([ceil(K/2), N]: row 2r in the low nibble,
// 2r+1 in the high one, each sign-extended). The weight never exists in
// fp, in device memory or in shared memory.
//
// Bound. The serving step multiplies M = 128 rows (the ragged step's T;
// 8 in a layer-scope burst's append) by the 7B projections. At 3.35 TB/s
// and 989 TFLOP/s (bf16): q/k/v/o 128 x 4096 x 4096 int8 5.64 us (bytes),
// int4 4.34 us (operations); gate/up 128 x 4096 x 11008 14.63 / 11.67 us;
// down 128 x 11008 x 4096 14.62 / 11.67 us; the burst's 8 x 4096 x 4096
// about 5.0 / 2.5 us (bytes); the fused int8 + int8-KV layer's k|v
// 128 x 4096 x 8192 column slice about 10.9 us (bytes). int8 at M = 128
// sits at the card's balance point; int4 is bound by the bf16 tensor-core
// rate.
//
// bf16 activations (the serving path):
//
// - The weight is read from device memory once per call: a block covers
//   all of the step's rows (M <= 128; a larger M grids over 128-row
//   tiles) and 256 weight columns, so x is read by N / 256 column blocks
//   (16 MB of L2 traffic at N = 4096, not the 64 MB of 64 x 64 tiles).
// - A ring of 6-8 stages in dynamic shared memory takes the raw payload,
//   int8 bytes or packed nibbles as they lie in device memory, beside the
//   bf16 x tile: TMA copies (tensor maps in the 128-byte swizzle, zeros
//   past every edge) completing on one mbarrier per stage, issued 4-7
//   tiles ahead (16 KB of int8 or 8 KB of int4 payload and 16 KB of x a
//   tile at M > 16: 96-144 KB in flight per SM, against the ~25 KB that
//   25 GB/s per SM needs over ~1 us). Nothing passes through registers on
//   the way, and no bf16 copy of the weight is written. (16-byte cp.async
//   kept too little in flight per SM, and 1-D bulk copies of 256-byte rows
//   queued one behind the other.)
// - Each lane reads its operand bytes from the staged raw tile and widens
//   them in registers right before its product, with integer bit
//   operations exact for every value: an int8 pair (rows k, k+1 of one
//   column) becomes a bf16 pair as (128 + (x & 127)) - (x < 0 ? 256 : 128),
//   both terms built by prmt/lop3 and subtracted by one bf16x2 fma; a
//   packed int4 byte already holds a K pair, widened as (128 + (x + 8)) -
//   136. Columns are dealt to lanes so that a lane's bytes of a payload row
//   are contiguous (one 32-bit shared load per row).
// - M > 16: wgmma on the swapped product out^T = W^T x^T. The widened
//   weight is the A operand from registers (the m16n8k16 A-fragment
//   layout is wgmma's per warp) and x the B operand straight from the
//   swizzled stage (n = 128 rows); two warpgroups of 128 weight columns
//   (two m64 tiles) each. Two K steps are one commit group, their
//   operands double buffered, so the next group widens while this one's
//   products run; only a product defines the accumulators (anything else
//   would make ptxas serialize every wgmma). M <= 16: mma.sync m16n8k16,
//   x the A operand by ldmatrix, the widened weight the B fragment, 8
//   warps of 16 rows x 32 columns.
// - Enough blocks for every shape, summed in a fixed order: split-K over
//   a thread-block cluster of S <= 8 blocks along K, S chosen per shape
//   from the clusters the card holds at once (waves x (K tiles per block
//   + a block's fixed cost)). Each block leaves its f32 partial tile in
//   its own shared memory; after a cluster barrier, block r sums its slice
//   of the tile over the S blocks' shared memory in rank order
//   (distributed shared memory: no device-memory traffic, no atomics, no
//   second launch), scales and rounds once. Two calls are bitwise equal.
// - The per-column scale stays in the epilogue, after the sum: (x @ w_q)
//   * s is the reference's x @ (w_q * s) rounded in another order (see
//   ROADMAP C).
//
// Operands TMA cannot take (K % 8, a row stride % 16, or an unaligned
// pointer) are staged element by element into the same layout.
//
// f32 activations take the dtype's own kernel on the CUDA cores: the same
// function at f32 precision throughout, tiled simply (a 64 x 64 tile, K
// 16 at a time, 256 threads with 4 x 4 outputs each). It is on no
// serving path.

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tma.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// bf16 activations: tensor cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // 8 warps, two warpgroups
constexpr int BK = 64;          // K per ring stage: one 128-byte x row
constexpr int kMaxSplits = 8;   // the largest portable cluster

// the split-count model's fixed cost of a block (start-up, the first
// tile's latency, the split-K sum), in K tiles: timed on the H100
constexpr int kBlockOverheadTiles = 8;

// Tile geometry of one instantiation. SMALL (M <= 16): mma.sync, 8 warps
// of one m16 tile x NT n8 tiles (32 columns); otherwise wgmma, two
// warpgroups of 128
// weight columns x 128 rows. Both stage tiles lie in TMA's 128-byte
// swizzle: x as [M_BLK rows x 128 bytes], the payload as two 128-column
// halves of [W_ROWS rows x 128 bytes].
template <int BITS, bool SMALL>
struct Cfg {
  static constexpr int M_BLK = SMALL ? 16 : 128;
  static constexpr int BN = 256;
  static constexpr int NT = 4;   // mma.sync: n8 tiles per warp
  static constexpr int X_BYTES = M_BLK * BK * 2;
  static constexpr int W_ROWS = BITS == 8 ? BK : BK / 2;   // payload rows
  static constexpr int W_HALF = W_ROWS * 128;
  static constexpr int W_BYTES = 2 * W_HALF;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  // wgmma refills a stage two tiles after its use (its products are
  // asynchronous), mma.sync one: wgmma takes a deeper ring
  static constexpr int BUDGET = SMALL ? 144000 : 200000;
  static constexpr int STAGES = BUDGET / STAGE < 8 ? BUDGET / STAGE : 8;
  static constexpr int AHEAD = SMALL ? STAGES - 1 : STAGES - 2;
  static constexpr int P_PITCH = BN + 4;   // floats per partial row
  static constexpr int P_BYTES = M_BLK * P_PITCH * 4;
  static constexpr int RING = STAGES * STAGE;
  // one mbarrier per stage after the ring (or the partial tile)
  static constexpr int BARS = RING > P_BYTES ? RING : P_BYTES;
  static constexpr int SMEM = BARS + 8 * STAGES + 1024;
  static_assert(AHEAD >= 2, "at least two tiles in flight");
  static_assert(X_BYTES % 1024 == 0 && W_HALF % 1024 == 0,
                "every swizzled tile on a 1024-byte boundary");
};

// Byte (row r, column c) of a staged payload tile
template <class C>
__device__ __forceinline__ const unsigned char* w_at(const unsigned char* sw,
                                                     int r, int c) {
  return sw + (c >> 7) * C::W_HALF + swz(r, c & 127);
}

// One K tile into ring stage `st`: the x tile (rows m0.., K tile
// `tile`) and the payload tile (payload rows tile * W_ROWS.., columns
// n0 .. n0 + 256), each by TMA from thread 0 (x: one box of [M_BLK, 64];
// payload: two boxes of [W_ROWS, 128]), completing on the stage's
// mbarrier `bar`; TMA fills what lies past M, K, the payload rows and N
// with zeros. vec_x / vec_w false (K % 8, ldw % 16 or a pointer's
// alignment rule TMA out): that operand is stored element by element, in
// the same swizzle, and the mbarrier counts no bytes for it.
template <class C>
__device__ __forceinline__ void load_tile(
    unsigned char* st, uint32_t bar, const CUtensorMap* tmx,
    const CUtensorMap* tmw, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int M, int N, int K, int rows, int ldw,
    int m0, int n0, int tile, int vec_x, int vec_w) {
  unsigned char* sw = st + C::X_BYTES;
  const int k0 = tile * BK, r0 = tile * C::W_ROWS;
  if (threadIdx.x == 0) {
    mbar_expect(bar, (vec_x ? C::X_BYTES : 0) + (vec_w ? C::W_BYTES : 0));
    if (vec_x) tma_load(st, tmx, k0, m0, bar);
    if (vec_w) {
      tma_load(sw, tmw, n0, r0, bar);
      tma_load(sw + C::W_HALF, tmw, n0 + 128, r0, bar);
    }
  }
  if (!vec_x) {
    for (int c = threadIdx.x; c < C::M_BLK * BK; c += kThreads) {
      const int r = c / BK, k = c % BK;
      const int m = m0 + r, kk = k0 + k;
      *reinterpret_cast<__nv_bfloat16*>(st + swz(r, 2 * k)) =
          m < M && kk < K ? x[(size_t)m * K + kk] : __float2bfloat16(0.f);
    }
  }
  if (!vec_w) {
    for (int c = threadIdx.x; c < C::W_ROWS * C::BN; c += kThreads) {
      const int r = c / C::BN, col = c % C::BN;
      const int row = r0 + r, n = n0 + col;
      *const_cast<unsigned char*>(w_at<C>(sw, r, col)) =
          row < rows && n < N ? (unsigned char)w[(size_t)row * ldw + n] : 0;
    }
  }
}

// mma.sync body (M <= 16), one staged tile: warp w's 16 rows x 32
// columns, NT n8 tiles. Tile j's column g is the block's column
// 32w + g * NT + j, so a lane's NT bytes of a payload row are contiguous.
template <class C, int BITS>
__device__ __forceinline__ void mma_tile(float (&acc)[C::NT][4],
                                         const unsigned char* st, int warp,
                                         int lane) {
  static_assert(C::NT == 4, "one 32-bit word of payload per row");
  const unsigned char* sw = st + C::X_BYTES;
  const int g = lane >> 2, t = lane & 3;
  const int col = warp * 32 + g * C::NT;
  auto word = [&](int r) {
    return *reinterpret_cast<const uint32_t*>(w_at<C>(sw, r, col));
  };
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, st + swz(lane & 15, (ks * 16 + (lane >> 4) * 8) * 2));
    uint32_t b[C::NT][2];
    if (BITS == 8) {
      // K rows ks*16 + 2t, +1 (b0) and +8, +9 (b1)
      const int k = ks * 16 + 2 * t;
      const uint32_t r0 = word(k), r1 = word(k + 1);
      const uint32_t r8 = word(k + 8), r9 = word(k + 9);
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        b[j][0] = widen_i8(r0, r1, j);
        b[j][1] = widen_i8(r8, r9, j);
      }
    } else {
      // packed rows ks*8 + t (K 2t, 2t+1) and + 4 (K 2t+8, 2t+9)
      const uint32_t q0 = word(ks * 8 + t) ^ 0x88888888u;
      const uint32_t q4 = word(ks * 8 + t + 4) ^ 0x88888888u;
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        b[j][0] = widen_i4(q0, q0 >> 4, j);
        b[j][1] = widen_i4(q4, q4 >> 4, j);
      }
    }
#pragma unroll
    for (int j = 0; j < C::NT; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
  }
}

// wgmma body. The warp (w of its warpgroup) holds rows 16w .. 16w + 15
// of two 64-row A tiles (j = 0, 1); A row 16w + g + 8h of tile j is the
// block's column c0 + g * 4 + h * 2 + j, so a lane's four bytes of a
// payload row are contiguous.

// K steps per wgmma commit group (an even number of groups per tile keeps
// the A double buffer alternating across tiles)
constexpr int kStepsPerGroup = 2;

// One staged tile, kStepsPerGroup K steps at a time: the lane widens
// their A operands, then the warpgroup issues their products as one
// commit group. A is double buffered: a group widens while the previous
// group's products run. The block's first products overwrite the
// (undefined) accumulators.
template <class C, int BITS>
__device__ __forceinline__ void wgmma_tile(float (&acc)[2][64],
                                           const unsigned char* st, int c0,
                                           int lane, bool first) {
  constexpr int KPG = kStepsPerGroup;
  static_assert((BK / 16) % (2 * KPG) == 0, "even groups per tile");
  const unsigned char* sw = st + C::X_BYTES;
  const uint32_t xs = smem_u32(st);
  const int g = lane >> 2, t = lane & 3;
  const int col = c0 + g * 4;
  uint32_t a[2][KPG][2][4];
#pragma unroll
  for (int gi = 0; gi < BK / 16 / KPG; ++gi) {
    uint32_t (&A)[KPG][2][4] = a[gi & 1];
#pragma unroll
    for (int u = 0; u < KPG; ++u) {
      const int ks = gi * KPG + u;
      if (BITS == 8) {
        const int k = ks * 16 + 2 * t;
        const uint32_t r0 =
            *reinterpret_cast<const uint32_t*>(w_at<C>(sw, k, col));
        const uint32_t r1 =
            *reinterpret_cast<const uint32_t*>(w_at<C>(sw, k + 1, col));
        const uint32_t r8 =
            *reinterpret_cast<const uint32_t*>(w_at<C>(sw, k + 8, col));
        const uint32_t r9 =
            *reinterpret_cast<const uint32_t*>(w_at<C>(sw, k + 9, col));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          A[u][j][0] = widen_i8(r0, r1, j);
          A[u][j][1] = widen_i8(r0, r1, 2 + j);
          A[u][j][2] = widen_i8(r8, r9, j);
          A[u][j][3] = widen_i8(r8, r9, 2 + j);
        }
      } else {
        const uint32_t q0 = *reinterpret_cast<const uint32_t*>(
                                w_at<C>(sw, ks * 8 + t, col)) ^ 0x88888888u;
        const uint32_t q4 = *reinterpret_cast<const uint32_t*>(
                                w_at<C>(sw, ks * 8 + t + 4, col)) ^
                            0x88888888u;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          A[u][j][0] = widen_i4(q0, q0 >> 4, j);
          A[u][j][1] = widen_i4(q0, q0 >> 4, 2 + j);
          A[u][j][2] = widen_i4(q4, q4 >> 4, j);
          A[u][j][3] = widen_i4(q4, q4 >> 4, 2 + j);
        }
      }
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < KPG; ++u) {
      const int ks = gi * KPG + u;
      const uint64_t desc = swizzle128_desc(xs + ks * 32);
      const int keep = !first || ks > 0;
      wgmma_n128(acc[0], A[u][0], desc, keep);
      wgmma_n128(acc[1], A[u][1], desc, keep);
    }
    wgmma_commit();
    // the previous group is done with its A registers (at gi = 0: the
    // tile before this one with its stage)
    wgmma_wait<1>();
    fence_acc(acc);
  }
}

// The split-K sum: each block's f32 partial tile P [M_BLK, P_PITCH] lies
// in its own shared memory; block `rank` of the S in the cluster sums its
// slice of the tile (4-column chunks CH * rank / S ..) over the S blocks'
// shared memory in rank order, scales, rounds once and stores. A thread's
// chunks are kThreads apart, a multiple of a row's BN / 4: one column
// chunk, whose scales `sc` it loaded early (reduce_scale). The S loads
// of a chunk are issued together. vec_out: N % 4 == 0 with out and scale
// aligned.
template <class C>
__device__ __forceinline__ int reduce_first(int rank, int S) {
  return C::M_BLK * (C::BN / 4) * rank / S + (int)threadIdx.x;
}

template <class C>
__device__ __forceinline__ float4 reduce_scale(
    const float* __restrict__ scale, int N, int n0, int rank, int S,
    int vec_out) {
  const int n = n0 + (reduce_first<C>(rank, S) % (C::BN / 4)) * 4;
  if (vec_out && n < N) return *reinterpret_cast<const float4*>(scale + n);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = n + e < N ? scale[n + e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <class C>
__device__ __forceinline__ void reduce_store(
    cg::cluster_group& cluster, const float* P, float4 sc,
    __nv_bfloat16* __restrict__ out, int M, int N, int m0, int n0,
    int vec_out) {
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  constexpr int CPR = C::BN / 4;
  constexpr int CH = C::M_BLK * CPR;
  const int col = (reduce_first<C>(rank, S) % CPR) * 4, n = n0 + col;
  if (n >= N) return;
  const int c1 = CH * (rank + 1) / S;
  for (int c = reduce_first<C>(rank, S); c < c1; c += kThreads) {
    const int row = c / CPR, m = m0 + row;
    if (m >= M) break;
    const int off = row * C::P_PITCH + col;
    float4 v[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < S)
        v[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(P, q) + off);
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q)
      if (q < S) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    __nv_bfloat16* o = out + (size_t)m * N + n;
    if (vec_out) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(s.x * sc.x, s.y * sc.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(s.z * sc.z, s.w * sc.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = u;
    } else {
      const float r[4] = {s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) o[e] = __float2bfloat16(r[e]);
    }
  }
}

// grid (ceil(N / BN), ceil(M / M_BLK), S), clusters (1, 1, S): block z
// takes K tiles [k_tiles * z / S, k_tiles * (z + 1) / S)
template <int BITS, bool SMALL>
__global__ void __launch_bounds__(kThreads, 1)
dequant_matmul_bf16(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw,
                    const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K,
                    int rows, int ldw, int vec_x, int vec_w, int vec_out) {
  using C = Cfg<BITS, SMALL>;
  constexpr int ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.z, z = blockIdx.z;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::M_BLK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = k_tiles * z / S;
  const int n_tiles = k_tiles * (z + 1) / S - kt0;
  const float4 sc = reduce_scale<C>(scale, N, n0, z, S, vec_out);

  // mma.sync: n8 tiles x 4; wgmma: two m64 tiles x 64. wgmma: the
  // block's first product defines the accumulators (any other definition
  // inside its pipeline makes ptxas serialize every wgmma); a block with
  // no K tile stores zeros
  std::conditional_t<SMALL, float[C::NT][4], float[2][64]> acc;
  if constexpr (SMALL) {
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  // wgmma: the warp's first column
  const int c0 = (warp >> 2) * 128 + (warp & 3) * 32;

  const uint32_t bars = smem_u32(smem + C::BARS);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) mbar_init(bars + 8 * s);
    mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < C::AHEAD; ++s)
    if (s < n_tiles)
      load_tile<C>(smem + s * C::STAGE, bars + 8 * s, &tmx, &tmw, x, w, M,
                   N, K, rows, ldw, m0, n0, kt0 + s, vec_x, vec_w);
  for (int i = 0; i < n_tiles; ++i) {
    // element-wise stores of x (the unaligned path) are read by wgmma
    // through the async proxy: fenced before the barrier publishing them
    if constexpr (!SMALL) fence_proxy_async();
    // every warp is done with the stage refilled next (mma.sync: tile
    // i - 1's; wgmma: tile i - 2's, its last products waited for in tile
    // i - 1), and the element-wise stores of tile i are visible
    __syncthreads();
    const int nx = i + C::AHEAD;
    if (nx < n_tiles)
      load_tile<C>(smem + (nx % ST) * C::STAGE, bars + 8 * (nx % ST), &tmx,
                   &tmw, x, w, M, N, K, rows, ldw, m0, n0, kt0 + nx, vec_x,
                   vec_w);
    mbar_wait(bars + 8 * (i % ST), (i / ST) & 1);   // tile i landed
    const unsigned char* st = smem + (i % ST) * C::STAGE;
    if constexpr (SMALL)
      mma_tile<C, BITS>(acc, st, warp, lane);
    else
      wgmma_tile<C, BITS>(acc, st, c0, lane, i == 0);
  }
  if constexpr (!SMALL) {
    wgmma_wait<0>();
    fence_acc(acc);
  }
  __syncthreads();   // the ring is free: it holds the partial tile now

  float* P = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
  if constexpr (SMALL) {
    // n8 tiles j and j + 1 hold neighbouring columns
#pragma unroll
    for (int j = 0; j < C::NT; j += 2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e >> 1) * 8;
        const int col = warp * 32 + (2 * t + (e & 1)) * C::NT + j;
        *reinterpret_cast<float2*>(P + row * C::P_PITCH + col) =
            make_float2(acc[j][e], acc[j + 1][e]);
      }
  } else {
    // tile j, element 4i + e: A row 16w + g + 8 (e >> 1) (the block's
    // column c0 + 4g + 2 (e >> 1) + j), x row 8i + 2t + (e & 1); tiles 0
    // and 1 hold neighbouring columns
    const bool any = n_tiles > 0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * i + 2 * t + (e & 1);
        const int col = c0 + g * 4 + (e >> 1) * 2;
        *reinterpret_cast<float2*>(P + row * C::P_PITCH + col) =
            any ? make_float2(acc[0][4 * i + e], acc[1][4 * i + e])
                : make_float2(0.f, 0.f);
      }
  }
  cluster.sync();   // every block's partial tile is written
  reduce_store<C>(cluster, P, sc, out, M, N, m0, n0, vec_out);
  cluster.sync();   // no block leaves while its tile is being read
}

// Launch plumbing of one instantiation: shared-memory opt-in, how many
// clusters of S blocks the card holds at once, and the split count.
template <int BITS, bool SMALL>
struct Launcher {
  using C = Cfg<BITS, SMALL>;

  static cudaError_t opt_in() {
    static cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_bf16<BITS, SMALL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    return err;
  }

  static cudaLaunchConfig_t config(dim3 grid, int s, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = 1;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  // clusters of s blocks resident at once (0 if none fit)
  static int clusters(int s) {
    static int cache[kMaxSplits + 1] = {};
    if (cache[s] == 0) {
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg = config(dim3(1, 1, s), s, 0, &attr);
      int n = 0;
      if (opt_in() != cudaSuccess ||
          cudaOccupancyMaxActiveClusters(
              &n, dequant_matmul_bf16<BITS, SMALL>, &cfg) !=
              cudaSuccess)
        n = 0;
      cache[s] = n > 0 ? n : -1;
    }
    return cache[s] > 0 ? cache[s] : 0;
  }

  // The split count with the least of waves of resident clusters times
  // each block's K tiles and fixed cost (the smaller on a tie); each
  // block keeps >= 2 tiles.
  static int splits(int M, int N, int K) {
    const long long base = (long long)((N + C::BN - 1) / C::BN) *
                           ((M + C::M_BLK - 1) / C::M_BLK);
    const int k_tiles = (K + BK - 1) / BK;
    int best = 1;
    long long best_cost = -1;
    for (int s = 1; s <= kMaxSplits; ++s) {
      if (s > 1 && k_tiles < 2 * s) break;
      const int act = clusters(s);
      if (act == 0) continue;
      const long long cost = (base + act - 1) / act *
                             ((k_tiles + s - 1) / s + kBlockOverheadTiles);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = s;
      }
    }
    return best;
  }

  static int launch(const void* x, const int8_t* w, const float* scale,
                    void* out, int M, int N, int K, int rows, int ldw,
                    int vec_x, int vec_w, int vec_out, int s,
                    cudaStream_t stream) {
    cudaError_t err = opt_in();
    if (err != cudaSuccess) return (int)err;
    if (s <= 0) s = splits(M, N, K);
    if (s > kMaxSplits) return (int)cudaErrorInvalidValue;
    CUtensorMap tmx = {}, tmw = {};
    if (vec_x && !encode_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                            2LL * K, BK, C::M_BLK))
      return (int)cudaErrorNotSupported;
    if (vec_w && !encode_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, rows,
                            ldw, 128, C::W_ROWS))
      return (int)cudaErrorNotSupported;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(
        dim3((N + C::BN - 1) / C::BN, (M + C::M_BLK - 1) / C::M_BLK, s), s,
        stream, &attr);
    err = cudaLaunchKernelEx(
        &cfg, dequant_matmul_bf16<BITS, SMALL>, tmx, tmw,
        static_cast<const __nv_bfloat16*>(x), w, scale,
        static_cast<__nv_bfloat16*>(out), M, N, K, rows, ldw, vec_x, vec_w,
        vec_out);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
};

// ---------------------------------------------------------------------------
// f32 activations: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;
constexpr int kFThreads = 256;

__device__ __forceinline__ int nibble_lo(uint32_t b) {
  const int v = b & 0xF;
  return v > 7 ? v - 16 : v;
}

__device__ __forceinline__ int nibble_hi(uint32_t b) {
  const int v = (b >> 4) & 0xF;
  return v > 7 ? v - 16 : v;
}

template <int BITS>
__global__ void __launch_bounds__(kFThreads)
dequant_matmul_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int N, int K, int ldw) {
  __shared__ float sA[FK][FM + 4];   // x tile, K-major
  __shared__ float sB[FK][FN + 4];   // dequantized weight tile (no scale)
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kFThreads;
      const int r = e / FK, kk = e % FK;
      const int m = m0 + r, k = k0 + kk;
      sA[kk][r] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kFThreads;
      const int kk = e / FN, c = e % FN;
      const int k = k0 + kk, n = n0 + c;
      int v = 0;
      if (k < K && n < N) {
        if (BITS == 8) {
          v = w[(size_t)k * ldw + n];
        } else {
          const uint32_t b = (uint8_t)w[(size_t)(k >> 1) * ldw + n];
          v = (k & 1) ? nibble_hi(b) : nibble_lo(b);
        }
      }
      sB[kk][c] = (float)v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < M && c < N) out[(size_t)r * N + c] = acc[i][j] * scale[c];
    }
}

template <int BITS>
int launch_bf16(const void* x, const int8_t* w, const float* scale,
                void* out, int M, int N, int K, int rows, int ldw, int vec_x,
                int vec_w, int vec_out, int splits, cudaStream_t stream) {
  return M <= 16 ? Launcher<BITS, true>::launch(x, w, scale, out, M, N, K,
                                               rows, ldw, vec_x, vec_w,
                                               vec_out, splits, stream)
                 : Launcher<BITS, false>::launch(x, w, scale, out, M, N, K,
                                                rows, ldw, vec_x, vec_w,
                                                vec_out, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out); bits: 8 or 4. w holds
// `rows` payload rows (K for int8, ceil(K/2) for int4) of N bytes at row
// stride ldw (>= N). vec_x: K % 8 == 0 and x 16-byte aligned; vec_w:
// ldw % 16 == 0 and w 16-byte aligned (both: TMA's rules; else those
// operands are staged element by element); vec_out: N % 4 == 0, out 8-
// and scale 16-byte aligned. splits: the bf16 kernel's K split count (0:
// its own choice, 1-8). Returns the CUDA error of the launch (0 =
// success); the launch is asynchronous on `stream`.
extern "C" int dequant_matmul(int dtype, int bits, const void* x,
                              const void* w, const void* scale, void* out,
                              int M, int N, int K, int rows, int ldw,
                              int vec_x, int vec_w, int vec_out, int splits,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    return bits == 8 ? launch_bf16<8>(x, wq, sc, out, M, N, K, rows, ldw,
                                      vec_x, vec_w, vec_out, splits, s)
                     : launch_bf16<4>(x, wq, sc, out, M, N, K, rows, ldw,
                                      vec_x, vec_w, vec_out, splits, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((M + FM - 1) / FM, (N + FN - 1) / FN);
  if (bits == 8)
    dequant_matmul_f32<8><<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(x), wq, sc, static_cast<float*>(out), M, N,
        K, ldw);
  else
    dequant_matmul_f32<4><<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(x), wq, sc, static_cast<float*>(out), M, N,
        K, ldw);
  return (int)cudaGetLastError();
}

// The K split count the bf16 kernel takes at this shape on this card.
extern "C" int dequant_matmul_splits(int bits, int M, int N, int K) {
  if (M <= 16)
    return bits == 8 ? Launcher<8, true>::splits(M, N, K)
                     : Launcher<4, true>::splits(M, N, K);
  return bits == 8 ? Launcher<8, false>::splits(M, N, K)
                   : Launcher<4, false>::splits(M, N, K);
}

// Dynamic shared memory of one block of the bf16 kernel (small: M <= 16).
extern "C" int dequant_matmul_smem_bytes(int bits, int small) {
  if (small)
    return bits == 8 ? Cfg<8, true>::SMEM : Cfg<4, true>::SMEM;
  return bits == 8 ? Cfg<8, false>::SMEM : Cfg<4, false>::SMEM;
}
