// Decode megakernel for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/decode_megakernel.py:185
// (_build_kernel, launched by fused_decode_layer at :520): a whole decoder
// layer for R decode rows (q_len = 1):
//
//   rms_norm -> q/k/v projections (int8 weights: x column scale) -> rope at
//   position kv_len - 1 -> online-softmax attention over the row's pages
//   (the current token's self term in registers when self_kv; int8 pages
//   x per-(head, page) scales) -> o projection + residual -> rms_norm ->
//   silu(gate) * up -> down projection + residual
//
// and, at model scope, every layer of a token in ONE launch: the same body
// in a loop over the layers, each layer's weights and pool found through a
// device table of per-layer pointers and a device table of per-layer
// tensor maps (nothing is stacked or copied), the current token's K/V
// written into its pool slot before any block attends it (an int8 pool
// requantizes its page there: the running-amax append). A layer-scope
// launch with append_at is the same launch over one layer.
//
// Bound on this card, one Llama-2-7B layer at R = 8 rows: the weights,
// 202,375,168 parameters = 404.75 MB in bf16 (202.4 MB int8 + scales), over
// 3.35 TB/s is 0.121 ms (0.060 ms), plus the rows' K/V pages; the
// projections' 2 * 8 * 202.4 M = 3.2 GFLOP take well under 1% of the tensor
// cores' rate. So the layer is bound by bytes, and the design streams every
// weight byte once per launch at the card's rate whatever R is. One
// PERSISTENT cooperative launch (the grid is the co-resident block count:
// one block of 256 threads per SM) whose phases are split by a
// hand-written grid barrier (an arrival counter and a generation word):
//
// - Weights go through a TMA ring. A projection unit is a strip of UC
//   columns of one matrix over one of ks chunks of K: NB boxes of 128
//   bytes side by side (Box<T, W> below). bf16 weights: 8 boxes, 512
//   columns = 1024 contiguous bytes of each weight row, in stages of
//   BK = 32 rows (32 KB), 4 deep; int8 weights: 4 boxes, 512 columns =
//   512 bytes, in 16 KB stages of 32 rows, 8 deep (f32 hidden states,
//   the card tests only: 4 boxes of 32 f32 columns or 2 of 128 int8
//   columns, 16 KB stages, 8 deep). The stages come by TMA tensor maps
//   into a ring of mbarrier-tracked stages in shared memory (128 KB in
//   every form); thread 0 keeps DEPTH - 1 stages in flight across unit
//   boundaries. The host picks ks per phase so the units fill the grid
//   (units are numbered strip-minor: blocks next to each other stream
//   neighbouring strips of the same rows). The tensor maps (7 per layer)
//   live in a device table encoded once by the host, 128 bytes and
//   64-byte aligned each, and go to cp.async.bulk.tensor by generic
//   address.
// - Tensor cores with the weights as M: out^T = W^T x^T on mma.sync
//   m16n8k16, the strip's columns as M and the 8 rows of a row group as
//   N. A comes from the k-major stage by ldmatrix.trans (bf16) or by
//   16-bit loads widened exactly to bf16 in registers (int8, prmt/lop3);
//   B is x^T from the x window in shared memory, normalised once per unit
//   (per window where the chunk does not fit). Rows beyond 8 loop over row
//   groups on the same staged strip, so the weight bytes do not grow with
//   R. Each warp owns UC / 8 distinct columns of the strip, so a unit's sums
//   leave the registers once, straight to its partial buffer. f32 hidden
//   states (the card tests only) keep CUDA-core FMAs reading the same ring.
// - Split-K partials are summed in chunk order by the phase that consumes
//   them, which applies the int8 column scale after the sum: no atomics,
//   two launches bitwise equal.
// - Attention: per (row, kv head, kSplit positions) unit, the K and V rows,
//   q heads and self k, v of the block's next unit are copied by cp.async
//   into a 2-stage ring while it computes the current one, their pool rows
//   looked up a unit further ahead; 8 warps share a unit's positions, each
//   an online softmax, merged in warp order.
//
// Phases (10, each ended by the grid barrier; a launch without stamps
// skips the last one):
//
//   0. q|k|v:     rstd of the rows; x = rms_norm(h) * ln1 per unit; the
//                 q|k|v units -> partial sums;
//   1. rope:      per (row, kv head): the partials summed, scaled,
//                 rounded, roped; the self-kv outputs, the appended record
//                 and the pool write (append_at);
//   2. attention: the position splits' (m, l, acc);
//   3. combine:   the splits of each (row, head) merged in order -> o;
//   4. o:         x = o; the o units -> partial sums;
//   5. h2:        h2 = h + o-proj;
//   6. gate|up:   rstd of h2; x2 = rms_norm(h2) * ln2; the gate|up units;
//   7. act:       act = silu(gate) * up;
//   8. down:      x = act; the down units -> partial sums;
//   9. out:       h_out = h2 + down.
//
// Every value is rounded to the hidden type where the plain version
// (_reference_layer) rounds it: after each norm, projection, rope, the
// attention output and each residual add. Sums are f32.

#include <stdint.h>
#include <string.h>

#include "hopper_tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 8;         // ring depth (the most)
// the x window: 64 rows x 260 f32 (a 256-deep k tile at the most rows)
constexpr int kXBytes = 66560;
constexpr int kSmemBytes = 232448;    // the SM's: one block per SM
constexpr int kSplit = 64;            // positions per attention unit
constexpr int kMaxRows = 64;
constexpr int kMaxGroup = 8;          // query heads per kv head
constexpr int kMaxDh = 128;           // 4 elements per lane
constexpr int kPos = kSplit / kWarps; // positions per warp and unit
constexpr int kPhases = 10;
constexpr float kNegInf = -1e30f;

// one layer's pointers in the device table
enum {
  P_LN1, P_LN2, P_WQ, P_WK, P_WV, P_WO, P_WG, P_WU, P_WD,
  P_SQ, P_SK, P_SV, P_SO, P_SG, P_SU, P_SD,
  P_KP, P_VP, P_KS, P_VS, kPtrs
};
// one layer's tensor maps in the map table
enum { M_Q, M_K, M_V, M_O, M_G, M_U, M_D, kMaps };

// shared memory: the ring (on a 1024-byte boundary, the 128-byte
// swizzle's period), then from the end of the block's: rstd of the rows,
// the ring's mbarriers and the x window. The rope phase works in the
// ring's bytes, attention keeps its copies there and merges in the
// window's.
constexpr int kTailBytes = 256 + 8 * kMaxStages + kXBytes;
constexpr int kRingBytes = kSmemBytes - 1024 - kTailBytes;
// attention: a ring of kAttnStages stages, each a unit's K and V rows in
// the pool's type, its q heads and self k, v (f32)
constexpr int kAttnStages = 2;
template <typename PT> struct AttnRing {
  static constexpr int KV = 2 * kSplit * kMaxDh * (int)sizeof(PT);
  static constexpr int BYTES = KV + (kMaxGroup + 2) * kMaxDh * 4;
  static constexpr int STAGES = kRingBytes / BYTES < kAttnStages
                                    ? kRingBytes / BYTES : kAttnStages;
  static_assert(STAGES >= 2, "shared memory: the attention ring");
};
constexpr int kAttnMerge =
    (2 * kWarps * kMaxGroup + kWarps * kMaxGroup * kMaxDh) * 4 +
    3 * kAttnStages * kSplit * 4 + (3 * kMaxRows + 1) * 4;
static_assert(kXBytes >= kAttnMerge, "shared memory: the attention merge");

struct Params {
  const unsigned long long* layers;   // [L, kPtrs] device pointer table
  const CUtensorMap* maps;            // [L, kMaps] weight tensor maps
  const void* h_in;                   // [R, D] T
  void* h_out;                        // [R, D] T (model scope: the state)
  void* k_cur;                        // [R, Hkv*dh] T (self_kv) or null
  void* v_cur;
  const int* tables;                  // [R, pps]
  const int* kv_lens;                 // [R], the current token included
  const float* cos;                   // [R, dh] rope tables
  const float* sin;
  const int* app_page;                // [R] append slot page (append_at;
  const int* app_off;                 //     page 0: dead row, no write)
  float* appended;                    // [L, 2, R, Hkv, dh] record or null
  float* part_qkv;                    // [ks_qkv, R, n_qkv]
  float* qkv;                         // [R, (H + 2 Hkv) dh] roped, rounded
  float* att;                         // [R, Hkv, S, grp, dh + 2] splits
  float* o;                           // [R, H*dh]
  float* part_o;                      // [ks_o, R, D]
  float* h2;                          // [R, D]
  float* part_gu;                     // [ks_gu, R, 2F]
  float* act;                         // [R, F]
  float* part_d;                      // [ks_d, R, D]
  unsigned int* bar;                  // [2] arrival count, generation
  unsigned long long* stamps;         // [1 + kPhases L] or null
  int L, R, D, H, Hkv, dh, F, P, ps, pps;
  int ks_qkv, ks_o, ks_gu, ks_d;      // K chunks of each projection phase
  int self_kv;   // the current token attends in registers (fp contract)
  int with_kv;   // project k and v (self_kv, or the append)
  int append;    // write k/v into the pool slot (append_at)
  int S;         // attention splits per row slot: ceil(pps * ps / kSplit)
  float eps, scale;
};

// ---------------------------------------------------------------------------
// element types

template <typename T> struct Val;
template <> struct Val<float> {
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ float ldcg(const float* p) {
    return __ldcg(p);
  }
  static __device__ __forceinline__ void st(float* p, float x) { *p = x; }
  // 4 consecutive values, 16-byte aligned
  static __device__ __forceinline__ void ld4(const float* p, float v[4]) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  // 8 consecutive values, 16-byte aligned
  static __device__ __forceinline__ void ld8(const float* p, float v[8]) {
    ld4(p, v);
    ld4(p + 4, v + 4);
  }
  // 8 values into the x window
  static __device__ __forceinline__ void st8(float* p, const float v[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};
template <> struct Val<__nv_bfloat16> {
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float ldcg(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(
        __ldcg(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  static __device__ __forceinline__ void ld4(const __nv_bfloat16* p,
                                             float v[4]) {
    const uint2 a = __ldcg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void ld8(const __nv_bfloat16* p,
                                             float v[8]) {
    const uint4 a = __ldcg(reinterpret_cast<const uint4*>(p));
    const unsigned int u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void st8(__nv_bfloat16* p,
                                             const float v[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
        pack(v[6], v[7]));
  }
};
template <> struct Val<int8_t> {
  static __device__ __forceinline__ float ldcg(const int8_t* p) {
    return (float)__ldcg(reinterpret_cast<const signed char*>(p));
  }
  static __device__ __forceinline__ void ld4(const int8_t* p, float v[4]) {
    const unsigned int a = __ldcg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (float)(int8_t)(a >> (8 * i));
  }
};

// A ring stage as TMA lays it in shared memory, for hidden type T and
// weights W: NB boxes side by side, each BK rows of 128 bytes of W (BC
// columns) in the 128-byte swizzle; a unit's strip is UC = NB x BC
// columns, 1024 bytes of each bf16 weight row and 512 of an int8 one
// (a 1024-byte int8 strip would hold twice the accumulators); the ring
// holds DEPTH stages of STAGE bytes
template <typename T, typename W> struct Box {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int NB = sizeof(W) == 2 ? 8 : kBf16 ? 4 : sizeof(W) == 1 ? 2 : 4;
  static constexpr int STAGE = sizeof(W) == 2 ? 32768 : 16384;
  static constexpr int DEPTH = sizeof(W) == 2 ? 4 : 8;
  static constexpr int BC = 128 / (int)sizeof(W);
  static constexpr int UC = NB * BC;
  static constexpr int GW = UC / (16 * kWarps);   // column groups a warp
  static constexpr int BK = STAGE / (NB * 128);
  static constexpr int BYTES = BK * 128;
  static_assert(DEPTH * STAGE <= kRingBytes && DEPTH <= kMaxStages, "ring");
  static __device__ __forceinline__ int off(int r, int b) {
    return swz(r, b);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Grid-wide barrier. Thread 0 of each block reads the generation, then
// arrives; the last arrival resets the count and advances the generation,
// the others wait for it to change. The fences order each block's writes
// before its arrival and the others' reads after their release.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The device clock in ns; with p.stamps, block 0 records it when each
// phase has ended in every block (after the barrier that follows it).
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void phase_end(const Params& p, int i) {
  grid_sync(p.bar);
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.stamps[i] = now_ns();
}

// a tensor map the host copied into device memory, made visible to the
// tensor copies (the tensormap proxy) before its first use
__device__ __forceinline__ void tmap_acquire(const CUtensorMap* m) {
  asm volatile("fence.proxy.tensormap::generic.acquire.gpu [%0], 128;\n"
               ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
}

// ---------------------------------------------------------------------------
// projections: part[c, r, col + n] = the sum over K chunk c of x[r, k]
// W[k, n] for every matrix of the phase. A unit is (strip, chunk); blocks
// take units in turn.

struct Mat {
  const CUtensorMap* map;
  int n;            // columns of this matrix
  int col;          // its first column in the partial buffer
};

struct Proj {
  Mat m[3];
  int nm;           // matrices
  int K;
  int ks;           // K chunks: the partials
  int ld;           // columns of the partial buffer
  float* part;      // [ks, R, ld]
};

// The blocks' shared memory
struct Smem {
  unsigned char* ring;
  uint32_t bars;
  void* xs;         // the x window [Rp][XP] T
  float* rstd;      // [kMaxRows]
  int Rp;           // rows rounded up to 8
};

// unit u of a phase: its matrix, strip and K chunk (units strip-minor),
// and the chunk's k tiles [kt0, kt1), for the box geometry B
template <class B>
struct Unit {
  int mi, strip, c, kt0, kt1;
  __device__ __forceinline__ Unit(const Proj& g, int u) {
    int ns = 0;
    for (int i = 0; i < g.nm; ++i) ns += (g.m[i].n + B::UC - 1) / B::UC;
    c = u / ns;
    int t = u % ns;
    mi = 0;
    while (t >= (g.m[mi].n + B::UC - 1) / B::UC) {
      t -= (g.m[mi].n + B::UC - 1) / B::UC;
      ++mi;
    }
    strip = t;
    const int KT = (g.K + B::BK - 1) / B::BK;
    kt0 = c * KT / g.ks;
    kt1 = (c + 1) * KT / g.ks;
  }
};

template <class B>
__device__ __forceinline__ int proj_units(const Proj& g) {
  int ns = 0;
  for (int i = 0; i < g.nm; ++i) ns += (g.m[i].n + B::UC - 1) / B::UC;
  return ns * g.ks;
}

// k tile kt of unit U's strip into a ring stage, by TMA from the calling
// thread: NB boxes side by side
template <class B>
__device__ __forceinline__ void issue(unsigned char* st, uint32_t bar,
                                      const Proj& g, const Unit<B>& U,
                                      int kt) {
  mbar_expect(bar, B::NB * B::BYTES);
#pragma unroll
  for (int b = 0; b < B::NB; ++b)
    tma_load(st + b * B::BYTES, g.m[U.mi].map, U.strip * B::UC + b * B::BC,
             kt * B::BK, bar);
}

// One staged strip on the tensor cores: the warp's GW column groups of
// 16 (columns 16 GW w.. of the strip) over the stage's K steps, for the ng row
// groups of the window (xs, pitch XP, the stage's first k at xk). A row g
// of the mma is column cl + g of its box (bf16: ldmatrix.trans of the
// k-major stage) or cl + 2g, and g + 8 is cl + g + 8 or cl + 2g + 1
// (int8: a 16-bit load holds two adjacent columns, widened exactly).
template <typename W, class B>
__device__ __forceinline__ void mma_strip(float (&acc)[B::GW][kMaxRows / 8][4],
                                          const unsigned char* st,
                                          const __nv_bfloat16* xs, int XP,
                                          int xk, int ng, int warp,
                                          int lane) {
  constexpr int GPB = B::BC / 16;              // column groups per box
  const int gq = lane >> 2, tq = lane & 3;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs);
#pragma unroll 2
  for (int ks = 0; ks < B::BK / 16; ++ks) {
    uint32_t a[B::GW][4];
#pragma unroll
    for (int q = 0; q < B::GW; ++q) {
      const int grp = B::GW * warp + q;
      const unsigned char* box = st + (grp / GPB) * B::BYTES;
      const int cl = (grp % GPB) * 16;
      if constexpr (sizeof(W) == 2) {
        const int row = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int chunk = (cl >> 3) + ((lane >> 3) & 1);
        ldsm_x4_trans(a[q], box + B::off(row, chunk << 4));
      } else {
        const int k = ks * 16 + 2 * tq, cb = cl + 2 * gq;
        auto wd = [&](int r) {
          return (uint32_t)*reinterpret_cast<const uint16_t*>(
              box + B::off(r, cb));
        };
        const uint32_t r0 = wd(k), r1 = wd(k + 1);
        const uint32_t r8 = wd(k + 8), r9 = wd(k + 9);
        a[q][0] = widen_i8(r0, r1, 0);
        a[q][1] = widen_i8(r0, r1, 1);
        a[q][2] = widen_i8(r8, r9, 0);
        a[q][3] = widen_i8(r8, r9, 1);
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxRows / 8; ++gi) {
      if (gi < ng) {
        const int at = (((8 * gi + gq) * XP + xk + ks * 16) >> 1) + tq;
        const uint32_t b0 = xw[at], b1 = xw[at + 4];
#pragma unroll
        for (int q = 0; q < B::GW; ++q) mma_bf16(acc[q][gi], a[q], b0, b1);
      }
    }
  }
}

// One staged strip on the CUDA cores (f32 hidden states): the warp's CW
// columns of the strip (UC / 8); with 16 (f32 weights) lane l takes
// column l & 15 and every other k row, with 32 (int8) column l and every
// row
template <typename W, class B>
__device__ __forceinline__ void fma_strip(float (&acc)[kMaxRows / 8][8],
                                          const unsigned char* st,
                                          const float* xs, int XP, int xk,
                                          int ng, int warp, int lane) {
  constexpr int CW = B::UC / kWarps;
  const int col = warp * CW + (CW == 16 ? (lane & 15) : lane);
  const unsigned char* box = st + (col / B::BC) * B::BYTES;
  const int cb = (col % B::BC) * (int)sizeof(W);
  for (int k = CW == 16 ? lane >> 4 : 0; k < B::BK; k += CW == 16 ? 2 : 1) {
    float w;
    if constexpr (sizeof(W) == 4)
      w = *reinterpret_cast<const float*>(box + B::off(k, cb));
    else
      w = (float)*reinterpret_cast<const int8_t*>(box + B::off(k, cb));
#pragma unroll
    for (int gi = 0; gi < kMaxRows / 8; ++gi) {
      if (gi < ng) {
        const float* x = xs + (8 * gi) * XP + xk + k;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[gi][j] = fmaf(x[j * XP], w, acc[gi][j]);
      }
    }
  }
}

// the x window: rows [0, Rp) x k [k0, k0 + klen) of stage(r, k, v[8]) (8
// consecutive values, rounded to T), zeros past R and past K; four
// chunks' loads in flight per thread
template <typename T, typename Stage>
__device__ void stage_x(Stage stage, T* xs, int XP, int Rp, int R, int K,
                        int k0, int klen) {
  const int per = klen >> 3, total = Rp * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kThreads) {
    float v[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * kThreads;
      const int r = i / per, k = (i % per) << 3;
      if (i < total && r < R && k0 + k < K) {
        stage(r, k0 + k, v[q]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[q][j] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * kThreads;
      if (i < total)
        Val<T>::st8(xs + (size_t)(i / per) * XP + ((i % per) << 3), v[q]);
    }
  }
}

// One projection phase: the block's units in turn, each streamed through
// the ring (thread 0 keeps ST - 1 stages in flight across units), its x
// window staged at the unit's start (again where the chunk outgrows it),
// its sums written to the partial buffer from the registers. pre() (the
// rows' rstd) runs once the first stages are in flight.
template <typename T, typename W, typename Pre, typename Stage>
__device__ void proj_phase(const Params& p, const Proj& g, Pre pre,
                           Stage stage, const Smem& sm) {
  using B = Box<T, W>;
  constexpr bool kTC = sizeof(T) == 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  constexpr int ST = B::DEPTH;
  const int units = proj_units<B>(g);
  const int nu = (int)blockIdx.x < units ? (units - 1 - blockIdx.x) / G + 1 : 0;
  const int Rp = sm.Rp, ng = Rp >> 3;
  constexpr int kPad = kTC ? 8 : 4;
  const int KWt = (kXBytes / (Rp * (int)sizeof(T)) - kPad) / B::BK;
  const int XP = KWt * B::BK + kPad;
  T* xs = static_cast<T*>(sm.xs);

  fence_proxy_async();                  // earlier shared-memory use first
  __syncthreads();
  // the producer's cursor (thread 0): unit j, k tile kt
  int pj = 0, pkt = 0, pend = 0;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(sm.bars + 8 * s);
    mbar_init_fence();
    for (int i = 0; i < g.nm; ++i) tmap_acquire(g.m[i].map);
    if (nu > 0) {
      const Unit<B> U(g, blockIdx.x);
      pkt = U.kt0;
      pend = U.kt1;
    }
  }
  __syncthreads();
  // thread 0: the next item of the block's sequence into stage n % ST
  auto issue_next = [&](int n) {
    while (pj < nu && pkt >= pend) {
      if (++pj < nu) {
        const Unit<B> U(g, blockIdx.x + pj * G);
        pkt = U.kt0;
        pend = U.kt1;
      }
    }
    if (pj >= nu) return;
    const Unit<B> U(g, blockIdx.x + pj * G);
    issue<B>(sm.ring + (n % ST) * B::STAGE, sm.bars + 8 * (n % ST), g, U,
             pkt++);
  };
  if (tid == 0)
    for (int n = 0; n < ST - 1; ++n) issue_next(n);
  pre();                                // with the first stages in flight

  int item = 0;
  for (int j = 0; j < nu; ++j) {
    const Unit<B> U(g, blockIdx.x + j * G);
    const int nk = U.kt1 - U.kt0;
    constexpr int kGW = kTC ? B::GW : 1;
    float acc[kGW][kMaxRows / 8][kTC ? 4 : 8];
#pragma unroll
    for (int a = 0; a < kGW; ++a)
#pragma unroll
      for (int b = 0; b < kMaxRows / 8; ++b)
#pragma unroll
        for (int c = 0; c < (kTC ? 4 : 8); ++c) acc[a][b][c] = 0.f;
    for (int kk = 0; kk < nk; ++kk, ++item) {
      const int w = kk / KWt;
      if (kk == w * KWt) {
        __syncthreads();                 // every warp is done with the window
        stage_x<T>(stage, xs, XP, Rp, p.R, g.K, (U.kt0 + kk) * B::BK,
                   min(KWt, nk - kk) * B::BK);
        __syncthreads();
      }
      // every warp is done with the previous item, whose stage is
      // refilled now
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) issue_next(item + ST - 1);
      mbar_wait(sm.bars + 8 * (item % ST), (item / ST) & 1);
      const unsigned char* stg = sm.ring + (item % ST) * B::STAGE;
      const int xk = (kk - w * KWt) * B::BK;
      if constexpr (kTC)
        mma_strip<W, B>(acc, stg, xs, XP, xk, ng, warp, lane);
      else
        fma_strip<W, B>(acc[0], stg, xs, XP, xk, ng, warp, lane);
    }
    // the unit's sums, straight from the registers
    const Mat& m = g.m[U.mi];
    float* out = g.part + (size_t)U.c * p.R * g.ld + m.col;
    const int c0 = U.strip * B::UC;
    if constexpr (kTC) {
      constexpr int GPB = B::BC / 16;
      const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int q = 0; q < B::GW; ++q) {
        const int grp = B::GW * warp + q;
        const int cb = (grp / GPB) * B::BC + (grp % GPB) * 16;
#pragma unroll
        for (int gi = 0; gi < kMaxRows / 8; ++gi) {
          if (gi >= ng) break;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 8 * gi + 2 * tq + (i & 1);
            const int n = c0 + cb + (sizeof(W) == 2 ? gq + 8 * (i >> 1)
                                                    : 2 * gq + (i >> 1));
            if (r < p.R && n < m.n) out[(size_t)r * g.ld + n] = acc[q][gi][i];
          }
        }
      }
    } else {
      constexpr int CW = B::UC / kWarps;
      const int n = c0 + warp * CW + (CW == 16 ? (lane & 15) : lane);
#pragma unroll
      for (int gi = 0; gi < kMaxRows / 8; ++gi) {
        if (gi >= ng) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = acc[0][gi][i];
          if (CW == 16) v += __shfl_xor_sync(0xffffffffu, v, 16);
          const int r = 8 * gi + i;
          if ((CW == 32 || lane < 16) && r < p.R && n < m.n)
            out[(size_t)r * g.ld + n] = v;
        }
      }
    }
  }
}

// rstd of each of the R rows of x (ld8(r, k, v): 8 values) into srstd;
// four chunks' loads in flight per lane
template <typename Ld>
__device__ void rows_rstd(Ld ld8, int R, int D, float eps, float* srstd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 8 * lane; k0 < D; k0 += 4 * 256) {
      float v[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (k0 + q * 256 < D) {
          ld8(r, k0 + q * 256, v[q]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[q][j] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[q] = fmaf(v[q][j], v[q][j], s[q]);
    }
    const float t = warp_sum((s[0] + s[1]) + (s[2] + s[3]));
    if (lane == 0) srstd[r] = 1.0f / sqrtf(t / (float)D + eps);
  }
  __syncthreads();
}

// sum of a partial buffer's ks chunks at (r, c), in chunk order
__device__ __forceinline__ float sum_parts(const float* part, int ks, int R,
                                           int ld, int r, int c) {
  float s = 0.f;
#pragma unroll 4
  for (int kc = 0; kc < ks; ++kc)
    s += __ldcg(part + ((size_t)kc * R + r) * ld + c);
  return s;
}

// an int8 column scale (1 for fp weights)
__device__ __forceinline__ float col_scale(const float* s, int n) {
  return s != nullptr ? s[n] : 1.f;
}

// ---------------------------------------------------------------------------
// attention

// the running-amax requantizing append of one token into its int8 page
// (the math of the engine's _quantized_append, which rounds amax / 127
// in the hidden type T)
template <typename T>
__device__ void quant_append(int8_t* pages, float* scales, int P, int ps,
                             int dh, int hk, int page, int off,
                             const float* tok, float* sred) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float a = 0.f;
  for (int e = tid; e < dh; e += kThreads) a = fmaxf(a, fabsf(tok[e]));
  a = warp_max(a);
  if (lane == 0) sred[warp] = a;
  __syncthreads();
  float amax = 0.f;
  for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, sred[w]);
  const float cand = Val<T>::rnd(Val<T>::rnd(fmaxf(amax, 1e-8f)) / 127.0f);
  const size_t at = (size_t)hk * P + page;
  const float old_s = __ldcg(scales + at);
  const float new_s = fmaxf(old_s, cand);
  const float ratio = new_s > 0.f ? old_s / new_s : 0.f;
  const float den = fmaxf(new_s, 1e-30f);
  int8_t* pg = pages + at * ps * dh;
  for (int i = tid; i < ps * dh; i += kThreads) {
    const int j = i / dh, e = i % dh;
    const float q = j == off ? rintf(tok[e] / den)
                             : rintf(Val<int8_t>::ldcg(pg + i) * ratio);
    pg[i] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
  __syncthreads();   // every thread has read old_s
  if (tid == 0) scales[at] = new_s;
  __syncthreads();
}

// Phase 1, per (row, kv head): the q heads of the group, k and v from the
// projection partials, summed, rounded and roped (into p.qkv); the self-kv outputs,
// the appended record and the pool write.
template <typename T, typename PT>
__device__ void rope_phase(const Params& p, const unsigned long long* lp,
                           int layer, float* smem) {
  const int tid = threadIdx.x;
  const int R = p.R, H = p.H, Hkv = p.Hkv, dh = p.dh, grp = H / Hkv;
  const int n_qkv = (H + (p.with_kv ? 2 * Hkv : 0)) * dh;
  const int n_full = (H + 2 * Hkv) * dh;
  constexpr bool kQuant = sizeof(PT) == 1;
  float* raw = smem;                            // [(grp + 2) * dh]
  float* skc = raw + (kMaxGroup + 2) * kMaxDh;  // [dh] roped k
  float* svc = skc + kMaxDh;                    // [dh] v
  float* sred = svc + kMaxDh;                   // [warps]
  const float* sq = reinterpret_cast<const float*>(lp[P_SQ]);
  const float* sk = reinterpret_cast<const float*>(lp[P_SK]);
  const float* sv = reinterpret_cast<const float*>(lp[P_SV]);
  for (int u = blockIdx.x; u < R * Hkv; u += gridDim.x) {
    const int r = u / Hkv, hk = u % Hkv;
    const int nv = (grp + (p.with_kv ? 2 : 0)) * dh;
    __syncthreads();
    // q heads hk*grp.., then k, v: their column in the sums (and qkv)
    auto column = [&](int i) {
      const int part = i / dh, e = i % dh;
      if (part < grp) return (hk * grp + part) * dh + e;
      if (part == grp) return H * dh + hk * dh + e;
      return (H + Hkv) * dh + hk * dh + e;
    };
    // the projection sums in chunk order, scaled after the sum (int8)
    auto scale = [&](int i) {
      const int part = i / dh, e = i % dh;
      if (part < grp) return col_scale(sq, (hk * grp + part) * dh + e);
      return col_scale(part == grp ? sk : sv, hk * dh + e);
    };
    for (int i = tid; i < nv; i += kThreads)
      raw[i] = Val<T>::rnd(sum_parts(p.part_qkv, p.ks_qkv, R, n_qkv, r,
                                     column(i)) * scale(i));
    __syncthreads();
    // rope at position kv_len - 1 (interleaved pairs), rounded to T
    for (int i = tid; i < nv; i += kThreads) {
      const int part = i / dh, e = i % dh;
      float out = raw[i];
      if (part <= grp) {
        const float c = p.cos[r * dh + e], s = p.sin[r * dh + e];
        const float x = raw[i], y = raw[i ^ 1];
        out = (e & 1) ? __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s))
                      : __fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s));
        out = Val<T>::rnd(out);
      }
      p.qkv[(size_t)r * n_full + column(i)] = out;
      if (part == grp)
        skc[e] = out;
      else if (part > grp)
        svc[e] = out;
    }
    __syncthreads();
    if (!p.with_kv) continue;
    for (int e = tid; e < dh; e += kThreads) {
      if (p.k_cur != nullptr) {
        const size_t at = (size_t)r * Hkv * dh + hk * dh + e;
        Val<T>::st(static_cast<T*>(p.k_cur) + at, skc[e]);
        Val<T>::st(static_cast<T*>(p.v_cur) + at, svc[e]);
      }
      if (p.appended != nullptr) {
        const size_t at = (((size_t)layer * 2 * R + r) * Hkv + hk) * dh + e;
        p.appended[at] = skc[e];
        p.appended[at + (size_t)R * Hkv * dh] = svc[e];
      }
    }
    const int page = p.append ? p.app_page[r] : 0;
    if (page == 0) continue;
    const int off = p.app_off[r];
    PT* kp = reinterpret_cast<PT*>(lp[P_KP]);
    PT* vp = reinterpret_cast<PT*>(lp[P_VP]);
    if constexpr (kQuant) {
      quant_append<T>(reinterpret_cast<int8_t*>(kp),
                      reinterpret_cast<float*>(lp[P_KS]), p.P, p.ps, dh, hk,
                      page, off, skc, sred);
      quant_append<T>(reinterpret_cast<int8_t*>(vp),
                      reinterpret_cast<float*>(lp[P_VS]), p.P, p.ps, dh, hk,
                      page, off, svc, sred);
    } else {
      const size_t at = (((size_t)hk * p.P + page) * p.ps + off) * dh;
      for (int e = tid; e < dh; e += kThreads) {
        Val<T>::st(reinterpret_cast<T*>(kp) + at + e, skc[e]);
        Val<T>::st(reinterpret_cast<T*>(vp) + at + e, svc[e]);
      }
    }
  }
}

// The splits of row r: ceil(Lc / kSplit), at least 1 (split 0 always
// runs: it carries the self term, and a row with nothing to attend
// still writes its empty state).
__device__ __forceinline__ int row_splits(const Params& p, int r) {
  const int Lc = p.kv_lens[r] - (p.self_kv ? 1 : 0);
  return min(p.S, max(1, (Lc + kSplit - 1) / kSplit));
}

// attention unit u (numbered row by row): row, kv head, split and its
// positions [p0, p1), from the phase's table of each row's first unit
// (ucum[R + 1]), splits and attended length
struct AttnUnit {
  int r, hk, s, p0, p1;
  __device__ __forceinline__ AttnUnit(const int* ucum, const int* uns,
                                      const int* ulc, int u) {
    r = 0;
    while (u >= ucum[r + 1]) ++r;
    const int v = u - ucum[r], ns = uns[r];
    hk = v / ns;
    s = v % ns;
    p0 = s * kSplit;
    p1 = min(ulc[r], p0 + kSplit);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 consecutive elements of a K or V row in shared memory, as f32
template <typename PT>
__device__ __forceinline__ void row4(const PT* p, float v[4]) {
  if constexpr (sizeof(PT) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (sizeof(PT) == 2) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
  } else {
    const unsigned int a = *reinterpret_cast<const unsigned int*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (float)(int8_t)(a >> (8 * i));
  }
}

// Phase 2, per (row, kv head, split of kSplit positions): the block's
// units in turn, the K and V rows, q heads and self k, v of its next
// STAGES - 1 units copied by cp.async into a ring while it computes the
// current one (each position's pool row, and an int8 pool's page scales,
// looked up a unit further ahead, one position per thread). Warps take kPos
// positions of the unit, each lane 4 consecutive elements of the head,
// each warp its own online softmax, merged in warp order into att = (acc,
// m, l) for every q head of the group. Only the splits that hold
// positions are units, numbered row by row.
template <typename T, typename PT>
__device__ void attend_phase(const Params& p, const unsigned long long* lp,
                             unsigned char* ring, void* merge) {
  constexpr int ES = (int)sizeof(PT);
  constexpr bool kQuant = ES == 1;
  using Ring = AttnRing<PT>;
  constexpr int AS = Ring::STAGES, D = AS - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.R, H = p.H, Hkv = p.Hkv, dh = p.dh, grp = H / Hkv;
  const int S = p.S, n_full = (H + 2 * Hkv) * dh;
  const PT* kp = reinterpret_cast<const PT*>(lp[P_KP]);
  const PT* vp = reinterpret_cast<const PT*>(lp[P_VP]);
  const float* ksc = reinterpret_cast<const float*>(lp[P_KS]);
  const float* vsc = reinterpret_cast<const float*>(lp[P_VS]);
  float* wm = static_cast<float*>(merge);         // [warps][grp]
  float* wl = wm + kWarps * kMaxGroup;            // [warps][grp]
  float* wacc = wl + kWarps * kMaxGroup;          // [warps][grp][dh]
  int* spos = reinterpret_cast<int*>(wacc + kWarps * kMaxGroup * kMaxDh);
  float* sks = reinterpret_cast<float*>(spos + AS * kSplit);  // [AS][kSplit]
  float* svs = sks + AS * kSplit;                              // [AS][kSplit]
  int* ucum = reinterpret_cast<int*>(svs + AS * kSplit);       // [R + 1]
  int* uns = ucum + kMaxRows + 1;                             // [R]
  int* ulc = uns + kMaxRows;                                  // [R]
  const int e0 = 4 * lane;                        // this lane's elements
  const bool lane_ok = e0 < dh;
  const int row_bytes = dh * ES, cpr = row_bytes / 16;
  fence_proxy_async();
  __syncthreads();
  if (tid < R) {
    uns[tid] = row_splits(p, tid);
    ulc[tid] = p.kv_lens[tid] - (p.self_kv ? 1 : 0);
  }
  __syncthreads();
  if (tid == 0) {
    ucum[0] = 0;
    for (int r = 0; r < R; ++r) ucum[r + 1] = ucum[r] + uns[r] * Hkv;
  }
  __syncthreads();
  const int units = ucum[R];
  const int G = gridDim.x;
  const int nj = (int)blockIdx.x < units ? (units - 1 - blockIdx.x) / G + 1
                                         : 0;
  // position tid of the block's unit j: its pool row and page scales
  int row_n = 0;
  float kf_n = 1.f, vf_n = 1.f;
  auto lookup = [&](int j) {
    row_n = 0;
    kf_n = vf_n = 1.f;
    if (j >= nj || tid >= kSplit) return;
    const AttnUnit A(ucum, uns, ulc, blockIdx.x + j * G);
    const int pos = A.p0 + tid;
    if (pos >= A.p1) return;
    const int pg = p.tables[(size_t)A.r * p.pps + pos / p.ps];
    row_n = (A.hk * p.P + pg) * p.ps + pos % p.ps;
    if constexpr (kQuant) {
      kf_n = __ldcg(ksc + (size_t)A.hk * p.P + pg);
      vf_n = __ldcg(vsc + (size_t)A.hk * p.P + pg);
    }
  };
  auto keep = [&](int j) {                // the lookup into buffer j % AS
    if (tid < kSplit) {
      const int b = (j % AS) * kSplit + tid;
      spos[b] = row_n;
      sks[b] = kf_n;
      svs[b] = vf_n;
    }
  };
  // unit j's K and V rows, q heads and self k, v into stage j % AS
  auto copy = [&](int j) {
    if (j >= nj) return;
    const AttnUnit A(ucum, uns, ulc, blockIdx.x + j * G);
    const int n = A.p1 - A.p0;
    unsigned char* st = ring + (j % AS) * Ring::BYTES;
    float* sqk = reinterpret_cast<float*>(st + Ring::KV);
    const float* row = p.qkv + (size_t)A.r * n_full;
    const int nq = grp * dh / 4, ns = p.self_kv && A.s == 0 ? dh / 4 : 0;
    for (int q = tid; q < nq + 2 * ns; q += kThreads) {
      const int part = q < nq ? 0 : 1 + (q - nq) / ns;
      const int c = q < nq ? q : (q - nq) % ns;
      const float* src = part == 0 ? row + A.hk * grp * dh
                       : part == 1 ? row + H * dh + A.hk * dh
                                   : row + (H + Hkv) * dh + A.hk * dh;
      cp_async16(sqk + (part == 0 ? 0 : (kMaxGroup + part - 1) * kMaxDh) +
                     4 * c, src + 4 * c);
    }
    const char* src[2] = {reinterpret_cast<const char*>(kp),
                          reinterpret_cast<const char*>(vp)};
    const int* rows = spos + (j % AS) * kSplit;
    // rows rr < 2n (K rows, then V rows), 16-byte chunk c of each
    auto one = [&](int rr, int c) {
      const int kv = rr >= n, pos = rr - kv * n;
      cp_async16(st + (kv * kSplit + pos) * row_bytes + c * 16,
                 src[kv] + (size_t)rows[pos] * row_bytes + c * 16);
    };
    if (kThreads % cpr == 0) {
      const int c = tid % cpr;
      for (int rr = tid / cpr; rr < 2 * n; rr += kThreads / cpr) one(rr, c);
    } else {
      for (int q = tid; q < 2 * n * cpr; q += kThreads) one(q / cpr, q % cpr);
    }
  };

  // the first D units' rows kept and their copies issued; unit D's
  // lookup in flight
  for (int d = 0; d < D; ++d) {
    lookup(d);
    keep(d);
  }
  lookup(D);
  __syncthreads();
  for (int d = 0; d < D; ++d) {
    copy(d);
    cp_commit();
  }
  for (int j = 0; j < nj; ++j) {
    keep(j + D);                          // buffer (j + D) % AS is free
    lookup(j + D + 1);
    __syncthreads();
    copy(j + D);
    cp_commit();
    const AttnUnit A(ucum, uns, ulc, blockIdx.x + j * G);
    const bool self = p.self_kv && A.s == 0;
    cp_wait<D>();                         // this unit's copies
    __syncthreads();
    const unsigned char* st = ring + (j % AS) * Ring::BYTES;
    const float* sqk = reinterpret_cast<const float*>(st + Ring::KV);
    float q[kMaxGroup][4], m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][4];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[g][c] = 0.f;
        q[g][c] = g < grp && lane_ok ? sqk[g * dh + e0 + c] : 0.f;
      }
    }
    if (self && warp == 0) {
      // the current token's term seeds warp 0: m = s_self, l = 1, acc = v
      float kc[4], vc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kc[c] = lane_ok ? sqk[kMaxGroup * kMaxDh + e0 + c] : 0.f;
        vc[c] = lane_ok ? sqk[(kMaxGroup + 1) * kMaxDh + e0 + c] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= grp) break;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) d = fmaf(q[g][c], kc[c], d);
        m[g] = warp_sum(d) * p.scale;
        l[g] = 1.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][c] = vc[c];
      }
    }
    const PT* ks = reinterpret_cast<const PT*>(st);
    const PT* vs = reinterpret_cast<const PT*>(st + kSplit * row_bytes);
    const float* fk = sks + (j % AS) * kSplit;
    const float* fv = svs + (j % AS) * kSplit;
    const int i0 = warp * kPos;
    float kx[kPos][4], vx[kPos][4];
#pragma unroll
    for (int i = 0; i < kPos; ++i) {
      if (lane_ok && A.p0 + i0 + i < A.p1) {
        row4<PT>(ks + (i0 + i) * dh + e0, kx[i]);
        row4<PT>(vs + (i0 + i) * dh + e0, vx[i]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) kx[i][c] = vx[i][c] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= grp) break;
      float sc[kPos], mx = m[g];
#pragma unroll
      for (int i = 0; i < kPos; ++i) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) d = fmaf(q[g][c], kx[i][c], d);
        const bool ok = A.p0 + i0 + i < A.p1;
        d = warp_sum(d) * (ok ? fk[i0 + i] : 1.f) * p.scale;
        sc[i] = ok ? d : kNegInf;
        mx = fmaxf(mx, sc[i]);
      }
      const float alpha = expf(m[g] - mx);
      float sum = 0.f, ex[kPos];
#pragma unroll
      for (int i = 0; i < kPos; ++i) {
        ex[i] = A.p0 + i0 + i < A.p1 ? expf(sc[i] - mx) : 0.f;
        sum += ex[i];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[g][c] * alpha;
#pragma unroll
        for (int i = 0; i < kPos; ++i) {
          const float f = A.p0 + i0 + i < A.p1 ? ex[i] * fv[i0 + i] : 0.f;
          a = fmaf(f, vx[i][c], a);
        }
        acc[g][c] = a;
      }
    }
    // merge the warps' softmax states into the unit's
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= grp) break;
      if (lane == 0) {
        wm[warp * kMaxGroup + g] = m[g];
        wl[warp * kMaxGroup + g] = l[g];
      }
      if (lane_ok)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wacc[(warp * kMaxGroup + g) * kMaxDh + e0 + c] = acc[g][c];
    }
    __syncthreads();
    float* out = p.att + (size_t)((A.r * Hkv + A.hk) * S + A.s) * grp *
                             (dh + 2);
    for (int i = tid; i < grp * dh; i += kThreads) {
      const int g = i / dh, e = i % dh;
      float mx = kNegInf;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kMaxGroup + g]);
      float ls = 0.f, as = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(wm[w * kMaxGroup + g] - mx);
        ls = fmaf(wl[w * kMaxGroup + g], f, ls);
        as = fmaf(wacc[(w * kMaxGroup + g) * kMaxDh + e], f, as);
      }
      out[g * (dh + 2) + e] = as;
      if (e == 0) {
        out[g * (dh + 2) + dh] = mx;
        out[g * (dh + 2) + dh + 1] = ls;
      }
    }
    __syncthreads();                      // the stage and the merge are free
  }
  cp_wait<0>();
}

// o[r, i] (i = q head x dh + e): the splits of (row r, q head) merged in
// split order, rounded to T
template <typename T>
__device__ __forceinline__ float combine_at(const Params& p, int r, int i) {
  const int dh = p.dh, grp = p.H / p.Hkv, hq = i / dh, e = i % dh;
  const int hk = hq / grp, g = hq % grp;
  const int ns = row_splits(p, r);
  const float* at =
      p.att + ((size_t)(r * p.Hkv + hk) * p.S * grp + g) * (dh + 2);
  const size_t stride = (size_t)grp * (dh + 2);
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, __ldcg(at + s * stride + dh));
  float ls = 0.f, as = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float f = expf(__ldcg(at + s * stride + dh) - mx);
    ls = fmaf(__ldcg(at + s * stride + dh + 1), f, ls);
    as = fmaf(__ldcg(at + s * stride + e), f, as);
  }
  return Val<T>::rnd(as / fmaxf(ls, 1e-30f));
}

// act[r, c] = silu(gate) * up from the gate|up partials, each summed in
// chunk order and scaled, rounded where the plain version rounds
template <typename T>
__device__ __forceinline__ float act_at(const Params& p, const float* sg,
                                        const float* su, int r, int c) {
  const int F = p.F;
  const float g = Val<T>::rnd(
      sum_parts(p.part_gu, p.ks_gu, p.R, 2 * F, r, c) * col_scale(sg, c));
  const float u = Val<T>::rnd(
      sum_parts(p.part_gu, p.ks_gu, p.R, 2 * F, r, F + c) *
      col_scale(su, c));
  return Val<T>::rnd(Val<T>::rnd(g / (1.0f + expf(-g))) * u);
}

// ---------------------------------------------------------------------------
// the layer (or model) body

template <typename T, typename W, typename PT>
__global__ void __launch_bounds__(kThreads, 1)
decode_megakernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm;
  sm.ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* tail = smem_raw + kSmemBytes - kTailBytes;
  sm.rstd = reinterpret_cast<float*>(tail);
  sm.bars = smem_u32(tail + 256);
  sm.xs = tail + 256 + 8 * kMaxStages;
  sm.Rp = (p.R + 7) & ~7;
  const int R = p.R, D = p.D, F = p.F, H = p.H, Hkv = p.Hkv, dh = p.dh;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int gstride = gridDim.x * kThreads;
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.stamps[0] = now_ns();
  for (int layer = 0; layer < p.L; ++layer) {
    int ph = 1 + kPhases * layer;        // the stamp of the next phase end
    const unsigned long long* lp = p.layers + (size_t)layer * kPtrs;
    const CUtensorMap* mp = p.maps + (size_t)layer * kMaps;
    const T* hin = static_cast<const T*>(layer == 0 ? p.h_in : p.h_out);
    const T* ln1 = reinterpret_cast<const T*>(lp[P_LN1]);
    const T* ln2 = reinterpret_cast<const T*>(lp[P_LN2]);
    auto sc = [&](int i) { return reinterpret_cast<const float*>(lp[i]); };
    const int n_qkv = (H + (p.with_kv ? 2 * Hkv : 0)) * dh;

    // 0. x = rms_norm(h) * ln1; q|k|v projections
    {
      Proj g;
      g.m[0] = {mp + M_Q, H * dh, 0};
      g.m[1] = {mp + M_K, Hkv * dh, H * dh};
      g.m[2] = {mp + M_V, Hkv * dh, (H + Hkv) * dh};
      g.nm = p.with_kv ? 3 : 1;
      g.K = D;
      g.ks = p.ks_qkv;
      g.ld = n_qkv;
      g.part = p.part_qkv;
      proj_phase<T, W>(
          p, g,
          [&] {
            rows_rstd([&](int r, int k, float v[8]) {
                        Val<T>::ld8(hin + (size_t)r * D + k, v);
                      }, R, D, p.eps, sm.rstd);
          },
          [&](int r, int k, float v[8]) {
            float x[8], w[8];
            Val<T>::ld8(hin + (size_t)r * D + k, x);
            Val<T>::ld8(ln1 + k, w);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              v[j] = Val<T>::rnd(Val<T>::rnd(x[j] * sm.rstd[r]) * w[j]);
          },
          sm);
    }
    phase_end(p, ph++);

    // 1-3. rope and the append; attention over position splits; merge -> o
    rope_phase<T, PT>(p, lp, layer, reinterpret_cast<float*>(sm.ring));
    phase_end(p, ph++);
    attend_phase<T, PT>(p, lp, sm.ring, sm.xs);
    phase_end(p, ph++);
    for (int i = gtid; i < R * H * dh; i += gstride)
      p.o[i] = combine_at<T>(p, i / (H * dh), i % (H * dh));
    phase_end(p, ph++);

    // 4. o projection
    {
      Proj g;
      g.m[0] = {mp + M_O, D, 0};
      g.nm = 1;
      g.K = H * dh;
      g.ks = p.ks_o;
      g.ld = D;
      g.part = p.part_o;
      proj_phase<T, W>(
          p, g, [] {},
          [&](int r, int k, float v[8]) {
            Val<float>::ld8(p.o + (size_t)r * H * dh + k, v);
          },
          sm);
    }
    phase_end(p, ph++);

    // 5. h2 = h + o-proj
    for (int i = gtid; i < R * D; i += gstride) {
      const int r = i / D, c = i % D;
      const float y = Val<T>::rnd(sum_parts(p.part_o, p.ks_o, R, D, r, c) *
                                  col_scale(sc(P_SO), c));
      p.h2[i] = Val<T>::rnd(Val<T>::ldcg(hin + i) + y);
    }
    phase_end(p, ph++);

    // 6. x2 = rms_norm(h2) * ln2; gate|up projections
    {
      Proj g;
      g.m[0] = {mp + M_G, F, 0};
      g.m[1] = {mp + M_U, F, F};
      g.nm = 2;
      g.K = D;
      g.ks = p.ks_gu;
      g.ld = 2 * F;
      g.part = p.part_gu;
      proj_phase<T, W>(
          p, g,
          [&] {
            rows_rstd([&](int r, int k, float v[8]) {
                        Val<float>::ld8(p.h2 + (size_t)r * D + k, v);
                      }, R, D, p.eps, sm.rstd);
          },
          [&](int r, int k, float v[8]) {
            float x[8], w[8];
            Val<float>::ld8(p.h2 + (size_t)r * D + k, x);
            Val<T>::ld8(ln2 + k, w);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              v[j] = Val<T>::rnd(Val<T>::rnd(x[j] * sm.rstd[r]) * w[j]);
          },
          sm);
    }
    phase_end(p, ph++);

    // 7. act = silu(gate) * up
    for (int i = gtid; i < R * F; i += gstride)
      p.act[i] = act_at<T>(p, sc(P_SG), sc(P_SU), i / F, i % F);
    phase_end(p, ph++);

    // 8. down projection
    {
      Proj g;
      g.m[0] = {mp + M_D, D, 0};
      g.nm = 1;
      g.K = F;
      g.ks = p.ks_d;
      g.ld = D;
      g.part = p.part_d;
      proj_phase<T, W>(
          p, g, [] {},
          [&](int r, int k, float v[8]) {
            Val<float>::ld8(p.act + (size_t)r * F + k, v);
          },
          sm);
    }
    phase_end(p, ph++);

    // 9. h_out = h2 + down
    for (int i = gtid; i < R * D; i += gstride) {
      const int r = i / D, c = i % D;
      const float y = Val<T>::rnd(sum_parts(p.part_d, p.ks_d, R, D, r, c) *
                                  col_scale(sc(P_SD), c));
      Val<T>::st(static_cast<T*>(p.h_out) + i,
                 Val<T>::rnd(__ldcg(p.h2 + i) + y));
    }
    // the next layer reads every row of h_out; a timed launch closes the
    // last layer's phase too
    if (layer + 1 < p.L || p.stamps != nullptr) phase_end(p, ph++);
  }
}

// ---------------------------------------------------------------------------
// launch plumbing

template <typename T, typename W, typename PT>
cudaError_t opt_in() {
  static cudaError_t err = cudaFuncSetAttribute(
      decode_megakernel<T, W, PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  return err;
}

template <typename T, typename W, typename PT>
int grid_for(int* grid) {
  cudaError_t err = opt_in<T, W, PT>();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_megakernel<T, W, PT>, kThreads, kSmemBytes)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = per_sm * sms;
  return 0;
}

// one cooperative launch: the runtime refuses it unless every block is
// resident, which the grid barrier needs. cudaLaunchKernelEx with the
// cooperative attribute, which a stream capture takes into a CUDA graph
template <typename T, typename W, typename PT>
int launch(const Params* p, int grid, cudaStream_t stream) {
  cudaError_t err = opt_in<T, W, PT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_megakernel<T, W, PT>, *p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// the 8 variants: dtype 0 = f32, 1 = bf16; quant_w / quant_kv: int8
// weights / int8 pool
#define DMK_DISPATCH(FN, ...)                                                \
  do {                                                                       \
    if (dtype == 0) {                                                        \
      if (quant_w)                                                           \
        return quant_kv ? FN<float, int8_t, int8_t>(__VA_ARGS__)             \
                        : FN<float, int8_t, float>(__VA_ARGS__);             \
      return quant_kv ? FN<float, float, int8_t>(__VA_ARGS__)                \
                      : FN<float, float, float>(__VA_ARGS__);                \
    }                                                                        \
    if (dtype == 1) {                                                        \
      typedef __nv_bfloat16 bf;                                              \
      if (quant_w)                                                           \
        return quant_kv ? FN<bf, int8_t, int8_t>(__VA_ARGS__)                \
                        : FN<bf, int8_t, bf>(__VA_ARGS__);                   \
      return quant_kv ? FN<bf, bf, int8_t>(__VA_ARGS__)                      \
                      : FN<bf, bf, bf>(__VA_ARGS__);                         \
    }                                                                        \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)

// The co-resident block count of one variant on the current device (the
// grid of every launch of it), in *grid. Returns a CUDA error code.
extern "C" int decode_megakernel_grid(int dtype, int quant_w, int quant_kv,
                                      int* grid) {
  DMK_DISPATCH(grid_for, grid);
}

// The kernel's limits, for the wrapper: most rows, most query heads per kv
// head, most head_dim, the positions of an attention unit, the phases of a
// layer, the x window's bytes.
extern "C" void decode_megakernel_limits(int* out) {
  out[0] = kMaxRows;
  out[1] = kMaxGroup;
  out[2] = kMaxDh;
  out[3] = kSplit;
  out[4] = kPhases;
  out[5] = kXBytes;
}

template <typename T, typename W>
int strip_of(int* out) {
  out[0] = Box<T, W>::UC;
  out[1] = Box<T, W>::BK;
  out[2] = Box<T, W>::BC;
  return 0;
}

// A projection unit's geometry for hidden dtype (0 = f32, 1 = bf16) and
// int8 or fp weights: its strip's columns, its k tile, a box's columns.
extern "C" int decode_megakernel_strip(int dtype, int quant_w, int* out) {
  if (dtype == 0)
    return quant_w ? strip_of<float, int8_t>(out) : strip_of<float, float>(out);
  if (dtype == 1)
    return quant_w ? strip_of<__nv_bfloat16, int8_t>(out)
                   : strip_of<__nv_bfloat16, __nv_bfloat16>(out);
  return (int)cudaErrorInvalidValue;
}

// The tensor map of a row-major weight [outer, inner] (hidden dtype 0 =
// f32, 1 = bf16; int8 or fp weights), rows `stride` bytes apart, in the
// kernel's boxes (128 bytes x BK rows, the 128-byte swizzle), into out
// (128 bytes). Returns a CUDA error code.
extern "C" int decode_megakernel_encode(int dtype, int quant_w,
                                        const void* base, int inner,
                                        int outer, long long stride,
                                        void* out) {
  CUtensorMapDataType type;
  int geo[3];
  if (quant_w) {
    type = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  } else if (dtype == 1) {
    type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  } else if (dtype == 0) {
    type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int err = decode_megakernel_strip(dtype, quant_w, geo);
  if (err != 0) return err;
  CUtensorMap map;
  if (!encode_2d(&map, type, base, inner, outer, stride, geo[2], geo[1],
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorNotSupported;
  memcpy(out, &map, sizeof(map));
  return 0;
}

// Launch. ptrs: 24 device pointers (layers, maps, h_in, h_out, k_cur,
// v_cur, tables, kv_lens, cos, sin, app_page, app_off, appended, part_qkv,
// qkv, att, o, part_o, h2, part_gu, act, part_d, bar, stamps); dims: L, R,
// D, H, Hkv, dh, F, P, ps, pps, ks_qkv, ks_o, ks_gu, ks_d, self_kv,
// with_kv, append, S. Asynchronous on `stream`; returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int decode_megakernel(int dtype, int quant_w, int quant_kv,
                                 const unsigned long long* ptrs,
                                 const int* dims, float eps, float scale,
                                 int grid, void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  int i = 0;
  auto ptr = [&]() { return reinterpret_cast<void*>(ptrs[i++]); };
  p.layers = static_cast<const unsigned long long*>(ptr());
  p.maps = static_cast<const CUtensorMap*>(ptr());
  p.h_in = ptr();
  p.h_out = ptr();
  p.k_cur = ptr();
  p.v_cur = ptr();
  p.tables = static_cast<const int*>(ptr());
  p.kv_lens = static_cast<const int*>(ptr());
  p.cos = static_cast<const float*>(ptr());
  p.sin = static_cast<const float*>(ptr());
  p.app_page = static_cast<const int*>(ptr());
  p.app_off = static_cast<const int*>(ptr());
  p.appended = static_cast<float*>(ptr());
  p.part_qkv = static_cast<float*>(ptr());
  p.qkv = static_cast<float*>(ptr());
  p.att = static_cast<float*>(ptr());
  p.o = static_cast<float*>(ptr());
  p.part_o = static_cast<float*>(ptr());
  p.h2 = static_cast<float*>(ptr());
  p.part_gu = static_cast<float*>(ptr());
  p.act = static_cast<float*>(ptr());
  p.part_d = static_cast<float*>(ptr());
  p.bar = static_cast<unsigned int*>(ptr());
  p.stamps = static_cast<unsigned long long*>(ptr());
  p.L = dims[0]; p.R = dims[1]; p.D = dims[2]; p.H = dims[3];
  p.Hkv = dims[4]; p.dh = dims[5]; p.F = dims[6]; p.P = dims[7];
  p.ps = dims[8]; p.pps = dims[9];
  p.ks_qkv = dims[10]; p.ks_o = dims[11]; p.ks_gu = dims[12];
  p.ks_d = dims[13];
  p.self_kv = dims[14]; p.with_kv = dims[15]; p.append = dims[16];
  p.S = dims[17];
  p.eps = eps;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DMK_DISPATCH(launch, &p, grid, s);
}
