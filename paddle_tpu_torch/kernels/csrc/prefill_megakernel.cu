// Prefill megakernel for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/prefill_megakernel.py:342
// (_build_prefill_kernel, launched by fused_prefill_layer at :722): a whole
// decoder layer over one ragged step's packed chunk h [T, D] (prefill
// chunks, continuation chunks and decode rows, each row's tokens starting at
// a multiple of q_block, pad rows last at q_start = T):
//
//   rms_norm -> fused q|k|v projection -> rope at each token's position ->
//   the chunk's K/V into its pool slots (fp pools) -> causal ragged paged
//   attention (int8 pages x per-(head, page) scales) -> o projection +
//   residual -> rms_norm -> fused gate|up projection -> silu(gate) * up ->
//   down projection + residual
//
// One PERSISTENT launch per layer (the grid is the co-resident block count,
// in clusters of kCluster blocks) whose phases are separated by a
// hand-written grid barrier (an arrival counter and a generation word, as
// in decode_megakernel.cu). Seven phases, six barriers:
//
//   0. norm:      per token, x = rms_norm(h) * ln1, rounded;
//   1. q|k|v:     x @ W_qkv; its epilogue scales (int8), rounds, ropes q
//                 and k, keeps q and writes a live token's k and v into its
//                 pool slot (fp pools; an int8 pool was appended to before
//                 the launch). The barrier after it makes the fresh K/V
//                 visible, so the TPU kernel's scratch overlay is not needed;
//   2. attention: causal ragged attention over the pages -> o, rounded;
//   3. o:         o @ W_o; its epilogue adds the residual -> h2;
//   4. h2+norm:   per token, x2 = rms_norm(h2) * ln2;
//   5. gate|up:   x2 @ [W_gate | W_up]; its epilogue forms silu(gate) * up;
//   6. down:      act @ W_down; its epilogue adds h2 -> h_out.
//
// Bound on this card, one Llama-2-7B layer at T = 128 (bf16): the weights,
// 202,375,168 parameters = 404.75 MB, over 3.35 TB/s is 0.121 ms; the
// projections' 2 * 128 * 202.4 M = 51.8 GFLOP over 989 TFLOP/s is 0.052 ms;
// bytes bound the layer. So every weight is read once per launch (T <= 128
// is one token tile) by every SM streaming at once, and nothing the layer
// computes goes to device memory and back that need not.
//
// Projections (bf16 activations). A warpgroup owns a 64-column tile of the
// weight over all of K and computes the swapped product out^T = W^T x^T on
// wgmma (m64 n128 k16: the tile's columns are wgmma's m, the 128 tokens its
// n). The two warpgroups of a block take two tiles side by side and share
// the activation tile of each K step. Stages go by TMA tensor maps through
// a ring of mbarrier-tracked stages in dynamic shared memory, as
// int8_matmul.cu's (hopper_tma.cuh holds the shared device code): the raw
// payload (bf16, or int8 as it lies in device memory) in the 128-byte (64-
// byte for int8) swizzle beside the activation tile; thread 0 issues every
// copy, ring depth set by the stage size, refills two tiles behind use.
// Each lane reads the A operand of its rows from the staged tile with
// 32-bit (bf16) or 16-bit (int8) shared loads and forms it in registers
// (prmt; int8 widened exactly by prmt/lop3): A row 16w + g + 8h is the
// tile's column 16w + 2g + h, so a thread's accumulators hold adjacent
// column pairs, which is what rope and silu * up need in one thread.
//   - q|k|v (192 tiles at 7B) and gate|up (172 units of a gate tile and
//     the up tile of the same columns, two A operands per K step over one
//     activation tile) fill the grid's 264 warpgroups with whole columns:
//     the sums never leave registers before their epilogue;
//   - o and down (64 tiles each) are split along K over the kCluster blocks
//     of a cluster; each block leaves its f32 partial tiles in its own
//     shared memory, and after a cluster barrier block r sums its share of
//     the tokens over the blocks' shared memory in rank order (distributed
//     shared memory; no device-memory partials, no atomics), then applies
//     the residual epilogue.
// Tensor maps are encoded by the host once per weight and per scratch
// buffer and passed in the launch's parameters (__grid_constant__).
//
// Attention (bf16 activations) runs on the tensor cores: a warp owns a unit
// of 16 query rows of one sequence row and kv head (with q_block 8 and one
// query head per kv head, two q blocks of the row); a team of kAttnSplit
// warps of one block takes a unit, units dealt team-major over the blocks
// so every SM takes a share, each warp a contiguous share of the row's
// causal horizon, 16 positions at a time through a kAttnStages-deep
// cp.async ring
// of K and V in the pool's own type (bf16, or int8 widened exactly in
// registers), Q.K^T and P.V on mma.sync m16n8k16 with an online softmax in
// registers, and P (times the page's V scale for an int8 pool; the K
// scale multiplies the score) fed to P.V as kPParts bf16 parts, each the
// rounding of what the parts before it left (hi = bf16(P), lo = bf16(P -
// hi), ...): P.V keeps ~8 bits of P per part. The team's (acc, m, l)
// are merged in part order through shared memory by its first warp, so
// two launches are bitwise equal. Dead tokens' outputs are zeros, as the
// plain version's.
//
// f32 activations (on no serving path) keep the CUDA cores: the same
// phases, a projection unit of 128 tokens x 64 columns over all of K with
// the same epilogues, attention a warp per query row and a lane per
// position.
//
// Every value is rounded to the hidden type where the plain version
// (_reference_prefill_layer) rounds it: after each norm, projection, rope,
// the attention output and each residual add. The int8 column scale
// multiplies each column's sum (the plain version scales the weight before
// the sum: the same function rounded in another order).

#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>

#include "hopper_tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// projections: a warpgroup tile is BN columns x BM tokens, walked BK at a
// time
constexpr int BM = 128, BN = 64, BK = 64;
constexpr int kCluster = 2;         // blocks splitting K of o and down
constexpr int kRingBytes = 196608;  // the projection ring (192 KB)
constexpr int kMaxStages = 8;
constexpr int kXBytes = BM * BK * 2;             // an activation tile
constexpr int kPPitch = BN + 4;                  // floats per partial row
constexpr int kPBytes = 4 * BM * kPPitch * 4;    // a block's sum tiles
// attention (tensor cores): positions per step, ring depth, q blocks of a
// row per unit when a q block has fewer than 16 query rows per kv head
constexpr int kAttnPos = 16;
constexpr int kAttnWarps = 8;       // warps of a block that take units
constexpr int kAttnSplit = 2;       // warps splitting a unit's horizon
constexpr int kAttnStages = 2;
constexpr int kPVSlices = 2;        // 16-column V slices per P.V batch
constexpr bool kPairBlocks = true;
constexpr int kPParts = 3;         // P as this many bf16 parts
constexpr int kMaxDh = 128;
constexpr int kMaxBlocks = 1024;    // q blocks of a step (at most)
constexpr int kPhases = 7;
constexpr float kNegInf = -1e30f;
// f32 (CUDA cores): K per step; attention positions per tile and query
// rows per (q block, kv head)
constexpr int FK = 16;
constexpr int kSplit = 64;
constexpr int kRows = 64;
constexpr int kRowsPerWarp = kRows / kWarps;

static_assert(kRingBytes % 1024 == 0 && kPBytes <= kRingBytes, "ring");

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
// bytes of one warp's attention stage: K and V rows of kAttnPos positions
// (row pitch dh elements + 16 bytes, against bank conflicts), their page
// scales; a warp's region: its unit's 16 query rows (bf16), then the stages
constexpr size_t attn_stage_bytes(int es) {
  return 2 * (size_t)kAttnPos * (kMaxDh * es + 16) + 2 * kAttnPos * 4;
}
constexpr size_t kAttnWarpBytes =
    16 * (kMaxDh * 2 + 16) + kAttnStages * attn_stage_bytes(2);
constexpr size_t kAttnBytes =
    (size_t)kAttnWarps * kAttnWarpBytes + kMaxBlocks * 4;
constexpr size_t kGemmF32Bytes = (size_t)FK * ((BM + 4) + 2 * (BN + 4)) * 4;
constexpr size_t kAttnF32Bytes =
    ((size_t)kSplit * (2 * kMaxDh + 1) + (size_t)kRows * kMaxDh +
     kWarps * kSplit) * 4;
constexpr size_t kRingSmem = 1024 + kRingBytes + 8 * kMaxStages;
constexpr size_t kSmemBytes =
    cmax(cmax(kRingSmem, kAttnBytes + 16),
         cmax(kGemmF32Bytes, kAttnF32Bytes));
static_assert(kSmemBytes <= 232448, "shared memory");

struct alignas(64) Params {
  // tensor maps: the weights (q|k|v, o, gate|up, down) and the activation
  // scratch (x, o, act) the projections read (bf16 activations only)
  CUtensorMap tm_w[4];
  CUtensorMap tm_x[3];
  // weights (fused layout) and their int8 column scales (null for fp)
  const void *ln1, *ln2, *w_qkv, *w_o, *w_gu, *w_d;
  const float *s_qkv, *s_o, *s_gu, *s_d;
  void *kp, *vp;                    // [Hkv, P, ps, dh] pools
  const float *ks, *vs;             // [Hkv, P] int8 pool scales or null
  const void* h;                    // [T, D] T
  void* h_out;                      // [T, D] T
  const int* tables;                // [R, pps]
  const int *q_starts, *q_lens, *kv_lens;   // [R]
  const int* block_row;             // [T / qb]
  const int* slot;                  // [T] pool slot of each token
  const float *cos, *sin;           // [T, dh / 2]
  void* xa;        // [T, D] T: x, then x2 (the A of q|k|v and gate|up)
  void* q;         // [T, H * dh] T: roped q
  void* o;         // [T, H * dh] T: attention output
  void* act;       // [T, F] T: silu(gate) * up
  float* h2;       // [T, D]: h + o-proj, rounded
  unsigned int* bar;             // [2] arrival count, generation
  unsigned long long* stamps;    // [1 + kPhases] or null
  int T, D, H, Hkv, dh, F, P, ps, pps, R, qb;
  int nq;          // q|k|v columns projected here (H dh for int8 pools)
  float eps, scale;
};

// ---------------------------------------------------------------------------
// element types

template <typename T> struct Val;
template <> struct Val<float> {
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float x) { *p = x; }
  static __device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  // 4 consecutive values, 16-byte aligned
  static __device__ __forceinline__ void ld4(const float* p, float v[4]) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};
template <> struct Val<__nv_bfloat16> {
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  static __device__ __forceinline__ void st2(__nv_bfloat16* p, float a,
                                             float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <> struct Val<int8_t> {
  static __device__ __forceinline__ float ld(const int8_t* p) {
    return (float)*p;
  }
  static __device__ __forceinline__ void ld4(const int8_t* p, float v[4]) {
    const unsigned int a = __ldcg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (float)(int8_t)(a >> (8 * i));
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

// the sum of x over the block (every thread gets it); red: kWarps floats
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();                       // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Grid-wide barrier (decode_megakernel.cu's, with a proxy fence): thread 0
// of each block reads
// the generation, then arrives; the last arrival resets the count and
// advances the generation, the others wait for it to change. The fences
// order each block's writes before its arrival and the others' reads after
// their release.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  // this block's global writes ordered before the tensor copies (async
  // proxy) that read them in the next phases
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
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

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the barrier after phase i; with p.stamps, block 0 records the device
// clock once every block has finished the phase
__device__ __forceinline__ void phase_end(const Params& p, int i) {
  grid_sync(p.bar);
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.stamps[1 + i] = now_ns();
}

// the live token t: inside its q block's row's q_len
__device__ __forceinline__ bool token_live(const Params& p, int t) {
  const int row = p.block_row[t / p.qb];
  const int off = t - p.q_starts[row];
  return off >= 0 && off < p.q_lens[row];
}

// ---------------------------------------------------------------------------
// epilogues: a token and an even column c with its neighbour c + 1, their
// f32 sums over all of K

// q|k|v: scale (int8), round, rope q and k; q kept, a live token's k and v
// into its pool slot
template <typename T>
__device__ __forceinline__ void epi_qkv(const Params& p, int t, int c,
                                        float a, float b) {
  const int Hd = p.H * p.dh, Kd = p.Hkv * p.dh, dh = p.dh;
  if (p.s_qkv != nullptr) {
    a *= p.s_qkv[c];
    b *= p.s_qkv[c + 1];
  }
  a = Val<T>::rnd(a);
  b = Val<T>::rnd(b);
  if (c < Hd + Kd) {
    // interleaved pairs (2i, 2i + 1) rotate by frequency i, in f32 with
    // unfused multiplies, as the plain version
    const int f = (c % dh) / 2;
    const float cs = p.cos[(size_t)t * (dh / 2) + f];
    const float sn = p.sin[(size_t)t * (dh / 2) + f];
    const float o1 = __fsub_rn(__fmul_rn(a, cs), __fmul_rn(b, sn));
    const float o2 = __fadd_rn(__fmul_rn(b, cs), __fmul_rn(a, sn));
    a = Val<T>::rnd(o1);
    b = Val<T>::rnd(o2);
  }
  if (c < Hd) {
    Val<T>::st2(static_cast<T*>(p.q) + (size_t)t * Hd + c, a, b);
    return;
  }
  if (!token_live(p, t)) return;
  const bool is_v = c >= Hd + Kd;
  const int cc = c - Hd - (is_v ? Kd : 0);
  const size_t at = ((size_t)(cc / dh) * p.P * p.ps + p.slot[t]) * dh +
                    cc % dh;
  Val<T>::st2(static_cast<T*>(is_v ? p.vp : p.kp) + at, a, b);
}

// gate|up: act = silu(gate) * up, each rounded where the plain version
// rounds
template <typename T>
__device__ __forceinline__ void epi_act(const Params& p, int t, int c,
                                        float g0, float g1, float u0,
                                        float u1) {
  const float gs[2] = {g0, g1}, us[2] = {u0, u1};
  float r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float g = gs[e], u = us[e];
    if (p.s_gu != nullptr) {
      g *= p.s_gu[c + e];
      u *= p.s_gu[p.F + c + e];
    }
    g = Val<T>::rnd(g);
    u = Val<T>::rnd(u);
    const float sg = Val<T>::rnd(g / (1.0f + expf(-g)));
    r[e] = Val<T>::rnd(sg * u);
  }
  Val<T>::st2(static_cast<T*>(p.act) + (size_t)t * p.F + c, r[0], r[1]);
}

// o: h2 = h + o-proj (rounded)
template <typename T>
__device__ __forceinline__ void epi_o(const Params& p, int t, int c, float a,
                                      float b) {
  const float v[2] = {a, b};
  const size_t at = (size_t)t * p.D + c;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float y = Val<T>::rnd(p.s_o != nullptr ? v[e] * p.s_o[c + e]
                                                 : v[e]);
    p.h2[at + e] =
        Val<T>::rnd(Val<T>::ld(static_cast<const T*>(p.h) + at + e) + y);
  }
}

// down: h_out = h2 + down-proj (rounded)
template <typename T>
__device__ __forceinline__ void epi_down(const Params& p, int t, int c,
                                         float a, float b) {
  const float v[2] = {a, b};
  const size_t at = (size_t)t * p.D + c;
  float r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float y = Val<T>::rnd(p.s_d != nullptr ? v[e] * p.s_d[c + e]
                                                 : v[e]);
    r[e] = Val<T>::rnd(__ldcg(p.h2 + at + e) + y);
  }
  Val<T>::st2(static_cast<T*>(p.h_out) + at, r[0], r[1]);
}

enum Epi { kEpiQkv, kEpiAct, kEpiO, kEpiDown };

template <typename T, int E>
__device__ __forceinline__ void epilogue(const Params& p, int t, int c,
                                         const float* v) {
  if constexpr (E == kEpiQkv) epi_qkv<T>(p, t, c, v[0], v[1]);
  if constexpr (E == kEpiAct) epi_act<T>(p, t, c, v[0], v[1], v[2], v[3]);
  if constexpr (E == kEpiO) epi_o<T>(p, t, c, v[0], v[1]);
  if constexpr (E == kEpiDown) epi_down<T>(p, t, c, v[0], v[1]);
}

// ---------------------------------------------------------------------------
// projections on wgmma (bf16 activations)

// One projection phase's geometry: A [M, K] through tensor map tmx, the
// weight [K, ldw] through tmw of which N columns are computed, NT weight
// tiles per warpgroup (gate|up: 2, the second `second` columns on), the
// epilogue E. SPLIT: o and down, K split over the cluster.
struct Proj {
  const CUtensorMap* tmx;
  const CUtensorMap* tmw;
  int M, K, N, second;
};

template <class W>
struct WCfg {
  static constexpr int TILE = BK * BN * (int)sizeof(W);   // one weight tile
};

// K tile `kt` into the stage at `st`: the activation tile (rows m0..m0 +
// 127) and the weight tiles cols[q] (q < nw; -1: none), by TMA from thread
// 0, completing on the stage's mbarrier
template <class W>
__device__ __forceinline__ void load_stage(unsigned char* st, uint32_t bar,
                                           const Proj& g, int kt, int m0,
                                           const int* cols, int nw) {
  if (threadIdx.x != 0) return;
  int n = 0;
  for (int q = 0; q < nw; ++q) n += cols[q] >= 0;
  mbar_expect(bar, kXBytes + n * WCfg<W>::TILE);
  tma_load(st, g.tmx, kt * BK, m0, bar);
  for (int q = 0; q < nw; ++q)
    if (cols[q] >= 0)
      tma_load(st + kXBytes + q * WCfg<W>::TILE, g.tmw, cols[q], kt * BK,
               bar);
}

// One staged K tile for one warpgroup: its NT weight tiles at `wt` (tile j
// WCfg::TILE bytes after), the activation tile at `st`. Two K steps per
// wgmma commit group (one for gate|up, whose 128 accumulators leave fewer
// registers), their A operands double buffered, as int8_matmul.cu.
// The warp (w of its warpgroup) holds A rows 16w + g + 8h = the tile's
// column 16w + 2g + h.
template <class W, int NT>
__device__ __forceinline__ void wg_tile(float (&acc)[NT][64],
                                        const unsigned char* st,
                                        const unsigned char* wt, int w,
                                        int lane, bool first) {
  constexpr int KPG = NT == 2 ? 1 : 2;
  static_assert((BK / 16) % (2 * KPG) == 0, "even groups per tile");
  const uint32_t xs = smem_u32(st);
  const int g = lane >> 2, t = lane & 3;
  const int colb = (16 * w + 2 * g) * (int)sizeof(W);
  uint32_t a[2][KPG][NT][4];
#pragma unroll
  for (int gi = 0; gi < BK / 16 / KPG; ++gi) {
    uint32_t (&A)[KPG][NT][4] = a[gi & 1];
#pragma unroll
    for (int u = 0; u < KPG; ++u) {
      const int k = (gi * KPG + u) * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* wj = wt + j * WCfg<W>::TILE;
        if constexpr (sizeof(W) == 2) {
          auto wd = [&](int r) {
            return *reinterpret_cast<const uint32_t*>(wj + swz(r, colb));
          };
          const uint32_t r0 = wd(k), r1 = wd(k + 1);
          const uint32_t r8 = wd(k + 8), r9 = wd(k + 9);
          A[u][j][0] = prmt(r0, r1, 0x5410);
          A[u][j][1] = prmt(r0, r1, 0x7632);
          A[u][j][2] = prmt(r8, r9, 0x5410);
          A[u][j][3] = prmt(r8, r9, 0x7632);
        } else {
          auto wd = [&](int r) {
            return (uint32_t)*reinterpret_cast<const uint16_t*>(
                wj + swz64(r, colb));
          };
          const uint32_t r0 = wd(k), r1 = wd(k + 1);
          const uint32_t r8 = wd(k + 8), r9 = wd(k + 9);
          A[u][j][0] = widen_i8(r0, r1, 0);
          A[u][j][1] = widen_i8(r0, r1, 1);
          A[u][j][2] = widen_i8(r8, r9, 0);
          A[u][j][3] = widen_i8(r8, r9, 1);
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
#pragma unroll
      for (int j = 0; j < NT; ++j) wgmma_n128(acc[j], A[u][j], desc, keep);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
}

// The mainloop of one unit: K tiles [kt0, kt1) of the activation rows m0..
// and of each warpgroup's weight tiles (cols[wg * NT + j], -1: none)
// through the ring. `it` counts the ring's tiles over the phase (stage
// it % ST, parity (it / ST) & 1). Returns with every product done; a
// warpgroup with no tile, or a unit with no K tile, leaves acc undefined.
template <class W, int NT>
__device__ __forceinline__ void mainloop(float (&acc)[NT][64],
                                         unsigned char* ring, uint32_t bars,
                                         int ST, int stage_bytes, int& it,
                                         const Proj& g, int m0, int kt0,
                                         int kt1, const int* cols) {
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int n = kt1 - kt0, ahead = ST - 2;
  const bool mine = cols[wg * NT] >= 0;
  for (int s = 0; s < ahead && s < n; ++s) {
    const int q = it + s;
    load_stage<W>(ring + (q % ST) * stage_bytes, bars + 8 * (q % ST), g,
                  kt0 + s, m0, cols, 2 * NT);
  }
  for (int i = 0; i < n; ++i, ++it) {
    // every warpgroup is done with the stage refilled next (tile i - 2's,
    // its last products waited for in tile i - 1; the partial tiles of a
    // split phase's previous unit ordered before the copies)
    fence_proxy_async();
    __syncthreads();
    if (i + ahead < n) {
      const int q = it + ahead;
      load_stage<W>(ring + (q % ST) * stage_bytes, bars + 8 * (q % ST), g,
                    kt0 + i + ahead, m0, cols, 2 * NT);
    }
    mbar_wait(bars + 8 * (it % ST), (it / ST) & 1);
    const unsigned char* st = ring + (it % ST) * stage_bytes;
    if (mine)
      wg_tile<W, NT>(acc, st, st + kXBytes + wg * NT * WCfg<W>::TILE, w,
                     lane, i == 0);
  }
  // unconditional: a wait that ptxas cannot see on every path to the
  // epilogue's reads makes it serialize every wgmma
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();                       // the ring is free
}

// (re)initialise the ring's mbarriers for a phase of stage_bytes stages
__device__ __forceinline__ int ring_init(unsigned char* ring, uint32_t bars,
                                         int stage_bytes) {
  int ST = kRingBytes / stage_bytes;
  ST = ST > kMaxStages ? kMaxStages : ST;
  fence_proxy_async();                   // earlier shared-memory use first
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(bars + 8 * s);
    mbar_init_fence();
  }
  __syncthreads();
  return ST;
}

// A projection whose units are whole column tiles (q|k|v: NT 1; gate|up:
// NT 2): warpgroup slot wg * G + block takes tile `base + slot` of each
// round over the token tiles. The sums go through shared memory (the free
// ring) to the epilogue, a column pair a thread, neighbouring threads on
// neighbouring pairs: its loads and stores coalesce, and no accumulator
// is live beside them (an epilogue unrolled over the accumulators held
// the registers of both and spilled).
template <typename T, class W, int NT, int E>
__device__ void proj_tiles(const Params& p, const Proj& g,
                           unsigned char* ring, uint32_t bars) {
  const int stage = kXBytes + 2 * NT * WCfg<W>::TILE;
  const int ST = ring_init(ring, bars, stage);
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int G = gridDim.x, ntn = (g.N + BN - 1) / BN;
  static_assert(2 * NT * BM * kPPitch * 4 <= kPBytes, "sum tiles");
  const int kt = (g.K + BK - 1) / BK;
  int it = 0;
  for (int m0 = 0; m0 < g.M; m0 += BM)
    for (int base = 0; base < ntn; base += 2 * G) {
      int cols[4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int tile = base + q * G + blockIdx.x;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          cols[q * NT + j] = tile < ntn ? tile * BN + j * g.second : -1;
      }
      if (cols[0] < 0 && cols[NT] < 0) continue;      // uniform per block
      float acc[NT][64];
      mainloop<W, NT>(acc, ring, bars, ST, stage, it, g, m0, 0, kt, cols);
      float* P = reinterpret_cast<float*>(ring);   // [2][NT][BM][kPPitch]
      if (cols[wg * NT] >= 0) {
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              *reinterpret_cast<float2*>(
                  P + ((wg * NT + q) * BM + 8 * i + 2 * tq + j) * kPPitch +
                  16 * w + 2 * gq) =
                  make_float2(acc[q][4 * i + j], acc[q][4 * i + 2 + j]);
      }
      __syncthreads();
      for (int x = threadIdx.x; x < 2 * BM * (BN / 2); x += kThreads) {
        const int q0 = x / (BM * (BN / 2)), tok = (x / (BN / 2)) % BM;
        const int cp = 2 * (x % (BN / 2));
        const int tile = base + q0 * G + blockIdx.x;
        const int c = tile * BN + cp;
        if (tile >= ntn || c >= g.N || m0 + tok >= g.M) continue;
        float v[2 * NT];
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          const float2 s2 = *reinterpret_cast<const float2*>(
              P + ((q0 * NT + q) * BM + tok) * kPPitch + cp);
          v[2 * q] = s2.x;
          v[2 * q + 1] = s2.y;
        }
        epilogue<T, E>(p, m0 + tok, c, v);
      }
      __syncthreads();                   // P is read before the ring refills
    }
}

// A projection split along K over each cluster (o and down): a cluster
// takes pairs of adjacent column tiles (one per warpgroup), block rank r
// its K tiles [kt r / CS, kt (r + 1) / CS); the partial tiles are summed
// in rank order over distributed shared memory, block r taking its share
// of the tokens, then the epilogue.
template <typename T, class W, int E>
__device__ void proj_split(const Params& p, const Proj& g,
                           unsigned char* ring, uint32_t bars) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int stage = kXBytes + 2 * WCfg<W>::TILE;
  const int ST = ring_init(ring, bars, stage);
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ntn = (g.N + BN - 1) / BN, pairs = (ntn + 1) / 2;
  const int mt = (g.M + BM - 1) / BM;
  const int kt = (g.K + BK - 1) / BK;
  const int kt0 = kt * rank / CS, kt1 = kt * (rank + 1) / CS;
  const int clusters = gridDim.x / CS, cid = blockIdx.x / CS;
  float* P = reinterpret_cast<float*>(ring);     // [2][BM][kPPitch]
  int it = 0;
  for (int u = cid; u < pairs * mt; u += clusters) {
    const int pair = u % pairs, m0 = (u / pairs) * BM;
    int cols[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      cols[q] = 2 * pair + q < ntn ? (2 * pair + q) * BN : -1;
    float acc[1][64];
    mainloop<W, 1>(acc, ring, bars, ST, stage, it, g, m0, kt0, kt1, cols);
    // this block's partial tiles (zeros for a block with no K tile)
    if (cols[wg] >= 0) {
      float* Pw = P + wg * BM * kPPitch;
      const int c = 16 * w + 2 * gq;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int tok = 8 * i + 2 * tq + j;
          *reinterpret_cast<float2*>(Pw + tok * kPPitch + c) =
              kt1 > kt0 ? make_float2(acc[0][4 * i + j], acc[0][4 * i + 2 + j])
                        : make_float2(0.f, 0.f);
        }
    }
    cluster.sync();                      // every block's partials written
    const int r0 = BM * rank / CS, r1 = BM * (rank + 1) / CS;
    for (int x = threadIdx.x; x < (r1 - r0) * (2 * BN / 4); x += kThreads) {
      const int tok = r0 + x / (2 * BN / 4), cc = (x % (2 * BN / 4)) * 4;
      const int q = cc / BN, c = cc % BN;
      if (cols[q] < 0 || cols[q] + c >= g.N || m0 + tok >= g.M) continue;
      const int off = q * BM * kPPitch + tok * kPPitch + c;
      float4 s = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(P, 0) + off);
      for (int r = 1; r < CS; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(P, r) + off);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const float v0[2] = {s.x, s.y}, v1[2] = {s.z, s.w};
      epilogue<T, E>(p, m0 + tok, cols[q] + c, v0);
      if (cols[q] + c + 2 < g.N) epilogue<T, E>(p, m0 + tok, cols[q] + c + 2,
                                                v1);
    }
    cluster.sync();                      // no block reuses P while read
  }
}

// ---------------------------------------------------------------------------
// projections on the CUDA cores (f32 activations): a unit is BM tokens x
// BN columns (NT weight tiles, the second `second` columns on) over all of
// K; thread (ty, tx) owns rows ty + 16 i (i < 8) and the column pairs
// 2 tx + 32 jj (jj < 2)

template <typename T, class W, int NT, int E>
__device__ void proj_f32(const Params& p, const void* a_, const void* w_,
                         int M, int K, int N, int ldw, int second,
                         unsigned char* smem) {
  float* sA = reinterpret_cast<float*>(smem);    // [FK][BM + 4], K-major
  float* sB = sA + FK * (BM + 4);                // [NT][FK][BN + 4]
  const float* A = static_cast<const float*>(a_);
  const W* Wt = static_cast<const W*>(w_);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ntn = (N + BN - 1) / BN, mt = (M + BM - 1) / BM;
  for (int u = blockIdx.x; u < ntn * mt; u += gridDim.x) {
    const int n0 = (u % ntn) * BN, m0 = (u / ntn) * BM;
    float acc[NT][8][4];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += FK) {
      __syncthreads();
      for (int e = tid; e < BM * FK; e += kThreads) {
        const int r = e / FK, kk = e % FK, m = m0 + r, k = k0 + kk;
        sA[kk * (BM + 4) + r] =
            (m < M && k < K) ? __ldcg(A + (size_t)m * K + k) : 0.f;
      }
      for (int e = tid; e < NT * FK * BN; e += kThreads) {
        const int q = e / (FK * BN), kk = (e / BN) % FK, c = e % BN;
        const int k = k0 + kk, n = n0 + c;
        sB[(q * FK + kk) * (BN + 4) + c] =
            (k < K && n < N) ? Val<W>::ld(Wt + (size_t)k * ldw + q * second +
                                          n)
                             : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sA[kk * (BM + 4) + ty + 16 * i];
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          float b[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = sB[(q * FK + kk) * (BN + 4) + 2 * tx + 32 * (j >> 1) +
                      (j & 1)];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[q][i][j] = fmaf(a[i], b[j], acc[q][i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int tok = m0 + ty + 16 * i, c = n0 + 2 * tx + 32 * jj;
        if (tok >= M || c >= N) continue;
        float v[2 * NT];
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          v[2 * q] = acc[q][i][2 * jj];
          v[2 * q + 1] = acc[q][i][2 * jj + 1];
        }
        epilogue<T, E>(p, tok, c, v);
      }
  }
}

// ---------------------------------------------------------------------------
// attention

// dead tokens' outputs are zeros (every head), as the plain version's
template <typename T>
__device__ __forceinline__ void zero_dead(const Params& p) {
  const int Hd = p.H * p.dh;
  T* o = static_cast<T*>(p.o);
  for (int t = blockIdx.x; t < p.T; t += gridDim.x) {
    if (token_live(p, t)) continue;                 // uniform per block
    for (int x = 2 * threadIdx.x; x < Hd; x += 2 * kThreads)
      Val<T>::st2(o + (size_t)t * Hd + x, 0.f, 0.f);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier `id` (1..15) over `threads` threads of the block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two int8 values as a bf16 pair (exact)
__device__ __forceinline__ uint32_t i8x2(int8_t lo, int8_t hi) {
  return bf2((float)lo, (float)hi);
}

// q blocks of a row per tensor-core unit, and the unit's m16 tiles
__device__ __forceinline__ int group_blocks(const Params& p) {
  const int per = (p.H / p.Hkv) * p.qb;
  return kPairBlocks && per < 16 && 16 % per == 0 ? 16 / per : 1;
}

// the q blocks that lead a group (the first of a row's GB consecutive live
// blocks) into lead[]; returns their count. Warp 0 scans, 32 at a time.
__device__ int find_leaders(const Params& p, int GB, int* lead) {
  __shared__ int count;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int b0 = 0; b0 < p.T / p.qb; b0 += 32) {
      const int i = b0 + lane;
      bool is = false;
      if (i < p.T / p.qb) {
        const int row = p.block_row[i];
        const int off = i * p.qb - p.q_starts[row];
        is = off >= 0 && off < p.q_lens[row] && (off / p.qb) % GB == 0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, is);
      if (is) lead[n + __popc(m & ((1u << lane) - 1u))] = i;
      n += __popc(m);
    }
    if (lane == 0) count = n;
  }
  __syncthreads();
  return count;
}

// Tensor cores (bf16 q). A unit: (group leader, m16 tile, kv head); query
// row r of the group (r < GB * grp * qb): q block leader + r / (grp qb),
// token (that block) * qb + (r % (grp qb)) % qb, q head hk * grp + (r %
// (grp qb)) / qb. A warp per unit.
template <typename PT>
__device__ void attend_mma(const Params& p, unsigned char* smem) {
  constexpr bool kQuant = sizeof(PT) == 1;
  constexpr int es = sizeof(PT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int H = p.H, Hkv = p.Hkv, dh = p.dh, grp = H / Hkv, qb = p.qb;
  const int Hd = H * dh;
  const int GB = group_blocks(p);
  const int rows = GB * grp * qb, tiles = (rows + 15) / 16;
  int* lead = reinterpret_cast<int*>(smem);
  const int nlead = find_leaders(p, GB, lead);
  const int pitch = dh * es + 16;                  // bytes per K/V row
  const int qpitch = dh * 2 + 16;                  // bytes per query row
  const size_t stage_bytes = 2 * (size_t)kAttnPos * pitch + 2 * kAttnPos * 4;
  unsigned char* sq = smem + kMaxBlocks * 4 + (size_t)warp * kAttnWarpBytes;
  unsigned char* wsm = sq + 16 * qpitch;
  const __nv_bfloat16* qbuf = static_cast<const __nv_bfloat16*>(p.q);
  const PT* kp = static_cast<const PT*>(p.kp);
  const PT* vp = static_cast<const PT*>(p.vp);
  const int units = nlead * tiles * Hkv;
  // a team of kAttnSplit warps per unit, each a contiguous share of its
  // horizon's steps; team w of block b takes units w G + b, ... : every SM
  // a share
  if (warp >= kAttnWarps) return;
  const int team = warp / kAttnSplit, part = warp % kAttnSplit;
  for (int u = team * gridDim.x + blockIdx.x; u < units;
       u += gridDim.x * (kAttnWarps / kAttnSplit)) {
    const int li = u % nlead, rest = u / nlead;
    const int tile = rest % tiles, hk = rest / tiles;
    const int i0 = lead[li], row = p.block_row[i0];
    const int qs = p.q_starts[row], ql = p.q_lens[row], kl = p.kv_lens[row];
    const int kv0 = kl - ql;
    const int* tbl = p.tables + (size_t)row * p.pps;
    // the thread's two query rows (g, g + 8): token, head, causal limit
    int tok[2], head[2], lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile * 16 + g + 8 * h;
      const int b = r / (grp * qb), wi = r % (grp * qb);
      tok[h] = (i0 + b) * qb + wi % qb;
      head[h] = hk * grp + wi / qb;
      const int off = tok[h] - qs;
      lim[h] = r < rows && off < ql ? kv0 + off : -1;
    }
    // the unit's horizon: the last live token of the group
    const int last = min(ql - 1, (i0 + GB) * qb - 1 - qs);
    const int horizon = min(kl, kv0 + last + 1);
    // the unit's 16 query rows into shared memory (zeros for rows past
    // the group or dead), lane r < 16 copying row r; the A operand of
    // each Q.K^T step is read from there by ldmatrix
    const int nch = dh * es / 16, qch = dh * 2 / 16;
    if (lane < 16) {
      const int r = tile * 16 + lane;
      const int b = r / (grp * qb), wi = r % (grp * qb);
      const int tk = (i0 + b) * qb + wi % qb;
      const bool lv = r < rows && tk - qs < ql;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          qbuf + (size_t)(lv ? tk : 0) * Hd + (hk * grp + wi / qb) * dh);
      for (int ch = 0; ch < qch; ++ch)
        cp_async16(sq + lane * qpitch + ch * 16, src + ch * 16, lv);
    }
    cp_async_commit();
    float oacc[kMaxDh / 8][4];
#pragma unroll
    for (int d = 0; d < kMaxDh / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const int j = lane & (kAttnPos - 1), which = lane >> 4;
    // stage s's positions p0 .. p0 + 15 (zeros past the horizon): lane l
    // copies the K (l < 16) or V row of position p0 + l % 16 after one
    // page lookup (lookups and index arithmetic dealt over the copies and
    // shared by shuffles held a 7B attention phase at 0.16 ms, 0.085 ms
    // this way; a window of pages in shared memory and copies of whole
    // rows per instruction were slower still, tools/prefill_variants.py)
    auto fetch = [&](int s, int p0) {
      unsigned char* sk = wsm + (size_t)s * stage_bytes;
      unsigned char* sv = sk + kAttnPos * pitch;
      float* ssc = reinterpret_cast<float*>(sv + kAttnPos * pitch);
      const int pos = p0 + j;
      const bool live = pos < horizon;
      const int pg = tbl[(live ? pos : 0) / p.ps];
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(which ? vp : kp) +
          (((size_t)hk * p.P + pg) * p.ps + (live ? pos : 0) % p.ps) * dh *
              es;
      unsigned char* dst = (which ? sv : sk) + j * pitch;
#pragma unroll 4
      for (int ch = 0; ch < nch; ++ch)
        cp_async16(dst + ch * 16, src + ch * 16, live);
      if constexpr (kQuant)
        ssc[lane] = live ? (which ? p.vs : p.ks)[(size_t)hk * p.P + pg]
                         : 0.f;
      cp_async_commit();
    };
    // this warp's steps [s0, s1) of the unit's horizon
    const int steps = (horizon + kAttnPos - 1) / kAttnPos;
    const int s0 = steps * part / kAttnSplit;
    const int n = steps * (part + 1) / kAttnSplit - s0;
#pragma unroll
    for (int s = 0; s < kAttnStages - 1; ++s)
      if (s < n) fetch(s, (s0 + s) * kAttnPos); else cp_async_commit();
    for (int st = 0; st < n; ++st) {
      if (st + kAttnStages - 1 < n)
        fetch((st + kAttnStages - 1) % kAttnStages,
              (s0 + st + kAttnStages - 1) * kAttnPos);
      else
        cp_async_commit();
      cp_async_wait<kAttnStages - 1>();
      __syncwarp();
      const unsigned char* sk = wsm + (size_t)(st % kAttnStages) * stage_bytes;
      const unsigned char* sv = sk + kAttnPos * pitch;
      const float* ssc = reinterpret_cast<const float*>(sv + kAttnPos * pitch);
      const int p0 = (s0 + st) * kAttnPos;
      // S = Q K^T over the 16 positions: two n8 tiles, even and odd k
      // steps summed apart (two chains of dependent products, not one)
      float sc[2][4], sd[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = sd[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kMaxDh / 16; ++ks) {
        if (ks * 16 >= dh) break;
        float (&acc2)[2][4] = ks & 1 ? sd : sc;
        uint32_t qa[4], b[4];
        ldsm_x4(qa, sq + (lane & 15) * qpitch + ks * 32 + (lane >> 4) * 16);
        if constexpr (kQuant) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int8_t* kr = reinterpret_cast<const int8_t*>(
                sk + (nt * 8 + g) * pitch) + ks * 16 + 2 * t;
            b[2 * nt] = i8x2(kr[0], kr[1]);
            b[2 * nt + 1] = i8x2(kr[8], kr[9]);
          }
        } else {
          const int pos = (lane & 7) + ((lane >> 4) << 3);
          const int kc = ks * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(b, sk + pos * pitch + kc * 2);
        }
        mma_bf16(acc2[0], qa, b[0], b[1]);
        mma_bf16(acc2[1], qa, b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] += sd[nt][e];
      // scale, mask, online softmax (rows g and g + 8)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = nt * 8 + 2 * t + (e & 1), pos = p0 + j;
          float s = sc[nt][e] * p.scale;
          if constexpr (kQuant) s = sc[nt][e] * ssc[j] * p.scale;
          s = pos <= lim[h] ? s : kNegInf;
          sc[nt][e] = s;
          mx[h] = fmaxf(mx[h], s);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = expf(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
      float pr[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = nt * 8 + 2 * t + (e & 1);
          const float ex = p0 + j <= lim[h] ? expf(sc[nt][e] - m[h]) : 0.f;
          l[h] += ex;
          pr[nt][e] = kQuant ? ex * ssc[kAttnPos + j] : ex;
        }
#pragma unroll
      for (int d = 0; d < kMaxDh / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[d][e] *= alpha[e >> 1];
      // P as the A operand of P V, in kPParts bf16 parts: part k rounds
      // what the parts before it left, so P V keeps ~8 kPParts bits of P
      // (V is exact in bf16)
      uint32_t pa[kPParts][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x0 = pr[e >> 1][(e & 1) * 2];
        float x1 = pr[e >> 1][(e & 1) * 2 + 1];
#pragma unroll
        for (int k = 0; k < kPParts; ++k) {
          pa[k][e] = bf2(x0, x1);
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
              &pa[k][e]);
          x0 -= __low2float(r);
          x1 -= __high2float(r);
        }
      }
      // P V, kPVSlices 16-column slices of V at a time: each part's
      // products go to 2 kPVSlices accumulators in turn, none waiting on
      // the one before
      constexpr int NS = kPVSlices;
#pragma unroll
      for (int d4 = 0; d4 < kMaxDh / (16 * NS); ++d4) {
        if (d4 * 16 * NS >= dh) break;
        uint32_t b[NS][4];
#pragma unroll
        for (int q4 = 0; q4 < NS; ++q4) {
          const int dp = d4 * NS + q4;
          if (dp * 16 >= dh) break;
          if constexpr (kQuant) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int8_t* vc = reinterpret_cast<const int8_t*>(sv) +
                                 dp * 16 + q * 8 + g;
              b[q4][2 * q] = i8x2(vc[(2 * t) * pitch],
                                  vc[(2 * t + 1) * pitch]);
              b[q4][2 * q + 1] = i8x2(vc[(2 * t + 8) * pitch],
                                      vc[(2 * t + 9) * pitch]);
            }
          } else {
            const int pos = (lane & 7) + ((lane >> 3) & 1) * 8;
            const int dc = dp * 16 + (lane >> 4) * 8;
            ldsm_x4_trans(b[q4], sv + pos * pitch + dc * 2);
          }
        }
#pragma unroll
        for (int k = 0; k < kPParts; ++k)
#pragma unroll
          for (int q4 = 0; q4 < NS; ++q4) {
            const int dp = d4 * NS + q4;
            if (dp * 16 >= dh) break;
            mma_bf16(oacc[2 * dp], pa[k], b[q4][0], b[q4][1]);
            mma_bf16(oacc[2 * dp + 1], pa[k], b[q4][2], b[q4][3]);
          }
      }
      __syncwarp();                        // the stage is read before refill
    }
    cp_async_wait<0>();
    __syncwarp();
    // the team's states merged in part order, lane by lane, through the
    // later parts' stage memory: part q > 0 leaves (acc, m, l), part 0
    // folds them in and writes the rows
    float* mine = reinterpret_cast<float*>(wsm);   // [68][32], lane-major
    if (part > 0) {
#pragma unroll
      for (int d = 0; d < kMaxDh / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(d * 4 + e) * 32 + lane] = oacc[d][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mine[(64 + h) * 32 + lane] = m[h];
        mine[(66 + h) * 32 + lane] = l[h];
      }
    }
    named_sync(1 + team, 32 * kAttnSplit);
    if (part == 0) {
      for (int q = 1; q < kAttnSplit; ++q) {
        const float* o2 = reinterpret_cast<const float*>(
            wsm + (size_t)q * kAttnWarpBytes);          // warp + q's stages
        float fa[2], fb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m2 = o2[(64 + h) * 32 + lane];
          const float mx = fmaxf(m[h], m2);
          fa[h] = expf(m[h] - mx);
          fb[h] = expf(m2 - mx);
          l[h] = l[h] * fa[h] + o2[(66 + h) * 32 + lane] * fb[h];
          m[h] = mx;
        }
#pragma unroll
        for (int d = 0; d < kMaxDh / 8; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oacc[d][e] = oacc[d][e] * fa[e >> 1] +
                         o2[(d * 4 + e) * 32 + lane] * fb[e >> 1];
      }
    }
    named_sync(1 + team, 32 * kAttnSplit);   // read before reused
    if (part > 0) continue;
    // the rows' sums over the 4 lanes of a row, then out = acc / l
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
    for (int d = 0; d < kMaxDh / 8; ++d) {
      if (d * 8 >= dh) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (lim[h] < 0) continue;
        const float inv = 1.f / l[h];
        Val<__nv_bfloat16>::st2(
            o + (size_t)tok[h] * Hd + head[h] * dh + d * 8 + 2 * t,
            oacc[d][2 * h] * inv, oacc[d][2 * h + 1] * inv);
      }
    }
    __syncwarp();
  }
}

// CUDA cores (f32 q): a unit is (q block i, kv head hk) over the block's
// whole causal horizon. K and V are staged in shared memory kSplit
// positions at a time (int8 pages dequantized by their (head, page) scales
// on the way, as the plain version's gather does); each warp then takes
// one of the block's grp * qb query rows at a time (row qi: token i*qb +
// qi % qb of q head hk*grp + qi / qb), a lane scoring one position with a
// whole dot product, the warp keeping the row's online softmax over the
// tiles, each lane 4 elements of its output.
template <typename PT>
__device__ void attend_f32(const Params& p, unsigned char* smem_raw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, Hkv = p.Hkv, dh = p.dh, grp = H / Hkv, qb = p.qb;
  const int nb = p.T / qb, nrows = grp * qb, Hd = H * dh;
  constexpr bool kQuant = sizeof(PT) == 1;
  const PT* kp = static_cast<const PT*>(p.kp);
  const PT* vp = static_cast<const PT*>(p.vp);
  const float* qbuf = static_cast<const float*>(p.q);
  float* obuf = static_cast<float*>(p.o);
  float* sk = reinterpret_cast<float*>(smem_raw);   // [kSplit][kMaxDh + 1]
  float* sv = sk + kSplit * (kMaxDh + 1);           // [kSplit][kMaxDh]
  float* sq = sv + kSplit * kMaxDh;                 // [kRows][kMaxDh]
  float* sp = sq + kRows * kMaxDh;                  // [kWarps][kSplit]
  const int e0 = 4 * lane;
  const bool lane_ok = e0 < dh;
  for (int u = blockIdx.x; u < nb * Hkv; u += gridDim.x) {
    const int i = u / Hkv, hk = u % Hkv;
    const int row = p.block_row[i];
    const int ql = p.q_lens[row], kl = p.kv_lens[row];
    const int off = i * qb - p.q_starts[row], kv0 = kl - ql;
    if (off < 0 || off >= ql) continue;            // uniform per block
    const int horizon = min(kl, kv0 + off + qb);
    const int* tbl = p.tables + (size_t)row * p.pps;
    __syncthreads();                     // the previous unit's smem reads
    for (int x = tid; x < nrows * dh; x += kThreads) {
      const int qi = x / dh, e = x % dh;
      sq[qi * kMaxDh + e] = __ldcg(
          qbuf + (size_t)(i * qb + qi % qb) * Hd + (hk * grp + qi / qb) * dh +
          e);
    }
    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int t0 = 0; t0 < horizon; t0 += kSplit) {
      const int n = min(kSplit, horizon - t0);
      __syncthreads();                   // the previous tile's reads
      for (int x = tid; x < n * (dh / 4); x += kThreads) {
        const int j = x / (dh / 4), e = (x % (dh / 4)) * 4, pos = t0 + j;
        const int pg = tbl[pos / p.ps];
        const size_t at =
            (((size_t)hk * p.P + pg) * p.ps + pos % p.ps) * dh + e;
        float kx[4], vx[4];
        Val<PT>::ld4(kp + at, kx);
        Val<PT>::ld4(vp + at, vx);
        float kf = 1.f, vf = 1.f;
        if constexpr (kQuant) {
          kf = __ldcg(p.ks + (size_t)hk * p.P + pg);
          vf = __ldcg(p.vs + (size_t)hk * p.P + pg);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sk[j * (kMaxDh + 1) + e + c] = kx[c] * kf;
          sv[j * kMaxDh + e + c] = vx[c] * vf;
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int qi = warp + kWarps * r;
        if (qi >= nrows) break;
        const int jj = qi % qb;
        // the last position row qi sees: none past a dead token's
        const int lim = off + jj < ql ? kv0 + off + jj : -1;
        if (lim < t0) continue;
        const float* qr = sq + qi * kMaxDh;
        float sc[kSplit / 32];
        float mx = m[r];
#pragma unroll
        for (int hh = 0; hh < kSplit / 32; ++hh) {
          const int j = lane + 32 * hh;
          float d = 0.f;
          if (j < n) {
            const float* kr = sk + j * (kMaxDh + 1);
            for (int e = 0; e < dh; ++e) d = fmaf(qr[e], kr[e], d);
          }
          sc[hh] = j < n && t0 + j <= lim ? d * p.scale : kNegInf;
          mx = fmaxf(mx, sc[hh]);
        }
        mx = warp_max(mx);
        const float alpha = expf(m[r] - mx);
        float sum = 0.f;
#pragma unroll
        for (int hh = 0; hh < kSplit / 32; ++hh) {
          const int j = lane + 32 * hh;
          const float ex = j < n && t0 + j <= lim ? expf(sc[hh] - mx) : 0.f;
          sp[warp * kSplit + j] = ex;
          sum += ex;
        }
        l[r] = l[r] * alpha + warp_sum(sum);
        m[r] = mx;
        __syncwarp();
        if (lane_ok) {
          float a[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) a[c] = acc[r][c] * alpha;
          for (int j = 0; j < n; ++j) {
            const float w = sp[warp * kSplit + j];
            const float4 vv =
                *reinterpret_cast<const float4*>(sv + j * kMaxDh + e0);
            a[0] = fmaf(w, vv.x, a[0]);
            a[1] = fmaf(w, vv.y, a[1]);
            a[2] = fmaf(w, vv.z, a[2]);
            a[3] = fmaf(w, vv.w, a[3]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = a[c];
        }
        __syncwarp();                    // sp is read before it is rewritten
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = warp + kWarps * r;
      if (qi >= nrows) break;
      if (off + qi % qb >= ql || !lane_ok) continue;   // dead: zeroed
      float* o = obuf + (size_t)(i * qb + qi % qb) * Hd +
                 (hk * grp + qi / qb) * dh + e0;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = acc[r][c] / l[r];
    }
  }
}

// ---------------------------------------------------------------------------
// the layer

// per token: out = rms_norm(src) * ln, rounded (src: the hidden type, or
// the f32 h2 holding rounded values)
template <typename T, typename S>
__device__ __forceinline__ void norm_phase(const Params& p, const S* src,
                                           const T* ln, float* red) {
  const int D = p.D, tid = threadIdx.x;
  T* xa = static_cast<T*>(p.xa);
  for (int r = blockIdx.x; r < p.T; r += gridDim.x) {
    const S* hr = src + (size_t)r * D;
    float ss = 0.f;
    for (int k = tid; k < D; k += kThreads) {
      const float v = Val<S>::ld(hr + k);
      ss = fmaf(v, v, ss);
    }
    const float rstd = 1.0f / sqrtf(block_sum(ss, red) / (float)D + p.eps);
    for (int k = tid; k < D; k += kThreads)
      Val<T>::st(xa + (size_t)r * D + k,
                 Val<T>::rnd(Val<T>::rnd(Val<S>::ld(hr + k) * rstd) *
                             Val<T>::ld(ln + k)));
  }
}

template <typename T, typename W, typename PT>
__global__ void __launch_bounds__(kThreads, 1)
prefill_megakernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the projection ring on a 1024-byte boundary (the 128-byte swizzle's
  // period), its mbarriers after it
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(ring + kRingBytes);
  float* red = reinterpret_cast<float*>(smem_raw);
  const int Hd = p.H * p.dh, Kd = p.Hkv * p.dh;
  constexpr bool kTC = sizeof(T) == 2;       // bf16: tensor cores
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.stamps[0] = now_ns();

  // 0. x = rms_norm(h) * ln1
  norm_phase<T, T>(p, static_cast<const T*>(p.h),
                   static_cast<const T*>(p.ln1), red);
  phase_end(p, 0);

  // 1. q|k|v (only q for an int8 pool), epilogue: rope, q kept, k/v to the
  // pool
  if constexpr (kTC)
    proj_tiles<T, W, 1, kEpiQkv>(
        p, Proj{&p.tm_x[0], &p.tm_w[0], p.T, p.D, p.nq, 0}, ring, bars);
  else
    proj_f32<T, W, 1, kEpiQkv>(p, p.xa, p.w_qkv, p.T, p.D, p.nq,
                               Hd + 2 * Kd, 0, smem_raw);
  phase_end(p, 1);

  // 2. attention -> o
  zero_dead<T>(p);
  if constexpr (kTC)
    attend_mma<PT>(p, smem_raw);
  else
    attend_f32<PT>(p, smem_raw);
  phase_end(p, 2);

  // 3. o projection, epilogue: h2 = h + o-proj
  if constexpr (kTC)
    proj_split<T, W, kEpiO>(p, Proj{&p.tm_x[1], &p.tm_w[1], p.T, Hd, p.D, 0},
                            ring, bars);
  else
    proj_f32<T, W, 1, kEpiO>(p, p.o, p.w_o, p.T, Hd, p.D, p.D, 0, smem_raw);
  phase_end(p, 3);

  // 4. x2 = rms_norm(h2) * ln2
  norm_phase<T, float>(p, p.h2, static_cast<const T*>(p.ln2), red);
  phase_end(p, 4);

  // 5. gate|up, epilogue: act = silu(gate) * up
  if constexpr (kTC)
    proj_tiles<T, W, 2, kEpiAct>(
        p, Proj{&p.tm_x[0], &p.tm_w[2], p.T, p.D, p.F, p.F}, ring, bars);
  else
    proj_f32<T, W, 2, kEpiAct>(p, p.xa, p.w_gu, p.T, p.D, p.F, 2 * p.F, p.F,
                               smem_raw);
  phase_end(p, 5);

  // 6. down projection, epilogue: h_out = h2 + down
  if constexpr (kTC)
    proj_split<T, W, kEpiDown>(
        p, Proj{&p.tm_x[2], &p.tm_w[3], p.T, p.F, p.D, 0}, ring, bars);
  else
    proj_f32<T, W, 1, kEpiDown>(p, p.act, p.w_d, p.T, p.F, p.D, p.D, 0,
                                smem_raw);
  if (p.stamps != nullptr) phase_end(p, 6);
}

// ---------------------------------------------------------------------------
// launch plumbing

template <typename T, typename W, typename PT>
struct Launcher {
  static cudaError_t opt_in() {
    static cudaError_t err = cudaFuncSetAttribute(
        prefill_megakernel<T, W, PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    return err;
  }

  static cudaLaunchConfig_t config(int grid, bool coop, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = coop ? 2 : 1;
    return cfg;
  }

  // blocks resident at once: whole clusters
  static int grid(int* out) {
    cudaError_t err = opt_in();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = config(kCluster, false, 0, attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, prefill_megakernel<T, W, PT>,
                                         &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;
    *out = n * kCluster;
    return 0;
  }

  // one cooperative launch with a cluster dimension: the runtime refuses
  // it unless every block is resident, which the grid barrier needs
  static int launch(const Params& p, int grid, cudaStream_t stream) {
    cudaError_t err = opt_in();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = config(grid, true, stream, attr);
    err = cudaLaunchKernelEx(&cfg, prefill_megakernel<T, W, PT>, p);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
};

template <typename T, typename W, typename PT>
int grid_for(int* grid) {
  return Launcher<T, W, PT>::grid(grid);
}

template <typename T, typename W, typename PT>
int launch(const Params* p, int grid, cudaStream_t stream) {
  return Launcher<T, W, PT>::launch(*p, grid, stream);
}

}  // namespace

// the 8 variants: dtype 0 = f32, 1 = bf16; quant_w / quant_kv: int8
// weights / int8 pool
#define PMK_DISPATCH(FN, ...)                                                \
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

// The co-resident block count of one variant on the current device (whole
// clusters; the grid of every launch of it), in *grid. Returns a CUDA
// error code.
extern "C" int prefill_megakernel_grid(int dtype, int quant_w, int quant_kv,
                                       int* grid) {
  PMK_DISPATCH(grid_for, grid);
}

// The kernel's geometry, for the wrapper: the projection tile (tokens,
// columns, K step), the cluster, the most head_dim, the phases of a launch,
// the most q blocks of a step, the most query rows of a (q block, kv head)
// on the CUDA cores, the shared memory of a block.
extern "C" void prefill_megakernel_limits(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
  out[3] = kCluster;
  out[4] = kMaxDh;
  out[5] = kPhases;
  out[6] = kMaxBlocks;
  out[7] = kRows;
  out[8] = (int)kSmemBytes;
}

// A tensor map for the bf16 path, into out (128 bytes): elem_bytes 2
// (bf16) or 1 (int8) elements, `inner` x `outer` of them, rows `stride`
// bytes apart, boxes of box0 x box1 in the 128-byte swizzle (64-byte for
// 64-byte boxes). Returns a CUDA error code.
extern "C" int prefill_megakernel_encode(int elem_bytes, const void* base,
                                         int inner, int outer,
                                         long long stride, int box0,
                                         int box1, void* out) {
  CUtensorMap map;
  const CUtensorMapDataType type = elem_bytes == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle swz = box0 * elem_bytes == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!encode_2d(&map, type, base, inner, outer, stride, box0, box1, swz))
    return (int)cudaErrorNotSupported;
  memcpy(out, &map, sizeof(map));
  return 0;
}

// Launch. ptrs: ln1, ln2, w_qkv, w_o, w_gu, w_d, s_qkv, s_o, s_gu, s_d, kp,
// vp, ks, vs, h, h_out, tables, q_starts, q_lens, kv_lens, block_row, slot,
// cos, sin, xa, q, o, act, h2, bar, stamps (31); dims: T, D, H, Hkv, dh, F,
// P, ps, pps, R, qb, nq; maps: 7 tensor maps of 128 bytes (w: q|k|v, o,
// gate|up, down; x: xa, o, act), or null for f32 activations.
// Asynchronous on `stream`; returns cudaGetLastError() after the launch (0
// = success).
extern "C" int prefill_megakernel(int dtype, int quant_w, int quant_kv,
                                  const unsigned long long* ptrs,
                                  const int* dims, const void* maps,
                                  float eps, float scale, int grid,
                                  void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  if (maps != nullptr) {
    memcpy(p.tm_w, maps, sizeof(p.tm_w));
    memcpy(p.tm_x, static_cast<const char*>(maps) + sizeof(p.tm_w),
           sizeof(p.tm_x));
  }
  int i = 0;
  auto ptr = [&]() { return reinterpret_cast<void*>(ptrs[i++]); };
  p.ln1 = ptr(); p.ln2 = ptr();
  p.w_qkv = ptr(); p.w_o = ptr(); p.w_gu = ptr(); p.w_d = ptr();
  p.s_qkv = static_cast<const float*>(ptr());
  p.s_o = static_cast<const float*>(ptr());
  p.s_gu = static_cast<const float*>(ptr());
  p.s_d = static_cast<const float*>(ptr());
  p.kp = ptr(); p.vp = ptr();
  p.ks = static_cast<const float*>(ptr());
  p.vs = static_cast<const float*>(ptr());
  p.h = ptr(); p.h_out = ptr();
  p.tables = static_cast<const int*>(ptr());
  p.q_starts = static_cast<const int*>(ptr());
  p.q_lens = static_cast<const int*>(ptr());
  p.kv_lens = static_cast<const int*>(ptr());
  p.block_row = static_cast<const int*>(ptr());
  p.slot = static_cast<const int*>(ptr());
  p.cos = static_cast<const float*>(ptr());
  p.sin = static_cast<const float*>(ptr());
  p.xa = ptr();
  p.q = ptr();
  p.o = ptr();
  p.act = ptr();
  p.h2 = static_cast<float*>(ptr());
  p.bar = static_cast<unsigned int*>(ptr());
  p.stamps = static_cast<unsigned long long*>(ptr());
  p.T = dims[0]; p.D = dims[1]; p.H = dims[2]; p.Hkv = dims[3];
  p.dh = dims[4]; p.F = dims[5]; p.P = dims[6]; p.ps = dims[7];
  p.pps = dims[8]; p.R = dims[9]; p.qb = dims[10]; p.nq = dims[11];
  p.eps = eps;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PMK_DISPATCH(launch, &p, grid, s);
}
