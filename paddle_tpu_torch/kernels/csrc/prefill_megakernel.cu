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
// Design. The Pallas grid was (q block, kv-head group, logical page), with
// whole layer weights as constant VMEM blocks and the prologue recomputed
// per q block; on Hopper that would read the layer's 405 MB of bf16 weights
// once per q block. Here one PERSISTENT cooperative launch covers the layer
// (the grid is the co-resident block count) and phases are separated by a
// hand-written grid barrier (an arrival counter and a generation word, as
// in decode_megakernel.cu):
//
//   1. per token: x = rms_norm(h) * ln1, rounded;
//   2. x @ W_qkv on the tensor cores (mma.sync m16n8k16 bf16, f32 sums):
//      units of (128 tokens x 64 columns, one K chunk) -> f32 partials;
//   3. per token and column pair: the partials summed, scaled (int8),
//      rounded, roped (q and k); q kept for the attention, a live token's
//      k and v written into its pool slot (fp pools; an int8 pool was
//      appended to before the launch). The barrier after this phase makes
//      the fresh K/V visible to every block, so the TPU kernel's scratch
//      overlay of the chunk's K/V is not needed;
//   4. attention split over positions: a unit is (q block, kv head, a
//      split of the block's causal horizon); the split's K/V staged in
//      shared memory, a warp per query row, a lane per position, each row
//      leaving its split's (acc, m, l);
//   5. the splits of each (token, head) merged -> o, rounded (dead tokens:
//      0, as the plain version);
//   6. o @ W_o;   7. per token: h2 = h + o-proj, rms_norm(h2) * ln2;
//   8. x2 @ W_gate|up;   9. act = silu(gate) * up;   10. act @ W_down;
//   11. h_out = h2 + down.
//
// Weights keep the reference's [in, out] layout (fused q|k|v and gate|up
// are column concatenations). A projection unit stages a 128 x 64 tile of
// the activations and a 64 x 64 tile of the weight per K step through
// registers into shared memory (the next step's global loads in flight
// during the current step's mma), int8 weights widened to bf16 on the way
// (every value in [-127, 127] is exact in bf16) and their column scales
// applied where the partials are summed. The K dimension is split so the
// units fill the grid. f32 activations take a CUDA-core tile of the same
// geometry. Every value is rounded to the hidden type where the plain
// version (_reference_prefill_layer) rounds it: after each norm,
// projection, rope, the attention output and each residual add.
//
// Bound on this card, one Llama-2-7B layer at T = 128 (bf16): the weights,
// 202,375,168 parameters = 404.75 MB, over 3.35 TB/s is 0.121 ms; the
// projections' 2 * 128 * 202.4 M = 51.8 GFLOP over 989 TFLOP/s is 0.052
// ms. Bytes bound the layer; the design reads every weight once per launch
// whatever T is (for T <= 128), keeps the tensor cores for the products,
// and splits K so every SM streams weights. mma.sync without TMA or
// wgmma, and register-staged loads, leave it above that bound: TMA rings
// and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// projections: a unit is BM tokens x BN columns over one K chunk, walked
// BK at a time
constexpr int BM = 128, BN = 64, BK = 64;
constexpr int kAStride = BK + 8;   // bf16 per shared activation row (pad)
constexpr int kBStride = BN + 8;   // bf16 per shared weight row
constexpr int FK = 16;             // f32 tiles: K per step
constexpr int kSplit = 64;         // attention: positions per split and tile
constexpr int kMaxSplits = 16;     // splits per q block (at most)
constexpr int kRows = 64;          // query rows per (q block, kv head), most
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kMaxDh = 128;        // 4 elements per lane
constexpr int kMaxBlocks = 1024;   // q blocks of a step (at most)
constexpr int kPhases = 11;
constexpr float kNegInf = -1e30f;

// shared memory: the largest of the phases' layouts
constexpr size_t kGemmBytes = (size_t)(BM * kAStride + BK * kBStride) * 2;
constexpr size_t kGemmF32Bytes = (size_t)FK * ((BM + 4) + (BN + 4)) * 4;
constexpr size_t kAttnBytes =
    ((size_t)kSplit * (2 * kMaxDh + 1) + (size_t)kRows * kMaxDh +
     kWarps * kSplit + kMaxBlocks) * 4;
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr size_t kSmemBytes =
    cmax(kGemmBytes, cmax(kGemmF32Bytes, kAttnBytes));

struct Params {
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
  float* part;     // GEMM partials [ks, T, N]
  float* q;        // [T, H * dh] roped q
  float* att;      // [nb, Hkv, S, grp * qb, dh + 2] attention splits
  void* o;         // [T, H * dh] T
  void* act;       // [T, F] T
  float* h2;       // [T, D]
  unsigned int* bar;             // [2] arrival count, generation
  unsigned long long* stamps;    // [1 + kPhases] or null
  int T, D, H, Hkv, dh, F, P, ps, pps, R, qb;
  int nq;          // q|k|v columns projected here (H dh for int8 pools)
  int ks_qkv, ks_o, ks_gu, ks_d;
  int S;           // most attention splits of a q block
  float eps, scale;
};

// ---------------------------------------------------------------------------
// element types

template <typename T> struct Val;
template <> struct Val<float> {
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float x) { *p = x; }
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
  static __device__ __forceinline__ void ld4(const __nv_bfloat16* p,
                                             float v[4]) {
    const uint2 a = __ldcg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
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

// Grid-wide barrier (decode_megakernel.cu's): thread 0 of each block reads
// the generation, then arrives; the last arrival resets the count and
// advances the generation, the others wait for it to change. The fences
// order each block's writes before its arrival and the others' reads after
// their release.
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

// ---------------------------------------------------------------------------
// projections: part[kc, m, n] = sum over K chunk kc of A[m, k] * W[k, n]
// (A: [M, K] in the hidden type, W: [K, ldw] of which the first N columns)

struct Gemm {
  const void* a;
  const void* w;
  float* part;
  int M, K, N, ldw, ks;
};

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 weights of one row as one 16-byte bf16 segment of shared memory:
// bf16 loads 16 bytes as they are, int8 loads 8 bytes and widens them
template <typename W> struct W8;
template <> struct W8<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, bool ok) {
    a = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ uint4 bf16() const { return a; }
};
template <> struct W8<int8_t> {
  uint2 a;
  __device__ __forceinline__ void load(const int8_t* p, bool ok) {
    a = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
  }
  __device__ __forceinline__ uint4 bf16() const {
    uint4 r;
    uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t word = i < 2 ? a.x : a.y;
      const int s = (i & 1) * 16;
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          (float)(int8_t)(word >> s), (float)(int8_t)(word >> (s + 8)));
      o[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    return r;
  }
};

constexpr int kAChunks = BM * BK / 8 / kThreads;   // 16-byte chunks of A
constexpr int kWChunks = BK * BN / 8 / kThreads;   // 8-weight chunks of W
static_assert(BM * BK / 8 % kThreads == 0 && BK * BN / 8 % kThreads == 0,
              "every thread stages whole chunks");

// the unit u's place: column tile, token tile, K chunk (consecutive units
// share the activation tile and K chunk)
struct Unit {
  int n0, m0, kc, k0, k1;
};

__device__ __forceinline__ Unit unit_of(const Gemm& g, int u) {
  const int ntn = (g.N + BN - 1) / BN, ntm = (g.M + BM - 1) / BM;
  const int kt = (g.K + BK - 1) / BK;
  const int kc_len = (kt + g.ks - 1) / g.ks * BK;
  Unit r;
  r.n0 = (u % ntn) * BN;
  r.m0 = (u / ntn % ntm) * BM;
  r.kc = u / ntn / ntm;
  r.k0 = r.kc * kc_len;
  r.k1 = min(g.K, r.k0 + kc_len);
  return r;
}

__device__ __forceinline__ int gemm_units(const Gemm& g) {
  return (g.N + BN - 1) / BN * ((g.M + BM - 1) / BM) * g.ks;
}

// tensor cores: bf16 activations, bf16 or int8 weights. 8 warps, each a
// 32 x 32 piece of the 128 x 64 tile (4 warps down, 2 across).
template <typename W>
__device__ void gemm_mma(const Gemm& g, unsigned char* smem) {
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + BM * kAStride;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a);
  const W* Wt = static_cast<const W*>(g.w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int units = gemm_units(g);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_of(g, u);
    const int steps = (t.k1 - t.k0 + BK - 1) / BK;
    const bool warp_rows = t.m0 + wm < g.M;   // any of the warp's rows live
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    uint4 sa[kAChunks];
    W8<W> sw[kWChunks];
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {
        const int c = tid + i * kThreads;
        const int m = t.m0 + c / (BK / 8), k = k0 + (c % (BK / 8)) * 8;
        sa[i] = (m < g.M && k < t.k1)
                    ? __ldcg(reinterpret_cast<const uint4*>(
                          A + (size_t)m * g.K + k))
                    : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kWChunks; ++i) {
        const int c = tid + i * kThreads;
        const int k = k0 + c / (BN / 8), n = t.n0 + (c % (BN / 8)) * 8;
        sw[i].load(Wt + (size_t)k * g.ldw + n, k < t.k1 && n < g.N);
      }
    };
    load(t.k0);
    for (int s = 0; s < steps; ++s) {
      __syncthreads();                  // the previous step's reads are done
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {
        const int c = tid + i * kThreads;
        *reinterpret_cast<uint4*>(sA + (c / (BK / 8)) * kAStride +
                                  (c % (BK / 8)) * 8) = sa[i];
      }
#pragma unroll
      for (int i = 0; i < kWChunks; ++i) {
        const int c = tid + i * kThreads;
        *reinterpret_cast<uint4*>(sB + (c / (BN / 8)) * kBStride +
                                  (c % (BN / 8)) * 8) = sw[i].bf16();
      }
      __syncthreads();
      if (s + 1 < steps) load(t.k0 + (s + 1) * BK);   // in flight meanwhile
      if (warp_rows) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          uint32_t a[2][4], b[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldsm_x4(a[mi], sA + (wm + mi * 16 + (lane & 15)) * kAStride + kk +
                               (lane >> 4) * 8);
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
            ldsm_x4_trans(b[nj],
                          sB + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   kBStride +
                               wn + nj * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                       b[ni >> 1][(ni & 1) * 2 + 1]);
        }
      }
    }
    // the f32 partial sums, two adjacent columns per store
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = t.n0 + wn + ni * 8 + (lane & 3) * 2;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = t.m0 + wm + mi * 16 + (lane >> 2) + hf * 8;
          if (r < g.M && c < g.N)
            *reinterpret_cast<float2*>(g.part + ((size_t)t.kc * g.M + r) *
                                                    g.N + c) =
                make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
        }
      }
  }
}

// CUDA cores: f32 activations, f32 or int8 weights. Thread (ty, tx) owns
// rows ty + 16 i (i < 8) and columns tx + 16 j (j < 4) of the tile.
template <typename W>
__device__ void gemm_f32(const Gemm& g, unsigned char* smem) {
  float* sA = reinterpret_cast<float*>(smem);    // [FK][BM + 4], K-major
  float* sB = sA + FK * (BM + 4);                // [FK][BN + 4]
  const float* A = static_cast<const float*>(g.a);
  const W* Wt = static_cast<const W*>(g.w);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int units = gemm_units(g);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_of(g, u);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = t.k0; k0 < t.k1; k0 += FK) {
      __syncthreads();
      for (int e = tid; e < BM * FK; e += kThreads) {
        const int r = e / FK, kk = e % FK, m = t.m0 + r, k = k0 + kk;
        sA[kk * (BM + 4) + r] =
            (m < g.M && k < t.k1) ? __ldcg(A + (size_t)m * g.K + k) : 0.f;
      }
      for (int e = tid; e < FK * BN; e += kThreads) {
        const int kk = e / BN, c = e % BN, k = k0 + kk, n = t.n0 + c;
        sB[kk * (BN + 4) + c] =
            (k < t.k1 && n < g.N) ? Val<W>::ld(Wt + (size_t)k * g.ldw + n)
                                  : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sA[kk * (BM + 4) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sB[kk * (BN + 4) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = t.m0 + ty + 16 * i, c = t.n0 + tx + 16 * j;
        if (r < g.M && c < g.N)
          g.part[((size_t)t.kc * g.M + r) * g.N + c] = acc[i][j];
      }
  }
}

template <typename T, typename W>
__device__ __forceinline__ void gemm(const Gemm& g, unsigned char* smem) {
  if constexpr (sizeof(T) == 2)
    gemm_mma<W>(g, smem);
  else
    gemm_f32<W>(g, smem);
}

// the K chunks of a partial buffer summed at (r, c), times the column's
// int8 scale (the plain version scales the weight before the sum: the same
// function rounded in another order)
__device__ __forceinline__ float partial(const float* part, int ks, int M,
                                         int N, int r, int c,
                                         const float* scale) {
  float s = 0.f;
  for (int kc = 0; kc < ks; ++kc)
    s += __ldcg(part + ((size_t)kc * M + r) * N + c);
  return scale != nullptr ? s * scale[c] : s;
}

// ---------------------------------------------------------------------------
// tokens, rows and attention units

// the live token t: inside its q block's row's q_len
__device__ __forceinline__ bool token_live(const Params& p, int t) {
  const int row = p.block_row[t / p.qb];
  const int off = t - p.q_starts[row];
  return off >= 0 && off < p.q_lens[row];
}

// the attention splits of q block i: none for a block outside its row's
// chunk, else ceil(horizon / kSplit) capped at S
__device__ __forceinline__ int block_splits(const Params& p, int i) {
  const int row = p.block_row[i];
  const int ql = p.q_lens[row], kl = p.kv_lens[row];
  const int off = i * p.qb - p.q_starts[row];
  if (off < 0 || off >= ql) return 0;
  const int horizon = min(kl, kl - ql + off + p.qb);
  return min(p.S, max(1, (horizon + kSplit - 1) / kSplit));
}

// every q block's split count, into shared memory (a unit's walk to its
// block then reads no global memory)
__device__ __forceinline__ void load_splits(const Params& p, int* sns) {
  __syncthreads();                       // sns is free
  for (int i = threadIdx.x; i < p.T / p.qb; i += kThreads)
    sns[i] = block_splits(p, i);
  __syncthreads();
}

// Phase 4: a unit is (q block i, kv head hk, split s of the block's causal
// horizon). The split's K and V are staged in shared memory kSplit
// positions at a time (int8 pages dequantized by their (head, page)
// scales on the way, as the plain version's gather does); each warp then
// takes one of the block's grp * qb query rows at a time (row qi: token
// i*qb + qi % qb of q head hk*grp + qi / qb), a lane scoring one position
// with a whole dot product (no cross-lane sum), the warp keeping the row's
// online softmax over the tiles, each lane 4 elements of its output.
template <typename PT>
__device__ void attend_phase(const Params& p, unsigned char* smem_raw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, Hkv = p.Hkv, dh = p.dh, grp = H / Hkv, qb = p.qb;
  const int nb = p.T / qb, nrows = grp * qb;
  constexpr bool kQuant = sizeof(PT) == 1;
  const PT* kp = static_cast<const PT*>(p.kp);
  const PT* vp = static_cast<const PT*>(p.vp);
  float* sk = reinterpret_cast<float*>(smem_raw);   // [kSplit][kMaxDh + 1]
  float* sv = sk + kSplit * (kMaxDh + 1);           // [kSplit][kMaxDh]
  float* sq = sv + kSplit * kMaxDh;                 // [kRows][kMaxDh]
  float* sp = sq + kRows * kMaxDh;                  // [kWarps][kSplit]
  int* sns = reinterpret_cast<int*>(sp + kWarps * kSplit);  // [nb]
  const int e0 = 4 * lane;
  const bool lane_ok = e0 < dh;
  load_splits(p, sns);
  int units = 0;
  for (int i = 0; i < nb; ++i) units += sns[i] * Hkv;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int i = 0, v = u;
    while (v >= sns[i] * Hkv) {
      v -= sns[i] * Hkv;
      ++i;
    }
    const int ns = sns[i], s = v % ns, hk = v / ns;
    const int row = p.block_row[i];
    const int ql = p.q_lens[row], kl = p.kv_lens[row];
    const int off = i * qb - p.q_starts[row], kv0 = kl - ql;
    const int horizon = min(kl, kv0 + off + qb);
    const int len = (horizon + ns - 1) / ns;
    const int p0 = s * len, p1 = min(horizon, p0 + len);
    const int* tbl = p.tables + (size_t)row * p.pps;
    __syncthreads();                     // the previous unit's smem reads
    for (int x = tid; x < nrows * dh; x += kThreads) {
      const int qi = x / dh, e = x % dh;
      sq[qi * kMaxDh + e] = __ldcg(
          p.q + ((size_t)(i * qb + qi % qb) * H + hk * grp + qi / qb) * dh +
          e);
    }
    // the warp's rows' softmax states: row warp + kWarps * r
    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int t0 = p0; t0 < p1; t0 += kSplit) {
      const int n = min(kSplit, p1 - t0);
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
        for (int h = 0; h < kSplit / 32; ++h) {
          const int j = lane + 32 * h;
          float d = 0.f;
          if (j < n) {
            const float* kr = sk + j * (kMaxDh + 1);
            for (int e = 0; e < dh; ++e) d = fmaf(qr[e], kr[e], d);
          }
          sc[h] = j < n && t0 + j <= lim ? d * p.scale : kNegInf;
          mx = fmaxf(mx, sc[h]);
        }
        mx = warp_max(mx);
        const float alpha = expf(m[r] - mx);
        float sum = 0.f;
#pragma unroll
        for (int h = 0; h < kSplit / 32; ++h) {
          const int j = lane + 32 * h;
          const float ex = j < n && t0 + j <= lim ? expf(sc[h] - mx) : 0.f;
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
    float* out = p.att + (((size_t)i * Hkv + hk) * p.S + s) * nrows * (dh + 2);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = warp + kWarps * r;
      if (qi >= nrows) break;
      float* o = out + (size_t)qi * (dh + 2);
      if (lane_ok)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[e0 + c] = acc[r][c];
      if (lane == 0) {
        o[dh] = m[r];
        o[dh + 1] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the layer

template <typename T, typename W, typename PT>
__global__ void __launch_bounds__(kThreads, 2)
prefill_megakernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const int T_ = p.T, D = p.D, F = p.F, H = p.H, Hkv = p.Hkv, dh = p.dh;
  const int Hd = H * dh, Kd = Hkv * dh;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * kThreads + tid;
  const int gstride = gridDim.x * kThreads;
  const T* h = static_cast<const T*>(p.h);
  const T* ln1 = static_cast<const T*>(p.ln1);
  const T* ln2 = static_cast<const T*>(p.ln2);
  T* xa = static_cast<T*>(p.xa);
  if (p.stamps != nullptr && blockIdx.x == 0 && tid == 0)
    p.stamps[0] = now_ns();

  // 1. x = rms_norm(h) * ln1, per token
  for (int r = blockIdx.x; r < T_; r += gridDim.x) {
    const T* hr = h + (size_t)r * D;
    float ss = 0.f;
        for (int k = tid; k < D; k += kThreads) {
      const float v = Val<T>::ld(hr + k);
      ss = fmaf(v, v, ss);
    }
    const float rstd = 1.0f / sqrtf(block_sum(ss, red) / (float)D + p.eps);
        for (int k = tid; k < D; k += kThreads)
      Val<T>::st(xa + (size_t)r * D + k,
                 Val<T>::rnd(Val<T>::rnd(Val<T>::ld(hr + k) * rstd) *
                             Val<T>::ld(ln1 + k)));
  }
  phase_end(p, 0);

  // 2. q|k|v projection (only q for an int8 pool)
  gemm<T, W>(Gemm{xa, p.w_qkv, p.part, T_, D, p.nq, Hd + 2 * Kd, p.ks_qkv},
             smem);
  phase_end(p, 1);

  // 3. per token and column pair: round, rope q and k; q kept, a live
  // token's k and v into its pool slot
  {
    const int pairs = p.nq / 2;
    T* kp = static_cast<T*>(p.kp);
    T* vp = static_cast<T*>(p.vp);
        for (int x = gtid; x < T_ * pairs; x += gstride) {
      const int t = x / pairs, c = (x % pairs) * 2;
      float a = Val<T>::rnd(partial(p.part, p.ks_qkv, T_, p.nq, t, c,
                                    p.s_qkv));
      float b = Val<T>::rnd(partial(p.part, p.ks_qkv, T_, p.nq, t, c + 1,
                                    p.s_qkv));
      if (c < Hd + Kd) {
        // interleaved pairs (2i, 2i + 1) rotate by frequency i, in f32
        // with unfused multiplies, as the plain version
        const int f = (c % dh) / 2;
        const float cs = p.cos[(size_t)t * (dh / 2) + f];
        const float sn = p.sin[(size_t)t * (dh / 2) + f];
        const float o1 = __fsub_rn(__fmul_rn(a, cs), __fmul_rn(b, sn));
        const float o2 = __fadd_rn(__fmul_rn(b, cs), __fmul_rn(a, sn));
        a = Val<T>::rnd(o1);
        b = Val<T>::rnd(o2);
      }
      if (c < Hd) {
        p.q[(size_t)t * Hd + c] = a;
        p.q[(size_t)t * Hd + c + 1] = b;
      } else if (token_live(p, t)) {
        const bool is_v = c >= Hd + Kd;
        const int cc = c - Hd - (is_v ? Kd : 0);
        const size_t at =
            ((size_t)(cc / dh) * p.P * p.ps + p.slot[t]) * dh + cc % dh;
        T* pool = is_v ? vp : kp;
        Val<T>::st(pool + at, a);
        Val<T>::st(pool + at + 1, b);
      }
    }
  }
  phase_end(p, 2);

  // 4-5. attention over position splits; the splits merged -> o
  attend_phase<PT>(p, smem);
  phase_end(p, 3);
  {
    const int grp = H / Hkv, qb = p.qb, nrows = grp * qb;
    int* sns = reinterpret_cast<int*>(smem);
    load_splits(p, sns);
    T* o = static_cast<T*>(p.o);
        for (int x = gtid; x < T_ * Hd; x += gstride) {
      const int t = x / Hd, hq = (x / dh) % H, e = x % dh;
      const int i = t / qb, ns = sns[i];
      float val = 0.f;
      if (ns > 0) {
        const int qi = (hq % grp) * qb + t % qb;
        const float* at = p.att + ((((size_t)i * Hkv + hq / grp) * p.S) *
                                   nrows + qi) * (dh + 2);
        const size_t stride = (size_t)nrows * (dh + 2);
        float mx = kNegInf;
        for (int s = 0; s < ns; ++s)
          mx = fmaxf(mx, __ldcg(at + s * stride + dh));
        float ls = 0.f, as = 0.f;
        for (int s = 0; s < ns; ++s) {
          const float f = expf(__ldcg(at + s * stride + dh) - mx);
          ls = fmaf(__ldcg(at + s * stride + dh + 1), f, ls);
          as = fmaf(__ldcg(at + s * stride + e), f, as);
        }
        val = as / fmaxf(ls, 1e-30f);    // a dead token: 0 / 1e-30 = 0
      }
      Val<T>::st(o + x, Val<T>::rnd(val));
    }
  }
  phase_end(p, 4);

  // 6. o projection
  gemm<T, W>(Gemm{p.o, p.w_o, p.part, T_, Hd, D, D, p.ks_o}, smem);
  phase_end(p, 5);

  // 7. per token: h2 = h + o-proj; x2 = rms_norm(h2) * ln2
  for (int r = blockIdx.x; r < T_; r += gridDim.x) {
    float ss = 0.f;
        for (int c = tid; c < D; c += kThreads) {
      const size_t at = (size_t)r * D + c;
      const float y = Val<T>::rnd(partial(p.part, p.ks_o, T_, D, r, c, p.s_o));
      const float v = Val<T>::rnd(Val<T>::ld(h + at) + y);
      p.h2[at] = v;
      ss = fmaf(v, v, ss);
    }
    const float rstd = 1.0f / sqrtf(block_sum(ss, red) / (float)D + p.eps);
        for (int c = tid; c < D; c += kThreads) {
      const size_t at = (size_t)r * D + c;
      Val<T>::st(xa + at, Val<T>::rnd(Val<T>::rnd(p.h2[at] * rstd) *
                                      Val<T>::ld(ln2 + c)));
    }
  }
  phase_end(p, 6);

  // 8. gate|up projection
  gemm<T, W>(Gemm{xa, p.w_gu, p.part, T_, D, 2 * F, 2 * F, p.ks_gu}, smem);
  phase_end(p, 7);

  // 9. act = silu(gate) * up
  {
    T* act = static_cast<T*>(p.act);
        for (int x = gtid; x < T_ * F; x += gstride) {
      const int t = x / F, c = x % F;
      const float g = Val<T>::rnd(partial(p.part, p.ks_gu, T_, 2 * F, t, c,
                                          p.s_gu));
      const float u = Val<T>::rnd(partial(p.part, p.ks_gu, T_, 2 * F, t,
                                          F + c, p.s_gu));
      const float sg = Val<T>::rnd(g / (1.0f + expf(-g)));
      Val<T>::st(act + x, Val<T>::rnd(sg * u));
    }
  }
  phase_end(p, 8);

  // 10. down projection
  gemm<T, W>(Gemm{p.act, p.w_d, p.part, T_, F, D, D, p.ks_d}, smem);
  phase_end(p, 9);

  // 11. h_out = h2 + down
    for (int x = gtid; x < T_ * D; x += gstride) {
    const float y = Val<T>::rnd(partial(p.part, p.ks_d, T_, D, x / D, x % D,
                                        p.s_d));
    Val<T>::st(static_cast<T*>(p.h_out) + x,
               Val<T>::rnd(__ldcg(p.h2 + x) + y));
  }
  if (p.stamps != nullptr) phase_end(p, 10);
}

template <typename T, typename W, typename PT>
int grid_for(int* grid) {
  auto kernel = prefill_megakernel<T, W, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
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
           &per_sm, kernel, kThreads, kSmemBytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = per_sm * sms;
  return 0;
}

template <typename T, typename W, typename PT>
int launch(Params* p, int grid, cudaStream_t stream) {
  auto kernel = prefill_megakernel<T, W, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, kSmemBytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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

// The co-resident block count of one variant on the current device (the
// grid of every launch of it), in *grid. Returns a CUDA error code.
extern "C" int prefill_megakernel_grid(int dtype, int quant_w, int quant_kv,
                                       int* grid) {
  PMK_DISPATCH(grid_for, grid);
}

// The kernel's geometry, for the wrapper: the projection tile (tokens,
// columns, K step), the positions of an attention split, the most splits
// of a q block, the most query rows of a (q block, kv head), the most
// head_dim, the phases of a launch and the most q blocks of a step.
extern "C" void prefill_megakernel_limits(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
  out[3] = kSplit;
  out[4] = kMaxSplits;
  out[5] = kRows;
  out[6] = kMaxDh;
  out[7] = kPhases;
  out[8] = kMaxBlocks;
}

// Launch. ptrs: 30 device pointers (ln1, ln2, w_qkv, w_o, w_gu, w_d, s_qkv,
// s_o, s_gu, s_d, kp, vp, ks, vs, h, h_out, tables, q_starts, q_lens,
// kv_lens, block_row, slot, cos, sin, xa, part, q, att, o, act, h2, bar,
// stamps -- 33 in all); dims: T, D, H, Hkv, dh, F, P, ps, pps, R, qb, nq,
// ks_qkv, ks_o, ks_gu, ks_d, S. Asynchronous on `stream`; returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int prefill_megakernel(int dtype, int quant_w, int quant_kv,
                                  const unsigned long long* ptrs,
                                  const int* dims, float eps, float scale,
                                  int grid, void* stream) {
  Params p;
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
  p.part = static_cast<float*>(ptr());
  p.q = static_cast<float*>(ptr());
  p.att = static_cast<float*>(ptr());
  p.o = ptr();
  p.act = ptr();
  p.h2 = static_cast<float*>(ptr());
  p.bar = static_cast<unsigned int*>(ptr());
  p.stamps = static_cast<unsigned long long*>(ptr());
  p.T = dims[0]; p.D = dims[1]; p.H = dims[2]; p.Hkv = dims[3];
  p.dh = dims[4]; p.F = dims[5]; p.P = dims[6]; p.ps = dims[7];
  p.pps = dims[8]; p.R = dims[9]; p.qb = dims[10]; p.nq = dims[11];
  p.ks_qkv = dims[12]; p.ks_o = dims[13]; p.ks_gu = dims[14];
  p.ks_d = dims[15]; p.S = dims[16];
  p.eps = eps;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PMK_DISPATCH(launch, &p, grid, s);
}
