// RMSNorm forward and backward over the last axis, for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/rms_norm.py:
//   - _fwd_kernel (:30, launched by _run_fwd at :65): per row of x [r, f],
//     rstd = rsqrt(mean(x^2) + eps) in f32 and y = x * rstd * w, multiplied
//     in f32 and cast to x's dtype last; rstd [r] is returned in f32;
//   - _bwd_kernel (:38, launched by _run_bwd at :88): from x, w, rstd, dy,
//     xhat = x * rstd, dx = rstd * (dy*w - xhat * mean(dy*w*xhat)) in x's
//     dtype, and dw = sum over rows of dy * xhat in w's dtype. The TPU
//     kernel sums dw in a VMEM scratch carried across its sequential grid.
//
// x and w are f32 or bf16 in any mix; y has their promoted type (f32 unless
// both are bf16, as jnp promotes them), dy and dx x's type; every tensor is
// contiguous.
//
// Bound: memory (about 1 flop per byte forward, 3 backward), so the design
// reads each byte of x and dy from device memory once, with several rows'
// loads in flight on every SM.
//
// Register tile (f <= kMaxTileF). A block of G = 32 * ceil(f / (32 * E))
// threads walks a contiguous chunk of rows; thread t owns the vectors
// t, t + G, t + 2G, ... of every row (E elements in all, a compile-time count:
// kFwdElems forward, kBwdElems backward), so it keeps its slice of w, and
// backward its slice of dw, in registers for the whole chunk. Rows go
// through a ring of kStages slots: the loads of row i + kStages - 1 are
// issued before row i is reduced, so each thread has up to kStages rows of
// loads in flight. The forward's ring lives in registers. The backward's
// ring of x and dy lives in dynamic shared memory, filled by 16-byte
// cp.async copies that each thread issues for its own elements and waits
// for itself (no barrier guards a slot), when the vector path applies;
// otherwise in registers (kRegStages slots). The row sum is a warp shuffle
// tree, then the warps' sums added in warp order through shared memory
// (one barrier a row, the scratch double-buffered). Each backward block
// writes one f32 dw partial per column for its chunk, its rows summed in
// row order; a second launch adds the partials in chunk order, launched as
// a programmatic dependent of the first so that its launch overlaps the
// first's run. (Letting the last blocks to finish sum them, after a
// __threadfence and a ticket counter, was 3-26x slower: a few SMs read
// every partial; PERF.md.) The chunking is a function of the shape and of
// constants (the caller's dw_chunks), never of arrival order or occupancy:
// two launches on the same inputs give the same bits.
//
// On the card (PERF.md): the forward runs at the speed of a plain device
// copy of the same bytes, the backward at 1.2x that of a torch.add of the
// same bytes; neither reaches the bytes bound when the L2 it starts with
// holds dirty lines, which its traffic must write back first.
//
// Wide rows (f > kMaxTileF): forward, a warp per row in two passes over
// the row (the second finds it in L1/L2); backward, a block of 256 threads
// per chunk of rows, two passes over each row (the second from L1/L2), dw
// partials accumulated in the partial buffer itself, summed as above.
//
// Rounding: the row sums are taken in another order than the plain
// PyTorch version (kernels/rms_norm.py), and every other product, sum and
// difference is rounded where the plain version rounds it (the _rn
// intrinsics keep nvcc from contracting them into FMAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSMs = 132;           // H100 SXM; sets the forward's chunking
constexpr int kFwdElems = 16;       // row elements per thread, forward
constexpr int kBwdElems = 8;        // row elements per thread, backward
constexpr int kMaxFwdThreads = 256;
constexpr int kMaxBwdThreads = 512;
constexpr int kMaxTileF = 4096;     // = kMaxFwdThreads * kFwdElems
                                    // = kMaxBwdThreads * kBwdElems
constexpr int kStages = 3;          // ring slots: rows of loads in flight
constexpr bool kRing = true;        // backward ring in shared memory
constexpr int kRegStages = 2;       // backward ring slots in registers
constexpr int kFwdWarpsPerSM = 32;  // forward chunks: warps aimed at an SM
constexpr bool kPdl = true;         // dw sum launched early (programmatic
                                    // dependent launch), waiting on the first
constexpr int kWideWarps = 8;       // wide forward: rows per block
constexpr int kWideThreads = 256;   // wide backward: threads per block
constexpr int kSumCols = 8;         // dw sum: columns per block
constexpr int kSumTile = 1024;      // dw sum: chunks staged at a time

static_assert(kMaxTileF == kMaxFwdThreads * kFwdElems &&
              kMaxTileF == kMaxBwdThreads * kBwdElems, "tile widths");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// y's type: x's and w's promoted (bf16 only when both are)
template <typename TX, typename TW>
using YOf = std::conditional_t<std::is_same<TW, float>::value, float, TX>;

// N consecutive elements as one aligned access (N * sizeof(T) bytes).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&out)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = to_f32(pk.v[k]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&in)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int k = 0; k < N; ++k) pk.v[k] = from_f32<T>(in[k]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> zero_pack() {
  Pack<T, N> pk;
#pragma unroll
  for (int k = 0; k < N; ++k) pk.v[k] = from_f32<T>(0.f);
  return pk;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v (every thread gets the same bits): the warp's
// shuffle tree, then the warps' sums in warp order. red is [2][32] floats;
// parity alternates per call, so one barrier per call suffices.
__device__ __forceinline__ float block_sum(float v, float (*red)[32],
                                           int& parity) {
  v = warp_sum(v);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[parity][threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < warps; ++k) s = __fadd_rn(s, red[parity][k]);
  parity ^= 1;
  return s;
}

// ---- cp.async (16 bytes a copy, one group per ring slot) ----
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A chunk of rows [r0, r1) and the row count per chunk: block b takes
// rows [b * per, min((b + 1) * per, rows)).
struct Chunk {
  long long r0, r1;
  __device__ Chunk(long long rows, long long per) {
    r0 = (long long)blockIdx.x * per;
    r1 = r0 + per < rows ? r0 + per : rows;
  }
};

// ---------------------------------------------------------------------------
// forward, register tile: thread t owns vectors t + G * k, k < NV
// ---------------------------------------------------------------------------
template <typename TX, typename TW, int V, int NV>
__global__ void __launch_bounds__(kMaxFwdThreads)
rms_fwd_tile_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    YOf<TX, TW>* __restrict__ y, float* __restrict__ rstd,
                    long long rows, int f, float eps, long long per) {
  using TY = YOf<TX, TW>;
  __shared__ float red[2][32];
  const int G = blockDim.x, tid = threadIdx.x, nvec = f / V;
  const Chunk ch(rows, per);
  float wv[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = tid + G * k;
    if (j < nvec) {
      load<TW, V>(w + (long long)j * V, wv[k]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) wv[k][e] = 0.f;
    }
  }
  Pack<TX, V> ring[kStages][NV];
  auto fetch = [&](Pack<TX, V> (&slot)[NV], long long row) {
    const TX* xr = x + row * f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = tid + G * k;
      slot[k] = j < nvec ? *reinterpret_cast<const Pack<TX, V>*>(
                               xr + (long long)j * V)
                         : zero_pack<TX, V>();
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (ch.r0 + s < ch.r1) fetch(ring[s], ch.r0 + s);
  int parity = 0;
  for (long long base = ch.r0; base < ch.r1; base += kStages) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const long long i = base + s;
      if (i >= ch.r1) break;                       // uniform in the block
      if (i + kStages - 1 < ch.r1)
        fetch(ring[(s + kStages - 1) % kStages], i + kStages - 1);
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xv = to_f32(ring[s][k].v[e]);
          ss = __fadd_rn(ss, __fmul_rn(xv, xv));
        }
      ss = block_sum(ss, red, parity);
      const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)f), eps));
      if (tid == 0) rstd[i] = r;
      TY* yr = y + i * f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = tid + G * k;
        if (j >= nvec) continue;
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          out[e] = __fmul_rn(__fmul_rn(to_f32(ring[s][k].v[e]), r), wv[k][e]);
        store<TY, V>(yr + (long long)j * V, out);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward, wide rows: a warp per row, two passes
// ---------------------------------------------------------------------------
template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(32 * kWideWarps)
rms_fwd_wide_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    YOf<TX, TW>* __restrict__ y, float* __restrict__ rstd,
                    long long rows, int f, float eps) {
  using TY = YOf<TX, TW>;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWideWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * f;
  TY* yr = y + row * f;
  const int chunks = f / N;
  float ss = 0.f;
  for (int j = lane; j < chunks; j += 32) {
    float xv[N];
    load<TX, N>(xr + (long long)j * N, xv);
#pragma unroll
    for (int k = 0; k < N; ++k) ss = __fadd_rn(ss, __fmul_rn(xv[k], xv[k]));
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)f), eps));
  if (lane == 0) rstd[row] = r;
  for (int j = lane; j < chunks; j += 32) {
    float xv[N], wv[N], yv[N];
    load<TX, N>(xr + (long long)j * N, xv);
    load<TW, N>(w + (long long)j * N, wv);
#pragma unroll
    for (int k = 0; k < N; ++k) yv[k] = __fmul_rn(__fmul_rn(xv[k], r), wv[k]);
    store<TY, N>(yr + (long long)j * N, yv);
  }
}

// ---------------------------------------------------------------------------
// backward: the dw partials of a chunk, then their sum in chunk order
// ---------------------------------------------------------------------------

// Programmatic dependent launch: the backward lets the dw sum launch at
// once (its blocks take their SM slots beside it), and the sum waits for
// the backward's grid to finish and its writes to show before it reads.
__device__ __forceinline__ void let_dependents_launch() {
  if constexpr (kPdl) asm volatile("griddepcontrol.launch_dependents;\n");
}
__device__ __forceinline__ void wait_for_prerequisites() {
  if constexpr (kPdl) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Sum partial[c, cols] over c in chunk order into dw[cols]: a block of
// 256 threads stages kSumTile chunks of its kSumCols columns at a time in
// shared memory, then kSumCols threads add them in order.
template <typename TW>
__global__ void __launch_bounds__(256)
rms_dw_sum_kernel(const float* __restrict__ partial, TW* __restrict__ dw,
                  int f, int chunks) {
  __shared__ float buf[kSumTile][kSumCols];
  wait_for_prerequisites();
  const int tid = threadIdx.x, col0 = blockIdx.x * kSumCols;
  float acc = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += kSumTile) {
    const int n = chunks - c0 < kSumTile ? chunks - c0 : kSumTile;
#pragma unroll 8
    for (int i = tid; i < n * kSumCols; i += blockDim.x) {
      const int c = i / kSumCols, col = col0 + i % kSumCols;
      buf[c][i % kSumCols] =
          col < f ? __ldcg(partial + (long long)(c0 + c) * f + col) : 0.f;
    }
    __syncthreads();
    if (tid < kSumCols) {
      int c = 0;
      for (; c + 16 <= n; c += 16) {            // 16 loads, then 16 adds
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = buf[c + u][tid];
#pragma unroll
        for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, v[u]);
      }
      for (; c < n; ++c) acc = __fadd_rn(acc, buf[c][tid]);
    }
    __syncthreads();
  }
  if (tid < kSumCols && col0 + tid < f) dw[col0 + tid] = from_f32<TW>(acc);
}

// Backward, register tile: thread t owns vectors t + G * k, k < NV, of
// every row of its block's chunk, through a ring of S slots. RING: x and
// dy stage through dynamic shared memory ([S][2][f] of TX, by cp.async);
// else registers.
template <typename TX, typename TW, int V, int NV, bool RING, int S>
__global__ void __launch_bounds__(kMaxBwdThreads)
rms_bwd_tile_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ rstd,
                    const TX* __restrict__ dy, TX* __restrict__ dx,
                    float* __restrict__ partial, long long rows, int f,
                    long long per) {
  __shared__ float red[2][32];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TX* sring = reinterpret_cast<TX*>(smem_raw);
  const int G = blockDim.x, tid = threadIdx.x, nvec = f / V;
  const Chunk ch(rows, per);
  let_dependents_launch();
  float wv[NV][V], dwa[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = tid + G * k;
#pragma unroll
    for (int e = 0; e < V; ++e) dwa[k][e] = 0.f;
    if (j < nvec) {
      load<TW, V>(w + (long long)j * V, wv[k]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) wv[k][e] = 0.f;
    }
  }
  Pack<TX, V> xq[S][NV], gq[S][NV];   // unused under RING
  float rq[S];
  // issue the loads of `row` into ring slot s (RING: one commit group per
  // slot, empty past the chunk, so the group count stays uniform)
  auto fetch = [&](int s, long long row) {
    const bool live = row < ch.r1;
    if (live) rq[s] = rstd[row];
    if constexpr (RING) {
      TX* sx = sring + (long long)s * 2 * f;
      TX* sg = sx + f;
      if (live) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int j = tid + G * k;
          if (j < nvec) {
            cp_async16(sx + j * V, x + row * f + (long long)j * V);
            cp_async16(sg + j * V, dy + row * f + (long long)j * V);
          }
        }
      }
      cp_async_commit();
    } else {
      if (!live) return;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = tid + G * k;
        const bool ok = j < nvec;
        xq[s][k] = ok ? *reinterpret_cast<const Pack<TX, V>*>(
                            x + row * f + (long long)j * V)
                      : zero_pack<TX, V>();
        gq[s][k] = ok ? *reinterpret_cast<const Pack<TX, V>*>(
                            dy + row * f + (long long)j * V)
                      : zero_pack<TX, V>();
      }
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) fetch(s, ch.r0 + s);
  int parity = 0;
  for (long long base = ch.r0; base < ch.r1; base += S) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long i = base + s;
      if (i >= ch.r1) break;                       // uniform in the block
      fetch((s + S - 1) % S, i + S - 1);
      float xv[NV][V], gv[NV][V];
      if constexpr (RING) {
        cp_async_wait<S - 1>();
        const TX* sx = sring + (long long)s * 2 * f;
        const TX* sg = sx + f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int j = tid + G * k;
          if (j < nvec) {
            load<TX, V>(sx + j * V, xv[k]);
            load<TX, V>(sg + j * V, gv[k]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) xv[k][e] = gv[k][e] = 0.f;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            xv[k][e] = to_f32(xq[s][k].v[e]);
            gv[k][e] = to_f32(gq[s][k].v[e]);
          }
      }
      const float r = rq[s];
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e)
          t = __fadd_rn(t, __fmul_rn(__fmul_rn(gv[k][e], wv[k][e]),
                                     __fmul_rn(xv[k][e], r)));
      const float c = __fdiv_rn(block_sum(t, red, parity), (float)f);
      TX* dxr = dx + i * f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = tid + G * k;
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = __fmul_rn(xv[k][e], r);
          const float dxhat = __fmul_rn(gv[k][e], wv[k][e]);
          out[e] = __fmul_rn(r, __fsub_rn(dxhat, __fmul_rn(xhat, c)));
          dwa[k][e] = __fadd_rn(dwa[k][e], __fmul_rn(gv[k][e], xhat));
        }
        if (j < nvec) store<TX, V>(dxr + (long long)j * V, out);
      }
    }
  }
  if constexpr (RING) cp_async_wait<0>();
  float* pr = partial + (long long)blockIdx.x * f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = tid + G * k;
    if (j < nvec) store<float, V>(pr + (long long)j * V, dwa[k]);
  }
}

// Backward, wide rows: a block of kWideThreads threads per chunk; two
// passes over each row (the second from L1/L2); the thread's dw partials
// accumulate in its own entries of partial[blockIdx.x].
template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(kWideThreads)
rms_bwd_wide_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ rstd,
                    const TX* __restrict__ dy, TX* __restrict__ dx,
                    float* __restrict__ partial, long long rows, int f,
                    long long per) {
  __shared__ float red[2][32];
  const int tid = threadIdx.x, nvec = f / N;
  const Chunk ch(rows, per);
  let_dependents_launch();
  float* pr = partial + (long long)blockIdx.x * f;
  int parity = 0;
  for (long long i = ch.r0; i < ch.r1; ++i) {
    const TX* xr = x + i * f;
    const TX* gr = dy + i * f;
    const float r = rstd[i];
    float t = 0.f;
    for (int j = tid; j < nvec; j += kWideThreads) {
      float xv[N], wv[N], gv[N];
      load<TX, N>(xr + (long long)j * N, xv);
      load<TW, N>(w + (long long)j * N, wv);
      load<TX, N>(gr + (long long)j * N, gv);
#pragma unroll
      for (int e = 0; e < N; ++e)
        t = __fadd_rn(t, __fmul_rn(__fmul_rn(gv[e], wv[e]),
                                   __fmul_rn(xv[e], r)));
    }
    const float c = __fdiv_rn(block_sum(t, red, parity), (float)f);
    TX* dxr = dx + i * f;
    for (int j = tid; j < nvec; j += kWideThreads) {
      float xv[N], wv[N], gv[N], out[N], acc[N];
      load<TX, N>(xr + (long long)j * N, xv);
      load<TW, N>(w + (long long)j * N, wv);
      load<TX, N>(gr + (long long)j * N, gv);
      if (i == ch.r0) {
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = 0.f;
      } else {
        load<float, N>(pr + (long long)j * N, acc);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = __fmul_rn(xv[e], r);
        const float dxhat = __fmul_rn(gv[e], wv[e]);
        out[e] = __fmul_rn(r, __fsub_rn(dxhat, __fmul_rn(xhat, c)));
        acc[e] = __fadd_rn(acc[e], __fmul_rn(gv[e], xhat));
      }
      store<TX, N>(dxr + (long long)j * N, out);
      store<float, N>(pr + (long long)j * N, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Threads of a tile block for rows of f elements, E elements a thread.
inline int tile_threads(int f, int elems) {
  return 32 * ((f + 32 * elems - 1) / (32 * elems));
}

template <typename TX>
constexpr int vec_width() { return 16 / (int)sizeof(TX); }

// Bytes of the backward's shared-memory ring (0 when it is not used).
template <typename TX>
long long ring_bytes(int vec, int f) {
  return (kRing && vec && f <= kMaxTileF) ? (long long)kStages * 2 * f *
                                                sizeof(TX)
                                          : 0;
}

// Opt in to `bytes` of dynamic shared memory beside the static (above
// 48 KB in all a launch fails without it).
template <typename K>
int allow_smem(K kernel, long long bytes) {
  if (bytes == 0) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TX, typename TW, int V>
void launch_fwd_tile(const void* x, const void* w, void* y, float* rstd,
                     long long rows, int f, float eps, cudaStream_t s) {
  const int threads = tile_threads(f, kFwdElems);
  long long want = (long long)kSMs *
                   (kFwdWarpsPerSM / (threads / 32) > 0
                        ? kFwdWarpsPerSM / (threads / 32) : 1);
  if (want > rows) want = rows;
  const long long per = (rows + want - 1) / want;
  const unsigned blocks = (unsigned)((rows + per - 1) / per);
  rms_fwd_tile_kernel<TX, TW, V, kFwdElems / V><<<blocks, threads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<YOf<TX, TW>*>(y), rstd, rows, f, eps, per);
}

template <typename TX, typename TW>
int launch_fwd(int vec, const void* x, const void* w, void* y, float* rstd,
               long long rows, int f, float eps, cudaStream_t s) {
  constexpr int V = vec_width<TX>();
  if (f <= kMaxTileF) {
    if (vec)
      launch_fwd_tile<TX, TW, V>(x, w, y, rstd, rows, f, eps, s);
    else
      launch_fwd_tile<TX, TW, 1>(x, w, y, rstd, rows, f, eps, s);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((rows + kWideWarps - 1) / kWideWarps);
  if (vec)
    rms_fwd_wide_kernel<TX, TW, V><<<blocks, 32 * kWideWarps, 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<YOf<TX, TW>*>(y), rstd, rows, f, eps);
  else
    rms_fwd_wide_kernel<TX, TW, 1><<<blocks, 32 * kWideWarps, 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<YOf<TX, TW>*>(y), rstd, rows, f, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_bwd(int vec, const void* x, const void* w, const float* rstd,
               const void* dy, void* dx, void* dw, float* partial,
               long long rows, int f, int chunks, long long per,
               cudaStream_t s) {
  constexpr int V = vec_width<TX>();
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TX* dyp = static_cast<const TX*>(dy);
  TX* dxp = static_cast<TX*>(dx);
  TW* dwp = static_cast<TW*>(dw);
  int err = 0;
  if (f <= kMaxTileF) {
    const int threads = tile_threads(f, kBwdElems);
    if (vec) {
      const long long smem = ring_bytes<TX>(vec, f);
      auto kernel = rms_bwd_tile_kernel<TX, TW, V, kBwdElems / V, kRing,
                                        kRing ? kStages : kRegStages>;
      err = allow_smem(kernel, smem);
      if (err) return err;
      kernel<<<chunks, threads, smem, s>>>(xp, wp, rstd, dyp, dxp, partial,
                                           rows, f, per);
    } else {
      rms_bwd_tile_kernel<TX, TW, 1, kBwdElems, false, kRegStages>
          <<<chunks, threads, 0, s>>>(xp, wp, rstd, dyp, dxp, partial, rows,
                                      f, per);
    }
  } else if (vec) {
    rms_bwd_wide_kernel<TX, TW, V><<<chunks, kWideThreads, 0, s>>>(
        xp, wp, rstd, dyp, dxp, partial, rows, f, per);
  } else {
    rms_bwd_wide_kernel<TX, TW, 1><<<chunks, kWideThreads, 0, s>>>(
        xp, wp, rstd, dyp, dxp, partial, rows, f, per);
  }
  err = (int)cudaGetLastError();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((f + kSumCols - 1) / kSumCols);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = kPdl;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, rms_dw_sum_kernel<TW>,
                                 (const float*)partial, dwp, f, chunks);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16 (x_dtype for x, dy, dx; w_dtype for w
// and dw; y is bf16 when both are, else f32). vec = 1: f is a multiple of
// 16 / sizeof(x) elements and every pointer is aligned to the bytes one
// access moves (16 for x, 32 for an f32 w or y beside bf16 x), so each
// thread moves 16 bytes of x per access;
// vec = 0: single elements. rows >= 1, f >= 1.
// Returns cudaGetLastError() after the launches (0 = success); they are
// asynchronous on `stream`.
extern "C" int rms_norm_fwd(int x_dtype, int w_dtype, int vec, const void* x,
                            const void* w, void* y, float* rstd,
                            long long rows, int f, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_fwd<float, float>(vec, x, w, y, rstd, rows, f, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_fwd<float, __nv_bfloat16>(vec, x, w, y, rstd, rows, f, eps,
                                            s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_fwd<__nv_bfloat16, float>(vec, x, w, y, rstd, rows, f, eps,
                                            s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(vec, x, w, y, rstd, rows,
                                                    f, eps, s);
  return (int)cudaErrorInvalidValue;
}

// partial: f32 scratch of chunks * f; chunk c covers rows
// [c * rows_per_chunk, min((c + 1) * rows_per_chunk, rows)) and is one
// block. Two launches: the chunks, then the sum of their dw partials.
extern "C" int rms_norm_bwd(int x_dtype, int w_dtype, int vec, const void* x,
                            const void* w, const float* rstd, const void* dy,
                            void* dx, void* dw, float* partial, long long rows,
                            int f, int chunks, long long rows_per_chunk,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd<float, float>(vec, x, w, rstd, dy, dx, dw, partial,
                                    rows, f, chunks, rows_per_chunk, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(vec, x, w, rstd, dy, dx, dw,
                                            partial, rows, f, chunks,
                                            rows_per_chunk, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(vec, x, w, rstd, dy, dx, dw,
                                            partial, rows, f, chunks,
                                            rows_per_chunk, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        vec, x, w, rstd, dy, dx, dw, partial, rows, f, chunks,
        rows_per_chunk, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one backward block (the ring of x and dy), in
// bytes; 0 when the rows take the register ring or the wide kernel.
extern "C" long long rms_norm_bwd_smem_bytes(int x_dtype, int vec, int f) {
  return x_dtype == 0 ? ring_bytes<float>(vec, f)
                      : ring_bytes<__nv_bfloat16>(vec, f);
}
