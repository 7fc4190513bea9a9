// Fused AdamW / Adam update of one flat bucket, for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/fused_adamw.py:28
// (_kernel, launched by _run at :60): one pass over a dtype bucket's flat
// param, grad and f32 moment buffers, updating param and both moments in
// place. Params (and grads) are f32 or bf16; the moments are f32.
//
// The step-varying scalars (lr, c1 = 1 - beta1^t, c2 = 1 - beta2^t) are
// read from a 3-float device buffer, as the TPU kernel read them from
// SMEM: a changing lr or step never changes the launch's arguments, so a
// captured CUDA graph replays it. betas, eps and weight decay are
// arguments.
//
// The math is the reference's (fused_adamw._reference), term by term, with
// every product, sum, quotient and square root rounded on its own
// (__fmul_rn and friends: no contraction into FMAs), so the kernel
// computes exactly what the plain PyTorch version computes op by op:
//   g' = g (+ wd * p if coupled)
//   m  = beta1 m + (1 - beta1) g'
//   v  = beta2 v + (1 - beta2) (g' g')
//   u  = (m / c1) / (sqrt(v / c2) + eps) (+ wd * p if decoupled)
//   p  = p - lr u
//
// Bound: memory. Each element reads p, g, m, v and writes p, m, v: 28
// bytes in f32, 24 with bf16 params, over 3.35 TB/s; nothing is reused.
//
// Design:
// - 16-byte accesses. A vector is 4 elements of f32 params (a float4 of p,
//   g, m and v each) or 8 of bf16 params (a uint4 of p and of g, two
//   float4s of m and of v). The optimizer aligns every parameter's offset
//   in the bucket to 16 bytes (zero padding, which an update leaves zero),
//   so a span's vectors are aligned; its last len % VEC elements are a
//   scalar tail.
// - Memory-level parallelism: a thread issues the loads of kUnroll vectors
//   (4 f32 / 2 bf16: 256 / 192 bytes) before any arithmetic.
// - The grid is exactly the blocks that are resident at once (SMs x
//   blocks per SM from the occupancy query): no second wave. The grid
//   walks the V vectors in a grid-stride, thread t of the N taking vectors
//   t, t + N, ... (kUnroll per round), so the threads move the same bytes
//   within one vector and the whole grid sweeps memory together.
// - L2-only accesses (ld.global.cg / st.global.cg): nothing is read
//   twice, so L1 is skipped (the streaming hints .cs were 2% slower at
//   both buckets, tools/adamw_variants.py).
// - A masked step (some parameters got no gradient) passes a table of the
//   present spans: starts[S], lens[S] and the vectors before each span,
//   vpre[S + 1] (int64, built on the host once per presence pattern). The
//   kernel reads and writes only those spans; the absent ones keep their
//   value and moments bit for bit. With every parameter present the bucket
//   is one span and the launch reads no table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, wd;
  int decoupled;
};

// The update of one element (f32 in, f32 out), the reference's rounding
__device__ __forceinline__ void adam(const Hyper& h, float lr, float c1,
                                     float c2, float& p, float g, float& m,
                                     float& v) {
  if (h.wd != 0.f && !h.decoupled) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.beta1, m), __fmul_rn(h.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(h.beta2, v),
                __fmul_rn(h.one_minus_beta2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fdiv_rn(m, c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
  if (h.wd != 0.f && h.decoupled) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One vector of VEC elements at element i: its loads (issued together by
// the caller), its update and its stores.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int VEC = 4;
  float4 p, g, m, v;
  __device__ __forceinline__ void load(const float* pp, const float* gp,
                                       const float* mp, const float* vp,
                                       long long i) {
    p = __ldcg(reinterpret_cast<const float4*>(pp + i));
    g = __ldcg(reinterpret_cast<const float4*>(gp + i));
    m = __ldcg(reinterpret_cast<const float4*>(mp + i));
    v = __ldcg(reinterpret_cast<const float4*>(vp + i));
  }
  __device__ __forceinline__ void update(const Hyper& h, float lr, float c1,
                                         float c2) {
    adam(h, lr, c1, c2, p.x, g.x, m.x, v.x);
    adam(h, lr, c1, c2, p.y, g.y, m.y, v.y);
    adam(h, lr, c1, c2, p.z, g.z, m.z, v.z);
    adam(h, lr, c1, c2, p.w, g.w, m.w, v.w);
  }
  __device__ __forceinline__ void store(float* pp, float* mp, float* vp,
                                        long long i) const {
    __stcg(reinterpret_cast<float4*>(pp + i), p);
    __stcg(reinterpret_cast<float4*>(mp + i), m);
    __stcg(reinterpret_cast<float4*>(vp + i), v);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int VEC = 8;
  uint4 p, g;
  float4 m[2], v[2];
  __device__ __forceinline__ void load(const __nv_bfloat16* pp,
                                       const __nv_bfloat16* gp,
                                       const float* mp, const float* vp,
                                       long long i) {
    p = __ldcg(reinterpret_cast<const uint4*>(pp + i));
    g = __ldcg(reinterpret_cast<const uint4*>(gp + i));
    m[0] = __ldcg(reinterpret_cast<const float4*>(mp + i));
    m[1] = __ldcg(reinterpret_cast<const float4*>(mp + i + 4));
    v[0] = __ldcg(reinterpret_cast<const float4*>(vp + i));
    v[1] = __ldcg(reinterpret_cast<const float4*>(vp + i + 4));
  }
  __device__ __forceinline__ void update(const Hyper& h, float lr, float c1,
                                         float c2) {
    uint32_t* pw = reinterpret_cast<uint32_t*>(&p);
    const uint32_t* gw = reinterpret_cast<const uint32_t*>(&g);
    float* mf = reinterpret_cast<float*>(m);
    float* vf = reinterpret_cast<float*>(v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float lo = bf_lo(pw[k]), hi = bf_hi(pw[k]);
      adam(h, lr, c1, c2, lo, bf_lo(gw[k]), mf[2 * k], vf[2 * k]);
      adam(h, lr, c1, c2, hi, bf_hi(gw[k]), mf[2 * k + 1], vf[2 * k + 1]);
      pw[k] = bf_pack(lo, hi);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* pp, float* mp,
                                        float* vp, long long i) const {
    __stcg(reinterpret_cast<uint4*>(pp + i), p);
    __stcg(reinterpret_cast<float4*>(mp + i), m[0]);
    __stcg(reinterpret_cast<float4*>(mp + i + 4), m[1]);
    __stcg(reinterpret_cast<float4*>(vp + i), v[0]);
    __stcg(reinterpret_cast<float4*>(vp + i + 4), v[1]);
  }
};

template <typename T> constexpr int kUnroll = sizeof(T) == 4 ? 4 : 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The spans: with no table, one span [0, n); else starts/lens/vpre (see
// the header).
struct Spans {
  const long long* starts;   // null: the whole bucket
  const long long* lens;
  const long long* vpre;
  int count;
  long long n;
  __device__ __forceinline__ int size() const {
    return starts == nullptr ? 1 : count;
  }
  __device__ __forceinline__ long long start(int s) const {
    return starts == nullptr ? 0 : starts[s];
  }
  __device__ __forceinline__ long long len(int s) const {
    return starts == nullptr ? n : lens[s];
  }
  template <int VEC>
  __device__ __forceinline__ long long vectors() const {
    return starts == nullptr ? n / VEC : vpre[count];
  }
  // the element of global vector j, walking span cursor s forward
  template <int VEC>
  __device__ __forceinline__ long long element(long long j, int& s) const {
    if (starts == nullptr) return j * VEC;
    while (vpre[s + 1] <= j) ++s;
    return starts[s] + (j - vpre[s]) * VEC;
  }
  // the first span holding global vector j (binary search)
  __device__ __forceinline__ int span_of(long long j) const {
    if (starts == nullptr) return 0;
    int lo = 0, hi = count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (vpre[mid] <= j) lo = mid; else hi = mid - 1;
    }
    return lo;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(T* __restrict__ p, const T* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   const float* __restrict__ scalars, Spans sp, Hyper h) {
  using V = Vec<T>;
  constexpr int VEC = V::VEC, U = kUnroll<T>;
  const float lr = scalars[0], c1 = scalars[1], c2 = scalars[2];
  const long long nv = sp.template vectors<VEC>();
  const long long N = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  // a thread's U vectors of a round are N apart
  int s = sp.span_of(t0);
  for (long long base = 0; base < nv; base += N * U) {
    V x[U];
    long long at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = base + u * N + t0;
      at[u] = j < nv ? sp.template element<VEC>(j, s) : -1;
      if (at[u] >= 0) x[u].load(p, g, m, v, at[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at[u] >= 0) {
        x[u].update(h, lr, c1, c2);
        x[u].store(p, m, v, at[u]);
      }
  }
  // the spans' scalar tails: span t's to block t % G
  for (int t = blockIdx.x; t < sp.size(); t += gridDim.x) {
    const long long len = sp.len(t), tail = len % VEC;
    if (threadIdx.x < tail) {
      const long long i = sp.start(t) + len - tail + threadIdx.x;
      float pf = to_f32(p[i]), mf = m[i], vf = v[i];
      adam(h, lr, c1, c2, pf, to_f32(g[i]), mf, vf);
      from_f32(p + i, pf);
      m[i] = mf;
      v[i] = vf;
    }
  }
}

// resident blocks of one instantiation on the current device (cached)
template <typename T>
int grid_size(int* grid) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_adamw_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    cached = sms * per_sm;
  }
  *grid = cached;
  return 0;
}

template <typename T>
int launch(void* p, const void* g, float* m, float* v, const float* scalars,
           long long n, const long long* table, int nspans, double beta1,
           double beta2, float eps, float wd, int decoupled,
           cudaStream_t stream) {
  if (n <= 0 || (table != nullptr && nspans <= 0)) return 0;
  int grid = 0;
  const int err = grid_size<T>(&grid);
  if (err) return err;
  Spans sp;
  sp.starts = table;
  sp.lens = table == nullptr ? nullptr : table + nspans;
  sp.vpre = table == nullptr ? nullptr : table + 2 * nspans;
  sp.count = nspans;
  sp.n = n;
  const Hyper h{(float)beta1, (float)(1.0 - beta1), (float)beta2,
                (float)(1.0 - beta2), eps, wd, decoupled};
  fused_adamw_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), m, v, scalars, sp, h);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of p and g: 0 = float32, 1 = bfloat16. scalars: device f32
// [lr, 1 - beta1^t, 1 - beta2^t]. beta1 and beta2 arrive in double, so
// 1 - beta is formed before rounding to f32, as the reference forms it in
// Python. p, g, m and v are 16-byte aligned. table: null (the whole
// bucket, n elements) or the device int64 span table of `nspans` spans
// (starts, lens, vpre; see the header), each start 16-byte aligned in p.
// Returns cudaGetLastError() after the launch (0 = success); the launch
// is asynchronous on `stream`.
extern "C" int fused_adamw(int dtype, void* p, const void* g, float* m,
                           float* v, const float* scalars, long long n,
                           const long long* table, int nspans, double beta1,
                           double beta2, float eps, float wd, int decoupled,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(p, g, m, v, scalars, n, table, nspans, beta1, beta2,
                         eps, wd, decoupled, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, g, m, v, scalars, n, table, nspans,
                                 beta1, beta2, eps, wd, decoupled, s);
  return (int)cudaErrorInvalidValue;
}
