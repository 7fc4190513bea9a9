// Flash attention, forward and backward, for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/flash_attention.py
// (bf16 kernel / f32 kernel):
//   flash_fwd_mma_kernel / flash_fwd_kernel <- _fwd_kernel (:47),
//     launched by _fwd (:102)
//   flash_bwd_dq_mma_kernel / flash_bwd_dq_kernel <- _bwd_dq_kernel
//     (:143), launched at :251
//   flash_bwd_dkv_mma_kernel (+ flash_dkv_sum_kernel under GQA) /
//     flash_bwd_dkv_kernel <- _bwd_dkv_kernel (:182), launched at :279,
//     and the group sum after it (:313)
//
// Semantics (the reference's): q [b, hq, sq, d], k/v [b, hkv, sk, d];
// query head h reads kv head h / (hq / hkv); with `causal`, query i sees
// key j iff i + (sk - sq) >= j (sequence ends aligned). The forward
// returns out and the f32 logsumexp; the backward recomputes the scores
// from the saved logsumexp and delta = rowsum(dO * O) (computed by the
// caller, as the reference does outside its kernels). A row that sees no
// key gets out 0, lse -1e30 and no gradient (masked scores contribute
// exactly 0, never exp(0)).
//
// Every tensor is addressed through (batch, head, seq) element strides
// with a contiguous head dimension, so the model's [b, s, h, d] buffers
// are read and written in place, with no transposes. lse and delta are
// contiguous f32 [b, hq, sq].
//
// Design. The TPU walks the kv blocks as a sequential grid axis carrying
// (m, l, acc) in VMEM; here a block owns one tile of rows and loops over
// the other side's tiles, stopping at the causal horizon. Two fixed
// implementations, chosen by dtype (FLASH_DISPATCH), never one in place
// of the other:
//
// bf16: tensor cores. 4 warps per block, each warp owning 16 rows of a
// 64-row tile. Every product is mma.sync.m16n8k16 (bf16 operands, f32
// sums) with fragments loaded by ldmatrix (.trans where the product
// needs the other major order): forward Q.K^T and P.V; dq Q.K^T, dO.V^T
// and dS.K; dk/dv K.Q^T, V.dO^T, P^T.dO and dS^T.Q. An m16n8 accumulator
// pair has the layout of an m16k16 A fragment, so P and dS are rounded
// to bf16 in registers and never pass through shared memory. mma.sync,
// not wgmma: one 16-row warp tile serves all nine products with one
// fragment scheme and needs no shared-memory descriptors or swizzled
// layouts; wgmma (64-row warpgroup tiles, B from swizzled shared memory)
// and TMA are later work. The other side's tiles stream through a
// two-stage ring in shared memory filled by 16-byte cp.async.cg copies
// (zero-filled past the sequence end) while the previous tile is being
// multiplied, one __syncthreads per trip; rows are addressed through
// the seq stride, so the copies need 16-byte aligned pointers and
// strides (the wrapper checks). Rows are padded to D + 8 elements, so
// ldmatrix's eight 16-byte rows fall on distinct banks. Only the tiles
// that cross the causal diagonal or a ragged sq/sk end run the mask
// test; masked scores are -inf before exp2, so they weigh exactly 0.
// Rounding is FA2's: scale multiplies the f32 score; the running max,
// the denominator l and the logsumexp come from the f32 probabilities;
// P (and dS = P (dP - delta), formed in f32) is rounded to bf16 only as
// an operand.
//   - forward and dq: one block per (q head, batch, q tile), the q tile
//     axis slowest and reversed, so the causal tiles with the most keys
//     are dispatched first.
//   - dk, dv: one block per (query head, batch, k tile), k tile 0 (which
//     every q tile sees) first; it walks the q tiles of its head
//     (64 rows at d = 64, 32 at d = 128 to keep dK and dV in registers).
//     With GQA each block writes f32 partials [b, hq, sk, d] and a
//     second launch (flash_dkv_sum_kernel) adds each kv head's group in
//     query-head order and casts; with hq == hkv the block writes dk and
//     dv directly. No atomics: two launches give the same bits.
//
// f32: CUDA cores, kept for the f32 tolerance (1e-4) that TF32 would
// not hold; no main path feeds f32 (auto_cast O1 casts attention to
// bf16). A block of 256 threads owns one 64-row tile; tiles are staged
// in shared memory as f32 (rows padded to D+4 floats so 16-byte reads
// are free of bank conflicts); each thread owns a 4 x 4 patch of the
// 64 x 64 score tile (rows ty*4+i, columns tx+16j) and a 4-row x
// 4-column strip per 64 head-dim columns of the accumulator. Row
// reductions are 16-lane shuffles.
//   - dq: one block per (q tile, q head), looping over k tiles.
//   - dk, dv: one block per (k tile, kv head), looping over the GQA
//     group's query heads and their q tiles, writing [b, hkv, sk, d]
//     directly.
//
// Bound: at the training shapes (s = 1024-2048, d = 64, causal) the
// backward is bound by its operations against the bf16 tensor-core peak
// (dq 3, dk/dv 4 products over the visible pairs); the forward's bytes
// and its 2 products weigh about the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // rows of a tile, both sides
constexpr int kThreads = 256;   // 16 x 16
constexpr int kR = 4;           // rows (and score columns) per thread
constexpr int kPP = kB + 4;     // pitch of the 64 x 64 score tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

// reductions over the 16 threads of one tile row (one half warp)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Stage rows [r0, r0 + kB) of one head of x into an f32 tile of pitch
// D + 4, times `mul`; rows at or past `n` are zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* x, long long ss,
                                      int r0, int n, float mul) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 4) + c] =
        r0 + r < n ? x[(long long)(r0 + r) * ss + c] * mul : 0.f;
  }
}

// s[i][j] += sum_c A[ty*4+i][c] * B[tx+16j][c] over two f32 tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int ty, int tx, float s[kR][kR]) {
  constexpr int P = D + 4;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 a[kR], b[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * kR + i) * P + c);
#pragma unroll
    for (int j = 0; j < kR; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * P + c);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
  }
}

// acc[i][q][e] += sum_k W[ty*4+i][k] * X[k][q*64 + tx*4 + e]: a 64 x 64
// weight tile (pitch kPP) times an f32 tile of pitch D + 4
template <int D>
__device__ __forceinline__ void tile_acc(const float* W, const float* X,
                                         int ty, int tx,
                                         float acc[kR][D / 64][4]) {
  constexpr int P = D + 4;
#pragma unroll 2
  for (int k = 0; k < kB; k += 4) {
    float4 w[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      w[i] = *reinterpret_cast<const float4*>(W + (ty * kR + i) * kPP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < D / 64; ++q) {
        const float4 x =
            *reinterpret_cast<const float4*>(X + (k + kk) * P + q * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float wi = kk == 0 ? w[i].x : kk == 1 ? w[i].y
                         : kk == 2 ? w[i].z : w[i].w;
          acc[i][q][0] = fmaf(wi, x.x, acc[i][q][0]);
          acc[i][q][1] = fmaf(wi, x.y, acc[i][q][1]);
          acc[i][q][2] = fmaf(wi, x.z, acc[i][q][2]);
          acc[i][q][3] = fmaf(wi, x.w, acc[i][q][3]);
        }
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float acc[kR][D / 64][4]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int q = 0; q < D / 64; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
}

// write rows [r0, r0 + kB) (those below n) of a thread's accumulator,
// times `mul`, into one head of y
template <int D>
__device__ __forceinline__ void store_acc(float* y, long long ss, int r0, int n,
                                          int ty, int tx,
                                          const float acc[kR][D / 64][4],
                                          const float mul[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = r0 + ty * kR + i;
    if (r >= n) continue;
#pragma unroll
    for (int q = 0; q < D / 64; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[(long long)r * ss + q * 64 + tx * 4 + e] =
            acc[i][q][e] * mul[i];
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int offset, int causal) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos + offset);
}

// number of k tiles the q tile starting at q0 may see
__device__ __forceinline__ int k_tiles(int q0, int sq, int sk, int offset,
                                       int causal) {
  const int nk = (sk + kB - 1) / kB;
  if (!causal) return nk;
  const int last = min(q0 + kB, sq) - 1 + offset;   // last key of last row
  return last < 0 ? 0 : min(nk, last / kB + 1);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 Strides os, int hq, int hkv, int sq, int sk, float scale,
                 int causal) {
  constexpr int P = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [kB][P], scaled
  float* sK = sQ + kB * P;      // [kB][P]
  float* sV = sK + kB * P;      // [kB][P]
  float* sP = sV + kB * P;      // [kB][kPP]
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = sk - sq;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  stage<D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq, scale);

  float m[kR], l[kR], acc[kR][D / 64][4];
#pragma unroll
  for (int i = 0; i < kR; ++i) m[i] = kNegInf, l[i] = 0.f;
  zero_acc<D>(acc);

  const int nk = k_tiles(q0, sq, sk, offset, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();   // the previous trip's readers are done
    stage<D>(sK, kb, ks.s, k0, sk, 1.f);
    stage<D>(sV, vb, vs.s, k0, sk, 1.f);
    __syncthreads();
    float s[kR][kR] = {};
    tile_dot<D>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qpos = q0 + ty * kR + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kR; ++j)
        if (visible(qpos, k0 + tx + 16 * j, sq, sk, offset, causal))
          mt = fmaxf(mt, s[i][j]);
      const float mn = fmaxf(m[i], row_max(mt));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float p =
            visible(qpos, k0 + tx + 16 * j, sq, sk, offset, causal)
                ? expf(s[i][j] - mn) : 0.f;
        sP[(ty * kR + i) * kPP + tx + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - mn);
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int qq = 0; qq < D / 64; ++qq)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][qq][e] *= alpha;
    }
    __syncthreads();
    tile_acc<D>(sP, sV, ty, tx, acc);
  }

  float inv[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const float li = l[i] == 0.f ? 1.f : l[i];   // dead rows -> 0
    inv[i] = 1.f / li;
    const int qpos = q0 + ty * kR + i;
    if (tx == 0 && qpos < sq)
      lse[((long long)b * hq + h) * sq + qpos] = m[i] + logf(li);
  }
  store_acc<D>(o + b * os.b + h * os.h, os.s, q0, sq, ty, tx, acc, inv);
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dqs, int hq, int hkv, int sq, int sk, float scale,
                    int causal) {
  constexpr int P = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [kB][P], scaled
  float* sO = sQ + kB * P;      // [kB][P] dO
  float* sK = sO + kB * P;      // [kB][P]
  float* sV = sK + kB * P;      // [kB][P]
  float* sS = sV + kB * P;      // [kB][kPP] dS
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = sk - sq;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  stage<D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq, scale);
  stage<D>(sO, dout + b * dos.b + h * dos.h, dos.s, q0, sq, 1.f);
  float rl[kR], rd[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qpos = q0 + ty * kR + i;
    const long long at = ((long long)b * hq + h) * sq + qpos;
    rl[i] = qpos < sq ? lse[at] : 0.f;
    rd[i] = qpos < sq ? delta[at] : 0.f;
  }
  float acc[kR][D / 64][4];
  zero_acc<D>(acc);

  const int nk = k_tiles(q0, sq, sk, offset, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    stage<D>(sK, kb, ks.s, k0, sk, 1.f);
    stage<D>(sV, vb, vs.s, k0, sk, 1.f);
    __syncthreads();
    float s[kR][kR] = {}, dp[kR][kR] = {};
    tile_dot<D>(sQ, sK, ty, tx, s);
    tile_dot<D>(sO, sV, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qpos = q0 + ty * kR + i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float p =
            visible(qpos, k0 + tx + 16 * j, sq, sk, offset, causal)
                ? expf(s[i][j] - rl[i]) : 0.f;
        sS[(ty * kR + i) * kPP + tx + 16 * j] = p * (dp[i][j] - rd[i]);
      }
    }
    __syncthreads();
    tile_acc<D>(sS, sK, ty, tx, acc);
  }
  const float mul[kR] = {scale, scale, scale, scale};
  store_acc<D>(dq + b * dqs.b + h * dqs.h, dqs.s, q0, sq, ty, tx, acc,
                  mul);
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                     Strides dos, Strides dks, Strides dvs, int hq, int hkv,
                     int sq, int sk, float scale, int causal) {
  constexpr int P = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;             // [kB][P]
  float* sV = sK + kB * P;      // [kB][P]
  float* sQ = sV + kB * P;      // [kB][P], scaled
  float* sO = sQ + kB * P;      // [kB][P] dO
  float* sS = sO + kB * P;      // [kB][kPP]: P^T, then dS^T
  float* sL = sS + kB * kPP;    // [kB] lse of the q tile
  float* sD = sL + kB;          // [kB] delta of the q tile
  const int k0 = blockIdx.x * kB, hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = sk - sq;
  stage<D>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, sk, 1.f);
  stage<D>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, sk, 1.f);
  float gk[kR][D / 64][4], gv[kR][D / 64][4];
  zero_acc<D>(gk);
  zero_acc<D>(gv);

  // first q tile whose rows may see this k tile's first key
  const int nq = (sq + kB - 1) / kB;
  const int first = causal ? max(0, k0 - offset) / kB : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long long row0 = ((long long)b * hq + h) * sq;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();
      stage<D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq, scale);
      stage<D>(sO, dout + b * dos.b + h * dos.h, dos.s, q0, sq, 1.f);
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        sL[r] = q0 + r < sq ? lse[row0 + q0 + r] : 0.f;
        sD[r] = q0 + r < sq ? delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are keys (ty*4+i), columns queries (tx+16j)
      float s[kR][kR] = {}, dp[kR][kR] = {};
      tile_dot<D>(sK, sQ, ty, tx, s);
      tile_dot<D>(sV, sO, ty, tx, dp);
      float ds[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int kpos = k0 + ty * kR + i;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int c = tx + 16 * j;
          const float p = visible(q0 + c, kpos, sq, sk, offset, causal)
                              ? expf(s[i][j] - sL[c]) : 0.f;
          sS[(ty * kR + i) * kPP + c] = p;
          ds[i][j] = p * (dp[i][j] - sD[c]);
        }
      }
      __syncthreads();
      tile_acc<D>(sS, sO, ty, tx, gv);      // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j)
          sS[(ty * kR + i) * kPP + tx + 16 * j] = ds[i][j];
      __syncthreads();
      tile_acc<D>(sS, sQ, ty, tx, gk);      // dK += dS^T (scale Q)
    }
  }
  const float one[kR] = {1.f, 1.f, 1.f, 1.f};
  store_acc<D>(dk + b * dks.b + hk * dks.h, dks.s, k0, sk, ty, tx, gk,
                  one);
  store_acc<D>(dv + b * dvs.b + hk * dvs.h, dvs.s, k0, sk, ty, tx, gv,
                  one);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async ring)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;   // 4 warps x 16 rows of a 64-row tile
constexpr int kPad = 8;            // bf16 elements of row padding
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// q rows per trip of the dk/dv kernel: 32 at d = 128 keeps the dK and dV
// accumulators (2 x 64 f32 a thread) beside the score tiles in registers
template <int D>
__host__ __device__ constexpr int dkv_rows() { return D == 64 ? 64 : 32; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copy to shared memory; `ok` false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment loads from a row-major bf16 tile of pitch P (elements).
// A operand: rows [r0, r0 + 16) x columns [c0, c0 + 16).
template <int P>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* t, int r0,
                                       int c0, int lane) {
  ldsm_x4(a, t + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8);
}
// B operands of two n8 tiles where the tile holds B^T ([n][k]): n rows
// [n0, n0 + 16), k columns [k0, k0 + 16); b[0..1] for n0, b[2..3] n0 + 8
template <int P>
__device__ __forceinline__ void frag_b_nk(uint32_t* b, const bf16* t, int n0,
                                          int k0, int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 +
                 ((lane >> 3) & 1) * 8);
}
// B operands of two n8 tiles where the tile holds B ([k][n]): k rows
// [k0, k0 + 16), n columns [n0, n0 + 16), read transposed
template <int P>
__device__ __forceinline__ void frag_b_kn(uint32_t* b, const bf16* t, int k0,
                                          int n0, int lane) {
  ldsm_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 +
                       (lane >> 4) * 8);
}

// Queue the copy of rows [r0, r0 + R) of one head (row stride ss) into
// a tile of pitch D + kPad; rows at or past n are zeros.
template <int R, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int r0, int n) {
  constexpr int C = D / 8;   // 16-byte chunks per row
#pragma unroll
  for (int e = threadIdx.x; e < R * C; e += kMmaThreads) {
    const int r = e / C, c = (e % C) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (D + kPad) + c,
               ok ? src + (long long)(r0 + r) * ss + c : src, ok);
  }
}

// acc[j] += A (16 x K, A fragments a[K/16]) times the tile B ([k][n],
// rows [0, K), all N columns): the P.V-shaped product
template <int K, int N, int P>
__device__ __forceinline__ void mma_a_kn(float (*acc)[4], uint32_t (*a)[4],
                                         const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t b[4];
      frag_b_kn<P>(b, t, kk * 16, nn * 16, lane);
      mma_bf16(acc[2 * nn], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * nn + 1], a[kk], b[2], b[3]);
    }
}

// s[j] += rows [r0, r0 + 16) of tile A ([m][k], K columns) times the
// tile B^T ([n][k], N rows): the Q.K^T-shaped product
template <int K, int N, int P>
__device__ __forceinline__ void mma_nk(float (*s)[4], const bf16* ta, int r0,
                                       const bf16* tb, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    frag_a<P>(a, ta, r0, kk * 16, lane);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t b[4];
      frag_b_nk<P>(b, tb, nn * 16, kk * 16, lane);
      mma_bf16(s[2 * nn], a, b[0], b[1]);
      mma_bf16(s[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// accumulators of N columns (N/8 n8 tiles) as the A fragments of a
// product over those columns: n8 tiles 2kk and 2kk + 1 form k step kk
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (*a)[4], float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[j >> 1][(j & 1) * 2] = pack_bf16(c[j][0], c[j][1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}

// max and sum over the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// store one warp's 16 x D f32 accumulator rows (r0 + g, r0 + g + 8),
// times mul, as bf16 rows of y (those below n)
template <int D>
__device__ __forceinline__ void store_rows_bf16(bf16* y, long long ss, int r0,
                                                int n, int lane,
                                                float (*acc)[4],
                                                float mul0, float mul1) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 + g < n)
      *reinterpret_cast<uint32_t*>(y + (long long)(r0 + g) * ss + c) =
          pack_bf16(acc[j][0] * mul0, acc[j][1] * mul0);
    if (r0 + g + 8 < n)
      *reinterpret_cast<uint32_t*>(y + (long long)(r0 + g + 8) * ss + c) =
          pack_bf16(acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

// ---- forward ----

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, Strides os, int hq, int hkv, int sq, int sk,
                     float scale, int causal) {
  constexpr int P = D + kPad, T = kB * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + T;          // [2][T] ring
  bf16* sV = sK + 2 * T;      // [2][T] ring
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;   // heaviest first
  const int hk = h / (hq / hkv);
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * 16;
  const int g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int nk = k_tiles(q0, sq, sk, offset, causal);
  load_rows<kB, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  if (nk > 0) {
    load_rows<kB, D>(sK, kb, ks.s, 0, sk);
    load_rows<kB, D>(sV, vb, vs.s, 0, sk);
  }
  cp_commit();

  const float sl2 = scale * kLog2e;   // scores in the log2 domain
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kB;
    cp_wait_all();
    __syncthreads();   // tile kt landed; trip kt - 1 is done with st ^ 1
    if (kt + 1 < nk) {
      load_rows<kB, D>(sK + (st ^ 1) * T, kb, ks.s, k0 + kB, sk);
      load_rows<kB, D>(sV + (st ^ 1) * T, vb, vs.s, k0 + kB, sk);
      cp_commit();
    }
    float s[kB / 8][4];
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_nk<D, kB, P>(s, sQ, r0, sK + st * T, lane);

    const bool edge = k0 + kB > sk || (causal && k0 + kB - 1 > q0 + offset);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          if (!visible(e < 2 ? row0 : row1, kpos, sq, sk, offset, causal))
            x = -INFINITY;
        }
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0, m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kB / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + rs0;   // this lane's part of the row sum, f32 P
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= a0, acc[j][1] *= a0;
      acc[j][2] *= a1, acc[j][3] *= a1;
    }
    uint32_t pa[kB / 16][4];
    acc_to_a<kB>(pa, s);
    mma_a_kn<kB, D, P>(acc, pa, sV + st * T, lane);
  }
  cp_wait_all();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // a row that saw no key has l = 0 and acc = 0: out 0, lse -1e30
  if (t == 0) {
    const long long at = ((long long)b * hq + h) * sq;
    if (row0 < sq) lse[at + row0] = l0 == 0.f ? kNegInf : (m0 + log2f(l0)) * kLn2;
    if (row1 < sq) lse[at + row1] = l1 == 0.f ? kNegInf : (m1 + log2f(l1)) * kLn2;
  }
  store_rows_bf16<D>(o + b * os.b + h * os.h, os.s, q0 + r0, sq, lane, acc,
                     l0 == 0.f ? 0.f : 1.f / l0, l1 == 0.f ? 0.f : 1.f / l1);
}

// ---- backward: dq ----

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, int hq, int hkv, int sq, int sk,
                        float scale, int causal) {
  constexpr int P = D + kPad, T = kB * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + T;          // dO
  bf16* sK = sO + T;          // [2][T] ring
  bf16* sV = sK + 2 * T;      // [2][T] ring
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;   // heaviest first
  const int hk = h / (hq / hkv);
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * 16;
  const int g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int nk = k_tiles(q0, sq, sk, offset, causal);
  load_rows<kB, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  load_rows<kB, D>(sO, dout + b * dos.b + h * dos.h, dos.s, q0, sq);
  if (nk > 0) {
    load_rows<kB, D>(sK, kb, ks.s, 0, sk);
    load_rows<kB, D>(sV, vb, vs.s, 0, sk);
  }
  cp_commit();
  const long long at = ((long long)b * hq + h) * sq;
  const float sl2 = scale * kLog2e;
  const float ll0 = row0 < sq ? lse[at + row0] * kLog2e : 0.f;
  const float ll1 = row1 < sq ? lse[at + row1] * kLog2e : 0.f;
  const float d0 = row0 < sq ? delta[at + row0] : 0.f;
  const float d1 = row1 < sq ? delta[at + row1] : 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kB;
    cp_wait_all();
    __syncthreads();
    if (kt + 1 < nk) {
      load_rows<kB, D>(sK + (st ^ 1) * T, kb, ks.s, k0 + kB, sk);
      load_rows<kB, D>(sV + (st ^ 1) * T, vb, vs.s, k0 + kB, sk);
      cp_commit();
    }
    float s[kB / 8][4], dp[kB / 8][4];
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nk<D, kB, P>(s, sQ, r0, sK + st * T, lane);
    mma_nk<D, kB, P>(dp, sO, r0, sV + st * T, lane);

    const bool edge = k0 + kB > sk || (causal && k0 + kB - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge && !visible(e < 2 ? row0 : row1, k0 + j * 8 + 2 * t + (e & 1),
                             sq, sk, offset, causal))
          x = -INFINITY;
        const float p = exp2f(x - (e < 2 ? ll0 : ll1));
        dp[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1));   // dS, f32
      }
    uint32_t da[kB / 16][4];
    acc_to_a<kB>(da, dp);
    mma_a_kn<kB, D, P>(acc, da, sK + st * T, lane);   // dQ += dS K
  }
  cp_wait_all();
  store_rows_bf16<D>(dq + b * dqs.b + h * dqs.h, dqs.s, q0 + r0, sq, lane,
                     acc, scale, scale);
}

// ---- backward: dk, dv ----

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ part, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dks, Strides dvs,
                         int hq, int hkv, int sq, int sk, float scale,
                         int causal) {
  constexpr int P = D + kPad, T = kB * P;
  constexpr int BQ = dkv_rows<D>(), TQ = BQ * P;
  constexpr int STAGE = 2 * TQ * (int)sizeof(bf16) + 2 * BQ * (int)sizeof(float);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + T;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + T);
  // stage i: Q [BQ][P], dO [BQ][P], lse [BQ], delta [BQ]
  auto stage_q = [&](int i) { return reinterpret_cast<bf16*>(ring + i * STAGE); };
  auto stage_o = [&](int i) { return stage_q(i) + TQ; };
  auto stage_l = [&](int i) {
    return reinterpret_cast<float*>(ring + i * STAGE + 2 * TQ * sizeof(bf16));
  };
  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kB;
  const int hk = h / (hq / hkv);
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * 16;
  const int t = lane & 3;
  const int offset = sk - sq;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* ob = dout + b * dos.b + h * dos.h;
  const long long at = ((long long)b * hq + h) * sq;
  const int nq = (sq + BQ - 1) / BQ;
  const int first = causal ? max(0, k0 - offset) / BQ : 0;

  auto load_q_tile = [&](int qt, int i) {
    const int q0 = qt * BQ;
    load_rows<BQ, D>(stage_q(i), qb, qs.s, q0, sq);
    load_rows<BQ, D>(stage_o(i), ob, dos.s, q0, sq);
    float* sl = stage_l(i);
    const int r = threadIdx.x % 64;
    if (r < BQ) {
      const float* src = threadIdx.x < 64 ? lse : delta;
      const bool ok = q0 + r < sq;
      cp_async4(sl + (threadIdx.x < 64 ? 0 : BQ) + r,
                ok ? src + at + q0 + r : src, ok);
    }
  };
  load_rows<kB, D>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, sk);
  load_rows<kB, D>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, sk);
  if (first < nq) load_q_tile(first, 0);
  cp_commit();

  const float sl2 = scale * kLog2e;
  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;
  // this lane's keys: rows r0 + g and r0 + g + 8 of the k tile
  const int key0 = k0 + r0 + (lane >> 2), key1 = key0 + 8;

  for (int qt = first; qt < nq; ++qt) {
    const int st = (qt - first) & 1, q0 = qt * BQ;
    cp_wait_all();
    __syncthreads();
    if (qt + 1 < nq) {
      load_q_tile(qt + 1, st ^ 1);
      cp_commit();
    }
    const bf16* tQ = stage_q(st);
    const bf16* tO = stage_o(st);
    const float* tL = stage_l(st);
    const float* tD = tL + BQ;
    // transposed tiles: rows are this warp's 16 keys, columns the q rows
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nk<D, BQ, P>(s, sK, r0, tQ, lane);   // S^T = K Q^T
    mma_nk<D, BQ, P>(dp, sV, r0, tO, lane);  // dP^T = V dO^T

    const bool edge = q0 + BQ > sq || (causal && k0 + kB - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * sl2;
        if (edge && !visible(q0 + c, e < 2 ? key0 : key1, sq, sk, offset,
                             causal))
          x = -INFINITY;
        const float p = exp2f(x - tL[c] * kLog2e);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - tD[c]);   // dS^T, f32
      }
    uint32_t pa[BQ / 16][4];
    acc_to_a<BQ>(pa, s);
    mma_a_kn<BQ, D, P>(gv, pa, tO, lane);    // dV += P^T dO
    acc_to_a<BQ>(pa, dp);
    mma_a_kn<BQ, D, P>(gk, pa, tQ, lane);    // dK += dS^T Q
  }
  cp_wait_all();

  if (hq == hkv) {
    store_rows_bf16<D>(dk + b * dks.b + hk * dks.h, dks.s, k0 + r0, sk, lane,
                       gk, scale, scale);
    store_rows_bf16<D>(dv + b * dvs.b + hk * dvs.h, dvs.s, k0 + r0, sk, lane,
                       gv, 1.f, 1.f);
    return;
  }
  // GQA: f32 partials of this query head, [2][b][hq][sk][D] (dk, dv;
  // gridDim.y is the batch)
  const long long plane = (long long)gridDim.y * hq * sk * D;
  float* pk = part + ((long long)b * hq + h) * sk * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (key0 < sk) {
      *reinterpret_cast<float2*>(pk + (long long)key0 * D + c) =
          make_float2(gk[j][0] * scale, gk[j][1] * scale);
      *reinterpret_cast<float2*>(pk + plane + (long long)key0 * D + c) =
          make_float2(gv[j][0], gv[j][1]);
    }
    if (key1 < sk) {
      *reinterpret_cast<float2*>(pk + (long long)key1 * D + c) =
          make_float2(gk[j][2] * scale, gk[j][3] * scale);
      *reinterpret_cast<float2*>(pk + plane + (long long)key1 * D + c) =
          make_float2(gv[j][2], gv[j][3]);
    }
  }
}

// dk, dv [b, hkv, sk, D] = the sum over each kv head's group of query
// heads, in head order, of the f32 partials [2][b][hq][sk][D], cast to
// bf16. One thread per 8 columns of one (plane, b, kv head, key) row.
template <int D>
__global__ void __launch_bounds__(256)
flash_dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides dks, Strides dvs, int b,
                     int hq, int hkv, int sk) {
  constexpr int C = D / 8;
  const long long n = (long long)b * hkv * sk * C;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int plane = blockIdx.y, group = hq / hkv;
  const int c = (int)(e % C) * 8;
  const int s = (int)(e / C % sk);
  const int hk = (int)(e / C / sk % hkv);
  const int bb = (int)(e / C / sk / hkv);
  const float* src = part + (long long)plane * b * hq * sk * D +
                     (((long long)bb * hq + hk * group) * sk + s) * D + c;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int hh = 0; hh < group; ++hh) {
    const float4 x0 = *reinterpret_cast<const float4*>(src);
    const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
    acc[0] += x0.x, acc[1] += x0.y, acc[2] += x0.z, acc[3] += x0.w;
    acc[4] += x1.x, acc[5] += x1.y, acc[6] += x1.z, acc[7] += x1.w;
    src += (long long)sk * D;
  }
  const Strides os = plane == 0 ? dks : dvs;
  bf16* y = (plane == 0 ? dk : dv) + bb * os.b + hk * os.h + s * os.s + c;
  uint4 out;
  out.x = pack_bf16(acc[0], acc[1]);
  out.y = pack_bf16(acc[2], acc[3]);
  out.z = pack_bf16(acc[4], acc[5]);
  out.w = pack_bf16(acc[6], acc[7]);
  *reinterpret_cast<uint4*>(y) = out;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr size_t tile_bytes(int d) { return sizeof(float) * kB * (d + 4); }
constexpr size_t score_bytes() { return sizeof(float) * kB * kPP; }
// f32 launches: dynamic shared memory per instantiation
constexpr size_t fwd_smem(int d) { return 3 * tile_bytes(d) + score_bytes(); }
constexpr size_t dq_smem(int d) { return 4 * tile_bytes(d) + score_bytes(); }
constexpr size_t dkv_smem(int d) {
  return 4 * tile_bytes(d) + score_bytes() + 2 * kB * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const long long* st, int b, int hq, int hkv, int sq, int sk,
        float scale, int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kB - 1) / kB, hq, b);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), hq, hkv, sq,
      sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq,
           const long long* st, int b, int hq, int hkv, int sq, int sk,
           float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kB - 1) / kB, hq, b);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), hq, hkv, sq,
      sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv,
            float* /* part: the f32 kernel sums the group itself */,
            const long long* st, int b, int hq, int hkv, int sq, int sk,
            float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + kB - 1) / kB, hkv, b);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), hq, hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

// bf16 launches: dynamic shared memory per instantiation
template <int D>
constexpr size_t bf16_tile_bytes(int rows) {
  return sizeof(bf16) * rows * (D + kPad);
}
template <int D>
constexpr size_t fwd_mma_smem() { return 5 * bf16_tile_bytes<D>(kB); }
template <int D>
constexpr size_t dq_mma_smem() { return 6 * bf16_tile_bytes<D>(kB); }
template <int D>
constexpr size_t dkv_mma_smem() {
  return 2 * bf16_tile_bytes<D>(kB) +
         2 * (2 * bf16_tile_bytes<D>(dkv_rows<D>()) +
              2 * dkv_rows<D>() * sizeof(float));
}

template <int D>
int fwd_mma(const void* q, const void* k, const void* v, void* o, float* lse,
            const long long* st, int b, int hq, int hkv, int sq, int sk,
            float scale, int causal, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, b, (sq + kB - 1) / kB);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), hq, hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq,
               const long long* st, int b, int hq, int hkv, int sq, int sk,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_mma_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, b, (sq + kB - 1) / kB);
  flash_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), hq, hkv, sq,
      sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv_mma(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, float* part, const long long* st, int b,
                int hq, int hkv, int sq, int sk, float scale, int causal,
                cudaStream_t stream) {
  if (hq != hkv && part == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = dkv_mma_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_mma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, b, (sk + kB - 1) / kB);
  flash_bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), part,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), hq, hkv, sq,
      sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv_sum(const float* part, void* dk, void* dv, const long long* st,
                int b, int hq, int hkv, int sk, cudaStream_t stream) {
  const long long n = (long long)b * hkv * sk * (D / 8);
  dim3 grid((unsigned)((n + 255) / 256), 2);
  flash_dkv_sum_kernel<D><<<grid, 256, 0, stream>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      strides_at(st, 0), strides_at(st, 1), b, hq, hkv, sk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); d: 64
// or 128. A fixed choice by dtype: a bf16 call never reaches the
// CUDA-core kernels. `strides` holds (batch, head, seq) element strides
// per tensor, in argument order (q, k, v, o for the forward; q, k, v, dO,
// dq; q, k, v, dO, dk, dv; dk, dv for the group sum). Each returns
// cudaGetLastError() after its launch (0 = success); launches are
// asynchronous on `stream`.
#define FLASH_DISPATCH(f32_fn, bf16_fn, ...)                      \
  if (dtype == 0 && d == 64) return f32_fn<64>(__VA_ARGS__);          \
  if (dtype == 0 && d == 128) return f32_fn<128>(__VA_ARGS__);        \
  if (dtype == 1 && d == 64) return bf16_fn<64>(__VA_ARGS__);         \
  if (dtype == 1 && d == 128) return bf16_fn<128>(__VA_ARGS__);       \
  return (int)cudaErrorInvalidValue;

extern "C" int flash_attention_fwd(int dtype, int d, const void* q,
                                   const void* k, const void* v, void* o,
                                   float* lse, const long long* strides,
                                   int b, int hq, int hkv, int sq, int sk,
                                   float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, fwd_mma, q, k, v, o, lse, strides, b, hq, hkv, sq, sk,
                 scale, causal, s)
}

extern "C" int flash_attention_bwd_dq(int dtype, int d, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const float* lse,
                                      const float* delta, void* dq,
                                      const long long* strides, int b, int hq,
                                      int hkv, int sq, int sk, float scale,
                                      int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dq, bwd_dq_mma, q, k, v, dout, lse, delta, dq, strides,
                 b, hq, hkv, sq, sk, scale, causal, s)
}

// `part`: for bf16 with hq != hkv, f32 scratch [2, b, hq, sk, d] that
// receives each query head's dk and dv; flash_attention_bwd_dkv_sum then
// writes dk and dv. Unused (may be null) otherwise.
extern "C" int flash_attention_bwd_dkv(int dtype, int d, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, void* dk,
                                       void* dv, float* part,
                                       const long long* strides, int b,
                                       int hq, int hkv, int sq, int sk,
                                       float scale, int causal,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dkv, bwd_dkv_mma, q, k, v, dout, lse, delta, dk, dv,
                 part, strides, b, hq, hkv, sq, sk, scale, causal, s)
}

// bf16 only: dk, dv = the in-order sums of the partials over each kv
// head's group of query heads
extern "C" int flash_attention_bwd_dkv_sum(int d, const float* part,
                                           void* dk, void* dv,
                                           const long long* strides, int b,
                                           int hq, int hkv, int sk,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return bwd_dkv_sum<64>(part, dk, dv, strides, b, hq, hkv, sk, s);
  if (d == 128)
    return bwd_dkv_sum<128>(part, dk, dv, strides, b, hq, hkv, sk, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one launch: kernel 0 forward, 1 dq, 2 dk/dv
extern "C" long long flash_attention_smem_bytes(int kernel, int dtype, int d) {
  const size_t f32[3][2] = {{fwd_smem(64), fwd_smem(128)},
                            {dq_smem(64), dq_smem(128)},
                            {dkv_smem(64), dkv_smem(128)}};
  const size_t mma[3][2] = {{fwd_mma_smem<64>(), fwd_mma_smem<128>()},
                            {dq_mma_smem<64>(), dq_mma_smem<128>()},
                            {dkv_mma_smem<64>(), dkv_mma_smem<128>()}};
  if (kernel < 0 || kernel > 2 || (d != 64 && d != 128)) return -1;
  return (long long)(dtype == 0 ? f32 : mma)[kernel][d == 128];
}
