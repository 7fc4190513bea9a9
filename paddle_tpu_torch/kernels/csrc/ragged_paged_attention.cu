// Ragged paged attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/paged_attention.py:53
// (_ragged_kernel, launched by ragged_paged_attention at :242) and its
// int8 variant _ragged_kernel_quant (:124, chosen at :238): packed mixed
// prefill-chunk + decode attention over a paged KV pool, with an online
// softmax, a per-token causal mask, GQA, and no reads past each block's
// causal horizon.
//
// Layout (the reference's):
//   q      [T, Hq, d]                 queries of every row, packed in
//                                     q_block-aligned slots
//   k, v   [Hkv, num_pages, ps, d]    the paged pool of one layer (int8
//                                     pools: ks, vs [Hkv, num_pages] f32)
//   tables [R, pps] int32             row -> pool pages
//   block_row [T / q_block] int32     q block -> row (ragged_block_row)
//   q_starts, q_lens, kv_lens [R] int32
//   out    [T, Hq, d]                 live tokens' attention; padding
//                                     tokens and dead blocks are zeros
//
// Design: split-KV (flash-decoding) over a pipelined page ring.
//
// - Grid (T / q_block, Hkv, S). Block (g, h, s) takes q block g's LIVE
//   query rows (its tokens inside q_len, times the GQA group; row r is
//   token g*q_block + r/group, q head h*group + r%group) against kv head
//   h. The block's causal horizon (the last live token's, so later pages
//   are never read) is cut into 64-position tiles; the tiles are dealt
//   into runs = min(S, tiles) near-equal runs of whole tiles, and split s
//   walks run s. Splits past the last run exit at once, so a short row
//   uses few splits and the longest row no longer sets the call's time.
//   S is fixed by the wrapper from shapes alone (at most 8; 2 at the 7B
//   step).
// - A horizon of one tile is one run: split 0 writes the output itself.
//   Otherwise each split writes f32 partials (m, l, acc) of its live rows
//   (a row that sees nothing in the run: m = -1e30, l = 0, acc = 0), and
//   a second launch, ragged_kernel_merge, combines each live (token, q
//   head) over its runs in run order. No atomics: two calls give the same
//   bits. Exactly one writer per output element: split 0 writes the zeros
//   of dead blocks and padding tokens, the single run or the merge the
//   live rows. Scratch: partials [S, T, Hq, d] and (m, l) [S, T, Hq, 2],
//   at most S x T x Hq x (d + 2) x 4 bytes (4.3 MB at the 7B step:
//   S = 2, T = 128, Hq = 32, d = 128), allocated by the wrapper.
// - The ring: each tile's K and V rows (one per position, through the
//   block table: pool page tbl[pos / ps], row pos % ps) are copied into
//   shared memory by 16-byte cp.async.cg copies (zero-filled past the
//   horizon), two stages. A trip asks for the next tile before it waits
//   on its own, so two tiles are in flight while it waits and one while
//   it multiplies; the table entries of a tile are read a trip ahead.
//   Each block also queues its Q rows before reading its row's metadata.
//   int8 pools are staged as int8 with the f32 scale of each position's
//   page beside it.
// - m is kept in the log2 domain: scores are multiplied by
//   scale * log2(e) and exponentiated with exp2; masked scores are -inf
//   (weight exactly 0) while m starts at -1e30, so exp2(m - m') is never
//   exp2(-inf + inf).
//
// Two bodies, fixed by q's dtype and d (body_for; the library reports
// the last launch's in ragged_paged_attention_last_body), never one in
// place of the other:
//
// Tensor cores: bf16 q over a bf16 or int8 pool, d % 16 == 0, d <= 256
// (ragged_kernel_mma, instantiated for d up to 64, 128 and 256). Every
// product is mma.sync.m16n8k16 (bf16 operands, f32 sums): S = Q K^T and
// O += P V. The block's rows form m16 row tiles, in passes of up to 4
// tiles: one tile (MHA: up to 16 rows, the 7B step's 8 live rows) -> the
// 4 warps split each staged tile's four 16-position chunks; two tiles ->
// 2 warps each; 3-4 tiles (GQA prefill) -> a warp per row tile. Each warp
// keeps its own (m, l, acc) and the warps of a row tile combine through
// shared memory (over the idle ring) in warp order at the end of the
// split. Q (bf16, rows padded to d + 8) is read with ldmatrix, bf16 K and
// V (rows padded to d + 8) with ldmatrix and ldmatrix.trans; int8 K and V
// (rows padded to d + 16 bytes) are widened to bf16 as they are read
// into fragments, which is exact (|x| <= 127 fits bf16's 8-bit
// significand). P is rounded to bf16 in registers as the A operand (an
// m16n8 accumulator pair is an m16k16 A fragment), flash_attention.cu's
// scheme;
// m and l stay f32 and l sums the f32 probabilities. int8 pools keep the
// reference's order of products: the page's K scale multiplies the f32
// score, the V scale multiplies each probability's weight on v before it
// is rounded to bf16, l takes the unscaled probability.
//
// CUDA cores: f32 q (over an f32 or int8 pool), or bf16 q with d % 16 != 0
// or d > 256 (ragged_kernel_simt): the same grid, ring, runs and merge;
// each warp takes whole (query row, position) scores, its lanes splitting
// d and reducing with shuffles; a warp per row updates m and l; one
// thread per accumulator element adds P.V. Every sum is f32.
//
// Bound: at the 7B step the call is memory-bound: the least time is the
// bytes it must move over 3.35 TB/s: each live row's pages up to its
// horizon x Hkv x ps*d x 2 (K and V) x element size (+ the pages' scales
// for int8), plus q and out. The prefill step's chunk also does 4 x
// visible pairs x d x Hq operations, still below the bytes at 989 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 64;       // kv positions per staged tile
constexpr int kStages = 2;    // ring depth
constexpr int kMaxSplits = 8;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;   // int8 pools: [Hkv, num_pages] scales, else null
  const float* vs;
  void* out;
  float* part;       // [S, T, Hq, d] partial accumulators (S > 1)
  float* part_ml;    // [S, T, Hq, 2] partial (m, l)
  const int* block_row;
  const int* q_starts;
  const int* q_lens;
  const int* kv_lens;
  const int* tables;
  int hq, hkv, d, num_pages, ps, pps, q_block, splits;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
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

// ---- cp.async, ldmatrix, mma.sync (as in flash_attention.cu) ----

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
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Fragments from a row-major tile of pitch p (elements). A operand: rows
// [r0, r0 + 16) x columns [c0, c0 + 16) of bf16 Q.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* t, int p,
                                       int r0, int c0, int lane) {
  ldsm_x4(a, t + (r0 + (lane & 15)) * p + c0 + (lane >> 4) * 8);
}

// B operands of S = Q K^T from a K tile [position][dim]: positions
// [n0, n0 + 16) (b[0..1] the n8 tile n0, b[2..3] n0 + 8), dims [k0, k0+16)
__device__ __forceinline__ void frag_k(uint32_t* b, const bf16* t, int p,
                                       int n0, int k0, int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * p + k0 +
                 ((lane >> 3) & 1) * 8);
}
// int8 K rows (pitch p bytes), widened to bf16 pairs: lane (g, t) holds
// K[n][k0 + 2t .. +1] and K[n][k0 + 2t + 8 .. +9] of position n = n0 + g
// (and n0 + 8 + g), the layout ldmatrix gives the bf16 tile
__device__ __forceinline__ uint32_t widen2(uint32_t two) {
  return pack_bf16((float)(int8_t)(two & 0xff),
                   (float)(int8_t)((two >> 8) & 0xff));
}
__device__ __forceinline__ void frag_k(uint32_t* b, const int8_t* t, int p,
                                       int n0, int k0, int lane) {
  const int8_t* r = t + (n0 + (lane >> 2)) * p + k0 + 2 * (lane & 3);
  const uint16_t* r0 = reinterpret_cast<const uint16_t*>(r);
  const uint16_t* r1 = reinterpret_cast<const uint16_t*>(r + 8 * p);
  b[0] = widen2(r0[0]);
  b[1] = widen2(r0[4]);
  b[2] = widen2(r1[0]);
  b[3] = widen2(r1[4]);
}

// B operands of O += P V from a V tile [position][dim]: positions
// [k0, k0 + 16), dims [n0, n0 + 16) (b[0..1] dims n0, b[2..3] n0 + 8)
__device__ __forceinline__ void frag_v(uint32_t* b, const bf16* t, int p,
                                       int k0, int n0, int lane) {
  ldsm_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * p + n0 +
                       (lane >> 4) * 8);
}
// int8 V: lane (g, t) holds V[k0 + 2t .. +1][n] and V[k0 + 2t + 8 .. +9][n]
// of dim n = n0 + g (and n0 + 8 + g), widened
__device__ __forceinline__ void frag_v(uint32_t* b, const int8_t* t, int p,
                                       int k0, int n0, int lane) {
  const int8_t* c = t + (k0 + 2 * (lane & 3)) * p + n0 + (lane >> 2);
  b[0] = pack_bf16((float)c[0], (float)c[p]);
  b[1] = pack_bf16((float)c[8 * p], (float)c[9 * p]);
  b[2] = pack_bf16((float)c[8], (float)c[p + 8]);
  b[3] = pack_bf16((float)c[8 * p + 8], (float)c[9 * p + 8]);
}

// ---- the work of one q block (shared by the split kernels and merge) ----

struct Block {
  int row, kv_start, blk_off, live_tok, horizon, tiles, runs;
};

// false for a dead block (no live token of any row)
__device__ __forceinline__ bool block_of(const Args& a, int g, Block& b) {
  b.row = a.block_row[g];
  const int q_len = a.q_lens[b.row];
  const int kv_len = a.kv_lens[b.row];
  b.kv_start = kv_len - q_len;   // position of chunk token 0
  b.blk_off = g * a.q_block - a.q_starts[b.row];
  if (b.blk_off < 0 || b.blk_off >= q_len) return false;
  b.live_tok = min(a.q_block, q_len - b.blk_off);
  // causal horizon of the block's last live token: later pages hold
  // nothing any query of this block may see
  b.horizon = min(kv_len, b.kv_start + b.blk_off + b.live_tok);
  b.tiles = max(0, (b.horizon + kTK - 1) / kTK);
  b.runs = max(1, min(a.splits, b.tiles));
  return true;
}

// zeros for block rows [r_lo, r_hi) of block (g, h)
template <typename T>
__device__ __forceinline__ void write_zeros(const Args& a, int g, int h,
                                            int r_lo, int r_hi) {
  const int group = a.hq / a.hkv;
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < (r_hi - r_lo) * a.d; i += kThreads) {
    const int r = r_lo + i / a.d, k = i % a.d;
    const size_t tok = (size_t)g * a.q_block + r / group;
    out[(tok * a.hq + h * group + r % group) * a.d + k] = from_f32<T>(0.f);
  }
}

// The block-table entry of tile position p0 + threadIdx.x (threads
// below kTK; -1 at or past the horizon). The walk reads it a trip before
// the tile is staged, so the table's latency hides behind that trip.
__device__ __forceinline__ int tile_page(const Args& a, const int* tbl,
                                         int p0, int horizon) {
  const int pos = p0 + (int)threadIdx.x;
  return threadIdx.x < kTK && pos < horizon ? tbl[pos / a.ps] : -1;
}

// Queue the copies of tile positions [p0, p0 + kTK) of kv head h: K and
// V rows into tiles of pitch `pitch` elements (zeros at or past the
// horizon), and for int8 pools each position's page scales. One thread
// per position turns its tile_page entry into the position's pool row
// in soff (-1 past the horizon); then every thread queues 16-byte
// copies. Called by the whole block (it synchronises once).
template <typename P>
__device__ __forceinline__ void stage_tile(const Args& a, int tpage, int h,
                                           int p0, P* sk, P* sv, float* sks,
                                           float* svs, long long* soff,
                                           int pitch) {
  constexpr int kVec = 16 / sizeof(P);   // elements per 16-byte copy
  const int d = a.d, chunks = d / kVec;
  if (threadIdx.x < kTK) {
    const int r = threadIdx.x, pos = p0 + r;
    const bool ok = tpage >= 0;
    const size_t page = ok ? (size_t)h * a.num_pages + tpage : 0;
    soff[r] = ok ? (long long)((page * a.ps + pos % a.ps) * d) : -1;
    if constexpr (sizeof(P) == 1) {
      cp_async4(sks + r, a.ks + page, ok);
      cp_async4(svs + r, a.vs + page, ok);
    }
  }
  __syncthreads();
  const P* kp = static_cast<const P*>(a.k);
  const P* vp = static_cast<const P*>(a.v);
  for (int e = threadIdx.x; e < kTK * chunks; e += kThreads) {
    const int r = e / chunks, c = (e % chunks) * kVec;
    const long long off = soff[r];
    const bool ok = off >= 0;
    cp_async16(sk + r * pitch + c, kp + (ok ? off + c : 0), ok);
    cp_async16(sv + r * pitch + c, vp + (ok ? off + c : 0), ok);
  }
}

// bytes of the per-position pool rows at the front of shared memory
constexpr int kOffBytes = kStages * kTK * sizeof(long long);

// ---------------------------------------------------------------------------
// tensor cores: bf16 q, bf16 or int8 pool
// ---------------------------------------------------------------------------

// rows of the Q tile a block stages (one pass of up to 4 row tiles)
__host__ __device__ __forceinline__ int mma_q_rows(int rows) {
  return rows > 48 ? 64 : (rows + 15) / 16 * 16;
}

template <typename P>
__host__ __device__ __forceinline__ int mma_pitch(int d) {
  return d + (sizeof(P) == 1 ? 16 : 8);
}

// the ring (K, V), and after a walk the warps' f32 accumulators
template <typename P>
__host__ __device__ __forceinline__ int mma_ring_bytes(int d) {
  const int ring = 2 * kStages * kTK * mma_pitch<P>(d) * (int)sizeof(P);
  const int combine = kWarps * 16 * d * (int)sizeof(float);
  return ring > combine ? ring : combine;
}

// tile pool rows, ring (K, V), Q, int8 scales, per-warp (m, l) of 16 rows
template <typename P>
size_t mma_smem_bytes(int rows, int d) {
  return kOffBytes + (size_t)mma_ring_bytes<P>(d) +
         (size_t)mma_q_rows(rows) * (d + 8) * sizeof(bf16) +
         (sizeof(P) == 1 ? 2 * (size_t)kStages * kTK * sizeof(float) : 0) +
         (size_t)kWarps * 16 * 2 * sizeof(float);
}

template <int DM, typename P>
__global__ void __launch_bounds__(kThreads) ragged_kernel_mma(Args a) {
  constexpr bool kQuant = sizeof(P) == 1;
  const int g = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int d = a.d, group = a.hq / a.hkv, rows = a.q_block * group;
  const int pitch = mma_pitch<P>(d), qp = d + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* sOff = reinterpret_cast<long long*>(smem);   // [kStages][kTK]
  unsigned char* ring = smem + kOffBytes;
  P* sK = reinterpret_cast<P*>(ring);               // [kStages][kTK][pitch]
  P* sV = sK + kStages * kTK * pitch;               // [kStages][kTK][pitch]
  bf16* sQ = reinterpret_cast<bf16*>(ring + mma_ring_bytes<P>(d));
  float* sKs = reinterpret_cast<float*>(sQ + mma_q_rows(rows) * qp);
  float* sVs = sKs + (kQuant ? kStages * kTK : 0);  // [kStages][kTK] (int8)
  float* sML = sVs + (kQuant ? kStages * kTK : 0);  // [kWarps][16][2]
  float* sC = reinterpret_cast<float*>(sK);         // [kWarps][16][d], over
                                                    // the ring after a walk
  const bf16* q = static_cast<const bf16*>(a.q);
  bf16* out = static_cast<bf16*>(a.out);

  // Queue Q rows [r0, r0 + n) of the block as bf16 (zeros past its q_block
  // x group rows; rows past the live ones are computed and dropped)
  auto stage_q = [&](int r0, int n) {
    const int qc = d / 8;
    for (int e = threadIdx.x; e < n * qc; e += kThreads) {
      const int r = e / qc, c = (e % qc) * 8, br = r0 + r;
      const bool ok = br < rows;
      const size_t tok = (size_t)g * a.q_block + br / group;
      cp_async16(sQ + r * qp + c,
                 ok ? q + (tok * a.hq + h * group + br % group) * d + c : q,
                 ok);
    }
  };
  // the first pass's Q copies fly while the block's metadata arrives
  stage_q(0, mma_q_rows(rows));
  Block b;
  const bool live = block_of(a, g, b);
  if (!live || s >= b.runs) {   // a dead block, or a split past its runs
    if (!live && s == 0) write_zeros<bf16>(a, g, h, 0, rows);
    cp_commit();
    cp_wait_all();   // the Q copies land before the block exits
    return;
  }
  const int nrows = b.live_tok * group;   // live query rows, first in order
  const int tb = s * b.tiles / b.runs, te = (s + 1) * b.tiles / b.runs;
  const bool single = b.runs == 1;
  const int* tbl = a.tables + (size_t)b.row * a.pps;
  const float sl2 = a.scale * kLog2e;
  const int T = gridDim.x * a.q_block;
  const int mt = (nrows + 15) / 16;                 // row tiles

  for (int pt0 = 0; pt0 < mt; pt0 += kWarps) {
    const int nt = min(kWarps, mt - pt0);           // row tiles this pass
    const int wp = nt == 1 ? 4 : (nt == 2 ? 2 : 1); // warps per row tile
    const int rt = warp / wp, sl = warp % wp;
    const bool active = rt < nt;
    const int r_base = pt0 * 16;
    if (pt0 > 0) {
      __syncthreads();   // the last pass is done with sQ, sC
      stage_q(r_base, nt * 16);
    }
    // the ring's first kStages - 1 tiles (the Q copies join the first)
    int tpage = tile_page(a, tbl, tb * kTK, b.horizon);
    for (int i = 0; i < kStages - 1; ++i) {
      if (tb + i < te) {
        const int o = i * kTK;
        stage_tile<P>(a, tpage, h, (tb + i) * kTK, sK + o * pitch,
                      sV + o * pitch, sKs + o, sVs + o, sOff + o, pitch);
      }
      cp_commit();
      tpage = tile_page(a, tbl, (tb + i + 1) * kTK, b.horizon);
    }
    if (s == 0 && pt0 == 0) write_zeros<bf16>(a, g, h, nrows, rows);

    // this lane's accumulator rows and the last position each may see
    const int row0 = r_base + rt * 16 + gq, row1 = row0 + 8;
    const int lim0 = b.kv_start + b.blk_off + row0 / group;
    const int lim1 = b.kv_start + b.blk_off + row1 / group;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float acc[DM / 8][4];
#pragma unroll
    for (int j = 0; j < DM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int it = tb; it < te; ++it) {
      const int st = (it - tb) % kStages, p0 = it * kTK;
      const int nx = it + kStages - 1;
      __syncthreads();   // trip it - 1 is done with the stage refilled next
      if (nx < te) {     // ask for tile nx before waiting on tile it
        const int o = ((nx - tb) % kStages) * kTK;
        stage_tile<P>(a, tpage, h, nx * kTK, sK + o * pitch, sV + o * pitch,
                      sKs + o, sVs + o, sOff + o, pitch);
      }
      cp_commit();
      tpage = tile_page(a, tbl, (nx + 1) * kTK, b.horizon);
      cp_wait<kStages - 1>();
      __syncthreads();   // tile it landed
      if (!active) continue;
      const P* tK = sK + st * kTK * pitch;
      const P* tV = sV + st * kTK * pitch;
      for (int c = sl; c < kTK / 16; c += wp) {   // 16-position chunks
        const int n0 = c * 16;
        if (p0 + n0 >= b.horizon) break;
        float sc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < DM / 16; ++kk) {
          if (kk * 16 < d) {
            uint32_t qa[4], kb[4];
            frag_a(qa, sQ, qp, rt * 16, kk * 16, lane);
            frag_k(kb, tK, pitch, n0, kk * 16, lane);
            mma_bf16(sc[0], qa, kb[0], kb[1]);
            mma_bf16(sc[1], qa, kb[2], kb[3]);
          }
        }
        // scale (and the K page scale), mask, running max
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jn = n0 + j * 8 + 2 * tq + (e & 1);
            float x = sc[j][e] * sl2;
            if constexpr (kQuant) x *= sKs[st * kTK + jn];
            if (p0 + jn > (e < 2 ? lim0 : lim1)) x = -INFINITY;
            sc[j][e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
          }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
        m0 = mx0, m1 = mx1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(sc[j][e] - (e < 2 ? mx0 : mx1));
            if (e < 2) rs0 += p; else rs1 += p;
            // int8 pools: the weight of v times its page's scale; the row
            // sum takes the probability itself
            if constexpr (kQuant)
              sc[j][e] = p * sVs[st * kTK + n0 + j * 8 + 2 * tq + (e & 1)];
            else
              sc[j][e] = p;
          }
        l0 = l0 * a0 + rs0;
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int j = 0; j < DM / 8; ++j) {
          acc[j][0] *= a0, acc[j][1] *= a0;
          acc[j][2] *= a1, acc[j][3] *= a1;
        }
        // the chunk's P as the A fragment (rounded to bf16)
        const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                                pack_bf16(sc[0][2], sc[0][3]),
                                pack_bf16(sc[1][0], sc[1][1]),
                                pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
        for (int nn = 0; nn < DM / 16; ++nn) {
          if (nn * 16 < d) {
            uint32_t vb[4];
            frag_v(vb, tV, pitch, n0, nn * 16, lane);
            mma_bf16(acc[2 * nn], pa, vb[0], vb[1]);
            mma_bf16(acc[2 * nn + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
    cp_wait_all();
    __syncthreads();   // every warp is done with the ring: sC may use it

    // combine the warps of each row tile, in warp order
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (active && tq == 0) {
      sML[(warp * 16 + gq) * 2] = m0;
      sML[(warp * 16 + gq + 8) * 2] = m1;
    }
    __syncthreads();
    if (active) {
      float M0 = kNegInf, M1 = kNegInf;
      for (int w = rt * wp; w < (rt + 1) * wp; ++w) {
        M0 = fmaxf(M0, sML[(w * 16 + gq) * 2]);
        M1 = fmaxf(M1, sML[(w * 16 + gq + 8) * 2]);
      }
      const float f0 = exp2f(m0 - M0), f1 = exp2f(m1 - M1);
      float* c0 = sC + (warp * 16 + gq) * d;
      float* c1 = c0 + 8 * d;
#pragma unroll
      for (int j = 0; j < DM / 8; ++j) {
        if (j * 8 < d) {
          const int col = j * 8 + 2 * tq;
          c0[col] = acc[j][0] * f0;
          c0[col + 1] = acc[j][1] * f0;
          c1[col] = acc[j][2] * f1;
          c1[col + 1] = acc[j][3] * f1;
        }
      }
      if (tq == 0) {
        sML[(warp * 16 + gq) * 2 + 1] = l0 * f0;
        sML[(warp * 16 + gq + 8) * 2 + 1] = l1 * f1;
      }
    }
    __syncthreads();
    const int nlive = min(nt * 16, nrows - r_base);   // live rows here
    for (int e = tid; e < nlive * d; e += kThreads) {
      const int r = e / d, k = e % d, br = r_base + r;
      const int w0 = (r / 16) * wp, rr = r % 16;
      float M = kNegInf, L = 0.f, A = 0.f;
      for (int w = w0; w < w0 + wp; ++w) M = fmaxf(M, sML[(w * 16 + rr) * 2]);
      for (int w = w0; w < w0 + wp; ++w) {
        L += sML[(w * 16 + rr) * 2 + 1];
        A += sC[(w * 16 + rr) * d + k];
      }
      const size_t tok = (size_t)g * a.q_block + br / group;
      const size_t at = tok * a.hq + h * group + br % group;
      if (single) {
        out[at * d + k] = __float2bfloat16(L > 0.f ? A / L : 0.f);
      } else {
        const size_t ps_ = (size_t)s * T * a.hq + at;
        a.part[ps_ * d + k] = A;
        if (k == 0) {
          a.part_ml[ps_ * 2] = M;
          a.part_ml[ps_ * 2 + 1] = L;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: f32 q (f32 or int8 pool); bf16 q with d % 16 != 0 or d > 256
// ---------------------------------------------------------------------------

// tile pool rows, ring (K, V in the pool's type, unpadded), int8
// scales, then f32 q, accumulator, scores and the per-row softmax state
size_t simt_smem_bytes(size_t elem, bool quant, int rows, int d) {
  return kOffBytes + 2 * (size_t)kStages * kTK * d * elem +
         (quant ? 2 * (size_t)kStages * kTK * sizeof(float) : 0) +
         sizeof(float) * (2 * (size_t)rows * d + (size_t)rows * kTK +
                          3 * (size_t)rows);
}

// T: the type of q and out; P: the pool's (T, or int8_t with scales)
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) ragged_kernel_simt(Args a) {
  constexpr bool kQuant = sizeof(P) == 1;
  const int g = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = a.d, group = a.hq / a.hkv, rows = a.q_block * group;
  Block b;
  if (!block_of(a, g, b)) {
    if (s == 0) write_zeros<T>(a, g, h, 0, rows);
    return;
  }
  const int nrows = b.live_tok * group;
  if (s == 0) write_zeros<T>(a, g, h, nrows, rows);
  if (s >= b.runs) return;
  const int tb = s * b.tiles / b.runs, te = (s + 1) * b.tiles / b.runs;

  extern __shared__ __align__(16) unsigned char smem[];
  long long* soff = reinterpret_cast<long long*>(smem);   // [kStages][kTK]
  P* sk = reinterpret_cast<P*>(smem + kOffBytes);    // [kStages][kTK][d]
  P* sv = sk + kStages * kTK * d;                    // [kStages][kTK][d]
  float* sks = reinterpret_cast<float*>(sv + kStages * kTK * d);
  float* svs = sks + (kQuant ? kStages * kTK : 0);   // [kStages][kTK]
  float* sq = svs + (kQuant ? kStages * kTK : 0);    // [rows, d]
  float* sacc = sq + rows * d;                       // [rows, d]
  float* ss = sacc + rows * d;                       // [rows, kTK]
  float* sm = ss + rows * kTK;                       // [rows] running max
  float* sl = sm + rows;                             // [rows] running sum
  float* salpha = sl + rows;                         // [rows] rescale
  const int* tbl = a.tables + (size_t)b.row * a.pps;
  const T* q = static_cast<const T*>(a.q);
  const float sl2 = a.scale * kLog2e;

  int tpage = tile_page(a, tbl, tb * kTK, b.horizon);
  for (int i = 0; i < kStages - 1; ++i) {   // the ring's first tiles
    if (tb + i < te) {
      const int o = i * kTK;
      stage_tile<P>(a, tpage, h, (tb + i) * kTK, sk + o * d, sv + o * d,
                    sks + o, svs + o, soff + o, d);
    }
    cp_commit();
    tpage = tile_page(a, tbl, (tb + i + 1) * kTK, b.horizon);
  }
  for (int i = tid; i < nrows * d; i += kThreads) {
    const int r = i / d, k = i % d;
    const size_t tok = (size_t)g * a.q_block + r / group;
    sq[i] = to_f32(q[(tok * a.hq + h * group + r % group) * d + k]);
    sacc[i] = 0.f;
  }
  for (int r = tid; r < nrows; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }

  for (int it = tb; it < te; ++it) {
    const int st = (it - tb) % kStages, p0 = it * kTK;
    const int nx = it + kStages - 1;
    __syncthreads();   // trip it - 1 is done with the stage refilled next
    if (nx < te) {     // ask for tile nx before waiting on tile it
      const int o = ((nx - tb) % kStages) * kTK;
      stage_tile<P>(a, tpage, h, nx * kTK, sk + o * d, sv + o * d, sks + o,
                    svs + o, soff + o, d);
    }
    cp_commit();
    tpage = tile_page(a, tbl, (nx + 1) * kTK, b.horizon);
    cp_wait<kStages - 1>();
    __syncthreads();   // tile it landed
    const P* tk = sk + st * kTK * d;
    const P* tv = sv + st * kTK * d;

    // scores: one warp per (row, position), lanes split d
    for (int i = warp; i < nrows * kTK; i += kWarps) {
      const int r = i / kTK, j = i % kTK, pos = p0 + j;
      if (pos > b.kv_start + b.blk_off + r / group) {   // masked or past
        if (lane == 0) ss[i] = -INFINITY;               // the horizon
        continue;
      }
      const float* qr = sq + r * d;
      const P* kr = tk + j * d;
      float x = 0.f;
      for (int k = lane; k < d; k += 32) x = fmaf(qr[k], to_f32(kr[k]), x);
      x = warp_sum(x);
      if constexpr (kQuant) x *= sks[st * kTK + j];   // q . (k x its scale)
      if (lane == 0) ss[i] = x * sl2;
    }
    __syncthreads();

    // online softmax (log2 domain): one warp per row
    for (int r = warp; r < nrows; r += kWarps) {
      float* sr = ss + r * kTK;
      float m_cur = kNegInf;
      for (int j = lane; j < kTK; j += 32) m_cur = fmaxf(m_cur, sr[j]);
      m_cur = warp_max(m_cur);
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int j = lane; j < kTK; j += 32) {
        const float e = exp2f(sr[j] - m_new);
        // int8 pools: the weight of v x its page's scale; the row's sum
        // takes the probability itself
        if constexpr (kQuant)
          sr[j] = e * svs[st * kTK + j];
        else
          sr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
        salpha[r] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < nrows * d; i += kThreads) {
      const int r = i / d, k = i % d;
      const float* pr = ss + r * kTK;
      float acc = sacc[i] * salpha[r];
      for (int j = 0; j < kTK; ++j) acc = fmaf(pr[j], to_f32(tv[j * d + k]), acc);
      sacc[i] = acc;
    }
  }
  cp_wait_all();
  __syncthreads();

  T* out = static_cast<T*>(a.out);
  const int Ttot = gridDim.x * a.q_block;
  for (int i = tid; i < nrows * d; i += kThreads) {
    const int r = i / d, k = i % d;
    const size_t tok = (size_t)g * a.q_block + r / group;
    const size_t at = tok * a.hq + h * group + r % group;
    if (b.runs == 1) {
      out[at * d + k] = from_f32<T>(sl[r] > 0.f ? sacc[i] / sl[r] : 0.f);
    } else {
      const size_t ps_ = (size_t)s * Ttot * a.hq + at;
      a.part[ps_ * d + k] = sacc[i];
      if (k == 0) {
        a.part_ml[ps_ * 2] = sm[r];
        a.part_ml[ps_ * 2 + 1] = sl[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the merge: each live (token, q head) of a multi-run block over its runs
// ---------------------------------------------------------------------------

// grid (T, ceil(Hq / 4)), a warp per (token, q head), lanes over d
template <typename T>
__global__ void __launch_bounds__(kThreads) ragged_kernel_merge(Args a) {
  const int tok = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int head = blockIdx.y * kWarps + warp;
  if (head >= a.hq) return;
  const int g = tok / a.q_block;
  Block b;
  if (!block_of(a, g, b)) return;                  // split 0 wrote zeros
  if (tok - g * a.q_block >= b.live_tok) return;   // padding: zeros too
  if (b.runs == 1) return;                         // the split wrote it
  const size_t step = (size_t)gridDim.x * a.hq;    // one split's slots
  const size_t at = (size_t)tok * a.hq + head;
  float mr[kMaxSplits], f[kMaxSplits];
  float M = kNegInf;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    mr[s] = s < b.runs ? a.part_ml[(s * step + at) * 2] : kNegInf;
    M = fmaxf(M, mr[s]);
  }
  float L = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < b.runs) {
      f[s] = exp2f(mr[s] - M);
      L += a.part_ml[(s * step + at) * 2 + 1] * f[s];
    }
  }
  T* out = static_cast<T*>(a.out);
  for (int k = lane; k < a.d; k += 32) {
    float A = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < b.runs) A += a.part[(s * step + at) * a.d + k] * f[s];
    out[at * a.d + k] = from_f32<T>(L > 0.f ? A / L : 0.f);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// 1: tensor cores (bf16 q, d % 16 == 0, d <= 256); 0: CUDA cores
int body_for(int dtype, int d) {
  return dtype == 1 && d % 16 == 0 && d <= 256;
}

size_t smem_for(int dtype, bool quant, int rows, int d) {
  if (body_for(dtype, d))
    return quant ? mma_smem_bytes<int8_t>(rows, d)
                 : mma_smem_bytes<bf16>(rows, d);
  const size_t elem = quant ? 1 : (dtype == 1 ? 2 : 4);
  return simt_smem_bytes(elem, quant, rows, d);
}

template <typename K>
int launch_kernel(K kernel, const Args& a, size_t smem, int num_blocks,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(num_blocks, a.hkv, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_mma(const Args& a, size_t smem, int num_blocks,
               cudaStream_t stream) {
  if (a.d <= 64)
    return launch_kernel(ragged_kernel_mma<64, P>, a, smem, num_blocks,
                         stream);
  if (a.d <= 128)
    return launch_kernel(ragged_kernel_mma<128, P>, a, smem, num_blocks,
                         stream);
  return launch_kernel(ragged_kernel_mma<256, P>, a, smem, num_blocks,
                       stream);
}

// the body of this process's last split launch (-1 before the first)
int last_body = -1;

// Launches the split kernel of (dtype, pool, d).
int launch(int dtype, bool quant, const Args& a, int num_blocks,
           cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (a.splits < 1 || a.splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_for(dtype, quant, a.q_block * (a.hq / a.hkv), a.d);
  last_body = body_for(dtype, a.d);
  if (last_body)
    return quant ? launch_mma<int8_t>(a, smem, num_blocks, stream)
                 : launch_mma<bf16>(a, smem, num_blocks, stream);
  if (dtype == 0)
    return quant ? launch_kernel(ragged_kernel_simt<float, int8_t>, a, smem,
                                 num_blocks, stream)
                 : launch_kernel(ragged_kernel_simt<float, float>, a, smem,
                                 num_blocks, stream);
  return quant ? launch_kernel(ragged_kernel_simt<bf16, int8_t>, a, smem,
                               num_blocks, stream)
               : launch_kernel(ragged_kernel_simt<bf16, bf16>, a, smem,
                               num_blocks, stream);
}

}  // namespace

// The body the last split launch of this process took (1 = tensor
// cores, 0 = CUDA cores), -1 before the first.
extern "C" int ragged_paged_attention_last_body() { return last_body; }

// Shared memory one split block needs, in bytes (the wrapper checks it
// against the card's limit before launching); rows = q_block x group.
extern "C" size_t ragged_paged_attention_smem_bytes(int dtype, int int8_pool,
                                                    int rows, int d) {
  return smem_for(dtype, int8_pool != 0, rows, d);
}

// The split launch over fp pools (q's dtype): grid (num_blocks, hkv,
// splits). part [splits, T, hq, d] and part_ml [splits, T, hq, 2] are f32
// scratch (unused when splits == 1). K and V are copied 16 bytes at a
// time: the wrapper guarantees head_dim % 8 == 0 and 16-byte aligned
// pools. Returns cudaGetLastError() after the launch (0 = success); the
// launch is asynchronous on `stream`.
extern "C" int ragged_paged_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* part, void* part_ml, const int* block_row, const int* q_starts,
    const int* q_lens, const int* kv_lens, const int* tables, int num_blocks,
    int hq, int hkv, int d, int num_pages, int ps, int pps, int q_block,
    int splits, float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, out, static_cast<float*>(part),
               static_cast<float*>(part_ml), block_row, q_starts, q_lens,
               kv_lens, tables, hq, hkv, d, num_pages, ps, pps, q_block,
               splits, scale};
  return launch(dtype, false, a, num_blocks, static_cast<cudaStream_t>(stream));
}

// The same over int8 pools with f32 scales ks, vs [Hkv, num_pages]; the
// wrapper guarantees head_dim % 16 == 0 and 16-byte aligned pools.
extern "C" int ragged_paged_attention_int8(
    int dtype, const void* q, const void* k, const void* v, const void* ks,
    const void* vs, void* out, void* part, void* part_ml,
    const int* block_row, const int* q_starts, const int* q_lens,
    const int* kv_lens, const int* tables, int num_blocks, int hq, int hkv,
    int d, int num_pages, int ps, int pps, int q_block, int splits,
    float scale, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), out, static_cast<float*>(part),
               static_cast<float*>(part_ml), block_row, q_starts, q_lens,
               kv_lens, tables, hq, hkv, d, num_pages, ps, pps, q_block,
               splits, scale};
  return launch(dtype, true, a, num_blocks, static_cast<cudaStream_t>(stream));
}

// The merge after a split launch with splits > 1 on the same stream:
// grid (T, ceil(hq / 4)); writes the live rows of every multi-run block.
extern "C" int ragged_paged_attention_merge(
    int dtype, void* out, const void* part, const void* part_ml,
    const int* block_row, const int* q_starts, const int* q_lens,
    const int* kv_lens, int num_blocks, int hq, int hkv, int d, int q_block,
    int splits, void* stream) {
  if (splits < 2 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, out,
               const_cast<float*>(static_cast<const float*>(part)),
               const_cast<float*>(static_cast<const float*>(part_ml)),
               block_row, q_starts, q_lens, kv_lens, nullptr, hq, hkv, d, 0,
               0, 0, q_block, splits, 0.f};
  dim3 grid(num_blocks * q_block, (hq + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    ragged_kernel_merge<float><<<grid, kThreads, 0, s>>>(a);
  else if (dtype == 1)
    ragged_kernel_merge<bf16><<<grid, kThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
