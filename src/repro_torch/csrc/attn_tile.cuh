// One attention tile engine for Hopper's tensor cores, shared by kernel B9
// (flash_attn.cu: the online softmax, bf16 and f32) and the quadratic route
// of kernel B8 (maclaurin_attn.cu: w(u) = 1 + u + u^2/2, f32). Kernel B2
// (rbf_pred.cu) streams its S through the engine's f32 k-step,
// qk_step_tf32, in a loop of its own.
//
// A block owns (b, a group of at most W value columns, one 64-row query
// tile) and loops over the 64-key tiles on or below the diagonal (all of
// them without a causal mask), the tile with the longest causal rows first
// in launch order. Its 4 warps each own 16 query rows, the m16 of
// mma.sync. Per key tile:
//
//   S = Q K^T  as MMA accumulator fragments, 16 x 64 a warp, in registers;
//   u = scale S, masked above the diagonal and past T; the weight of each
//   pair in place: the online softmax (m, l, acc rescaled by e^(m - m'))
//   or w(u), which is >= 1/2, so it needs no running max;
//   acc += W V with the same registers as the A operand: no trip through
//   shared memory. Row max and row sum are shuffles over the 4 lanes of a
//   row.
//
// K and V tiles are staged by cp.async into a two-stage ring, so the next
// tile's copy overlaps this tile's MMAs. Rows past T are zero-filled by the
// copy, and d and dv are padded with zeros up to the compiled width W (64
// or 128), a multiple of every MMA's k-step. Rows whose width is not a
// whole number of 16-byte chunks are copied element by element instead.
// No atomics: a second launch gives the same bits.
//
// What bounds it: not the tensor cores. At 4 warps a block and 2-3 blocks
// an SM, the instructions around the MMAs (the operand splits below, the
// softmax, the copies) set the time, so the code keeps them few: a
// thread's copy addresses are set once a tile and stepped, the f32 splits
// take four instructions a term, and the MMAs of a k-step are issued
// term by term over independent accumulators, so none waits on the one
// just issued. bf16 at W = 64 keeps to 168 registers, 3 blocks an SM.
//
// Precision. bf16 (B9): Q K^T is mma.m16n8k16 bf16 with f32 accumulators,
// so its products are exact in f32, as the reference's
// preferred_element_type=f32. The reference multiplies its f32 p by v, so P
// is not just rounded to bf16: it is split into three bf16 terms, p = hi +
// mid + lo to 24 bits, each multiplied by V (exact in bf16) on the tensor
// cores. f32 (B9 and B8): 3xTF32, a = hi + lo, each term rounded to TF32
// as cvt.rna.tf32.f32 rounds, and hi*hi + hi*lo + lo*hi from mma.m16n8k8
// tf32. For P V the key order of S's accumulator fragment (2t, 2t + 1) is
// taken as the k order (t, t + 4) of the A fragment, and V's rows are read
// in the same order. In both types the small terms go to their own
// accumulator and every key tile's W V is added to acc in f32 with rounding
// to nearest, so the tensor cores' truncating accumulation never runs over
// more than one tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace attn_tile {

using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::mma_tf32;
using ptx::smem_addr;
using ptx::split_tf32;

constexpr int kRows = 64;              // query rows of a block, keys of a tile
constexpr int kWarps = 4;              // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTiles = kRows / 8;   // n8 tiles of a warp's 16 x 64 scores
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// The weight of a pair: exp against a running max, or w(u) (no max).
struct Softmax {
  static constexpr bool kRunningMax = true;
};
struct Maclaurin {
  static constexpr bool kRunningMax = false;
};

template <bool kBf16>
struct Elem;
template <>
struct Elem<true> {
  using T = __nv_bfloat16;
  static constexpr int kPad = 8;  // 16 bytes: the 8 rows of an ldmatrix hit 8 bank groups
  static __device__ __forceinline__ T zero() { return __float2bfloat16(0.f); }
};
template <>
struct Elem<false> {
  using T = float;
  static constexpr int kPad = 4;  // rows 4 banks apart: a fragment's 8 rows x 4 lanes
  static __device__ __forceinline__ T zero() { return 0.f; }
};

// Shared memory: the Q tile, then two K and two V stages, 64 rows each of
// W + pad elements.
template <bool kBf16, int W>
struct Layout {
  using T = typename Elem<kBf16>::T;
  static constexpr int kStride = W + Elem<kBf16>::kPad;
  static constexpr int kTile = kRows * kStride;
  static constexpr size_t kBytes = 5 * (size_t)kTile * sizeof(T);
};

// Blocks an SM should hold: bf16 at W = 64 fits three in registers and
// shared memory (46 KB each) if a thread keeps to 170 registers.
template <bool kBf16, int W>
struct Occupancy {
  static constexpr int kBlocks = kBf16 && W == 64 ? 3 : 1;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int T, D, DV;
  float scale;
  int causal;
  int vec_qk, vec_v;  // rows are whole 16-byte chunks at 16-byte aligned addresses
};

// ------------------------------------------------------------ PTX wrappers

// (cp.async, mma.m16n8k8 tf32 and the TF32 split: ptx.cuh)

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x, y) = hi + mid + lo to 24 bits, each term a pair of bf16 values packed
// as an MMA operand register (x in the low half).
__device__ __forceinline__ void split_bf16x3(float x, float y, uint32_t& hi, uint32_t& mid,
                                             uint32_t& lo) {
  __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
  hi = bits(b);
  float2 f = __bfloat1622float2(b);
  x -= f.x;
  y -= f.y;
  b = __floats2bfloat162_rn(x, y);
  mid = bits(b);
  f = __bfloat1622float2(b);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// ------------------------------------------------------------------ copies

// Rows r0 .. r0 + 63 of a (T, width) matrix, columns c0 .. c0 + ncols - 1,
// into a tile of shared memory; rows past T are zeros. Columns past ncols
// are never written (zero since the block began). Element by element: for
// rows that are not whole 16-byte chunks (kept out of line, off the path of
// aligned widths).
template <bool kBf16, int W>
__device__ __noinline__ void load_rows_scalar(typename Elem<kBf16>::T* dst,
                                              const typename Elem<kBf16>::T* src, int r0,
                                              int T, int width, int c0, int ncols) {
  constexpr int S = Layout<kBf16, W>::kStride;
  for (int e = threadIdx.x; e < kRows * ncols; e += kThreads) {
    const int r = e / ncols, c = e - r * ncols;
    dst[r * S + c] = r0 + r < T ? src[(size_t)(r0 + r) * width + c0 + c] : Elem<kBf16>::zero();
  }
}

// The same by cp.async, 16 bytes a copy: a thread copies one column chunk
// of every kStep-th row, so its addresses are set once and then stepped.
template <bool kBf16, int W>
__device__ __forceinline__ void load_rows(typename Elem<kBf16>::T* dst,
                                          const typename Elem<kBf16>::T* src, int r0, int T,
                                          int width, int c0, int ncols, int vec) {
  using Tp = typename Elem<kBf16>::T;
  constexpr int S = Layout<kBf16, W>::kStride;
  if (!vec) {
    load_rows_scalar<kBf16, W>(dst, src, r0, T, width, c0, ncols);
    return;
  }
  constexpr int kV = 16 / sizeof(Tp);         // elements a chunk
  constexpr int kChunks = W / kV;             // chunks a row, a power of 2
  constexpr int kStep = kThreads / kChunks;   // rows a pass of the block
  const int r = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * kV;
  if (c >= ncols) return;
  const Tp* g = src + (size_t)(r0 + r) * width + c0 + c;
  Tp* const d = dst + r * S + c;
#pragma unroll
  for (int i = 0; i < kRows / kStep; ++i) {
    const bool ok = r0 + r + i * kStep < T;
    cp_async16(d + i * kStep * S, ok ? g : src, ok);
    g += (size_t)kStep * width;
  }
}

// ------------------------------------------------------------- S = Q K^T

// bf16: the warp's Q fragments (16 rows x W), loaded once a block.
template <int W>
__device__ __forceinline__ void load_q_bf16(uint32_t (&qf)[W / 16][4], const __nv_bfloat16* qs,
                                            int warp, int lane) {
  constexpr int S = Layout<true, W>::kStride;
  const __nv_bfloat16* p = qs + (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) ldsm_x4(qf[kk], p + 16 * kk);
}

template <int W>
__device__ __forceinline__ void qk_bf16(float (&s)[kKeyTiles][4],
                                        const uint32_t (&qf)[W / 16][4],
                                        const __nv_bfloat16* ks, int lane) {
  constexpr int S = Layout<true, W>::kStride;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // matrices: keys 8j.. at d 16kk.. and 16kk+8.., then keys 8j+8.. likewise
  const __nv_bfloat16* p = ks + ((lane >> 4) * 8 + (lane & 7)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
    for (int j = 0; j < kKeyTiles; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, p + 8 * j * S + 16 * kk);
      mma_bf16(s[j], qf[kk], b[0], b[1]);
      mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
    }
}

// f32, 3xTF32: one k-step of S = Q K^T for a warp's 16 rows x 64 keys.
// The A fragment (rows g and g + 8 at qr) and the B fragments (key 8j + g
// at kr), rows S floats apart, are split as read; the products are issued
// term by term over independent accumulators, so no MMA waits on the one
// just issued: hi*lo and lo*hi into small, hi*hi into big. small may be
// big itself. Kernel B2 (rbf_pred.cu) streams its S through this step too.
template <int S>
__device__ __forceinline__ void qk_step_tf32(float (&big)[kKeyTiles][4],
                                             float (&small)[kKeyTiles][4], const float* qr,
                                             const float* kr, int kk) {
  uint32_t ah[4], al[4], bh[kKeyTiles][2], bl[kKeyTiles][2];
  split_tf32(qr[8 * kk], ah[0], al[0]);               // (g, t)
  split_tf32(qr[8 * S + 8 * kk], ah[1], al[1]);       // (g + 8, t)
  split_tf32(qr[8 * kk + 4], ah[2], al[2]);           // (g, t + 4)
  split_tf32(qr[8 * S + 8 * kk + 4], ah[3], al[3]);   // (g + 8, t + 4)
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    split_tf32(kr[8 * j * S + 8 * kk], bh[j][0], bl[j][0]);      // key 8j + g, d t
    split_tf32(kr[8 * j * S + 8 * kk + 4], bh[j][1], bl[j][1]);  // d t + 4
  }
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) mma_tf32(small[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) mma_tf32(small[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) mma_tf32(big[j], ah, bh[j][0], bh[j][1]);
}

// S = Q K^T over the W / 8 k-steps of padded rows, the small terms in
// their own accumulator, added to S at the end.
template <int W>
__device__ __forceinline__ void qk_tf32(float (&s)[kKeyTiles][4], const float* qs,
                                        const float* ks, int warp, int g, int t) {
  constexpr int S = Layout<false, W>::kStride;
  float small[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = small[j][e] = 0.f;
  const float* qr = qs + (warp * 16 + g) * S + t;
  const float* kr = ks + g * S + t;
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) qk_step_tf32<S>(s, small, qr, kr, kk);
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += small[j][e];
}

// ---------------------------------------------------------- acc += W V

// acc = acc corr + (big + small), rounded to nearest in f32.
template <bool kRescale>
__device__ __forceinline__ void fold(float (&acc)[4], const float (&big)[4],
                                     const float (&small)[4], const float (&corr)[2]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float tile = big[e] + small[e];
    acc[e] = kRescale ? fmaf(acc[e], corr[e >> 1], tile) : acc[e] + tile;
  }
}

// Both products below take the value columns G n8 tiles at a time, the
// k-steps of the tile in the outer loop: 2G independent accumulators keep
// the tensor cores busy where one column tile's chain of dependent MMAs
// would wait on each result.

template <int W, int G, bool kRescale>
__device__ __forceinline__ void pv_bf16(float (&acc)[W / 8][4], const float (&p)[kKeyTiles][4],
                                        const __nv_bfloat16* vs, int lane,
                                        const float (&corr)[2]) {
  constexpr int S = Layout<true, W>::kStride;
  // A fragment of k-step kk, register r: S's n-tile 2kk + r/2, row g (+8 if r odd)
  uint32_t ph[kKeyTiles / 2][4], pm[kKeyTiles / 2][4], pl[kKeyTiles / 2][4];
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* x = p[2 * kk + (r >> 1)] + 2 * (r & 1);
      split_bf16x3(x[0], x[1], ph[kk][r], pm[kk][r], pl[kk][r]);
    }
  // matrices (transposed): keys 16kk.. and 16kk+8.. at columns 8jn.., then 8jn+8..
  const __nv_bfloat16* vp = vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * S + (lane >> 4) * 8;
#pragma unroll
  for (int jn0 = 0; jn0 < W / 8; jn0 += G) {
    float big[G][4], small[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[i][e] = small[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
      uint32_t b[G][2];  // value columns 8 (jn0 + i) ..
#pragma unroll
      for (int i = 0; i < G; i += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, vp + 16 * kk * S + 8 * (jn0 + i));
        b[i][0] = r[0], b[i][1] = r[1], b[i + 1][0] = r[2], b[i + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < G; ++i) mma_bf16(small[i], pl[kk], b[i][0], b[i][1]);
#pragma unroll
      for (int i = 0; i < G; ++i) mma_bf16(small[i], pm[kk], b[i][0], b[i][1]);
#pragma unroll
      for (int i = 0; i < G; ++i) mma_bf16(big[i], ph[kk], b[i][0], b[i][1]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) fold<kRescale>(acc[jn0 + i], big[i], small[i], corr);
  }
}

template <int W, int G, bool kRescale>
__device__ __forceinline__ void pv_tf32(float (&acc)[W / 8][4], const float (&p)[kKeyTiles][4],
                                        const float* vs, int g, int t,
                                        const float (&corr)[2]) {
  constexpr int S = Layout<false, W>::kStride;
  // k-step j is S's n-tile j: its keys 2t, 2t + 1 stand at k = t, t + 4
  uint32_t ph[kKeyTiles][4], pl[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    split_tf32(p[j][0], ph[j][0], pl[j][0]);  // (g, key 2t)
    split_tf32(p[j][2], ph[j][1], pl[j][1]);  // (g + 8, key 2t)
    split_tf32(p[j][1], ph[j][2], pl[j][2]);  // (g, key 2t + 1)
    split_tf32(p[j][3], ph[j][3], pl[j][3]);  // (g + 8, key 2t + 1)
  }
  const float* vr = vs + 2 * t * S + g;
#pragma unroll
  for (int jn0 = 0; jn0 < W / 8; jn0 += G) {
    float big[G][4], small[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[i][e] = small[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float* x = vr + 8 * j * S + 8 * (jn0 + i);
        split_tf32(x[0], bh[i][0], bl[i][0]);  // V[8j + 2t][8jn + g]
        split_tf32(x[S], bh[i][1], bl[i][1]);  // V[8j + 2t + 1][8jn + g]
      }
#pragma unroll
      for (int i = 0; i < G; ++i) mma_tf32(small[i], ph[j], bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < G; ++i) mma_tf32(small[i], pl[j], bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < G; ++i) mma_tf32(big[i], ph[j], bh[i][0], bh[i][1]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) fold<kRescale>(acc[jn0 + i], big[i], small[i], corr);
  }
}

// ------------------------------------------------------------------ kernel

template <class Weight, bool kBf16, int W>
__global__ void __launch_bounds__(kThreads, Occupancy<kBf16, W>::kBlocks)
    attn_fwd(const Args a) {
  using L = Layout<kBf16, W>;
  using Tp = typename L::T;
  constexpr int NV = W / 8;  // n8 tiles of the value columns
  constexpr bool kRescale = Weight::kRunningMax;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tp* const qs = reinterpret_cast<Tp*>(smem_raw);
  const auto ks = [&](int st) { return qs + (1 + st) * L::kTile; };
  const auto vs = [&](int st) { return qs + (3 + st) * L::kTile; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int groups = (a.DV + W - 1) / W;
  const int bh = blockIdx.x / groups;
  const int c0 = (blockIdx.x - bh * groups) * W;  // first value column of the block
  const int ncv = min(W, a.DV - c0);
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int row0 = qt * kRows;
  const int T = a.T;
  const Tp* q = static_cast<const Tp*>(a.q) + (size_t)bh * T * a.D;
  const Tp* k = static_cast<const Tp*>(a.k) + (size_t)bh * T * a.D;
  const Tp* v = static_cast<const Tp*>(a.v) + (size_t)bh * T * a.DV;

  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = threadIdx.x; i < (int)(L::kBytes / 16); i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();  // the zeros land before any copy

  const int n_kt = a.causal ? qt + 1 : (T + kRows - 1) / kRows;
  load_rows<kBf16, W>(qs, q, row0, T, a.D, 0, a.D, a.vec_qk);
  load_rows<kBf16, W>(ks(0), k, 0, T, a.D, 0, a.D, a.vec_qk);
  load_rows<kBf16, W>(vs(0), v, 0, T, a.DV, c0, ncv, a.vec_v);
  cp_async_commit();

  float acc[NV][4];
#pragma unroll
  for (int jn = 0; jn < NV; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  uint32_t qf[kBf16 ? W / 16 : 1][4];
  const int row_a = row0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kt) {  // the next tile's copy overlaps this tile's MMAs
      load_rows<kBf16, W>(ks(st ^ 1), k, (it + 1) * kRows, T, a.D, 0, a.D, a.vec_qk);
      load_rows<kBf16, W>(vs(st ^ 1), v, (it + 1) * kRows, T, a.DV, c0, ncv, a.vec_v);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kKeyTiles][4];
    if constexpr (kBf16) {
      if (it == 0) load_q_bf16<W>(qf, qs, warp, lane);
      qk_bf16<W>(s, qf, ks(st), lane);
    } else {
      qk_tf32<W>(s, qs, ks(st), warp, g, t);
    }

    // the weight of every pair, in place; masks only on the diagonal tile
    // and the ragged last one
    const int col0 = it * kRows;
    const bool edge = (a.causal && it == n_kt - 1) || col0 + kRows > T;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float u = a.scale * s[j][e];
        bool keep = true;
        if (edge) {
          const int col = col0 + 8 * j + 2 * t + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          keep = col < T && !(a.causal && col > row);
        }
        if constexpr (kRescale) {
          s[j][e] = keep ? u : kNegInf;
        } else {
          s[j][e] = keep ? 1.f + u + 0.5f * u * u : 0.f;
        }
      }
    float corr[2] = {1.f, 1.f};
    if constexpr (kRescale) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        corr[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part = 0.f;  // this lane's columns; the row's 4 lanes add up at the end
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) part += s[j][2 * h] + s[j][2 * h + 1];
      lsum[h] = kRescale ? fmaf(lsum[h], corr[h], part) : lsum[h] + part;
    }

    if constexpr (kBf16) {
      pv_bf16<W, 4, kRescale>(acc, s, vs(st), lane, corr);
    } else {
      pv_tf32<W, W == 64 ? 8 : 4, kRescale>(acc, s, vs(st), g, t, corr);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  Tp* out = static_cast<Tp*>(a.out) + (size_t)bh * T * a.DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lsum[h];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const int row = row_a + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int jn = 0; jn < NV; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jn + 2 * t + e;
        if (col >= ncv) continue;
        const float x = acc[jn][2 * h + e] / l;
        const size_t o = (size_t)row * a.DV + c0 + col;
        if constexpr (kBf16) {
          out[o] = __float2bfloat16_rn(x);
        } else {
          out[o] = x;
        }
      }
  }
}

// One launch: grid (BH x value-column groups, query tiles), 128 threads,
// the Layout's dynamic shared memory. Returns cudaGetLastError().
template <class Weight, bool kBf16, int W>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int T, int D,
                   int DV, float scale, int causal, cudaStream_t stream) {
  using L = Layout<kBf16, W>;
  constexpr int es = sizeof(typename L::T);
  if (BH <= 0 || T <= 0 || D <= 0 || D > W || DV <= 0) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const Args a{q,     k,     v,      out,
               T,     D,     DV,     scale,
               causal, aligned(q) && aligned(k) && (D * es) % 16 == 0,
               aligned(v) && (DV * es) % 16 == 0};
  const long long blocks = (long long)BH * ((DV + W - 1) / W);
  const int tiles = (T + kRows - 1) / kRows;
  if (blocks > 2147483647LL || tiles > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd<Weight, kBf16, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  attn_fwd<Weight, kBf16, W><<<dim3((unsigned)blocks, tiles), kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace attn_tile
