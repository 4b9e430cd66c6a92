// Fused K-head Maclaurin quadratic form (Eq 3.8) with the Eq 3.11 mask.
//
// Replaces repro/kernels/quadform/kernel.py::quadform_heads_pallas (body
// _heads_kernel). For K collapsed heads sharing one batch Z (n, d):
//
//   s[n,k]  = exp(-gamma_k |z|^2) (c_k + v_k.z + z^T M_k z) + b_k
//   zsq[n]  = |z|^2
//   ok[n,k] = msq_k |z|^2 < 0.0625 / max(gamma_k^2, 1e-30)
//
// What bounds it on an H100: 2 n K d^2 flops of f32-accurate products
// against K d^2 floats of Hessian. At n=1024, K=10, d=780 that is 12.5
// GFLOP (0.076 ms at the 3xTF32 rate, 495 / 3 TFLOP/s) against 24 MB (7 us
// at 3.35 TB/s): bound by operations. At n <= 32 the same 24 MB meets 0.4
// GFLOP: bound by bytes, and the work must spread over enough SMs to pull
// the Hessian in.
//
// Design (B1, f32). The TPU kernel kept a (d, block_k*d) Hessian slice
// resident in VMEM; at d=780 one head is 2.4 MB, ten times a block's shared
// memory, so nothing stays resident here. A block of 8 warps owns (a tile
// of BN rows of Z, one head k, one run of 64-column tiles of M_k). A warp
// owns 32 rows of the (BN, 64) tile of Z M_k, as two rows of eight
// mma.m16n8k8 fragments in registers, so that one A fragment split serves
// eight MMAs and one B fragment split two; at BN=128 two warps share the
// rows, each over half of a stage's 8 k-steps, and at BN=64 and 32 four and
// eight, so that a small batch still keeps the SM's four tensor cores busy.
// The contraction streams in 64-deep stages: the stage's Z tile (BN x 64)
// and M_k tile (64 x 64) come by cp.async into a ring of three to six (as
// deep as shared memory allows), so the next copies are in flight while
// the MMAs run. Each product is 3xTF32 (ptx.cuh: lo*hi + hi*lo + hi*hi);
// the tensor cores' truncating accumulation runs over one stage, then the
// stage is added to the running tile in f32 with rounding to nearest. A
// column tile's own 64 columns are its last stage, so when the tile is
// complete the stage in hand holds z at every position of the accumulator
// fragments: the tile is folded at once into the row sums g[n] += sum_j
// ((Z M_k)[n,j] + v_k[j]) z[n,j], with |z|^2 riding along in fp32 FMAs
// (head-0 blocks), and the (n, K*d) product never reaches device memory.
// The fold is linear, so warps that share rows fold their share of the
// k-steps on their own. The 4 lanes of a row add with a fixed shuffle
// tree, the warps of a row in warp order through shared memory, and each
// block writes one partial per split; a second pass sums the splits in
// split order and applies the exp envelope, bias and mask in fp32. No
// atomics: the result is the same bit for bit from run to run. Row tiles
// are the fastest grid axis, so the blocks that stream one head's Hessian
// run side by side and share it in L2; the column tiles are split over
// blocks so that small batches (10 heads x 1 row tile) do not run on 10 of
// 132 SMs. Ragged edges (d=780, any n) are zero-filled by the copies, which
// changes no sum. Nothing assumes M_k symmetric.
//
// Kernel B3 replaces quadform_heads_q8_pallas (body _heads_kernel_q8): M_k
// is stored int8 with one f32 scale per (head, column), and
//
//   s[n,k] = exp(-gamma_k |z|^2) (c_k + v_k.z + sum_j (Z M_k)[n,j] scale_k[j] z[n,j]) + b_k
//
// It keeps B1's earlier fp32 SIMT body: the (BN, 64) tile of Z M_k in registers
// (BN/16 x 4 a thread) from 16-deep shared tiles double-buffered through
// registers, the Hessian loaded as int8 (four bytes a thread in one 32-bit
// load where d is a multiple of 4, one byte at a time on a ragged edge) and
// upcast as it is staged, so no f32 copy of M exists; the column scale
// multiplies each column of the tile before the row-dot with z, and
// cannot move past the row sum. Its Hessian is 4x fewer bytes (6.1 MB at
// d=780, K=10). It shares the second pass with B1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

// --------------------------------------------------- B1: 3xTF32 on mma.sync

constexpr int kCols = 64;            // Hessian columns of a tile, and depth of a stage
constexpr int kWarps = 8;            // a block's warps, whatever its rows
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 32;        // rows of a warp's tile: two m16 fragments
constexpr int kNT = kCols / 8;       // n8 tiles of a warp's 32 x 64 tile
constexpr int kZStride = kCols + 4;  // A fragment rows 4 banks apart
constexpr int kMStride = kCols + 8;  // B fragment rows (the contraction) 8 banks apart

// A block of BN rows: BN / 32 warps down the rows, and kGroups warps
// across the 8 k-steps of a stage, each on its own run of them, so small
// batches still keep the SM's four tensor cores busy. The ring is as deep
// as shared memory allows: the fewer the rows, the more stages in flight.
template <int BN>
struct Tiling {
  static constexpr int kRowWarps = BN / kWarpRows;
  static constexpr int kGroups = kWarps / kRowWarps;
  static constexpr int kSteps = kCols / 8 / kGroups;  // k-steps of a warp a stage
  static constexpr int kStages = BN == 128 ? 3 : BN == 64 ? 4 : 6;
  static constexpr int kZ = BN * kZStride;
  static constexpr int kStage = kZ + kCols * kMStride;
  static constexpr size_t kBytes = (size_t)kStages * kStage * sizeof(float);
  static_assert(kRowWarps * kGroups == kWarps && kBytes <= 232448, "tiling");
};

// acc += Z_s M_s over kSteps k-steps of a stage from kk0, for a warp's 32
// rows x 64 columns: 3xTF32 into one stage accumulator, the MMAs of a
// k-step issued term by term (small terms first) over 16 independent
// accumulators; the stage is added to acc in f32. One A fragment split
// serves 8 column tiles and one B fragment split 2 row tiles.
template <int kSteps>
__device__ __forceinline__ void stage_product(float (&acc)[2][kNT][4], const float* zs,
                                              const float* ms, int row, int kk0, int g,
                                              int t) {
  float st[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][j][e] = 0.f;
  const float* zr = zs + (row + g) * kZStride + 8 * kk0 + t;
  const float* mr = ms + (8 * kk0 + t) * kMStride + g;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    uint32_t ah[2][4], al[2][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* z = zr + 16 * i * kZStride + 8 * kk;
      ptx::split_tf32(z[0], ah[i][0], al[i][0]);                 // (g, t)
      ptx::split_tf32(z[8 * kZStride], ah[i][1], al[i][1]);      // (g + 8, t)
      ptx::split_tf32(z[4], ah[i][2], al[i][2]);                 // (g, t + 4)
      ptx::split_tf32(z[8 * kZStride + 4], ah[i][3], al[i][3]);  // (g + 8, t + 4)
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      ptx::split_tf32(mr[8 * kk * kMStride + 8 * j], bh[j][0], bl[j][0]);        // M[k t][8j + g]
      ptx::split_tf32(mr[(8 * kk + 4) * kMStride + 8 * j], bh[j][1], bl[j][1]);  // M[k t + 4][.]
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) ptx::mma_tf32(st[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) ptx::mma_tf32(st[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) ptx::mma_tf32(st[i][j], ah[i], bh[j][0], bh[j][1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += st[i][j][e];
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    quadform_tf32(const float* __restrict__ Z, const float* __restrict__ M,
                  const float* __restrict__ V, int n, int d, int tiles_per_split, bool vec,
                  float* __restrict__ g_part, float* __restrict__ zsq_part) {
  using L = Tiling<BN>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) float smem[];
  const auto zs = [&](int st) { return smem + st * L::kStage; };
  const auto ms = [&](int st) { return smem + st * L::kStage + L::kZ; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = kWarpRows * (warp % L::kRowWarps);  // the warp's first row in the tile
  const int group = warp / L::kRowWarps;              // and its run of k-steps
  const int row0 = blockIdx.x * BN;
  const int k = blockIdx.y, K = gridDim.y;
  const int split = blockIdx.z;
  const int tiles = (d + kCols - 1) / kCols;  // column tiles, and stages of each
  const int jt_begin = split * tiles_per_split;
  const int jt_end = min(tiles, jt_begin + tiles_per_split);
  const int stages = max(0, jt_end - jt_begin) * tiles;
  const float* Mk = M + (size_t)k * d * d;
  const float* vk = V + (size_t)k * d;

  // Stage s: column tile jt, contraction tile it, the tile's own last.
  const auto issue = [&](int s) {
    const int jt = jt_begin + s / tiles;
    const int it = (jt + 1 + s % tiles) % tiles;
    const int st = s % kStages;
    ptx::copy_tile<BN, kZStride, kThreads>(zs(st), Z, row0, n, it * kCols, d, d, vec);
    ptx::copy_tile<kCols, kMStride, kThreads>(ms(st), Mk, it * kCols, d, jt * kCols, d, d,
                                              vec);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) issue(s);
    ptx::cp_async_commit();
  }

  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float gsum[4] = {0.f, 0.f, 0.f, 0.f}, sq[4] = {0.f, 0.f, 0.f, 0.f};  // rows g + 8r

  for (int s = 0; s < stages; ++s) {
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1's slot
    if (s + kStages - 1 < stages) issue(s + kStages - 1);
    ptx::cp_async_commit();
    const int st = s % kStages;
    stage_product<L::kSteps>(acc, zs(st), ms(st), row, group * L::kSteps, g, t);
    if (s % tiles != tiles - 1) continue;
    // The column tile is complete (over this warp's k-steps) and the stage
    // in hand holds z at its columns: fold it into the row sums, (Z M_k)[n,j]
    // (+ v_k[j] in group 0) times z[n,j]. The fold is linear, so the
    // groups' sums add up to the whole.
    const int j0 = (jt_begin + s / tiles) * kCols;
    const float* zr = zs(st) + (row + g) * kZStride + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * i + (e >> 1), c = 8 * j + 2 * t + (e & 1);
          const float z = zr[8 * r * kZStride + 8 * j + (e & 1)];
          const float v = group == 0 && j0 + c < d ? vk[j0 + c] : 0.f;
          gsum[r] = fmaf(acc[i][j][e] + v, z, gsum[r]);
          sq[r] = fmaf(z, z, sq[r]);
          acc[i][j][e] = 0.f;
        }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the groups' row sums now

  float* gred = smem;                     // (kGroups, BN)
  float* sqred = smem + L::kGroups * BN;  // (BN,), group 0's
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float gs = gsum[r], ss = sq[r];
    gs += __shfl_xor_sync(0xffffffffu, gs, 1);  // the row's 4 lanes, a fixed tree
    gs += __shfl_xor_sync(0xffffffffu, gs, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if (t == 0) {
      const int rr = row + g + 8 * r;
      gred[group * BN + rr] = gs;
      if (group == 0) sqred[rr] = ss;
    }
  }
  __syncthreads();
  if (threadIdx.x < BN && row0 + threadIdx.x < n) {
    const int r = threadIdx.x;
    float gs = gred[r];
    for (int q = 1; q < L::kGroups; ++q) gs += gred[q * BN + r];  // group order
    g_part[((size_t)split * K + k) * n + row0 + r] = gs;
    if (k == 0) zsq_part[(size_t)split * n + row0 + r] = sqred[r];  // head-0 blocks only
  }
}

// ------------------------------------------------- B3: int8 Hessian, SIMT

constexpr int kQ8Threads = 256;
constexpr int kLanesX = 16;  // threads along the column axis of a tile
constexpr int kLanesY = 16;  // threads along the row axis
constexpr int kBlockJ = 64;  // Hessian columns per tile
constexpr int kBlockI = 16;  // contraction depth per shared-memory stage
constexpr int kTN = kBlockJ / kLanesX;

__device__ __forceinline__ float lane16_sum(float x) {
  // Butterfly over the 16 lanes that share a row (xor stays inside each
  // half-warp); the same tree every run.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  // N consecutive floats from 8- or 16-byte aligned shared memory.
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = v.x, out[4 * q + 1] = v.y, out[4 * q + 2] = v.z, out[4 * q + 3] = v.w;
    }
  } else {
    static_assert(N == 2, "rows per thread must be 2 or a multiple of 4");
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  }
}

// At most 128 registers a thread (kQ8Threads, 2), so two blocks share an
// SM and hide each other's global loads; the arithmetic, and so every bit
// of the result, is the same as without the cap.
template <int BN>
__global__ void __launch_bounds__(kQ8Threads, 2)
    quadform_q8_partial(const float* __restrict__ Z, const int8_t* __restrict__ M,
                        const float* __restrict__ col_scale, const float* __restrict__ V,
                        int n, int d, int tiles_per_split, bool vec4,
                        float* __restrict__ g_part, float* __restrict__ zsq_part) {
  constexpr int TM = BN / kLanesY;                         // rows per thread
  constexpr int kZLoads = BN * kBlockI / kQ8Threads;       // Z floats per thread per stage
  constexpr int kMLoads = kBlockI * kBlockJ / kQ8Threads;  // M values per thread per stage
  static_assert(kMLoads == 4, "a thread loads one 4-byte run a stage");
  constexpr int kZStrideQ8 = BN + 4;  // keeps each row 16-byte aligned, spreads banks
  // Two stages: the next stage's global loads are in flight in registers
  // while the current one is multiplied out of shared memory.
  __shared__ __align__(16) float zs[2][kBlockI][kZStrideQ8];  // Z tile, transposed
  __shared__ __align__(16) float ms[2][kBlockI][kBlockJ];

  const int tid = threadIdx.x;
  const int tx = tid % kLanesX;
  const int ty = tid / kLanesX;
  const int row0 = blockIdx.x * BN;
  const int k = blockIdx.y;
  const int K = gridDim.y;
  const int split = blockIdx.z;
  const int j_tiles = (d + kBlockJ - 1) / kBlockJ;
  const int jt_begin = split * tiles_per_split;
  const int jt_end = min(j_tiles, jt_begin + tiles_per_split);
  const int8_t* Mk = M + (size_t)k * d * d;
  const float* vk = V + (size_t)k * d;
  // Thread tid stages row tid / 16, columns 4 (tid % 16) .. + 3.
  const int mi = tid / (kBlockJ / 4), mj = 4 * (tid % (kBlockJ / 4));

  float zr[kZLoads], mr[kMLoads];
  auto fetch = [&](int i0, int j0) {  // global -> registers, edges as zeros
#pragma unroll
    for (int q = 0; q < kZLoads; ++q) {
      const int e = tid + q * kQ8Threads;
      const int row = row0 + e / kBlockI, col = i0 + e % kBlockI;
      zr[q] = (row < n && col < d) ? Z[(size_t)row * d + col] : 0.f;
    }
    const int i = i0 + mi, j = j0 + mj;
    const int8_t* p = Mk + (size_t)i * d + j;
    if (vec4 && i < d && j + 3 < d) {
      const char4 v = *reinterpret_cast<const char4*>(p);
      mr[0] = v.x, mr[1] = v.y, mr[2] = v.z, mr[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < kMLoads; ++q) mr[q] = (i < d && j + q < d) ? (float)p[q] : 0.f;
    }
  };
  auto stash = [&](int buf) {  // registers -> shared stage ``buf``
#pragma unroll
    for (int q = 0; q < kZLoads; ++q) {
      const int e = tid + q * kQ8Threads;
      zs[buf][e % kBlockI][e / kBlockI] = zr[q];
    }
    *reinterpret_cast<float4*>(&ms[buf][mi][mj]) = make_float4(mr[0], mr[1], mr[2], mr[3]);
  };

  float g[TM], sq[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) g[r] = sq[r] = 0.f;

  for (int jt = jt_begin; jt < jt_end; ++jt) {
    const int j0 = jt * kBlockJ;
    float acc[TM][kTN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;

    fetch(0, j0);
    stash(0);
    __syncthreads();
    int buf = 0;
    for (int i0 = 0; i0 < d; i0 += kBlockI) {
      const bool more = i0 + kBlockI < d;
      if (more) fetch(i0 + kBlockI, j0);
#pragma unroll
      for (int ii = 0; ii < kBlockI; ++ii) {
        float a[TM], b[kTN];
        load_vec(&zs[buf][ii][ty * TM], a);
        load_vec(&ms[buf][ii][tx * kTN], b);
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      if (more) stash(buf ^ 1);
      __syncthreads();  // stage buf^1 is complete; buf is refilled only after this
      buf ^= 1;
    }

    // Fold the (BN, 64) tile of Z @ M_k into the row sums at once; the
    // column scales multiply the tile first.
    float scale[kTN];
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int col = j0 + tx * kTN + c;
      scale[c] = col < d ? col_scale[(size_t)k * d + col] : 1.f;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = row0 + ty * TM + r;
      if (row >= n) continue;
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const int col = j0 + tx * kTN + c;
        if (col >= d) continue;
        const float z = Z[(size_t)row * d + col];
        const float zm = acc[r][c] * scale[c];
        g[r] = fmaf(zm + vk[col], z, g[r]);  // quad + lin
        sq[r] = fmaf(z, z, sq[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const float gs = lane16_sum(g[r]);
    const float ss = lane16_sum(sq[r]);
    const int row = row0 + ty * TM + r;
    if (tx == 0 && row < n) {
      g_part[((size_t)split * K + k) * n + row] = gs;
      if (k == 0) zsq_part[(size_t)split * n + row] = ss;  // head-0 blocks only
    }
  }
}

// ------------------------------------------------------ both: second pass

__global__ void quadform_finalize(const float* __restrict__ g_part,
                                  const float* __restrict__ zsq_part, int splits,
                                  int n, int K, const float* __restrict__ c,
                                  const float* __restrict__ b,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ msq, float* __restrict__ scores,
                                  float* __restrict__ zsq, uint8_t* __restrict__ valid) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * K) return;
  const int row = idx / K, k = idx % K;
  float g = 0.f, s = 0.f;
  for (int p = 0; p < splits; ++p) {  // split order: deterministic
    g += g_part[((size_t)p * K + k) * n + row];
    s += zsq_part[(size_t)p * n + row];
  }
  const float gk = gamma[k];
  const float env = expf(-s * gk);
  scores[idx] = env * (c[k] + g) + b[k];
  const float rhs = 0.0625f / fmaxf(gk * gk, 1e-30f);  // eq311_valid, strict <
  valid[idx] = (msq[k] * s < rhs) ? 1 : 0;
  if (k == 0) zsq[row] = s;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int BN>
cudaError_t launch_f32(const float* Z, const float* M, const float* V, int n, int d, int K,
                       int splits, float* g_part, float* zsq_part, cudaStream_t stream) {
  const int tiles = (d + kCols - 1) / kCols;
  const int per_split = (tiles + splits - 1) / splits;
  const bool vec = d % 4 == 0 && aligned16(Z) && aligned16(M);
  constexpr size_t bytes = Tiling<BN>::kBytes;
  static bool opted[ptx::kMaxDevices] = {};
  const cudaError_t err = ptx::allow_smem(quadform_tf32<BN>, (int)bytes, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, K, splits);
  quadform_tf32<BN><<<grid, kThreads, bytes, stream>>>(Z, M, V, n, d, per_split, vec, g_part,
                                                       zsq_part);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_q8(const float* Z, const int8_t* M, const float* col_scale, const float* V,
                      int n, int d, int K, int splits, float* g_part, float* zsq_part,
                      cudaStream_t stream) {
  const int j_tiles = (d + kBlockJ - 1) / kBlockJ;
  const int per_split = (j_tiles + splits - 1) / splits;
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(M) % 4 == 0;
  const dim3 grid((n + BN - 1) / BN, K, splits);
  quadform_q8_partial<BN><<<grid, kQ8Threads, 0, stream>>>(Z, M, col_scale, V, n, d,
                                                           per_split, vec4, g_part, zsq_part);
  return cudaGetLastError();
}

int finalize(const float* g_part, const float* zsq_part, int splits, int n, int K,
             const float* c, const float* b, const float* gamma, const float* msq,
             float* scores, float* zsq, uint8_t* valid, cudaStream_t stream) {
  const int total = n * K;
  quadform_finalize<<<(total + 255) / 256, 256, 0, stream>>>(
      g_part, zsq_part, splits, n, K, c, b, gamma, msq, scores, zsq, valid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// B1. Z (n, d), M (K, d, d), V (K, d), c/b/gamma/msq (K,): f32, contiguous,
// on the device. g_part (splits, K, n) and zsq_part (splits, n) are
// scratch. Writes scores (n, K), zsq (n,), valid (n, K) as 0/1 bytes.
int quadform_heads_f32(const float* Z, const float* M, const float* V, const float* c,
                       const float* b, const float* gamma, const float* msq, int n,
                       int d, int K, int block_n, int splits, float* g_part,
                       float* zsq_part, float* scores, float* zsq, uint8_t* valid,
                       cudaStream_t stream) {
  if (n <= 0 || d <= 0 || K <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (block_n == 128) {
    err = launch_f32<128>(Z, M, V, n, d, K, splits, g_part, zsq_part, stream);
  } else if (block_n == 64) {
    err = launch_f32<64>(Z, M, V, n, d, K, splits, g_part, zsq_part, stream);
  } else if (block_n == 32) {
    err = launch_f32<32>(Z, M, V, n, d, K, splits, g_part, zsq_part, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return finalize(g_part, zsq_part, splits, n, K, c, b, gamma, msq, scores, zsq, valid,
                  stream);
}

// B3. As B1, with M (K, d, d) int8 and col_scale (K, d) f32.
int quadform_heads_q8(const float* Z, const int8_t* M, const float* col_scale,
                      const float* V, const float* c, const float* b, const float* gamma,
                      const float* msq, int n, int d, int K, int block_n, int splits,
                      float* g_part, float* zsq_part, float* scores, float* zsq,
                      uint8_t* valid, cudaStream_t stream) {
  if (n <= 0 || d <= 0 || K <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (block_n == 128) {
    err = launch_q8<128>(Z, M, col_scale, V, n, d, K, splits, g_part, zsq_part, stream);
  } else if (block_n == 64) {
    err = launch_q8<64>(Z, M, col_scale, V, n, d, K, splits, g_part, zsq_part, stream);
  } else if (block_n == 32) {
    err = launch_q8<32>(Z, M, col_scale, V, n, d, K, splits, g_part, zsq_part, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return finalize(g_part, zsq_part, splits, n, K, c, b, gamma, msq, scores, zsq, valid,
                  stream);
}

}  // extern "C"
