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
// Its Hessian is 4x fewer bytes (6.1 MB at d=780, K=10) and its products
// 2 n K d^2 flops as B1's. It is the int8 instantiation of B1's template:
//
// - The ring holds M_k's tile as the int8 bytes (4-byte cp.async where d
//   is a multiple of 4, plain byte loads on a ragged d), 5 KB a stage where
//   B1's f32 tile takes 18 KB, so the ring runs as deep as shared memory
//   allows (5, 9 and 15 stages at 128, 64 and 32 rows). No f32 or
//   transposed copy of M exists.
// - An int8 value is exact in TF32, so M needs no split: each product is
//   Z_lo M + Z_hi M (small terms first), two MMAs where B1 spends three,
//   into one stage accumulator that is added to the running tile in f32.
// - M_k is row-major with the contraction down its rows, so the B fragment
//   of column n of n8 tile j would gather bytes 8 apart. The tile's columns
//   are permuted instead: tile j, column n is column 8n + j, and a lane's
//   bytes of one contraction row for all eight tiles are 8 contiguous bytes,
//   one 8-byte shared load upcast by a byte permute and a subtraction
//   (ptx::s8_at). The k order inside a k-step is permuted alike for A and B
//   (k = t and t + 4 are contraction columns 2t and 2t + 1), so an A
//   fragment is two 8-byte loads; rows are padded so that the lanes of a
//   half-warp hit distinct banks. Only the fold sees the column permutation.
// - The fold takes z from the stage in hand, and the tile's column scales
//   and v_k, which came with that stage: zm = acc * scale_k[c] first, then
//   g[n] += (zm + v_k[c]) z[n,c], the scale before the row-dot with z, as
//   the reference has it.
// - The second pass is B1's.
//
// On an H100 80GB HBM3 at 700 W, n=1024: B3 0.25 ms, B1 0.30 (chip_smoke.py),
// 3.3x and 4.0x their 3xTF32 bound. B3 at 128 rows a block takes the same
// time at 4 to 13 splits of the column tiles, 64 rows 1.3x and 32 rows 1.9x
// as long (scripts/quadform_q8_sweep.py): the time follows the k-steps a
// stage gives a warp (4, 2, 1), not the tail of the grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

// ------------------------------------------ B1 (f32) and B3 (int8): mma.sync

constexpr int kCols = 64;            // Hessian columns of a tile, and depth of a stage
constexpr int kWarps = 8;            // a block's warps, whatever its rows
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 32;        // rows of a warp's tile: two m16 fragments
constexpr int kNT = kCols / 8;       // n8 tiles of a warp's 32 x 64 tile
constexpr int kZStride = kCols + 4;  // B1: A fragment rows 4 banks apart
constexpr int kMStride = kCols + 8;  // B1: B fragment rows (the contraction) 8 banks apart
constexpr int kZStrideQ8 = kCols + 8;    // B3: 8-byte A fragment reads 8 banks apart
constexpr int kMStrideQ8 = kCols + 16;   // B3: int8 rows in bytes, 8-byte reads 8 banks apart
constexpr int kSmemBytes = 232448;       // a block's shared memory on an H100

// A block of BN rows: BN / 32 warps down the rows, and kGroups warps
// across the 8 k-steps of a stage, each on its own run of them, so small
// batches still keep the SM's four tensor cores busy. The ring is as deep
// as shared memory allows: the fewer the rows, the more stages in flight.
// A stage (in floats): the Z tile, the M_k tile (B3: its bytes), and B3's
// column scales and v_k for the tile (64 each).
template <typename T, int BN>
struct Tiling {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int kRowWarps = BN / kWarpRows;
  static constexpr int kGroups = kWarps / kRowWarps;
  static constexpr int kSteps = kCols / 8 / kGroups;  // k-steps of a warp a stage
  static constexpr int kZS = kInt8 ? kZStrideQ8 : kZStride;
  static constexpr int kZ = BN * kZS;
  static constexpr int kM = kInt8 ? kCols * kMStrideQ8 / 4 : kCols * kMStride;
  static constexpr int kStage = kZ + kM + (kInt8 ? 2 * kCols : 0);
  static constexpr int kStages =
      kInt8 ? kSmemBytes / (kStage * 4) : BN == 128 ? 3 : BN == 64 ? 4 : 6;
  static constexpr size_t kBytes = (size_t)kStages * kStage * sizeof(float);
  static_assert(kRowWarps * kGroups == kWarps && kBytes <= kSmemBytes, "tiling");
  static_assert(kZ % 4 == 0 && kM % 4 == 0, "16-byte aligned tiles");
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

// B3's: Z_lo M + Z_hi M off the int8 tile. Column n of n8 tile j is the
// tile's column 8n + j, and k = t, t + 4 of a k-step are its contraction
// columns 2t, 2t + 1, so lane (g, t) reads its A values as pairs and its B
// bytes of all eight tiles as 8 bytes of each of two rows.
template <int kSteps>
__device__ __forceinline__ void stage_product_q8(float (&acc)[2][kNT][4], const float* zs,
                                                 const unsigned char* ms, int row, int kk0,
                                                 int g, int t) {
  float st[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][j][e] = 0.f;
  const float* zr = zs + (row + g) * kZStrideQ8 + 8 * kk0 + 2 * t;
  const unsigned char* mr = ms + (8 * kk0 + 2 * t) * kMStrideQ8 + 8 * g;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    uint32_t ah[2][4], al[2][4], b[kNT][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* z = zr + 16 * i * kZStrideQ8 + 8 * kk;
      const float2 top = *reinterpret_cast<const float2*>(z);
      const float2 bot = *reinterpret_cast<const float2*>(z + 8 * kZStrideQ8);
      ptx::split_tf32(top.x, ah[i][0], al[i][0]);  // (g, k = t: column 2t)
      ptx::split_tf32(bot.x, ah[i][1], al[i][1]);  // (g + 8, 2t)
      ptx::split_tf32(top.y, ah[i][2], al[i][2]);  // (g, k = t + 4: column 2t + 1)
      ptx::split_tf32(bot.y, ah[i][3], al[i][3]);  // (g + 8, 2t + 1)
    }
    const unsigned char* m = mr + 8 * kk * kMStrideQ8;
    const uint2 lo = *reinterpret_cast<const uint2*>(m);               // M[2t][8g .. 8g + 7]
    const uint2 hi = *reinterpret_cast<const uint2*>(m + kMStrideQ8);  // M[2t + 1][.]
    const uint32_t x[4] = {lo.x ^ 0x80808080u, lo.y ^ 0x80808080u, hi.x ^ 0x80808080u,
                           hi.y ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {  // byte j: the tile's column 8g + j
      b[j][0] = __float_as_uint(ptx::s8_at(x[j / 4], 0x4550 + j % 4));
      b[j][1] = __float_as_uint(ptx::s8_at(x[2 + j / 4], 0x4550 + j % 4));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) ptx::mma_tf32(st[i][j], al[i], b[j][0], b[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) ptx::mma_tf32(st[i][j], ah[i], b[j][0], b[j][1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += st[i][j][e];
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    quadform_tf32(const float* __restrict__ Z, const T* __restrict__ M,
                  const float* __restrict__ col_scale, const float* __restrict__ V, int n,
                  int d, int tiles_per_split, bool vec, float* __restrict__ g_part,
                  float* __restrict__ zsq_part) {
  using L = Tiling<T, BN>;
  constexpr bool kInt8 = L::kInt8;
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
  const T* Mk = M + (size_t)k * d * d;
  const float* vk = V + (size_t)k * d;

  // Stage s: column tile jt, contraction tile it, the tile's own last.
  const auto issue = [&](int s) {
    const int jt = jt_begin + s / tiles;
    const int it = (jt + 1 + s % tiles) % tiles;
    const int st = s % kStages;
    ptx::copy_tile<BN, L::kZS, kThreads>(zs(st), Z, row0, n, it * kCols, d, d, vec);
    if constexpr (kInt8) {
      ptx::copy_tile_s8<kCols, kMStrideQ8, kThreads>(reinterpret_cast<unsigned char*>(ms(st)),
                                                     Mk, it * kCols, d, jt * kCols, d, d, vec);
      if (it == jt && threadIdx.x < 2 * kCols) {  // the tile's scales, then v_k
        const int c = jt * kCols + threadIdx.x % kCols;
        const float* src = threadIdx.x < kCols ? col_scale + (size_t)k * d : vk;
        const bool ok = c < d;
        ptx::cp_async4(ms(st) + L::kM + threadIdx.x, ok ? src + c : src, ok);
      }
    } else {
      ptx::copy_tile<kCols, kMStride, kThreads>(ms(st), Mk, it * kCols, d, jt * kCols, d, d,
                                                vec);
    }
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
    if constexpr (kInt8) {
      stage_product_q8<L::kSteps>(acc, zs(st), reinterpret_cast<const unsigned char*>(ms(st)),
                                  row, group * L::kSteps, g, t);
    } else {
      stage_product<L::kSteps>(acc, zs(st), ms(st), row, group * L::kSteps, g, t);
    }
    if (s % tiles != tiles - 1) continue;
    // The column tile is complete (over this warp's k-steps) and the stage
    // in hand holds z at its columns: fold it into the row sums, (Z M_k)[n,j]
    // (+ v_k[j] in group 0) times z[n,j]. The fold is linear, so the
    // groups' sums add up to the whole.
    if constexpr (kInt8) {
      // acc[i][j][2h + u] is row 16i + 8h + g, column 8 (2t + u) + j; the
      // column's scale first, then v_k, as _heads_kernel_q8.
      const float* zr = zs(st) + (row + g) * kZStrideQ8 + 16 * t;
      const float* sv = ms(st) + L::kM + 16 * t;  // scales, then v_k at + kCols
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              const int r = 2 * i + h, c = 8 * u + j;
              const float z = zr[8 * r * kZStrideQ8 + c];
              const float zm = __fmul_rn(acc[i][j][2 * h + u], sv[c]);
              const float v = group == 0 ? sv[kCols + c] : 0.f;
              gsum[r] = fmaf(zm + v, z, gsum[r]);
              sq[r] = fmaf(z, z, sq[r]);
              acc[i][j][2 * h + u] = 0.f;
            }
    } else {
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

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, int BN>
cudaError_t launch_partial(const float* Z, const T* M, const float* col_scale, const float* V,
                           int n, int d, int K, int splits, float* g_part, float* zsq_part,
                           cudaStream_t stream) {
  const int tiles = (d + kCols - 1) / kCols;
  const int per_split = (tiles + splits - 1) / splits;
  const bool vec = d % 4 == 0 && aligned(Z, 16) && aligned(M, Tiling<T, BN>::kInt8 ? 4 : 16);
  constexpr size_t bytes = Tiling<T, BN>::kBytes;
  static bool opted[ptx::kMaxDevices] = {};
  const cudaError_t err = ptx::allow_smem(quadform_tf32<T, BN>, (int)bytes, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, K, splits);
  quadform_tf32<T, BN><<<grid, kThreads, bytes, stream>>>(Z, M, col_scale, V, n, d, per_split,
                                                          vec, g_part, zsq_part);
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

template <typename T>
int run(const float* Z, const T* M, const float* col_scale, const float* V, const float* c,
        const float* b, const float* gamma, const float* msq, int n, int d, int K, int block_n,
        int splits, float* g_part, float* zsq_part, float* scores, float* zsq, uint8_t* valid,
        cudaStream_t stream) {
  if (n <= 0 || d <= 0 || K <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (block_n == 128) {
    err = launch_partial<T, 128>(Z, M, col_scale, V, n, d, K, splits, g_part, zsq_part, stream);
  } else if (block_n == 64) {
    err = launch_partial<T, 64>(Z, M, col_scale, V, n, d, K, splits, g_part, zsq_part, stream);
  } else if (block_n == 32) {
    err = launch_partial<T, 32>(Z, M, col_scale, V, n, d, K, splits, g_part, zsq_part, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return finalize(g_part, zsq_part, splits, n, K, c, b, gamma, msq, scores, zsq, valid,
                  stream);
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
  return run<float>(Z, M, nullptr, V, c, b, gamma, msq, n, d, K, block_n, splits, g_part,
                    zsq_part, scores, zsq, valid, stream);
}

// B3. As B1, with M (K, d, d) int8 and col_scale (K, d) f32.
int quadform_heads_q8(const float* Z, const int8_t* M, const float* col_scale,
                      const float* V, const float* c, const float* b, const float* gamma,
                      const float* msq, int n, int d, int K, int block_n, int splits,
                      float* g_part, float* zsq_part, float* scores, float* zsq,
                      uint8_t* valid, cudaStream_t stream) {
  return run<int8_t>(Z, M, col_scale, V, c, b, gamma, msq, n, d, K, block_n, splits, g_part,
                     zsq_part, scores, zsq, valid, stream);
}

}  // extern "C"
