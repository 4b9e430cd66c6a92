// Fused K-head Maclaurin quadratic form (Eq 3.8) with the Eq 3.11 mask.
//
// Replaces repro/kernels/quadform/kernel.py::quadform_heads_pallas (body
// _heads_kernel). For K collapsed heads sharing one batch Z (n, d):
//
//   s[n,k]  = exp(-gamma_k |z|^2) (c_k + v_k.z + z^T M_k z) + b_k
//   zsq[n]  = |z|^2
//   ok[n,k] = msq_k |z|^2 < 0.0625 / max(gamma_k^2, 1e-30)
//
// What bounds it on an H100 (fp32, no tensor cores): 2 n K d^2 FMA-flops
// against K d^2 floats of Hessian. At n=1024, K=10, d=780 that is
// 12.5 GFLOP (0.19 ms at 67 TFLOP/s) against 24 MB (7 us at 3.35 TB/s):
// compute bound. At n <= 32 the same 24 MB meets 0.4 GFLOP (6 us): memory
// bound, and the work must spread over enough SMs to pull the Hessian in.
//
// Design. The TPU kernel kept a (d, block_k*d) Hessian slice resident in
// VMEM; at d=780 one head is 2.4 MB, ten times a block's shared memory,
// so nothing stays resident here. One block owns (a tile of BN rows of Z,
// one head k, one run of 64-column tiles of M_k). For each column tile it
// builds the (BN, 64) tile of Z @ M_k in registers (BN/16 x 4 per thread,
// operands read from shared memory as float4) from 16-deep shared tiles of
// Z and M_k, double-buffered so the next tile's loads overlap the current
// tile's FMAs, and folds it at once into the row sums
// quad[n] += sum_j (ZM)[n,j] z[n,j] (with v_k.z and |z|^2 riding along),
// so the (n, K*d) product never reaches device memory. A block's row sums
// are reduced across its 16 column lanes with a fixed shuffle tree and
// written per split; a second pass sums the splits in split order and
// applies the exp envelope, bias and mask. No atomics: the result is the
// same bit for bit from run to run. Splitting the column tiles over
// blocks is what keeps small batches (10 heads x 1 row tile) from running
// on 10 of 132 SMs. Ragged edges (d=780, any n) are masked with zeros,
// which change no sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// At most 128 registers a thread (kThreads, 2), so two blocks share an SM
// and hide each other's global loads; the arithmetic, and so every bit of
// the result, is the same as without the cap.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    quadform_partial(const float* __restrict__ Z, const float* __restrict__ M,
                     const float* __restrict__ V, int n, int d, int tiles_per_split,
                     float* __restrict__ g_part, float* __restrict__ zsq_part) {
  constexpr int TM = BN / kLanesY;                       // rows per thread
  constexpr int kZLoads = BN * kBlockI / kThreads;       // Z floats per thread per stage
  constexpr int kMLoads = kBlockI * kBlockJ / kThreads;  // M floats per thread per stage
  constexpr int kZStride = BN + 4;  // keeps each row 16-byte aligned, spreads banks
  // Two stages: the next stage's global loads are in flight in registers
  // while the current one is multiplied out of shared memory.
  __shared__ __align__(16) float zs[2][kBlockI][kZStride];  // Z tile, transposed
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
  const float* Mk = M + (size_t)k * d * d;
  const float* vk = V + (size_t)k * d;

  float zr[kZLoads], mr[kMLoads];
  auto fetch = [&](int i0, int j0) {  // global -> registers, edges as zeros
#pragma unroll
    for (int q = 0; q < kZLoads; ++q) {
      const int e = tid + q * kThreads;
      const int row = row0 + e / kBlockI, col = i0 + e % kBlockI;
      zr[q] = (row < n && col < d) ? Z[(size_t)row * d + col] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kMLoads; ++q) {
      const int e = tid + q * kThreads;
      const int i = i0 + e / kBlockJ, j = j0 + e % kBlockJ;
      mr[q] = (i < d && j < d) ? Mk[(size_t)i * d + j] : 0.f;
    }
  };
  auto stash = [&](int buf) {  // registers -> shared stage ``buf``
#pragma unroll
    for (int q = 0; q < kZLoads; ++q) {
      const int e = tid + q * kThreads;
      zs[buf][e % kBlockI][e / kBlockI] = zr[q];
    }
#pragma unroll
    for (int q = 0; q < kMLoads; ++q) {
      const int e = tid + q * kThreads;
      ms[buf][e / kBlockJ][e % kBlockJ] = mr[q];
    }
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

    // Fold the (BN, 64) tile of Z @ M_k into the row sums at once.
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = row0 + ty * TM + r;
      if (row >= n) continue;
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const int col = j0 + tx * kTN + c;
        if (col >= d) continue;
        const float z = Z[(size_t)row * d + col];
        g[r] = fmaf(acc[r][c] + vk[col], z, g[r]);  // quad + lin
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

template <int BN>
void launch_partial(const float* Z, const float* M, const float* V, int n, int d, int K,
                    int splits, float* g_part, float* zsq_part, cudaStream_t stream) {
  const int j_tiles = (d + kBlockJ - 1) / kBlockJ;
  const int per_split = (j_tiles + splits - 1) / splits;
  const dim3 grid((n + BN - 1) / BN, K, splits);
  quadform_partial<BN><<<grid, kThreads, 0, stream>>>(Z, M, V, n, d, per_split, g_part,
                                                      zsq_part);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Z (n, d), M (K, d, d), V (K, d), c/b/gamma/msq (K,): f32, contiguous, on
// the device. g_part (splits, K, n) and zsq_part (splits, n) are scratch.
// Writes scores (n, K), zsq (n,), valid (n, K) as 0/1 bytes.
int quadform_heads_f32(const float* Z, const float* M, const float* V, const float* c,
                       const float* b, const float* gamma, const float* msq, int n,
                       int d, int K, int block_n, int splits, float* g_part,
                       float* zsq_part, float* scores, float* zsq, uint8_t* valid,
                       cudaStream_t stream) {
  if (n <= 0 || d <= 0 || K <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  if (block_n == 128) {
    launch_partial<128>(Z, M, V, n, d, K, splits, g_part, zsq_part, stream);
  } else if (block_n == 64) {
    launch_partial<64>(Z, M, V, n, d, K, splits, g_part, zsq_part, stream);
  } else if (block_n == 32) {
    launch_partial<32>(Z, M, V, n, d, K, splits, g_part, zsq_part, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = n * K;
  quadform_finalize<<<(total + 255) / 256, 256, 0, stream>>>(
      g_part, zsq_part, splits, n, K, c, b, gamma, msq, scores, zsq, valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
