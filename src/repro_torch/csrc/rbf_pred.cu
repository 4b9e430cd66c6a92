// Exact RBF expansion, streamed over support-vector tiles (Eq 3.2).
//
// Replaces repro/kernels/rbf_pred/kernel.py::rbf_predict_pallas (body
// _kernel), with the engine's vmap over heads (serve/svm_engine.py, the
// slow path) written out as a head dimension:
//
//   out[n,k] = sum_i A[k,i] exp(-gamma max(|z|^2 + |x_i|^2 - 2 z.x_i, 0)) + b[k]
//
// What bounds it on an H100 (fp32, no tensor cores): 2 n m d FMA-flops for
// the distances against (n + m) d floats of input. At n=256, m=16384,
// d=780 that is 6.5 GFLOP (0.10 ms at 67 TFLOP/s) against 52 MB (16 us at
// 3.35 TB/s): compute bound. At a few fallback rows (n <= 32) it turns
// memory bound on streaming X once.
//
// Design. The TPU kernel streamed SV tiles through a hand 2-slot DMA into
// one sequential grid. Here one block owns (a tile of BN rows of Z, one
// run of 64-row SV tiles, up to 16 heads). Per SV tile it builds the
// (BN, 64) dot tile Z X_t^T in registers from 16-deep shared tiles
// (double-buffered through registers, read back as float4), turns
// it into exp(-gamma d2) in place, and accumulates every head's sum from
// that one distance: each distance is computed once and shared by all K
// accumulators. The (n, m) kernel matrix never reaches device memory.
// Runs of SV tiles are spread over blocks (split-K); each block writes
// its per-row, per-head partial sums, and a second pass adds the splits
// in split order plus the bias. Row norms come from a warp-per-row pass
// with a fixed shuffle tree. No atomics: bitwise the same every run.
// Zero-padded SVs would need alpha = 0; the kernel masks the ragged SV,
// row and feature edges itself, so nothing is padded.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesX = 16;  // threads along the SV axis of a tile
constexpr int kLanesY = 16;  // threads along the row axis
constexpr int kBlockM = 64;  // SVs per tile
constexpr int kBlockD = 16;  // feature depth per shared-memory stage
constexpr int kHeads = 16;   // heads accumulated per block
constexpr int kTN = kBlockM / kLanesX;

__device__ __forceinline__ float lane16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// out[r] = |A[r, :]|^2, one warp per row.
__global__ void sqnorm_rows(const float* __restrict__ A, int rows, int d,
                            float* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = A[(size_t)row * d + j];
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
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
    rbf_partial(const float* __restrict__ Z, const float* __restrict__ X,
                const float* __restrict__ A, const float* __restrict__ zsq,
                const float* __restrict__ xsq, const float* __restrict__ gamma_p, int n,
                int m, int d, int K, int tiles_per_split, float* __restrict__ part) {
  constexpr int TM = BN / kLanesY;                       // rows per thread
  constexpr int kZLoads = BN * kBlockD / kThreads;       // Z floats per thread per stage
  constexpr int kXLoads = kBlockM * kBlockD / kThreads;  // X floats per thread per stage
  // Two stages, rows padded by 4 floats (16-byte aligned, banks spread):
  // the next stage's global loads are in flight in registers while the
  // current one is multiplied out of shared memory.
  __shared__ __align__(16) float zs[2][kBlockD][BN + 4];       // Z tile, transposed
  __shared__ __align__(16) float xs[2][kBlockD][kBlockM + 4];  // X tile, transposed
  __shared__ __align__(16) float as[kHeads][kBlockM];
  __shared__ __align__(16) float xsq_s[kBlockM];

  const int tid = threadIdx.x;
  const int tx = tid % kLanesX;
  const int ty = tid / kLanesX;
  const int row0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int k0 = blockIdx.z * kHeads;
  const int kh = min(kHeads, K - k0);
  const int m_tiles = (m + kBlockM - 1) / kBlockM;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(m_tiles, t_begin + tiles_per_split);
  const float gamma = *gamma_p;

  float zr_[kZLoads], xr_[kXLoads];
  auto fetch = [&](int d0, int m0) {  // global -> registers, edges as zeros
#pragma unroll
    for (int q = 0; q < kZLoads; ++q) {
      const int e = tid + q * kThreads;
      const int row = row0 + e / kBlockD, col = d0 + e % kBlockD;
      zr_[q] = (row < n && col < d) ? Z[(size_t)row * d + col] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kXLoads; ++q) {
      const int e = tid + q * kThreads;
      const int sv = m0 + e / kBlockD, col = d0 + e % kBlockD;
      xr_[q] = (sv < m && col < d) ? X[(size_t)sv * d + col] : 0.f;
    }
  };
  auto stash = [&](int buf) {  // registers -> shared stage ``buf``
#pragma unroll
    for (int q = 0; q < kZLoads; ++q) {
      const int e = tid + q * kThreads;
      zs[buf][e % kBlockD][e / kBlockD] = zr_[q];
    }
#pragma unroll
    for (int q = 0; q < kXLoads; ++q) {
      const int e = tid + q * kThreads;
      xs[buf][e % kBlockD][e / kBlockD] = xr_[q];
    }
  };

  float zr[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = row0 + ty * TM + r;
    zr[r] = row < n ? zsq[row] : 0.f;
  }
  float acc[kHeads][TM];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[h][r] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int m0 = t * kBlockM;
    for (int e = tid; e < kHeads * kBlockM; e += kThreads) {
      const int h = e / kBlockM, c = e % kBlockM;
      const int sv = m0 + c;
      as[h][c] = (h < kh && sv < m) ? A[(size_t)(k0 + h) * m + sv] : 0.f;
    }
    if (tid < kBlockM) xsq_s[tid] = (m0 + tid < m) ? xsq[m0 + tid] : 0.f;

    float dot[TM][kTN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) dot[r][c] = 0.f;

    fetch(0, m0);
    stash(0);
    __syncthreads();
    int buf = 0;
    for (int d0 = 0; d0 < d; d0 += kBlockD) {
      const bool more = d0 + kBlockD < d;
      if (more) fetch(d0 + kBlockD, m0);
#pragma unroll
      for (int dd = 0; dd < kBlockD; ++dd) {
        float a[TM], b[kTN];
        load_vec(&zs[buf][dd][ty * TM], a);
        load_vec(&xs[buf][dd][tx * kTN], b);
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < kTN; ++c) dot[r][c] = fmaf(a[r], b[c], dot[r][c]);
      }
      if (more) stash(buf ^ 1);
      __syncthreads();  // stage buf^1 is complete; buf is refilled only after this
      buf ^= 1;
    }

    // One distance, every head's accumulator (SVs past m carry a = 0).
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int cc = tx * kTN + c;
      const float xq = xsq_s[cc];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float d2 = fmaxf(zr[r] + xq - 2.f * dot[r][c], 0.f);
        const float w = expf(-gamma * d2);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) acc[h][r] = fmaf(w, as[h][cc], acc[h][r]);
      }
    }
    __syncthreads();  // as / xsq_s are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = row0 + ty * TM + r;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const float s = lane16_sum(acc[h][r]);
      if (tx == 0 && row < n && h < kh) part[((size_t)split * n + row) * K + k0 + h] = s;
    }
  }
}

__global__ void rbf_finalize(const float* __restrict__ part, int splits, int n, int K,
                             const float* __restrict__ b, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * K) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * n * K + idx];  // split order
  out[idx] = s + b[idx % K];
}

template <int BN>
void launch_partial(const float* Z, const float* X, const float* A, const float* zsq,
                    const float* xsq, const float* gamma, int n, int m, int d, int K,
                    int splits, float* part, cudaStream_t stream) {
  const int m_tiles = (m + kBlockM - 1) / kBlockM;
  const int per_split = (m_tiles + splits - 1) / splits;
  const dim3 grid((n + BN - 1) / BN, splits, (K + kHeads - 1) / kHeads);
  rbf_partial<BN><<<grid, kThreads, 0, stream>>>(Z, X, A, zsq, xsq, gamma, n, m, d, K,
                                                 per_split, part);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Z (n, d), X (m, d), A (K, m), gamma (1,), b (K,): f32, contiguous, on the
// device. zsq (n,), xsq (m,) and part (splits, n, K) are scratch. Writes
// out (n, K).
int rbf_scores_f32(const float* Z, const float* X, const float* A, const float* gamma,
                   const float* b, int n, int m, int d, int K, int block_n, int splits,
                   float* zsq, float* xsq, float* part, float* out, cudaStream_t stream) {
  if (n <= 0 || m <= 0 || d <= 0 || K <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  if (block_n != 64 && block_n != 32) return (int)cudaErrorInvalidValue;
  sqnorm_rows<<<(n * 32 + 255) / 256, 256, 0, stream>>>(Z, n, d, zsq);
  sqnorm_rows<<<(m * 32 + 255) / 256, 256, 0, stream>>>(X, m, d, xsq);
  if (block_n == 64) {
    launch_partial<64>(Z, X, A, zsq, xsq, gamma, n, m, d, K, splits, part, stream);
  } else {
    launch_partial<32>(Z, X, A, zsq, xsq, gamma, n, m, d, K, splits, part, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = n * K;
  rbf_finalize<<<(total + 255) / 256, 256, 0, stream>>>(part, splits, n, K, b, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
