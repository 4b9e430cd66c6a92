// Exact RBF expansion, streamed over support-vector tiles (Eq 3.2).
//
// Replaces repro/kernels/rbf_pred/kernel.py::rbf_predict_pallas (body
// _kernel), with the engine's vmap over heads (serve/svm_engine.py, the
// slow path) written out as a head dimension:
//
//   out[n,k] = sum_i A[k,i] exp(-gamma max(|z|^2 + |x_i|^2 - 2 z.x_i, 0)) + b[k]
//
// What bounds it on an H100: 2 n m d flops of f32-accurate products for the
// distances against (n + m) d floats of input. At n=256, m=16384, d=780
// that is 6.5 GFLOP (0.040 ms at the 3xTF32 rate, 495 / 3 TFLOP/s) against
// 52 MB (16 us at 3.35 TB/s): bound by operations. At a few fallback rows
// (n <= 32) it turns bound by bytes, streaming X once.
//
// Design. The function has the shape of attention: the queries are Z, the
// keys X, the values A^T (dv = K heads), with no softmax normalisation or
// mask. So it runs on the tile engine's fragments (attn_tile.cuh), with
// S streamed over the feature axis since d is wider than a tile. A block
// of BN/16 warps owns (a tile of BN rows of Z, one run of 64-SV tiles, up
// to 16 heads); a warp owns 16 rows. Per SV tile, S = Z X_t^T comes as
// mma.m16n8k8 fragments (3xTF32, the engine's qk_step_tf32) from 64-deep
// stages of Z and X_t, which cp.async brings into a ring of three, so two
// copies are in flight while the MMAs run on the third. After the tile's
// last stage, w = exp(-gamma max(zsq + xsq - 2S, 0)) is formed in place,
// as the reference forms it, and acc += W A_t^T runs on the tensor cores
// with S's registers as the A operand (the engine's P V key order, heads
// padded with zeros to 16). The tile's coefficients (transposed to SV
// rows) ride in the ring slot of that last stage; |x_i|^2 is summed from
// the staged X tiles themselves (a few threads an SV, a fixed shuffle
// tree), so X is read once a row tile and never by a pass of its own;
// |z|^2 comes from a warp-per-row pass. Each distance is computed once and
// shared by every head; the (n, m) kernel matrix never reaches device
// memory. Runs of SV tiles are spread over blocks (split-K; row tiles are
// the fastest grid axis, so blocks that stream the same SVs run side by
// side and share them in L2); each block writes its per-row, per-head
// partial sums, and a second pass, a warp an output, adds them in a fixed
// order plus the bias. Heads past 16 take the grid's z axis. No atomics:
// bitwise the same every run. Ragged SV, row, head and feature edges are
// zero-filled by the copies (an SV past m carries a = 0), so nothing is
// padded in memory.
//
// Precision. The sums over SVs cancel (a head's coefficients sum to zero),
// so B2 is held to float64 through its f32 twin, not to a tolerance
// relative to its output, and every rounding the twin does not make shows.
// - S: the tensor cores' truncating accumulation of the hi*hi products
//   runs over two k-steps, which are then added to S in f32 with rounding;
//   the small terms run over the stage. Non-negative features give every
//   product one sign, so a longer run pulls every S one way, and d2 turns
//   that into a bias of every weight that the sums over SVs keep.
// - |x_i|^2: a thread's squares and then the kParts partial sums of an SV
//   are added with their rounding errors carried beside them (TwoSum). A
//   plain f32 chain, up to 780 squares long at BN = 32 (one thread an SV),
//   set B2's error at a few rows.
// - W A_t^T: w and a are each split into three TF32 terms (about 33 bits),
//   and the six products down to order 2^-22 are taken. Two terms keep
//   about 22 bits, and those roundings, summed over 16384 SVs, come to the
//   size of the f32 twin's whole error.
// - Each k-step of W A_t^T starts from zero and is added to the running sum
//   with its rounding error carried (TwoSum): no truncating accumulation
//   runs longer than 8 SVs, and the running sum keeps its low bits.

#include "attn_tile.cuh"

namespace {

constexpr int kSVs = 64;                      // SVs of a tile
constexpr int kDepth = 64;                    // features of a stage
constexpr int kHeads = 16;                    // heads of a block: two n8 tiles
constexpr int kStages = 3;                    // cp.async ring
constexpr int kStride = kDepth + 4;           // A and B fragment rows 4 banks apart
constexpr int kAStride = kHeads + 4;          // A_t^T's B fragment rows 4 banks apart
constexpr int kTiles = attn_tile::kKeyTiles;  // n8 tiles of a warp's 16 x 64 scores
static_assert(kSVs == attn_tile::kRows, "one key tile of the engine");

// (hi, lo) += x: hi the f32 sum, lo the rounding errors so far (TwoSum:
// exact whatever the magnitudes).
__device__ __forceinline__ void two_sum(float& hi, float& lo, float x) {
  const float s = hi + x;
  const float b = s - hi;
  lo += (hi - (s - b)) + (x - b);
  hi = s;
}

// s += Z_s X_s^T over one 64-deep stage, for a warp's 16 rows x 64 SVs:
// the engine's 3xTF32 k-step, its hi*hi products run from zero over each
// pair of k-steps and then added to s in f32, so the tensor cores truncate
// no sum longer than 16 products; the small terms accumulate over the stage
// in their own registers.
__device__ __forceinline__ void stage_scores(float (&s)[kTiles][4], const float* zs,
                                             const float* xs, int warp, int g, int t) {
  float small[kTiles][4], pair[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = pair[j][e] = 0.f;
  const float* zr = zs + (warp * 16 + g) * kStride + t;
  const float* xr = xs + g * kStride + t;
#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) {
    attn_tile::qk_step_tf32<kStride>(pair, small, zr, xr, kk);
    if (kk % 2 == 1) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += pair[j][e], pair[j][e] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += small[j][e];
}

// x = hi + mid + lo to about 33 bits, each term TF32: hi and mid rounded
// to nearest as split_tf32 rounds hi, lo passed as split_tf32 passes its lo.
__device__ __forceinline__ void split3_tf32(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float r = x - __uint_as_float(hi);
  mid = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(r - __uint_as_float(mid)) + 0x1000u;
}

// (acc, lo) += W A_t^T for a warp's 16 rows x 64 SVs and 16 heads. k-step
// j is S's n-tile j, its SVs 2t and 2t + 1 taken at k = t and t + 4 (the
// engine's P V order), A's rows read in that order. w and a in three TF32
// terms each; per k-step the five small products (hi*mid, mid*hi, hi*lo,
// lo*hi, mid*mid) and hi*hi run from zero over independent accumulators,
// then join (acc, lo) by TwoSum.
__device__ __forceinline__ void pv_scores(float (&acc)[kHeads / 8][4],
                                          float (&lo)[kHeads / 8][4],
                                          const float (&p)[kTiles][4], const float* as, int g,
                                          int t) {
  constexpr int G = kHeads / 8;
  const float* ar = as + 2 * t * kAStride + g;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    uint32_t wh[4], wm[4], wl[4], ah[G][2], am[G][2], al[G][2];
    split3_tf32(p[j][0], wh[0], wm[0], wl[0]);  // (g, SV 2t)
    split3_tf32(p[j][2], wh[1], wm[1], wl[1]);  // (g + 8, SV 2t)
    split3_tf32(p[j][1], wh[2], wm[2], wl[2]);  // (g, SV 2t + 1)
    split3_tf32(p[j][3], wh[3], wm[3], wl[3]);  // (g + 8, SV 2t + 1)
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float* x = ar + 8 * j * kAStride + 8 * i;
      split3_tf32(x[0], ah[i][0], am[i][0], al[i][0]);         // A[8i + g][8j + 2t]
      split3_tf32(x[kAStride], ah[i][1], am[i][1], al[i][1]);  // A[8i + g][8j + 2t + 1]
    }
    float big[G][4], mid[G][4], small[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[i][e] = mid[i][e] = small[i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) ptx::mma_tf32(small[i], wl, ah[i][0], ah[i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i) ptx::mma_tf32(mid[i], wm, ah[i][0], ah[i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i) ptx::mma_tf32(small[i], wh, al[i][0], al[i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i) ptx::mma_tf32(mid[i], wh, am[i][0], am[i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i) ptx::mma_tf32(small[i], wm, am[i][0], am[i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i) ptx::mma_tf32(big[i], wh, ah[i][0], ah[i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        two_sum(acc[i][e], lo[i][e], big[i][e] + (mid[i][e] + small[i][e]));
  }
}

template <int BN>
struct Smem {
  static constexpr int kZ = BN * kStride;
  static constexpr int kX = kSVs * kStride;
  static constexpr int kA = kSVs * kAStride;
  static constexpr int kStage = kZ + kX + kA;
  static constexpr int kNorms = kStages * kStage;  // then |x_i|^2 of the tile in hand
  static constexpr size_t kBytes = (size_t)(kNorms + kSVs) * sizeof(float);
  // |x_i|^2 is summed from the staged X tiles: kParts threads an SV
  static constexpr int kParts = 2 * BN / kSVs;
  static_assert(kBytes <= 232448 && kParts >= 1 && kParts <= 32, "tiling");
};

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

template <int BN>
__global__ void __launch_bounds__(2 * BN, 1)
    rbf_tf32(const float* __restrict__ Z, const float* __restrict__ X,
             const float* __restrict__ A, const float* __restrict__ zsq,
             const float* __restrict__ gamma_p, int n, int m, int d, int K,
             int tiles_per_split, bool vec, float* __restrict__ part) {
  constexpr int kThreads = 2 * BN;  // BN / 16 warps
  using L = Smem<BN>;
  extern __shared__ __align__(16) float smem[];
  const auto zs = [&](int st) { return smem + st * L::kStage; };
  const auto xs = [&](int st) { return smem + st * L::kStage + L::kZ; };
  const auto as = [&](int st) { return smem + st * L::kStage + L::kZ + L::kX; };
  float* const xn = smem + L::kNorms;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int k0 = blockIdx.z * kHeads;
  const int kh = min(kHeads, K - k0);
  const int m_tiles = (m + kSVs - 1) / kSVs;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(m_tiles, t_begin + tiles_per_split);
  const int depth = (d + kDepth - 1) / kDepth;  // stages of a tile
  const int stages = max(0, t_end - t_begin) * depth;
  const float gamma = *gamma_p;

  // Stage s: SV tile t_begin + s / depth, features (s % depth) * 64 ..; the
  // tile's last stage also brings its coefficients.
  const auto issue = [&](int s) {
    const int m0 = (t_begin + s / depth) * kSVs, d0 = (s % depth) * kDepth;
    const int st = s % kStages;
    ptx::copy_tile<BN, kStride, kThreads>(zs(st), Z, row0, n, d0, d, d, vec);
    ptx::copy_tile<kSVs, kStride, kThreads>(xs(st), X, m0, m, d0, d, d, vec);
    if (s % depth != depth - 1) return;
    for (int e = threadIdx.x; e < kSVs * kHeads; e += kThreads) {
      const int c = e % kSVs, h = e / kSVs;  // neighbouring threads, neighbouring SVs
      const bool ok = h < kh && m0 + c < m;
      ptx::cp_async4(as(st) + c * kAStride + h, ok ? A + (size_t)(k0 + h) * m + m0 + c : A,
                     ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) issue(s);
    ptx::cp_async_commit();
  }

  const int x_sv = threadIdx.x / L::kParts, x_part = threadIdx.x % L::kParts;
  // this thread's share of |x|^2 of SV x_sv of the tile in hand, and its
  // rounding errors
  float x_sq = 0.f, x_lo = 0.f;
  float zr[2];  // |z|^2 of rows g and g + 8 of the warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + g + 8 * h;
    zr[h] = row < n ? zsq[row] : 0.f;
  }
  float srun[kTiles][4], acc[kHeads / 8][4], alo[kHeads / 8][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) srun[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kHeads / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = alo[j][e] = 0.f;

  for (int s = 0; s < stages; ++s) {
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1's slot
    if (s + kStages - 1 < stages) issue(s + kStages - 1);
    ptx::cp_async_commit();
    const int st = s % kStages;
    {  // |x_i|^2 over the stage's features, errors carried; lanes spread on banks
      const float* x = xs(st) + x_sv * kStride + x_part;
#pragma unroll 8
      for (int i = 0; i < kDepth / L::kParts; ++i) {
        const int c = L::kParts == 1 ? (i + x_sv) % kDepth : i;
        const float v = x[L::kParts * c];
        two_sum(x_sq, x_lo, v * v);
      }
    }
    const bool last = s % depth == depth - 1;
    if (last) {  // the tile's SV norms, its kParts lanes by a fixed tree
#pragma unroll
      for (int off = 1; off < L::kParts; off <<= 1) {
        const float oh = __shfl_xor_sync(0xffffffffu, x_sq, off);
        const float ol = __shfl_xor_sync(0xffffffffu, x_lo, off);
        two_sum(x_sq, x_lo, oh);
        x_lo += ol;
      }
      x_sq += x_lo;
      if (x_part == 0) xn[x_sv] = x_sq;
      x_sq = x_lo = 0.f;
      __syncthreads();
    }
    stage_scores(srun, zs(st), xs(st), warp, g, t);
    if (!last) continue;
    // The tile's S is complete: its weights in place, then every head's sum.
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d2 = fmaxf(zr[e >> 1] + xn[8 * j + 2 * t + (e & 1)] - 2.f * srun[j][e], 0.f);
        srun[j][e] = expf(-gamma * d2);
      }
    pv_scores(acc, alo, srun, as(st), g, t);
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) srun[j][e] = 0.f;
  }
  ptx::cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kHeads / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + warp * 16 + g + 8 * (e >> 1);
      const int h = 8 * j + 2 * t + (e & 1);
      if (row < n && h < kh)
        part[((size_t)row * K + k0 + h) * gridDim.y + split] = acc[j][e] + alo[j][e];
    }
}

// One warp an output: its lanes add the output's split partials (contiguous
// in part) in strided order, then a fixed butterfly; plus the bias.
constexpr int kFinalWarps = 8;
__global__ void rbf_finalize(const float* __restrict__ part, int splits, int total, int K,
                             const float* __restrict__ b, float* __restrict__ out) {
  const int idx = blockIdx.x * kFinalWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= total) return;  // whole warps leave together
  const float* p = part + (size_t)idx * splits;
  float s = 0.f;
  for (int q = lane; q < splits; q += 32) s += p[q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[idx] = s + b[idx % K];
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int BN>
cudaError_t launch_partial(const float* Z, const float* X, const float* A, const float* zsq,
                           const float* gamma, int n, int m, int d, int K, int splits,
                           float* part, cudaStream_t stream) {
  const int m_tiles = (m + kSVs - 1) / kSVs;
  const int per_split = (m_tiles + splits - 1) / splits;
  const bool vec = d % 4 == 0 && aligned16(Z) && aligned16(X);
  constexpr size_t bytes = Smem<BN>::kBytes;
  static bool opted[ptx::kMaxDevices] = {};
  const cudaError_t err = ptx::allow_smem(rbf_tf32<BN>, (int)bytes, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, splits, (K + kHeads - 1) / kHeads);
  rbf_tf32<BN><<<grid, 2 * BN, bytes, stream>>>(Z, X, A, zsq, gamma, n, m, d, K, per_split,
                                                vec, part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Z (n, d), X (m, d), A (K, m), gamma (1,), b (K,): f32, contiguous, on the
// device. zsq (n,) and part (n, K, splits) are scratch. Writes out (n, K).
int rbf_scores_f32(const float* Z, const float* X, const float* A, const float* gamma,
                   const float* b, int n, int m, int d, int K, int block_n, int splits,
                   float* zsq, float* part, float* out, cudaStream_t stream) {
  if (n <= 0 || m <= 0 || d <= 0 || K <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  if (block_n != 128 && block_n != 64 && block_n != 32) return (int)cudaErrorInvalidValue;
  sqnorm_rows<<<(n * 32 + 255) / 256, 256, 0, stream>>>(Z, n, d, zsq);
  cudaError_t err;
  if (block_n == 128) {
    err = launch_partial<128>(Z, X, A, zsq, gamma, n, m, d, K, splits, part, stream);
  } else if (block_n == 64) {
    err = launch_partial<64>(Z, X, A, zsq, gamma, n, m, d, K, splits, part, stream);
  } else {
    err = launch_partial<32>(Z, X, A, zsq, gamma, n, m, d, K, splits, part, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int total = n * K;
  rbf_finalize<<<(total + kFinalWarps - 1) / kFinalWarps, 32 * kFinalWarps, 0, stream>>>(
      part, splits, total, K, b, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
