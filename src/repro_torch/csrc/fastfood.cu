// Fused Fastfood (structured random-Fourier-feature) scoring, off f32 (B6)
// or int8 (B7) operators.
//
// Replaces repro/kernels/fwht/kernel.py::fastfood_score_pallas (bodies
// _kernel and _transform) and fastfood_score_q8_pallas (body _kernel_q8).
// For K heads over one batch Z (n, d), zero-padded to d' = 2^ceil(log2 d),
// and ``stacks`` operators of d' features each (F = stacks d'):
//
//   proj_s = fwht(fwht(z * B_s)[Pi_s] * G_s) * S_s
//   out[n,k] = sv_k sum_f wt[k,f] cos(proj[f] + phase[f]) + b_k
//
// fwht is the unnormalized Walsh-Hadamard transform, [Pi_s] the gather
// t[perm_s[j]]. B6 has f32 B, G, S, phase, wt, int32 perm and sv = 1. B7
// reads the int8 artifact as stored: B (exact +-1), G and S int8, the
// per-stack product of the G and S scales (stack_scale, folded onto S),
// int16 perm, f16 phase (__half2float), int8 wt with one scale per head
// (sv, applied once in the second pass).
//
// What bounds it on an H100 (fp32, no tensor cores): per row and stack,
// two transforms of d' log2 d' adds, the diagonals, the gather, d' cosines
// and 2 d' K readout flops; the operators are O(F) and read from L1/L2.
// At n=1024, F=4096, d'=1024, K=10 that is ~0.2 GFLOP (3 us at 67 TFLOP/s)
// against 3.2 MB of Z (1 us at 3.35 TB/s): bound by operations. The dense
// projection it stands for would be 6.5 GFLOP.
//
// Design. The TPU kernel kept a (rows, d') tile and every operator
// resident in VMEM and unrolled the stacks. Here one warp owns a row:
// L = min(32, d') lanes hold its d' values, E = d'/L in each lane's
// registers (value j of lane l is element j L + l). A butterfly stage of
// stride h < L pairs lanes l and l ^ h (__shfl_xor_sync); a stride of L or
// more pairs two registers of one lane. So both transforms run with no
// shared memory and no block barrier. The permutation is the one step
// that crosses lanes arbitrarily: the warp writes its row to its own d'
// floats of shared memory, __syncwarp, and gathers. At d' < 32 a warp
// holds 32 / d' rows side by side. cosf, never __cosf: the projection
// spans radians, and the fast intrinsic loses accuracy outside [-pi, pi].
// Each cosine feeds up to 16 heads' accumulators at once; the L lanes of a
// row then sum by shuffles. A block owns (block_n rows, one stack, up to
// 16 heads); stacks are spread over blocks and each writes its per-row,
// per-head partial sums; a second pass adds the stacks in stack order,
// then the head scale and the bias. No atomics: bitwise the same every
// run. F = stacks d' exactly, so no feature is padded, and Z's columns
// past d are zeros. d' is a template argument (2 .. 2048): the transform
// indexes registers with constants only.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 16;  // heads accumulated per block

template <bool kInt8>
struct Operands;
template <>
struct Operands<false> {
  using Diag = float;
  using Perm = int32_t;
  using Phase = float;
};
template <>
struct Operands<true> {
  using Diag = int8_t;
  using Perm = int16_t;
  using Phase = __half;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <int N>
__host__ __device__ constexpr int log2_of() {
  return N <= 1 ? 0 : 1 + log2_of<N / 2>();
}

// H x over one row held by L lanes, E values a lane (value j of lane l is
// element j L + l). Every lane of the warp takes part in every shuffle.
// The stage loops count to compile-time constants, so they unroll and v
// stays in registers.
template <int L, int E>
__device__ __forceinline__ void fwht_row(float (&v)[E], int l) {
  constexpr int kStagesL = log2_of<L>(), kStagesE = log2_of<E>();
#pragma unroll
  for (int t = 0; t < kStagesL; ++t) {
    const int h = 1 << t;
    const bool hi = (l & h) != 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float p = __shfl_xor_sync(0xffffffffu, v[j], h);
      v[j] = hi ? __fsub_rn(p, v[j]) : __fadd_rn(v[j], p);
    }
  }
#pragma unroll
  for (int t = 0; t < kStagesE; ++t) {
    const int s = 1 << t;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & s) == 0) {
        const float a = v[j], b = v[j | s];
        v[j] = __fadd_rn(a, b);
        v[j | s] = __fsub_rn(a, b);
      }
    }
  }
}

template <bool kInt8, int DD>
__global__ void __launch_bounds__(kThreads)
    fastfood_partial(const float* __restrict__ Z,
                     const typename Operands<kInt8>::Diag* __restrict__ B,
                     const typename Operands<kInt8>::Diag* __restrict__ G,
                     const typename Operands<kInt8>::Perm* __restrict__ perm,
                     const typename Operands<kInt8>::Diag* __restrict__ S,
                     const float* __restrict__ stack_scale,
                     const typename Operands<kInt8>::Phase* __restrict__ phase,
                     const typename Operands<kInt8>::Diag* __restrict__ wt, int n, int d,
                     int K, int block_n, float* __restrict__ part) {
  constexpr int L = DD < 32 ? DD : 32;  // lanes a row
  constexpr int RW = 32 / L;            // rows a warp holds at once
  constexpr int E = DD / L;             // values a lane
  extern __shared__ float rows_s[];     // kWarps * RW rows of DD floats

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = lane % L, rl = lane / L;
  const int s = blockIdx.y;
  const int F = static_cast<int>(gridDim.y) * DD;
  const int k0 = static_cast<int>(blockIdx.z) * kHeads;
  const int kh = min(kHeads, K - k0);
  const int row_end = min(n, static_cast<int>(blockIdx.x + 1) * block_n);
  const size_t off = static_cast<size_t>(s) * DD;
  const float ss = kInt8 ? stack_scale[s] : 1.f;
  float* row_s = rows_s + (warp * RW + rl) * DD;

  // r0 is the same in every lane of a warp, so the shuffles below always
  // see the whole warp; rows past the end compute on zeros and write
  // nothing.
  for (int r0 = static_cast<int>(blockIdx.x) * block_n + warp * RW; r0 < row_end;
       r0 += kWarps * RW) {
    const int row = r0 + rl;
    const bool live = row < row_end;
    float v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = j * L + l;
      const float z = (live && i < d) ? Z[static_cast<size_t>(row) * d + i] : 0.f;
      v[j] = __fmul_rn(z, to_f32(B[off + i]));
    }
    fwht_row<L, E>(v, l);
#pragma unroll
    for (int j = 0; j < E; ++j) row_s[j * L + l] = v[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = j * L + l;
      v[j] = __fmul_rn(row_s[perm[off + i]], to_f32(G[off + i]));
    }
    __syncwarp();  // the next row overwrites row_s
    fwht_row<L, E>(v, l);

    float acc[kHeads];
#pragma unroll
    for (int h = 0; h < kHeads; ++h) acc[h] = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = j * L + l;
      float sc = to_f32(S[off + i]);
      if (kInt8) sc = __fmul_rn(sc, ss);
      const float c = cosf(__fadd_rn(__fmul_rn(v[j], sc), to_f32(phase[off + i])));
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const size_t w = static_cast<size_t>(k0 + h) * F + off + i;
        if (h < kh) acc[h] = fmaf(c, to_f32(wt[w]), acc[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      float a = acc[h];
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (l == 0 && live && h < kh) part[(static_cast<size_t>(s) * n + row) * K + k0 + h] = a;
    }
  }
}

__global__ void fastfood_finalize(const float* __restrict__ part, int stacks, int n, int K,
                                  const float* __restrict__ wt_scale,
                                  const float* __restrict__ b, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * K) return;
  float s = 0.f;
  for (int p = 0; p < stacks; ++p) s += part[static_cast<size_t>(p) * n * K + idx];  // stack order
  const int k = idx % K;
  if (wt_scale != nullptr) s = __fmul_rn(s, wt_scale[k]);
  out[idx] = s + b[k];
}

template <bool kInt8>
struct Args {
  const float* Z;
  const typename Operands<kInt8>::Diag *B, *G;
  const typename Operands<kInt8>::Perm* perm;
  const typename Operands<kInt8>::Diag* S;
  const float* stack_scale;
  const typename Operands<kInt8>::Phase* phase;
  const typename Operands<kInt8>::Diag* wt;
  int n, d, stacks, K, block_n;
  float* part;
  cudaStream_t stream;
};

template <bool kInt8, int DD>
cudaError_t launch_partial(const Args<kInt8>& a) {
  constexpr int L = DD < 32 ? DD : 32;
  const int smem = static_cast<int>(sizeof(float)) * kWarps * (32 / L) * DD;
  if (smem > 48 * 1024) {  // d' = 2048: 64 KB, only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        fastfood_partial<kInt8, DD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.n + a.block_n - 1) / a.block_n, a.stacks, (a.K + kHeads - 1) / kHeads);
  fastfood_partial<kInt8, DD><<<grid, kThreads, smem, a.stream>>>(
      a.Z, a.B, a.G, a.perm, a.S, a.stack_scale, a.phase, a.wt, a.n, a.d, a.K, a.block_n,
      a.part);
  return cudaGetLastError();
}

template <bool kInt8>
int run(const Args<kInt8>& a, int dd, const float* wt_scale, const float* bias, float* out) {
  if (a.n <= 0 || a.d <= 0 || a.d > dd || a.stacks <= 0 || a.stacks > 65535 || a.K <= 0 ||
      a.block_n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dd) {
    case 2: err = launch_partial<kInt8, 2>(a); break;
    case 4: err = launch_partial<kInt8, 4>(a); break;
    case 8: err = launch_partial<kInt8, 8>(a); break;
    case 16: err = launch_partial<kInt8, 16>(a); break;
    case 32: err = launch_partial<kInt8, 32>(a); break;
    case 64: err = launch_partial<kInt8, 64>(a); break;
    case 128: err = launch_partial<kInt8, 128>(a); break;
    case 256: err = launch_partial<kInt8, 256>(a); break;
    case 512: err = launch_partial<kInt8, 512>(a); break;
    case 1024: err = launch_partial<kInt8, 1024>(a); break;
    case 2048: err = launch_partial<kInt8, 2048>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = a.n * a.K;
  fastfood_finalize<<<(total + 255) / 256, 256, 0, a.stream>>>(a.part, a.stacks, a.n, a.K,
                                                               wt_scale, bias, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// B6. Z (n, d); B, G, S (stacks, dd); perm (stacks, dd) int32; phase (F,);
// wt (K, F); bias (K,): f32 unless said, contiguous, on the device, with
// dd a power of two in [2, 2048], d <= dd and F = stacks dd. part
// (stacks, n, K) is scratch. Writes out (n, K).
int fastfood_score_f32(const float* Z, const float* B, const float* G, const int32_t* perm,
                       const float* S, const float* phase, const float* wt, const float* bias,
                       int n, int d, int dd, int stacks, int K, int block_n, float* part,
                       float* out, cudaStream_t stream) {
  const Args<false> a{Z, B, G, perm, S, nullptr, phase, wt, n, d, stacks, K, block_n, part,
                      stream};
  return run<false>(a, dd, nullptr, bias, out);
}

// B7. As B6, with B, G, S and wt int8, perm int16, phase f16, the per-stack
// G*S scales stack_scale (stacks,) and the head scales wt_scale (K,) f32.
int fastfood_score_q8(const float* Z, const int8_t* B, const int8_t* G, const int16_t* perm,
                      const int8_t* S, const float* stack_scale, const __half* phase,
                      const int8_t* wt, const float* wt_scale, const float* bias, int n, int d,
                      int dd, int stacks, int K, int block_n, float* part, float* out,
                      cudaStream_t stream) {
  const Args<true> a{Z, B, G, perm, S, stack_scale, phase, wt, n, d, stacks, K, block_n, part,
                     stream};
  return run<true>(a, dd, wt_scale, bias, out);
}

}  // extern "C"
