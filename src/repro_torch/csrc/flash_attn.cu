// Fused softmax attention with an online softmax, causal or full (B9).
//
// Replaces repro/kernels/flash_attn/kernel.py::flash_attention_pallas (body
// _kernel). For every (batch*head) b, q and k (T, D), v (T, DV):
//
//   s    = scale q k^T,  masked to NEG_INF = -1e30 above the diagonal
//   m'   = max(m, rowmax(s));  p = exp(s - m');  l' = l e^(m - m') + rowsum(p)
//   acc' = acc e^(m - m') + p v;  out = acc / l after the last key tile
//
// What bounds it on an H100: 4 T^2 D flops a head (half of them under a
// causal mask). At the smollm-135m prefill shape (b = 4 x 9 heads, T = 2048,
// D = DV = 64) that is 19.3 GFLOP against 37.7 MB of bf16 inputs and output:
// bound by operations, 0.0195 ms at the bf16 tensor-core rate. This first
// kernel uses no tensor cores: every product is an fp32 FMA (67 TFLOP/s,
// 0.29 ms), so a bf16 input is widened to f32 as it is staged, P stays f32
// for P.V exactly as the reference multiplies its f32 p by v promoted to
// f32, and the f32 instantiation is IEEE f32 throughout (no TF32).
//
// Design. The TPU kernel ran a sequential kv grid axis and carried (m, l,
// acc) in VMEM scratch from step to step. Here one block owns (b, a tile of
// BQ query rows) and loops over the key tiles itself; m and l live in
// registers, acc in registers (RQ rows x CV columns a thread), so nothing
// crosses blocks. 256 threads form a 16 x 16 grid: thread (ty, tx) owns
// rows ty*RQ .. ty*RQ+RQ-1 of the tile, score columns tx + 16c and output
// columns tx + 16c; the 16 threads of a row are 16 adjacent lanes, so row
// max and row sum are four xor-shuffles. Per key tile: K (transposed) and V
// are staged in shared memory as f32, S is built from D rank-1 updates,
// masked, turned into P in registers and stored to shared memory, and P.V
// is accumulated. Under a causal mask the key tiles wholly above the
// diagonal are not visited: this changes no number, since the first tile
// holds column 0 <= every row (so m is finite after it) and a masked entry
// adds exp(-1e30 - m) = 0. Ragged edges (T not a multiple of a tile, DV
// below the compiled width) are masked in the kernel: padded keys are -1e30
// and padded rows are not written, so nothing is padded in memory. Blocks
// take the longest causal rows first. The output is written in q's type
// (round to nearest even for bf16, as the reference's astype).
//
// Compiled for one 64 x 64 tile (BQ = BK = 64: RQ = CK = 4) and DV up to 64
// or 128 (CV = 4, 8): two variants. D <= 128 is a runtime loop bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kMaxD = 128;
constexpr int kRQ = 4;  // query rows a thread owns: BQ = 16 kRQ = 64
constexpr int kCK = 4;  // score columns a thread owns: BK = 16 kCK = 64

__device__ __forceinline__ float load_f32(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int RQ, int CK, int CV>
__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)D * (16 * RQ + 1) + (size_t)D * (16 * CK + 1) + 16 * CK * 16 * CV +
         16 * RQ * (16 * CK + 1);
}

template <int RQ, int CK, int CV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const void* __restrict__ q, const void* __restrict__ k,
              const void* __restrict__ v, void* __restrict__ out, int T, int D, int DV,
              float scale, int causal, int bf16) {
  constexpr int BQ = 16 * RQ, BK = 16 * CK, DVM = 16 * CV;
  extern __shared__ float smem[];
  float* qs = smem;                // [D][BQ + 1]  Q tile, transposed
  float* ks = qs + D * (BQ + 1);   // [D][BK + 1]  K tile, transposed
  float* vs = ks + D * (BK + 1);   // [BK][DVM]    V tile, zero past DV
  float* ps = vs + BK * DVM;       // [BQ][BK + 1] probabilities of the tile

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const bool is_bf16 = bf16 != 0;
  const size_t qk_base = (size_t)bh * T * D;
  const size_t v_base = (size_t)bh * T * DV;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    qs[c * (BQ + 1) + r] = row < T ? load_f32(q, qk_base + (size_t)row * D + c, is_bf16) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CV];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(T, row0 + BQ) : T;
  for (int col0 = 0; col0 < kv_end; col0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < BK * D; e += kThreads) {
      const int j = e / D, c = e % D;
      const int col = col0 + j;
      ks[c * (BK + 1) + j] = col < T ? load_f32(k, qk_base + (size_t)col * D + c, is_bf16) : 0.f;
    }
    for (int e = tid; e < BK * DVM; e += kThreads) {
      const int j = e / DVM, c = e % DVM;
      const int col = col0 + j;
      vs[e] = (col < T && c < DV) ? load_f32(v, v_base + (size_t)col * DV + c, is_bf16) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], b[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qs[d * (BQ + 1) + ty * RQ + i];
#pragma unroll
      for (int c = 0; c < CK; ++c) b[c] = ks[d * (BK + 1) + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[i][c] = fmaf(a[i], b[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = row0 + ty * RQ + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = col0 + tx + kLanes * c;
        float x = scale * s[i][c];
        if ((causal && col > row) || col >= T) x = kNegInf;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = expf(s[i][c] - m_new);
        ps[(ty * RQ + i) * (BK + 1) + tx + kLanes * c] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum16(sum);
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[RQ], w[CV];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = ps[(ty * RQ + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CV; ++c) w[c] = vs[j * DVM + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = row0 + ty * RQ + i;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int col = tx + kLanes * c;
      if (col >= DV) continue;
      const float x = acc[i][c] / l[i];
      const size_t o = v_base + (size_t)row * DV + col;
      if (is_bf16) {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(x);
      } else {
        static_cast<float*>(out)[o] = x;
      }
    }
  }
}

template <int RQ, int CK, int CV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int T,
                   int D, int DV, float scale, int causal, int bf16, cudaStream_t stream) {
  const size_t smem = smem_floats<RQ, CK, CV>(D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<RQ, CK, CV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + 16 * RQ - 1) / (16 * RQ), BH);
  flash_fwd<RQ, CK, CV><<<grid, kThreads, smem, stream>>>(q, k, v, out, T, D, DV, scale,
                                                          causal, bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k (BH, T, D), v (BH, T, DV), out (BH, T, DV): contiguous, all f32 or
// all bf16 (bf16 != 0), on the device. 1 <= D <= 128, 1 <= DV <= 128.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, int BH, int T,
                   int D, int DV, float scale, int causal, int bf16, cudaStream_t stream) {
  if (BH <= 0 || T <= 0 || D <= 0 || D > kMaxD || DV <= 0 || DV > 128)
    return (int)cudaErrorInvalidValue;
  if (DV <= 64)
    return (int)launch<kRQ, kCK, 4>(q, k, v, out, BH, T, D, DV, scale, causal, bf16, stream);
  return (int)launch<kRQ, kCK, 8>(q, k, v, out, BH, T, D, DV, scale, causal, bf16, stream);
}

}  // extern "C"
