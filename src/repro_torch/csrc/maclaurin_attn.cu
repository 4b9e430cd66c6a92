// Causal Maclaurin attention, w(u) = 1 + u + u^2/2 (B8), by two routes.
//
// Replaces repro/kernels/maclaurin_attn/kernel.py::maclaurin_attention_pallas
// (body _kernel). For every (batch*head) b, q and k (T, D), v (T, DV), with
// u = scale q_t.k_j:
//
//   out_t = sum_{j<=t} w(u_tj) v_j / sum_{j<=t} w(u_tj)
//
// What bounds it on an H100: the function needs the smaller of two counts.
// The causal quadratic form does T (T + 1) / 2 (2 D + 2 DV + 6) flops a
// head; the chunked moments schedule below does, per head and key, 2 D^2
// (DV + 1) to update the moments and per query as many to read them out,
// plus the exact intra-chunk term: ~4 T D^2 DV. The second is smaller only
// from T ~ 2 D DV (8192 at D = DV = 64). At the smollm-135m prefill shape
// (b = 36, T = 2048, D = DV = 64) the quadratic count, 19.8 GFLOP, against
// 75 MB of f32 inputs and output, is bound by operations: 0.120 ms at the
// rate of f32-accurate 3xTF32 products (495 / 3 TFLOP/s). The counts do
// not pick the route: the quadratic route runs on the tensor cores, the
// moments route as SIMT FMAs a block a head at a time, so the wrapper
// (kernels/maclaurin_attn/kernel.py::route) takes the one that a cost
// model fitted to both routes' times on the card finds faster: the
// quadratic form at every model shape, the moments only at long T with
// few blocks (e.g. b = 64, D = DV = 16 past T ~ 4096). The entry point
// takes the route as an argument.
//
// Quadratic route: the tile engine of attn_tile.cuh with the Maclaurin
// weight. A block of 4 warps owns (b, at most 128 value columns, a 64-row
// query tile) and loops over the key tiles on or below the diagonal: S = Q
// K^T and then W V on the tensor cores as 3xTF32, W = w(scale S) set to 0
// above the diagonal and past T, the numerator acc += W V and the
// denominator l += rowsum(W) in registers, out = acc / l. w >= 1/2, so
// there is no running max and no rescale. This is the reference's
// quadratic oracle (ref.py) in f32.
//
// Moments route (long sequences with few heads): keys of the query's own
// chunk enter exactly; keys of earlier chunks through the running moments
// of the paper's collapse (Eq 3.7):
//
//   sum_j w(u_tj) v_j = V0 + scale q^T S1 + scale^2/2 phi2(q)^T S2
//   S1 = sum k v^T (D, DV),  S2 = sum phi2(k) v^T (D^2, DV),  V0 = sum v
//
// and the denominator likewise from count, sum k and sum phi2(k). The
// column of S2 for output channel c, reshaped (D, D), is the symmetric
// M_c = sum_j v_jc k_j k_j^T, so its readout is a quadratic form
// q^T M_c q: Y = Q M_c, then rowsum(Y * Q). The denominator is the same
// sum with v = 1, so it is carried as one more column (all ones) of V:
// its M is sum k k^T, its S1 column sum k, its V0 the count. Every
// operation is an f32 FMA, as the reference casts its inputs
// (kernel.py:155). The kernel returns only the output: the model's decode
// state is built apart from it (models/maclaurin_attention.py), so the
// moments serve here only as the faster route at long T.
//
// Design of the moments route. The TPU kernel carried S2 (D^2 x DV: 1 MB a
// head at D = 64, 8 MB at 128) in VMEM across a sequential chunk grid
// axis. A block has at most 227 KB of shared memory and blocks carry
// nothing between them. So S2 is split by column: a block owns (b, dvt
// value columns) and keeps their M_c, and the denominator's, in dynamic
// shared memory (dvt is chosen at launch to fit: 8 at D = 64, 1 at D =
// 128), and loops over the chunks of its head in order. Each block
// recomputes the denominator and the intra-chunk scores of its head; the
// grid is (DV / dvt, b). Within a chunk, 64-row sub-tiles of queries are
// read out (order 0 and 1 terms, then q^T M_c q for each column, then the
// exact intra-chunk term against the chunk's keys up to the row, masked
// rows >= cols), and only then are the chunk's keys folded into the
// moments: chunk c's keys are "previous" only for chunk c + 1. 256 threads
// form a 16 x 16 grid; thread (ty, tx) owns rows ty*4 .. ty*4+3 of a
// sub-tile and columns tx + 16j, and owns the entries (ty + 16i, tx + 16j)
// of every M_c in the update, so no two threads write one value and no
// atomics are used: bitwise the same every run. Ragged T (the reference
// pads to a multiple of the chunk) is masked here: keys past T are zero
// rows and are never folded in, rows past T are not written. D is a
// template argument (16, 32, 64, 96, 128).

#include "attn_tile.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;
constexpr int kRows = 64;  // rows of a sub-tile
constexpr int kRQ = kRows / kLanes;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kMaxCols = 16;         // value columns a block keeps at most

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr size_t smem_floats(int D, int ncols) {
  return (size_t)ncols * D * D       // M_c
         + (size_t)D * ncols + ncols  // S1, V0
         + 2 * (size_t)kRows * (D + 1)  // Q and K sub-tiles
         + (size_t)kRows * ncols        // V sub-tile with the ones column
         + (size_t)kRows * (kRows + 1)  // intra-chunk weights
         + (size_t)kRows * ncols;       // numerators of the sub-tile's rows
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    mac_attn(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int T, int DV, int chunk,
             int dvt, float scale) {
  constexpr int DP = D + 1;
  constexpr int NB = D / kLanes;
  const int ncols = dvt + 1;  // dvt value columns, then the ones column
  extern __shared__ float smem[];
  float* ms = smem;                     // [ncols][D][D]
  float* s1 = ms + (size_t)ncols * D * D;  // [D][ncols]
  float* s0 = s1 + D * ncols;           // [ncols]
  float* qs = s0 + ncols;               // [kRows][DP]
  float* ks = qs + kRows * DP;          // [kRows][DP]
  float* vs = ks + kRows * DP;          // [kRows][ncols]
  float* ws = vs + kRows * ncols;       // [kRows][kRows + 1]
  float* acc = ws + kRows * (kRows + 1);  // [kRows][ncols]

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const int bh = blockIdx.y;
  const int c_lo = blockIdx.x * dvt;
  const size_t qk_base = (size_t)bh * T * D;
  const size_t v_base = (size_t)bh * T * DV;
  const float half_s2 = 0.5f * scale * scale;

  for (size_t e = tid; e < (size_t)ncols * D * D + D * ncols + ncols; e += kThreads) smem[e] = 0.f;

  auto load_rows = [&](float* dst, const float* src, int r0, int n) {
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int r = e / D, c = e % D;
      dst[r * DP + c] = r < n ? src[qk_base + (size_t)(r0 + r) * D + c] : 0.f;
    }
  };
  auto load_v = [&](int r0, int n) {
    for (int e = tid; e < kRows * ncols; e += kThreads) {
      const int r = e / ncols, c = e % ncols;
      float x = 0.f;
      if (r < n) {
        if (c == dvt) {
          x = 1.f;
        } else if (c_lo + c < DV) {
          x = v[v_base + (size_t)(r0 + r) * DV + c_lo + c];
        }
      }
      vs[e] = x;
    }
  };

  for (int c0 = 0; c0 < T; c0 += chunk) {
    const int c_end = min(c0 + chunk, T);

    // ---- readout of the chunk's queries, 64 rows at a time
    for (int q0 = c0; q0 < c_end; q0 += kRows) {
      const int nq = min(kRows, c_end - q0);
      __syncthreads();  // the previous sub-tile's rows are written out
      load_rows(qs, q, q0, nq);
      __syncthreads();
      // order 0 and order 1: V0 + scale q.S1
      for (int e = tid; e < kRows * ncols; e += kThreads) {
        const int r = e / ncols, c = e % ncols;
        float lin = 0.f;
#pragma unroll 8
        for (int a = 0; a < D; ++a) lin = fmaf(qs[r * DP + a], s1[a * ncols + c], lin);
        acc[e] = s0[c] + scale * lin;
      }
      __syncthreads();
      // order 2: scale^2/2 q^T M_c q, one column at a time
      for (int c = 0; c < ncols; ++c) {
        const float* m = ms + (size_t)c * D * D;
        float y[kRQ][NB];
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) y[i][j] = 0.f;
#pragma unroll 4
        for (int a = 0; a < D; ++a) {
          float qa[kRQ], mb[NB];
#pragma unroll
          for (int i = 0; i < kRQ; ++i) qa[i] = qs[(ty * kRQ + i) * DP + a];
#pragma unroll
          for (int j = 0; j < NB; ++j) mb[j] = m[a * D + tx + kLanes * j];
#pragma unroll
          for (int i = 0; i < kRQ; ++i)
#pragma unroll
            for (int j = 0; j < NB; ++j) y[i][j] = fmaf(qa[i], mb[j], y[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
          const int r = ty * kRQ + i;
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < NB; ++j) part = fmaf(y[i][j], qs[r * DP + tx + kLanes * j], part);
          part = sum16(part);
          if (tx == 0) acc[r * ncols + c] += half_s2 * part;
        }
      }
      // exact intra-chunk term against the chunk's keys up to the sub-tile
      for (int k0 = c0; k0 < q0 + nq; k0 += kRows) {
        const int nk = min(kRows, c_end - k0);
        __syncthreads();  // acc is complete; ks, vs and ws are free
        load_rows(ks, k, k0, nk);
        load_v(k0, nk);
        __syncthreads();
        float u[kRQ][4];
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
#pragma unroll 4
        for (int a = 0; a < D; ++a) {
          float qa[kRQ], kb[4];
#pragma unroll
          for (int i = 0; i < kRQ; ++i) qa[i] = qs[(ty * kRQ + i) * DP + a];
#pragma unroll
          for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + kLanes * j) * DP + a];
#pragma unroll
          for (int i = 0; i < kRQ; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) u[i][j] = fmaf(qa[i], kb[j], u[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
          const int r = ty * kRQ + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cj = tx + kLanes * j;
            const float x = scale * u[i][j];
            const bool keep = r < nq && cj < nk && k0 + cj <= q0 + r;
            ws[r * (kRows + 1) + cj] = keep ? 1.f + x + 0.5f * x * x : 0.f;
          }
        }
        __syncthreads();
        for (int e = tid; e < kRows * ncols; e += kThreads) {
          const int r = e / ncols, c = e % ncols;
          float s = 0.f;
          for (int j = 0; j < nk; ++j) s = fmaf(ws[r * (kRows + 1) + j], vs[j * ncols + c], s);
          acc[e] += s;
        }
      }
      __syncthreads();
      for (int e = tid; e < kRows * dvt; e += kThreads) {
        const int r = e / dvt, c = e % dvt;
        if (r < nq && c_lo + c < DV)
          out[v_base + (size_t)(q0 + r) * DV + c_lo + c] = acc[r * ncols + c] / acc[r * ncols + dvt];
      }
    }

    // ---- fold the chunk's keys into the moments (none after the last)
    if (c_end >= T) break;
    for (int k0 = c0; k0 < c_end; k0 += kRows) {
      const int nk = min(kRows, c_end - k0);
      __syncthreads();  // every reader of ks, vs and the moments is done
      load_rows(ks, k, k0, nk);
      load_v(k0, nk);
      __syncthreads();
      for (int e = tid; e < D * ncols; e += kThreads) {
        const int a = e / ncols, c = e % ncols;
        float s = 0.f;
        for (int j = 0; j < nk; ++j) s = fmaf(ks[j * DP + a], vs[j * ncols + c], s);
        s1[e] += s;
      }
      for (int c = tid; c < ncols; c += kThreads) {
        float s = 0.f;
        for (int j = 0; j < nk; ++j) s += vs[j * ncols + c];
        s0[c] += s;
      }
      for (int c = 0; c < ncols; ++c) {
        float* m = ms + (size_t)c * D * D;
        float mm[NB][NB];
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) mm[i][j] = m[(ty + kLanes * i) * D + tx + kLanes * j];
        for (int jr = 0; jr < nk; ++jr) {
          const float vj = vs[jr * ncols + c];
          float ka[NB], kb[NB];
#pragma unroll
          for (int i = 0; i < NB; ++i) ka[i] = vj * ks[jr * DP + ty + kLanes * i];
#pragma unroll
          for (int j = 0; j < NB; ++j) kb[j] = ks[jr * DP + tx + kLanes * j];
#pragma unroll
          for (int i = 0; i < NB; ++i)
#pragma unroll
            for (int j = 0; j < NB; ++j) mm[i][j] = fmaf(ka[i], kb[j], mm[i][j]);
        }
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) m[(ty + kLanes * i) * D + tx + kLanes * j] = mm[i][j];
      }
    }
  }
}

// Value columns a block keeps at head dim D: as many as fit its shared
// memory beside the denominator's column, at most kMaxCols, spread evenly
// over the blocks of one head; 0 if not even one fits.
int value_columns(int D, int DV) {
  int most = 0;
  for (int c = 1; c <= DV && c <= kMaxCols; ++c)
    if (smem_floats(D, c + 1) * sizeof(float) <= kMaxSmem) most = c;
  if (most == 0) return 0;
  const int blocks = (DV + most - 1) / most;
  return (DV + blocks - 1) / blocks;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int BH, int T,
                   int DV, int chunk, float scale, cudaStream_t stream) {
  const int dvt = value_columns(D, DV);
  if (dvt == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_floats(D, dvt + 1) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(mac_attn<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((DV + dvt - 1) / dvt, BH);
  mac_attn<D><<<grid, kThreads, smem, stream>>>(q, k, v, out, T, DV, chunk, dvt, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k (BH, T, D), v (BH, T, DV), out (BH, T, DV): f32, contiguous, on the
// device. D in {16, 32, 64, 96, 128}; chunk >= 1; DV >= 1. route 0: the
// chunked moments; route 1: the causal quadratic form (chunk unused).
int maclaurin_attn_f32(const float* q, const float* k, const float* v, float* out, int BH,
                       int T, int D, int DV, int chunk, int route, float scale,
                       cudaStream_t stream) {
  if (BH <= 0 || T <= 0 || DV <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (D != 16 && D != 32 && D != 64 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  if (route == 1) {
    using attn_tile::Maclaurin;
    if (D <= 64 && DV <= 64)
      return (int)attn_tile::launch<Maclaurin, false, 64>(q, k, v, out, BH, T, D, DV, scale, 1,
                                                          stream);
    return (int)attn_tile::launch<Maclaurin, false, 128>(q, k, v, out, BH, T, D, DV, scale, 1,
                                                         stream);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16>(q, k, v, out, BH, T, DV, chunk, scale, stream);
    case 32: return (int)launch<32>(q, k, v, out, BH, T, DV, chunk, scale, stream);
    case 64: return (int)launch<64>(q, k, v, out, BH, T, DV, chunk, scale, stream);
    case 96: return (int)launch<96>(q, k, v, out, BH, T, DV, chunk, scale, stream);
    default: return (int)launch<128>(q, k, v, out, BH, T, DV, chunk, scale, stream);
  }
}

}  // extern "C"
