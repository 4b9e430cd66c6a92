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
// int16 perm, f16 phase, int8 wt with one scale per head (sv, applied once
// to the stack sum).
//
// What bounds it on an H100: per row and stack two transforms of
// d' log2 d' adds, the diagonals and the cos (fp32 pipes, 67 TFLOP/s), and
// the readout's 2 d' K products (3xTF32 on the tensor cores, 165 TFLOP/s of
// f32 products); the operators are O(F). At n=1024, F=4096, d'=1024, K=10
// that is 0.10 GFLOP of adds and 0.08 of products, ~2 us, against 3.2 MB
// of Z (1 us at 3.35 TB/s): bound by operations. The body is far from it
// (~14x on an H100 at 700 W, PERF.md): a cos costs ~20 instructions where
// the bound counts one, and an element makes ~16 shared-memory accesses
// (three transposes, the gather at ~3.5 ways of bank conflict on a random
// permutation, the operators, the cos tile), so the shared-memory pipe and
// the instruction rate set the rows' pace; a block also waits for its operators,
// Z's rows and the readout slice (~110 KB at 16 rows, B6) from L2 before
// and between its tiles.
//
// Design. The TPU kernel kept a (rows, d') tile and every operator resident
// in VMEM and unrolled the stacks. Here a block owns (BN rows, one stack,
// up to 16 heads) and walks its rows in tiles of 16:
//
// - The stack's operators come to shared memory once a block, B7's int8
//   and f16 ones converted to f32 there (S times the stack scale): B as
//   stored, G paired with the padded place of perm's element, S and the
//   phase paired at padded places.
// - A row is one warp's at d' >= 32 (16 warps, one row each a tile; 8
//   warps, two rows each, at d' = 2048): 32 lanes, E = d'/32 values a lane.
//   Z's row, copied into the row's slot of the cos tile, is read in layout
//   A (register j of lane l holds element 32 j + l), which puts strides
//   32 .. d'/2 in a lane's registers. One transpose through the row's slot of the cos tile
//   turns it to layout B (lane l holds elements E l .. E l + E - 1), where
//   strides 1 .. E/2 are in registers and the strides from E to 16 (d' <
//   1024) take a shuffle each. The slot is padded (a word every 32
//   elements, every 64 at d' = 2048) so a warp's 32 stores in layout A and
//   32 loads in layout B are conflict-free. The permutation's gather is the
//   transpose back: the warp stores its row in layout B and reads the
//   permuted elements in layout A. So a transform costs 5 shuffles at most
//   where it cost 5 E, and the gather no extra pass. At d' <= 32 a row is
//   d' lanes (32/d' rows a warp) and every stage is a shuffle.
// - cos(proj * S + phase) by cos_rn (cos.cuh: cosf's arithmetic, no stack)
//   goes into the row's slot, where the tile of 16 rows is then read out on
//   the tensor cores: mma.sync m16n8k8 TF32, rows against 16 heads (two n8
//   fragments), the warps splitting the d'/8 k-steps (two chains of MMAs
//   each, even and odd k-steps). B6 takes each
//   product as 3xTF32 (cos_lo w_hi + cos_hi w_lo + cos_hi w_hi), B7 as
//   cos_lo w + cos_hi w on the int8 bytes (exact in TF32). The slot's row
//   stride is 4 mod 8 words, so a fragment's 32 loads hit 32 banks. The
//   warps' partial 16 x 16 tiles are added in warp order.
// - Z's rows and the readout slice (its rows padded so the B fragments'
//   loads hit distinct banks) come to shared memory by cp.async while the
//   operators are converted; the rows wait for Z alone, the readout for the
//   slice. At d' = 2048 the 133 KB cos tile leaves no room for the slice,
//   which the fragments then load from L2, as at d' < 64.
// - The stacks' sums: with ``part``, each block writes its (row, head)
//   partials and a second pass adds the stacks in stack order, then the
//   head scale and the bias. With one stack the block applies the scale and
//   the bias itself (one launch, the same arithmetic). No atomics: bitwise
//   the same every run, and the same bits from both forms. (A cluster along
//   the stacks adding them through distributed shared memory in one launch
//   measured slower at n=1024, F=4096: see PERF.md.)
//
// d' is a template argument (2 .. 2048): every register index is a
// compile-time constant. Rows past n compute on zeros and write nothing;
// Z's columns past d are zeros.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cos.cuh"
#include "ptx.cuh"

namespace {

constexpr int kTileRows = 16;  // rows of a cos tile: one m16 fragment
constexpr int kHeads = 16;     // heads a block reads out: two n8 fragments

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

// The shape of one instantiation, d' = DD.
template <int DD>
struct Geo {
  static constexpr int L = DD < 32 ? DD : 32;  // lanes a row
  static constexpr int RW = 32 / L;            // rows a warp holds at once
  static constexpr int E = DD / L;             // values a lane
  static constexpr int kWarps = DD <= 16 ? DD / 2 : DD <= 1024 ? 16 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPasses = kTileRows / (kWarps * RW);  // rows a warp takes a tile
  static constexpr int kPadShift = E > 32 ? log2_of<E>() : 5;  // a pad word every 2^this
  static constexpr int KP = DD < 8 ? 8 : DD;                   // readout depth (k-steps of 8)
  static constexpr int kRowLen = KP + ((KP - 1) >> kPadShift);
  static constexpr int kStride = kRowLen + (12 - kRowLen % 8) % 8;  // 4 mod 8: fragment banks
  // Shared memory, in floats: B, (G, perm's place) pairs, (S, phase) pairs
  // at padded places, the cos tile, the warps' partial tiles, the slice.
  static constexpr int kB = 0;
  static constexpr int kGP = kB + (DD + 3) / 4 * 4;
  static constexpr int kSP = kGP + (2 * DD + 3) / 4 * 4;
  static constexpr int kCos = kSP + (2 * kRowLen + 3) / 4 * 4;
  static constexpr int kRed = kCos + kTileRows * kStride;
  static constexpr int kWs = kRed + kWarps * kTileRows * kHeads;
  // The readout slice comes to shared memory with Z (rows of d' + 4 floats or
  // d' + 16 bytes: the fragments' 32 loads on distinct banks) at 64 <= d' <=
  // 1024; at d' = 2048 it does not fit beside the cos tile and is read from L2.
  static constexpr bool kWtSmem = DD >= 64 && DD <= 1024;
  static_assert(kPasses >= 1 && kPasses * kWarps * RW == kTileRows, "row passes");
  static_assert(kStride % 8 == 4, "fragment loads on distinct banks");
  static_assert(kGP % 4 == 0 && kSP % 4 == 0 && kCos % 4 == 0 && kWs % 4 == 0, "16-byte segments");
};

// Row stride (elements) and words of the readout slice's rows in shared memory.
template <bool kInt8, int DD>
__host__ __device__ constexpr int ws_ld() {
  return kInt8 ? DD + 16 : DD + 4;
}
template <bool kInt8, int DD>
__host__ __device__ constexpr int ws_words() {
  return kInt8 ? (DD + 16) / 4 : DD + 4;
}

// A block's shared memory in bytes: the segments of Geo, then the rows of
// the readout slice it keeps (min(K, 16), at 64 <= d' <= 1024).
template <bool kInt8, int DD>
__host__ __device__ constexpr int smem_bytes(int K) {
  return 4 * (Geo<DD>::kWs + (Geo<DD>::kWtSmem ? (K < kHeads ? K : kHeads) : 0) *
                                 ws_words<kInt8, DD>());
}

template <int DD>
__device__ __forceinline__ int pad(int i) {
  return i + (i >> Geo<DD>::kPadShift);
}

// One butterfly stage over a row, partner in the lane ``h`` away.
__device__ __forceinline__ float shfl_stage(float x, int h, bool hi) {
  const float p = __shfl_xor_sync(0xffffffffu, x, h);
  return hi ? __fsub_rn(p, x) : __fadd_rn(x, p);
}

// The stages over register bits: pairs (j, j | s) for s = 1 .. N/2.
template <int E, int N>
__device__ __forceinline__ void reg_stages(float (&v)[E]) {
#pragma unroll
  for (int s = 1; s < N; s <<= 1) {
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

// Layout B's stages: strides 1 .. E/2 (at most 16) in registers, then the
// strides from E to 16 by shuffles (lane bit b is element bit log2 E + b).
template <int DD>
__device__ __forceinline__ void stages_b(float (&v)[Geo<DD>::E], int l) {
  constexpr int E = Geo<DD>::E;
  reg_stages<E, (E < 32 ? E : 32)>(v);
#pragma unroll
  for (int h = 1; h * E < 32; h <<= 1) {
    const bool hi = (l & h) != 0;
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = shfl_stage(v[j], h, hi);
  }
}

template <int DD>
__device__ __forceinline__ void store_a(float* buf, const float (&v)[Geo<DD>::E], int l) {
#pragma unroll
  for (int j = 0; j < Geo<DD>::E; ++j) buf[pad<DD>(32 * j + l)] = v[j];
}

template <int DD>
__device__ __forceinline__ void load_b(const float* buf, float (&v)[Geo<DD>::E], int l) {
#pragma unroll
  for (int j = 0; j < Geo<DD>::E; ++j) v[j] = buf[pad<DD>(Geo<DD>::E * l + j)];
}

template <int DD>
__device__ __forceinline__ void store_b(float* buf, const float (&v)[Geo<DD>::E], int l) {
#pragma unroll
  for (int j = 0; j < Geo<DD>::E; ++j) buf[pad<DD>(Geo<DD>::E * l + j)] = v[j];
}

// One row (d' >= 64) through both transforms, the gather, the diagonals and
// the cos, in ``buf``, its slot of the cos tile: Z's row there as copied
// (element i at i, read only where ``live``), the cos at padded places.
template <int DD>
__device__ __forceinline__ void row_wide(bool live, int d, const float* Bs, const float2* GP,
                                         const float2* SP, float* buf, int l) {
  constexpr int E = Geo<DD>::E;
  float v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = 32 * j + l;
    v[j] = __fmul_rn(live && i < d ? buf[i] : 0.f, Bs[i]);
  }
  reg_stages<E, E>(v);  // strides 32 .. d'/2
  __syncwarp();         // Z's row is read
  store_a<DD>(buf, v, l);
  __syncwarp();
  load_b<DD>(buf, v, l);  // each lane reads back only what it stores next
  stages_b<DD>(v, l);     // strides 1 .. 16
  store_b<DD>(buf, v, l);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < E; ++j) {  // the gather, back to layout A
    const int i = 32 * j + l;
    const float2 gp = GP[i];
    v[j] = __fmul_rn(buf[__float_as_int(gp.y)], gp.x);
  }
  __syncwarp();
  reg_stages<E, E>(v);
  store_a<DD>(buf, v, l);
  __syncwarp();
  load_b<DD>(buf, v, l);
  stages_b<DD>(v, l);
  store_b<DD>(buf, v, l);  // the cos reads it back a few values at a time
#pragma unroll 4
  for (int j = 0; j < E; ++j) {
    const int p = pad<DD>(E * l + j);
    const float2 sp = SP[p];
    buf[p] = cos_rn(__fadd_rn(__fmul_rn(buf[p], sp.x), sp.y));
  }
}

// The same for d' <= 32: element l of the row in lane l of its group of L,
// every stage a shuffle (every lane of the warp takes part in each).
template <int DD>
__device__ __forceinline__ void row_narrow(bool live, int d, const float* Bs,
                                           const float2* GP, const float2* SP, float* buf, int l) {
  constexpr int L = Geo<DD>::L;
  float x = __fmul_rn(live && l < d ? buf[l] : 0.f, Bs[l]);  // lane l alone uses buf[l]
#pragma unroll
  for (int h = 1; h < L; h <<= 1) x = shfl_stage(x, h, (l & h) != 0);
  buf[l] = x;  // pad(l) = l below 32
  __syncwarp();
  const float2 gp = GP[l];
  x = __fmul_rn(buf[__float_as_int(gp.y)], gp.x);
  __syncwarp();
#pragma unroll
  for (int h = 1; h < L; h <<= 1) x = shfl_stage(x, h, (l & h) != 0);
  const float2 sp = SP[l];
  buf[l] = cos_rn(__fadd_rn(__fmul_rn(x, sp.x), sp.y));
}

// This warp's share of the tile's readout, cos (16 x KP) times the stack's
// readout slice (heads k0 .. k0 + 15: row h at w0 + h ld), into acc (two n8
// fragments).
template <bool kInt8, int DD>
__device__ __forceinline__ void readout(float (&acc)[2][4], const float* ct,
                                        const typename Operands<kInt8>::Diag* w0, size_t ld,
                                        int kh, int warp, int lane) {
  using Gm = Geo<DD>;
  constexpr int kSteps = Gm::KP / 8;
  constexpr int kPer = (kSteps + Gm::kWarps - 1) / Gm::kWarps;
  const int g = lane / 4, t = lane % 4;
  const int kk0 = warp * kPer, kk1 = min(kSteps, kk0 + kPer);
  const float* r0 = ct + g * Gm::kStride;
  const float* r1 = r0 + 8 * Gm::kStride;
  const typename Operands<kInt8>::Diag* w[2];
  bool ok[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    ok[nt] = 8 * nt + g < kh;
    w[nt] = w0 + (ok[nt] ? 8 * nt + g : 0) * ld;
  }
  // Even and odd k-steps in two accumulators (two chains of dependent MMAs),
  // added at the end.
  float ch[2][2][4] = {};
  const auto step = [&](int kk, float (&c)[2][4]) {
    const int k = 8 * kk + t;
    const int p0 = pad<DD>(k), p4 = pad<DD>(k + 4);
    uint32_t ah[4], al[4];
    ptx::split_tf32(r0[p0], ah[0], al[0]);  // (g, k = t)
    ptx::split_tf32(r1[p0], ah[1], al[1]);  // (g + 8, t)
    ptx::split_tf32(r0[p4], ah[2], al[2]);  // (g, t + 4)
    ptx::split_tf32(r1[p4], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {  // B (k, n) = wt[k0 + 8 nt + n][k]
      const float b0 = ok[nt] && k < DD ? to_f32(w[nt][k]) : 0.f;
      const float b1 = ok[nt] && k + 4 < DD ? to_f32(w[nt][k + 4]) : 0.f;
      if constexpr (kInt8) {  // exact in TF32: no split
        ptx::mma_tf32(c[nt], al, __float_as_uint(b0), __float_as_uint(b1));
        ptx::mma_tf32(c[nt], ah, __float_as_uint(b0), __float_as_uint(b1));
      } else {
        uint32_t bh0, bl0, bh1, bl1;
        ptx::split_tf32(b0, bh0, bl0);
        ptx::split_tf32(b1, bh1, bl1);
        ptx::mma_tf32(c[nt], al, bh0, bh1);
        ptx::mma_tf32(c[nt], ah, bl0, bl1);
        ptx::mma_tf32(c[nt], ah, bh0, bh1);
      }
    }
  };
#pragma unroll 2
  for (int kk = kk0; kk < kk1; kk += 2) {
    step(kk, ch[0]);
    if (kk + 1 < kk1) step(kk + 1, ch[1]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = ch[0][nt][e] + ch[1][nt][e];
}

// Z's rows t0 .. min(t0 + 16, row_end) - 1 into their slots of the cos
// tile (element i at i), by cp.async: 16 bytes a copy with vec (d % 4 == 0,
// Z 16-byte aligned), else 4.
template <int DD>
__device__ __forceinline__ void stage_z(float* ct, const float* __restrict__ Z, int t0,
                                        int row_end, int d, bool vec) {
  using Gm = Geo<DD>;
  const int rows = min(kTileRows, row_end - t0);
  const int per = vec ? 4 : 1, chunks = d / per;
  for (int e = threadIdx.x; e < rows * chunks; e += Gm::kThreads) {
    const int r = e / chunks, c = per * (e - r * chunks);
    const float* src = Z + static_cast<size_t>(t0 + r) * d + c;
    if (vec) {
      ptx::cp_async16(ct + r * Gm::kStride + c, src, true);
    } else {
      ptx::cp_async4(ct + r * Gm::kStride + c, src, true);
    }
  }
}

// The stack's readout slice, rows 0 .. kh - 1 from w0 (row stride F), into
// ws: by cp.async, 16 bytes a copy, with vec (the slice 16-byte aligned);
// else plain loads, which the block's next barrier makes visible.
template <bool kInt8, int DD>
__device__ __forceinline__ void stage_wt(typename Operands<kInt8>::Diag* ws,
                                         const typename Operands<kInt8>::Diag* __restrict__ w0,
                                         size_t F, int kh, bool vec) {
  using Gm = Geo<DD>;
  constexpr int kLd = ws_ld<kInt8, DD>();
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(typename Operands<kInt8>::Diag));
    constexpr int kChunks = DD / kPer;
    for (int e = threadIdx.x; e < kh * kChunks; e += Gm::kThreads) {
      const int h = e / kChunks, c = kPer * (e % kChunks);
      ptx::cp_async16(ws + h * kLd + c, w0 + h * F + c, true);
    }
  } else {
    for (int e = threadIdx.x; e < kh * DD; e += Gm::kThreads) {
      const int h = e / DD, c = e % DD;
      ws[h * kLd + c] = w0[h * F + c];
    }
  }
}

template <bool kInt8, int DD>
__global__ void __launch_bounds__(Geo<DD>::kThreads, 1)
    fastfood_tile(const float* __restrict__ Z,
                  const typename Operands<kInt8>::Diag* __restrict__ B,
                  const typename Operands<kInt8>::Diag* __restrict__ G,
                  const typename Operands<kInt8>::Perm* __restrict__ perm,
                  const typename Operands<kInt8>::Diag* __restrict__ S,
                  const float* __restrict__ stack_scale,
                  const typename Operands<kInt8>::Phase* __restrict__ phase,
                  const typename Operands<kInt8>::Diag* __restrict__ wt,
                  const float* __restrict__ wt_scale, const float* __restrict__ bias, int n,
                  int d, int K, int block_n, bool vec_z, bool vec_wt,
                  float* __restrict__ part, float* __restrict__ out) {
  using Gm = Geo<DD>;
  using Diag = typename Operands<kInt8>::Diag;
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem + Gm::kB;
  float2* GP = reinterpret_cast<float2*>(smem + Gm::kGP);
  float2* SP = reinterpret_cast<float2*>(smem + Gm::kSP);
  float* ct = smem + Gm::kCos;
  float* red = smem + Gm::kRed;
  Diag* ws = reinterpret_cast<Diag*>(smem + Gm::kWs);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l = lane % Gm::L, rl = lane / Gm::L;
  const int s = blockIdx.y;
  const size_t F = static_cast<size_t>(gridDim.y) * DD, off = static_cast<size_t>(s) * DD;
  const int k0 = blockIdx.z * kHeads, kh = min(kHeads, K - k0);
  const int row0 = blockIdx.x * block_n, row_end = min(n, row0 + block_n);
  const Diag* w0 = wt + k0 * F + off;  // the readout slice, row stride F

  // The copies first (Z's rows, then the slice, in two groups), so that they
  // fly while the operators are converted.
  stage_z<DD>(ct, Z, row0, row_end, d, vec_z);
  ptx::cp_async_commit();
  if constexpr (Gm::kWtSmem) {
    stage_wt<kInt8, DD>(ws, w0, F, kh, vec_wt);
    ptx::cp_async_commit();
  }
  const float ss = kInt8 ? stack_scale[s] : 1.f;
#pragma unroll
  for (int i0 = 0; i0 < DD; i0 += Gm::kThreads) {
    const int i = i0 + tid;
    if (i < DD) {
      Bs[i] = to_f32(B[off + i]);
      const int place = pad<DD>(static_cast<int>(perm[off + i]));
      GP[i] = make_float2(to_f32(G[off + i]), __int_as_float(place));
      float sc = to_f32(S[off + i]);
      if (kInt8) sc = __fmul_rn(sc, ss);
      SP[pad<DD>(i)] = make_float2(sc, to_f32(phase[off + i]));
    }
  }
  if constexpr (DD < Gm::KP) {  // the readout's k padding: cos columns d' .. 7 stay 0
    for (int e = tid; e < kTileRows * (Gm::KP - DD); e += Gm::kThreads)
      ct[(e / (Gm::KP - DD)) * Gm::kStride + DD + e % (Gm::KP - DD)] = 0.f;
  }

  for (int t0 = row0; t0 < row_end; t0 += kTileRows) {
    if (t0 != row0) {  // the next rows, once the last tile's readout is done
      stage_z<DD>(ct, Z, t0, row_end, d, vec_z);
      ptx::cp_async_commit();
      ptx::cp_async_wait<0>();
    } else if constexpr (Gm::kWtSmem) {
      ptx::cp_async_wait<1>();  // Z's rows; the slice may still be on its way
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();  // Z's rows and the operators are in
#pragma unroll
    for (int p = 0; p < Gm::kPasses; ++p) {
      const int tr = (p * Gm::kWarps + warp) * Gm::RW + rl;  // row in the tile
      float* buf = ct + tr * Gm::kStride;
      if constexpr (DD <= 32) {
        row_narrow<DD>(t0 + tr < row_end, d, Bs, GP, SP, buf, l);
      } else {
        row_wide<DD>(t0 + tr < row_end, d, Bs, GP, SP, buf, l);
      }
    }
    ptx::cp_async_wait<0>();
    __syncthreads();  // the cos tile is whole, the slice in; the last partials are read

    float acc[2][4];
    if constexpr (Gm::kWtSmem) {
      readout<kInt8, DD>(acc, ct, ws, ws_ld<kInt8, DD>(), kh, warp, lane);
    } else {
      readout<kInt8, DD>(acc, ct, w0, F, kh, warp, lane);
    }
    {
      const int g = lane / 4, t = lane % 4;
      float* rw = red + warp * kTileRows * kHeads;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        rw[g * kHeads + 8 * nt + 2 * t] = acc[nt][0];
        rw[g * kHeads + 8 * nt + 2 * t + 1] = acc[nt][1];
        rw[(g + 8) * kHeads + 8 * nt + 2 * t] = acc[nt][2];
        rw[(g + 8) * kHeads + 8 * nt + 2 * t + 1] = acc[nt][3];
      }
    }
    __syncthreads();  // partials in; the cos tile is free for the next rows

    for (int e = tid; e < kTileRows * kHeads; e += Gm::kThreads) {
      const int r = e / kHeads, h = e % kHeads, row = t0 + r;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < Gm::kWarps; ++w) sum += red[w * kTileRows * kHeads + e];  // warp order
      if (h >= kh || row >= row_end) continue;
      if (part != nullptr) {
        part[(static_cast<size_t>(s) * n + row) * K + k0 + h] = sum;
      } else {  // one stack: the second pass's arithmetic, here
        if (wt_scale != nullptr) sum = __fmul_rn(sum, wt_scale[k0 + h]);
        out[static_cast<size_t>(row) * K + k0 + h] = sum + bias[k0 + h];
      }
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
  const float *wt_scale, *bias;
  int n, d, stacks, K, block_n;
  float *part, *out;
  cudaStream_t stream;
};

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <bool kInt8, int DD>
cudaError_t launch_tile(const Args<kInt8>& a) {
  using Gm = Geo<DD>;
  constexpr int kMaxBytes = smem_bytes<kInt8, DD>(kHeads);
  static_assert(kMaxBytes <= 232448, "shared memory");
  static bool opted[ptx::kMaxDevices] = {};
  const cudaError_t err = ptx::allow_smem(fastfood_tile<kInt8, DD>, kMaxBytes, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + a.block_n - 1) / a.block_n, a.stacks, (a.K + kHeads - 1) / kHeads);
  fastfood_tile<kInt8, DD><<<grid, Gm::kThreads, smem_bytes<kInt8, DD>(a.K), a.stream>>>(
      a.Z, a.B, a.G, a.perm, a.S, a.stack_scale, a.phase, a.wt, a.wt_scale, a.bias, a.n, a.d,
      a.K, a.block_n, a.d % 4 == 0 && aligned(a.Z, 16), aligned(a.wt, 16), a.part, a.out);
  return cudaGetLastError();
}

template <bool kInt8>
int run(const Args<kInt8>& a, int dd) {
  if (a.n <= 0 || a.d <= 0 || a.d > dd || a.stacks <= 0 || a.stacks > 65535 || a.K <= 0 ||
      a.block_n <= 0 || a.block_n % kTileRows != 0 || (a.part == nullptr && a.stacks != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dd) {
    case 2: err = launch_tile<kInt8, 2>(a); break;
    case 4: err = launch_tile<kInt8, 4>(a); break;
    case 8: err = launch_tile<kInt8, 8>(a); break;
    case 16: err = launch_tile<kInt8, 16>(a); break;
    case 32: err = launch_tile<kInt8, 32>(a); break;
    case 64: err = launch_tile<kInt8, 64>(a); break;
    case 128: err = launch_tile<kInt8, 128>(a); break;
    case 256: err = launch_tile<kInt8, 256>(a); break;
    case 512: err = launch_tile<kInt8, 512>(a); break;
    case 1024: err = launch_tile<kInt8, 1024>(a); break;
    case 2048: err = launch_tile<kInt8, 2048>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || a.part == nullptr) return static_cast<int>(err);
  const int total = a.n * a.K;
  fastfood_finalize<<<(total + 255) / 256, 256, 0, a.stream>>>(a.part, a.stacks, a.n, a.K,
                                                               a.wt_scale, a.bias, a.out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// B6. Z (n, d); B, G, S (stacks, dd); perm (stacks, dd) int32; phase (F,);
// wt (K, F); bias (K,): f32 unless said, contiguous, on the device, with
// dd a power of two in [2, 2048], d <= dd and F = stacks dd. block_n, the
// rows a block owns, is a multiple of 16. part (stacks, n, K) is scratch
// for the second pass; null asks for one launch (one stack only). Writes
// out (n, K).
int fastfood_score_f32(const float* Z, const float* B, const float* G, const int32_t* perm,
                       const float* S, const float* phase, const float* wt, const float* bias,
                       int n, int d, int dd, int stacks, int K, int block_n, float* part,
                       float* out, cudaStream_t stream) {
  const Args<false> a{Z,    B, G, perm,   S,     nullptr, phase,   wt, nullptr,
                      bias, n, d, stacks, K, block_n, part,  out,     stream};
  return run<false>(a, dd);
}

// B7. As B6, with B, G, S and wt int8, perm int16, phase f16, the per-stack
// G*S scales stack_scale (stacks,) and the head scales wt_scale (K,) f32.
int fastfood_score_q8(const float* Z, const int8_t* B, const int8_t* G, const int16_t* perm,
                      const int8_t* S, const float* stack_scale, const __half* phase,
                      const int8_t* wt, const float* wt_scale, const float* bias, int n, int d,
                      int dd, int stacks, int K, int block_n, float* part, float* out,
                      cudaStream_t stream) {
  const Args<true> a{Z,    B, G, perm,   S, stack_scale, phase, wt,  wt_scale,
                     bias, n, d, stacks, K, block_n,     part,  out, stream};
  return run<true>(a, dd);
}

}  // extern "C"
