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
// D = DV = 64) that is 19.6 GFLOP against 37.7 MB of bf16 inputs and
// output: bound by operations, 0.020 ms at the bf16 tensor-core rate (989
// TFLOP/s); in f32 0.119 ms at the rate of f32-accurate 3xTF32 products
// (495 / 3 TFLOP/s). The kernel is held back not by its MMAs but by the
// instructions around them: attn_tile.cuh says how it keeps those few.
//
// Design: the tile engine of attn_tile.cuh with the Softmax weight. The
// TPU kernel ran a sequential kv grid axis and carried (m, l, acc) in VMEM
// scratch; here a block of 4 warps owns (b, a 64-row query tile) and loops
// over the 64-key tiles on or below the diagonal, with (m, l, acc) of its
// rows in registers. Products: bf16 Q K^T on mma.m16n8k16 (exact products,
// f32 accumulators), P V as three bf16 terms of the f32 P against V; f32
// both products as 3xTF32 on mma.m16n8k8. The precision contract is the f32
// twin's: in f32 within 4x the twin's distance from float64 (+ 1e-6), in
// bf16 each element within half a bf16 step of that f32 value, since the
// output is rounded to bf16 (nearest even) from f32 accumulators as the
// reference's astype. Key tiles wholly above the diagonal are not visited:
// this changes no number, since the first tile holds column 0 <= every row
// (so m is finite after it) and a masked entry adds exp(-1e30 - m) = 0.
// Ragged edges (T not a multiple of 64, d and dv below the compiled width)
// are masked or zero-padded in the kernel, nothing in memory. Compiled at W
// = 64 (d, dv <= 64) and W = 128 (d, dv <= 128), each in f32 and bf16.

#include "attn_tile.cuh"

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k (BH, T, D), v (BH, T, DV), out (BH, T, DV): contiguous, all f32 or
// all bf16 (bf16 != 0), on the device. 1 <= D <= 128, 1 <= DV <= 128.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, int BH, int T,
                   int D, int DV, float scale, int causal, int bf16, cudaStream_t stream) {
  using attn_tile::launch;
  using attn_tile::Softmax;
  if (BH <= 0 || T <= 0 || D <= 0 || D > 128 || DV <= 0 || DV > 128)
    return (int)cudaErrorInvalidValue;
  const bool narrow = D <= 64 && DV <= 64;
  const auto go = [&](auto fwd) {
    return (int)fwd(q, k, v, out, BH, T, D, DV, scale, causal, stream);
  };
  if (bf16) return narrow ? go(launch<Softmax, true, 64>) : go(launch<Softmax, true, 128>);
  return narrow ? go(launch<Softmax, false, 64>) : go(launch<Softmax, false, 128>);
}

}  // extern "C"
