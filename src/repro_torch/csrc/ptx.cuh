// PTX wrappers shared by the f32 tensor-core kernels: cp.async copies into
// shared memory, mma.m16n8k8 on TF32 operands, and the split of an f32 value
// into the two TF32 terms of 3xTF32 (hi*hi + hi*lo + lo*hi). The attention
// tile engine (attn_tile.cuh, kernels B8 and B9), the quadratic form
// (quadform.cu, B1) and the exact RBF expansion (rbf_pred.cu, B2) take them
// from here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes from global to shared memory; zero where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b: A 16 x 8 tf32 (row), B 8 x 8 tf32 (col), f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo to about 22 bits, each term rounded to TF32 as
// cvt.rna.tf32.f32 rounds a finite x (to nearest, ties away from zero):
// half a TF32 step added to the magnitude and the 13 bits below it cleared.
// lo is passed with those bits set: the MMA reads only the TF32 bits of its
// operands (were it to read more, lo would be off by at most that same half
// step). Four instructions where two cvt take about eight.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// Rows r0 .. r0 + R - 1 and columns c0 .. c0 + 63 of a row-major f32 matrix
// with ``ld`` columns into a shared tile of row stride S, by a block of
// kThreads threads: zeros past row ``rows`` and column ``cols``. With vec,
// 16 bytes a copy (cols a multiple of 4, rows 16-byte aligned); without,
// 4 bytes a copy, for rows that are not whole 16-byte chunks.
template <int R, int S, int kThreads>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int r0, int rows,
                                          int c0, int cols, int ld, bool vec) {
  static_assert(R * 16 % kThreads == 0 && S % 4 == 0, "whole chunks a thread, aligned rows");
  if (vec) {
#pragma unroll
    for (int i = 0; i < R * 16 / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / 16, c = 4 * (e % 16);
      const bool ok = r0 + r < rows && c0 + c < cols;
      cp_async16(dst + r * S + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < R * 64 / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / 64, c = e % 64;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cp_async4(dst + r * S + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// Host side: let ``kernel`` launch with ``bytes`` of dynamic shared memory
// on the current device, once a device (``done``, one flag a device, kept
// by the caller for that kernel); the driver call would otherwise cost
// more host time on every launch than a small launch takes.
constexpr int kMaxDevices = 64;
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace ptx
