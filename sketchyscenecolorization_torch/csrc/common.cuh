// Device helpers shared by the kernels: cp.async, the 3xTF32 split, the
// m16n8k8 tensor-core product, the sigmoid, a warp sum and a per-row count
// of kept steps.  Everything sits in an anonymous namespace, so each source
// that includes this header gets its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cp.async of 16 bytes that writes zeros instead when `live` is false (the
// source is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}

// Wait until at most `kPending` committed cp.async groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// 3xTF32: x = big + small, both TF32 (round to nearest, ties away from
// zero, to 10 mantissa bits); big*big + big*small + small*big keeps the
// product of two floats to about f32 precision on the tensor cores.  The
// rounding is cvt.rna.tf32.f32's, done as "add half an ulp to the
// magnitude bits, drop the low 13": the same result for every input but a
// NaN whose payload lies in those 13 bits, in two integer operations
// where nvcc lowers the cvt to four (it tests for inf and NaN first).
// small keeps its low bits: the tensor cores ignore them.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a b on the tensor cores: one m16n8k8 TF32 product of a warp with an
// f32 accumulator (fragments as in the PTX ISA: a row-major 16x8, b
// column-major 8x8, d 16x8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy `rows` rows of `width` floats, starting at row `r0` of the row-major
// matrix `src`, into `dst` with cp.async (width*rows a multiple of 4, both
// 16-byte aligned); commits one group.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows, int width) {
  const float* s = src + (size_t)r0 * width;
  const int n16 = rows * width / 4;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    cp_async16(dst + 4 * i, s + 4 * i);
  }
  cp_async_commit();
}

// Number of nonzero flags among the first t of one batch row.
__device__ __forceinline__ int valid_before(const int* valid, int T, int t) {
  int k = 0;
  for (int s = 0; s < t; ++s) k += valid[s] != 0;
  return k;
}

// Sum over the 32 lanes of a full warp; every lane gets the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

}  // namespace
