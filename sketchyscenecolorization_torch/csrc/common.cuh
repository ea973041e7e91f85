// Device helpers (cp.async, the 3xTF32 split and the m16n8k8 tensor-core
// product) and the reduction kernels shared by the kernels: the tiled f32
// products, sums and transpose serve csrc/recur_attn_bwd.cu (B6).
// Everything sits in an anonymous namespace, so each source that includes
// this header gets its own copy.
//
// The reductions are deterministic: no float atomics, every sum is taken
// in a fixed order, so two launches give bit-identical results.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kProductTile = 64;   // output tile of rows_product_kernel
constexpr int kProductDepth = 16;  // rows per shared-memory stage

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

// src [rows, cols] -> dst [cols, rows], 32x32 tiles through shared memory.
__global__ void transpose_kernel(const float* __restrict__ src,
                                 float* __restrict__ dst, int rows, int cols) {
  __shared__ float tile[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = blockIdx.y * 32 + i;
    if (r < rows && c < cols) tile[i][threadIdx.x] = src[(size_t)r * cols + c];
  }
  __syncthreads();
  const int r = blockIdx.y * 32 + threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int cc = blockIdx.x * 32 + i;
    if (r < rows && cc < cols) dst[(size_t)cc * rows + r] = tile[threadIdx.x][i];
  }
}

// out[split] [ka, mb] = sum over (n, valid slot >= first_slot, p in this
// split's pixel range) of A[n, slot, p, 0:ka]^T B[n, slot, p, 0:mb].  A and
// B are scratch in [N, T, P] row order with row strides lda and ldb floats
// (slot = rank of the valid step).  A register-tiled f32 product: 64x64
// output tile per block, 4x4 per thread, rows staged 16 at a time.  ka, mb,
// lda, ldb multiples of 4; A and B 16-byte aligned.
__global__ void __launch_bounds__(256)
rows_product_kernel(const float* __restrict__ A, int lda, int ka,
                    const float* __restrict__ B, int ldb, int mb,
                    const int* __restrict__ valid,
                    float* __restrict__ out,      // [splits, ka, mb]
                    int N, int P, int T, int first_slot, int p_chunk) {
  __shared__ __align__(16) float a_s[kProductDepth][kProductTile];
  __shared__ __align__(16) float b_s[kProductDepth][kProductTile];
  const int m0 = blockIdx.y * kProductTile;   // rows of out (columns of A)
  const int c0 = blockIdx.x * kProductTile;   // columns of out (of B)
  const int p_lo = blockIdx.z * p_chunk;
  const int p_hi = min(P, p_lo + p_chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lr = threadIdx.x / 16, lc = 4 * (threadIdx.x % 16);
  const bool a_in = m0 + lc < ka;
  const bool b_in = c0 + lc < mb;

  float acc[4][4] = {};
  for (int n = 0; n < N; ++n) {
    const int n_valid = valid_before(valid + n * T, T, T);
    for (int slot = first_slot; slot < n_valid; ++slot) {
      const size_t base = ((size_t)n * T + slot) * P;
      for (int p = p_lo; p < p_hi; p += kProductDepth) {
        const int pr = p + lr;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 b = a;
        if (pr < p_hi && a_in) {
          a = *reinterpret_cast<const float4*>(A + (base + pr) * lda + m0 + lc);
        }
        if (pr < p_hi && b_in) {
          b = *reinterpret_cast<const float4*>(B + (base + pr) * ldb + c0 + lc);
        }
        __syncthreads();           // the previous stage has been consumed
        *reinterpret_cast<float4*>(&a_s[lr][lc]) = a;
        *reinterpret_cast<float4*>(&b_s[lr][lc]) = b;
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kProductDepth; ++k) {
          const float4 av = *reinterpret_cast<const float4*>(&a_s[k][4 * ty]);
          const float4 bv = *reinterpret_cast<const float4*>(&b_s[k][4 * tx]);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
          }
        }
      }
    }
  }
  const int col = c0 + 4 * tx;
  if (col >= mb) return;
  float* o = out + (size_t)blockIdx.z * ka * mb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row < ka) {
      *reinterpret_cast<float4*>(o + (size_t)row * mb + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// out[b] = sum over r < rows of part[b, r] (vectors of 4*n4 floats), in
// order of r; grid (ceil(n4 / 256), batches).
__global__ void sum_rows_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int rows,
                                size_t n4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* src = reinterpret_cast<const float4*>(part)
                      + (size_t)blockIdx.y * rows * n4;
  float4 s = src[i];
  for (int k = 1; k < rows; ++k) {
    const float4 v = src[k * n4 + i];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  reinterpret_cast<float4*>(out)[(size_t)blockIdx.y * n4 + i] = s;
}

// out[n, t, col] = sum over p of rows[n, slot(t), p, col] for a valid step
// t, else 0 (rows: scratch [N, T, P, width] in valid-slot order).  Block
// (32 columns, 8 pixel lanes); the lanes' sums are added in lane order.
__global__ void column_sums_kernel(const float* __restrict__ rows,
                                   const int* __restrict__ valid,
                                   float* __restrict__ out, int P, int width,
                                   int T) {
  __shared__ float part[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int t = blockIdx.y;
  const int n = blockIdx.z;
  const int* vrow = valid + n * T;
  const bool v = vrow[t] != 0;
  float sum = 0.0f;
  if (v && col < width) {
    const size_t base = ((size_t)n * T + valid_before(vrow, T, t)) * P;
    for (int p = threadIdx.y; p < P; p += 8) {
      sum += rows[(base + p) * width + col];
    }
  }
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float total = 0.0f;
    for (int k = 0; k < 8; ++k) total += part[k][threadIdx.x];
    out[((size_t)n * T + t) * width + col] = total;
  }
}

// Host: src [rows, cols] -> dst [cols, rows].
inline int launch_transpose(const float* src, float* dst, int rows, int cols,
                            cudaStream_t s) {
  transpose_kernel<<<dim3((cols + 31) / 32, (rows + 31) / 32), dim3(32, 8), 0,
                     s>>>(src, dst, rows, cols);
  return (int)cudaGetLastError();
}

// Host: out [ka, mb] = rows_product_kernel summed over `splits` pixel
// ranges (partials [splits, ka, mb] when splits > 1, added in order).
inline int launch_rows_product(const float* A, int lda, int ka,
                               const float* B, int ldb, int mb,
                               const int* valid, float* out, float* partials,
                               int N, int P, int T, int first_slot,
                               int splits, cudaStream_t s) {
  if (splits <= 0 || splits > 65535 || (splits > 1 && partials == nullptr) ||
      ka % 4 || mb % 4 || lda % 4 || ldb % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int p_chunk = (P + splits - 1) / splits;
  const dim3 grid((mb + kProductTile - 1) / kProductTile,
                  (ka + kProductTile - 1) / kProductTile, splits);
  rows_product_kernel<<<grid, 256, 0, s>>>(A, lda, ka, B, ldb, mb, valid,
                                           splits > 1 ? partials : out, N, P,
                                           T, first_slot, p_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n4 = (size_t)ka * mb / 4;
  sum_rows_kernel<<<dim3((unsigned)((n4 + 255) / 256), 1), 256, 0, s>>>(
      partials, out, splits, n4);
  return (int)cudaGetLastError();
}

// Host: out[b] = sum over r < rows of part[b, r] for b < batches (vectors
// of `width` floats, a multiple of 4).
inline int launch_sum_rows(const float* part, float* out, int rows,
                           int width, int batches, cudaStream_t s) {
  if (width % 4 || batches <= 0 || batches > 65535 || rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t n4 = (size_t)width / 4;
  sum_rows_kernel<<<dim3((unsigned)((n4 + 255) / 256), batches), 256, 0, s>>>(
      part, out, rows, n4);
  return (int)cudaGetLastError();
}

// Host: per-(n, t) column sums of slot-ordered rows (column_sums_kernel).
inline int launch_column_sums(const float* rows, const int* valid, float* out,
                              int N, int P, int width, int T, cudaStream_t s) {
  column_sums_kernel<<<dim3((width + 31) / 32, T, N), dim3(32, 8), 0, s>>>(
      rows, valid, out, P, width, T);
  return (int)cudaGetLastError();
}

}  // namespace
