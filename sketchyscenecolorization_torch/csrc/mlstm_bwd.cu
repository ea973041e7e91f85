// Masked pixel-LSTM backward (BPTT) for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel `_mlstm_bwd_kernel` (sketchyscenecolorization_tpu/
// ops/pallas_mlstm.py, called through `mlstm_pallas_bwd`).  Given the inputs
// of the forward (csrc/mlstm_fwd.cu) and g = dL/dh_final [N, P, H], it
// returns
//
//     d_pixel [N, P, 4H]   (per pixel, summed over steps)
//     d_step  [N, T, 4H]   (summed over pixels; 0 at masked steps)
//     d_W_h   [H, 4H]      (summed over batch, steps and pixels)
//
// with the gate algebra of the TPU kernel (TF BasicLSTMCell, gates i, j, f,
// o, forget bias 1): per valid step, backwards,
//
//     do = dh*tanh(c)*so*(1-so);  dc' = dc + dh*so*(1-tanh(c)^2)
//     df = dc'*c_prev*sf*(1-sf);  di = dc'*tj*si*(1-si);  dj = dc'*si*(1-tj^2)
//     dh = [di dj df do] @ W_h^T;  dc = dc'*sf
//
// A masked step leaves dh and dc unchanged and contributes nothing.
//
// Instantiated with kAttn it is B4, the backward of the word-attention
// variant B3 (csrc/mlstm_fwd.cu), which replaces the TPU kernel
// `_mlstm_attn_bwd_kernel` (pallas_mlstm.py, `mlstm_attn_pallas_bwd`).  Its
// g is dL/dacc, acc = sum over kept steps of attn[n, t] * h_t, so dh starts
// at 0 and gains attn[n, t] * g at every kept step before that step's cell
// gradient, and d_attn[n, t] = sum over pixels and units of g * h_t at a kept
// step (0 at a masked one).
//
// What bounds it on an H100: the products.  Per batch row and valid step
// after the first there are three [P, H] x [H, 4H]-sized products (the
// recomputed forward h @ W_h, dh = dgates @ W_h^T, and h_prev^T dgates for
// d_W_h): 55 GFLOP per step at the matching shape (N=1, P=9216, H=500).  On
// the CUDA cores in f32 (67 TFLOP/s) that is 4.95 ms at 7 valid steps; here
// they run on the tensor cores in 3xTF32, three TF32 products per f32
// product at 495 TFLOP/s, 2.0 ms.  The bytes the function must move take
// about 0.05 ms; the staged trajectory (1.7 GB at that shape) and the cell
// epilogues move about 2 GB through HBM, 0.6 ms.
//
// Design (csrc/lstm_tc.cuh: the recurrence carried from launch to launch,
// one slot rank per launch, 3xTF32 products, gate-interleaved W_h).  The
// TPU kernel kept each tile's h/c trajectory in VMEM and carried the
// recurrence inside one grid step.  All launches run on one stream without
// float atomics: two calls give bit-identical gradients.
//   1. Layout, once per call: the slot table (lstm_slots_kernel) and W_h
//      permuted and zero-padded to [Hp, 4Hp] (lstm_layout_kernel).
//   2. Staging forward, k = 0 .. T-1: mlstm_stage_kernel<kModeStage>, the
//      kernel that is B1 and B3 in their modes (csrc/mlstm_fwd.cu): gates =
//      h_{k-1} @ W_h (no product at k = 0, where h = 0) in 128x128 tiles, the
//      epilogue adds pixel_term and step_term[n, t] and writes the
//      pre-activation gates to stage_g slot k and c, h to stage_c/stage_h
//      slot k ([T, N*P, 4Hp] and [T, N*P, Hp]).
//   3. Reverse sweep, k = T-1 .. 0: dh = dgates_{k+1} @ W_h^T in 64x64 tiles
//      of (rows x hidden units), with no product at a row's last slot (dh =
//      g, or 0 for B4); B4 adds attn[n, t] * g.  The epilogue is the cell
//      gradient of slot k: dc lives in an [N*P, Hp] buffer that only the
//      tile owning an element touches, the dgates overwrite the gates in
//      stage_g, d_pixel is stored at the row's last slot and added to after.
//      Each row is aligned at its own last slot; all-masked rows get d_pixel
//      = 0 in the first launch.
//   4. d_W_h = sum over rows and slots k >= 1 of h_{k-1}^T dgates_k
//      (lstm_rows_product_kernel): one product whose K runs over the staged
//      rows (dead rows zero-filled), split into `splits` interleaved K
//      ranges whose partials are summed in a fixed order, then un-permuted
//      (lstm_weight_sum_kernel).
//   5. d_step: column sums of the dgates over pixels in a fixed order
//      (ordered_column_sum); B4's d_attn: per-chunk partials of g . h_k
//      summed in chunk order (lstm_ordered_sum_kernel).
// The accumulator tile is staged through shared memory before the cell
// epilogues.  The kernels take any H: the pixel and step terms, g and
// d_pixel are read and written one float at a time.
//
// Measured on an H100 (chip_smoke.py, PERF.md): 9.6 ms at the matching
// shape, where the earlier CUDA-core design took 17.3; staging forward 2.9
// ms, sweep 3.9, d_W_h 2.5, d_step 0.2.  What holds it back: the products
// run at 120-180 TFLOP/s of TF32 work, issue-bound with every warp
// splitting its own fragments (four integer/float operations per element
// loaded) and folding its sums, and the cell epilogues (0.13-0.14 ms per
// slot each way) do not overlap the products.  wgmma from swizzled shared
// memory, operands split once per block, and epilogues overlapped with the
// next tile are later work.

#include "lstm_tc.cuh"

namespace {

constexpr int kAttnRows = 64;    // pixel rows of one d_attn partial

// Reverse sweep at slot rank k over a 64-row x 64-unit tile: dh =
// dgates_{k+1} @ W_h^T (rows that have a slot k+1), then the cell gradient.
// Small tiles, three blocks per SM: 1152 blocks at the matching shape fill
// 2.9 waves of 396 (128-row tiles filled 2.2 of 264, so ran three).
template <bool kAttn>
__global__ void __launch_bounds__(kThreads, 3)
mlstm_bwd_sweep_kernel(const float* __restrict__ gout,    // [N*P, H]
                       const float* __restrict__ attn,    // [N, T] (kAttn)
                       const float* __restrict__ wp,      // [Hp, 4Hp]
                       const int* __restrict__ slot_t,    // [N, T] (+2)
                       const float* __restrict__ cs,      // [T, N*P, Hp]
                       float* __restrict__ sg,            // [T, N*P, 4Hp]
                       float* __restrict__ dc,            // [N*P, Hp]
                       float* __restrict__ dpix,          // [N*P, 4H]
                       int N, int P, int H, int Hp, int T, int k) {
  using G = SweepTile;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* row_t = reinterpret_cast<int*>(smem + G::FLOATS);   // [ROWS]
  int* row_more = row_t + G::ROWS;                         // [ROWS]
  const int M = N * P, H4 = 4 * H, H4p = 4 * Hp;
  const int m0 = blockIdx.y * G::ROWS, u0 = blockIdx.x * G::COLS;
  int live = 0, more = 0;
  if (threadIdx.x < G::ROWS) {
    const int m = m0 + threadIdx.x;
    int t = -1;
    if (m < M) {
      const int* srow = slot_t + (m / P) * T;
      t = srow[k];
      more = k + 1 < T && srow[k + 1] >= 0;
      if (t < 0 && k == T - 1 && srow[0] < 0) t = -2;   // no valid step
    }
    row_t[threadIdx.x] = t;
    row_more[threadIdx.x] = more;
    live = t != -1;
  }
  if (!__syncthreads_or(live)) return;
  const bool product = __syncthreads_or(more);

  float acc[G::MT][G::NT][4];
  const float* a_src = product ? sg + ((size_t)(k + 1) * M + m0) * H4p : sg;
  tile_product<G>(acc, smem, product ? H4p / kBK : 0,
                  [&](float* As, float* Bs, int kt) {
    stage_inner<G::LDA>(As, a_src + kt * kBK, H4p, G::ROWS, M - 1 - m0);
    stage_inner<G::LDB>(Bs, wp + (size_t)u0 * H4p + kt * kBK, H4p, G::COLS,
                        G::COLS - 1);
  });
  store_tile<G>(acc, smem);
  __syncthreads();

  const int uu = threadIdx.x % G::COLS;
  const int u = u0 + uu;
  for (int r = threadIdx.x / G::COLS; r < G::ROWS; r += kThreads / G::COLS) {
    const int t = row_t[r];
    if (t == -1) continue;
    const int m = m0 + r, n = m / P;
    float* dp = dpix + (size_t)m * H4 + u;
    if (t == -2) {                        // nothing flows back to the inputs
      if (u < H) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dp[g * H] = 0.0f;
      }
      continue;
    }
    float* gr = sg + ((size_t)k * M + m) * H4p;
    if (u >= H) {                         // padding: dgates 0
#pragma unroll
      for (int g = 0; g < 4; ++g) gr[perm_col(g, u)] = 0.0f;
      continue;
    }
    const bool first = !row_more[r];      // the row's last slot
    const float gv = gout[(size_t)m * H + u];
    float dh = first ? (kAttn ? 0.0f : gv) : smem[r * G::LDC + uu];
    if (kAttn) dh += attn[n * T + t] * gv;
    const float c_prev = k > 0 ? cs[((size_t)(k - 1) * M + m) * Hp + u] : 0.0f;
    float d[4];
    cell_backward(gr, u, c_prev, dh, dc + (size_t)m * Hp + u, first, d);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gr[perm_col(g, u)] = d[g];
      dp[g * H] = first ? d[g] : dp[g * H] + d[g];
    }
  }
}

// d_step[n, t, col] = sum over p of the dgates of row n's slot for step t
// (0 at a masked step), in ordered_column_sum's order; block (32 columns, 8
// pixel lanes).
__global__ void mlstm_bwd_step_sums_kernel(const float* __restrict__ sg,
                                           const int* __restrict__ valid,
                                           float* __restrict__ dstep, int N,
                                           int P, int H, int Hp, int T) {
  const int H4 = 4 * H;
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int t = blockIdx.y, n = blockIdx.z;
  const int* vrow = valid + n * T;
  const bool kept = vrow[t] != 0;
  const int r0 = kept ? (valid_before(vrow, T, t) * N + n) * P : 0;
  const float total = ordered_column_sum(
      sg, 4 * (size_t)Hp, col < H4 ? perm_col(col / H, col % H) : 0,
      kept && col < H4, r0, r0 + P, [](int) { return true; });
  if (threadIdx.y == 0 && col < H4) {
    dstep[((size_t)n * T + t) * H4 + col] = total;
  }
}

// B4: attn_part[n, t, chunk] = sum over the chunk's kAttnRows pixel rows
// and the units of g * h_t (h_t = stage_h at the step's slot), in a fixed
// tree order; 0 at a masked step.
__global__ void mlstm_bwd_attn_part_kernel(const float* __restrict__ gout,
                                           const float* __restrict__ hs,
                                           const int* __restrict__ valid,
                                           float* __restrict__ attn_part,
                                           int N, int P, int H, int Hp,
                                           int T) {
  __shared__ float red[kThreads];
  const int n = blockIdx.y / T, t = blockIdx.y % T;
  const int* vrow = valid + n * T;
  const int p0 = blockIdx.x * kAttnRows;
  const int rows = min(kAttnRows, P - p0);
  float s = 0.0f;
  if (vrow[t] != 0) {
    const int k = valid_before(vrow, T, t);
    const float* g = gout + ((size_t)n * P + p0) * H;
    const float* h = hs + ((size_t)k * N * P + (size_t)n * P + p0) * Hp;
    for (int i = threadIdx.x; i < rows * H; i += kThreads) {
      s = fmaf(g[i], h[(size_t)(i / H) * Hp + i % H], s);
    }
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    attn_part[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = red[0];
  }
}

template <bool kAttn>
int bwd(const float* pixel, const float* step, const float* wh,
        const int* valid, const float* attn, const float* gout, float* dpix,
        float* dstep, float* dwh, float* dattn, float* wp, int* slot_t,
        float* hs, float* cs, float* sg, float* dc, float* part,
        float* attn_part, int N, int P, int H, int T, int Hp, int splits,
        void* stream) {
  const long long M = (long long)N * P;
  if (N <= 0 || P <= 0 || T <= 0 || H <= 0 || Hp < H || Hp % kPad != 0 ||
      N > 65535 || T > 65535 || M > 65535LL * SweepTile::ROWS ||
      splits <= 0 ||
      splits > 65535 || M * T + kBK * (long long)splits >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H4p = 4 * Hp;
  int rc = set_smem(mlstm_stage_kernel<kModeStage>, FwdTile::BYTES);
  if (rc == 0) rc = set_smem(mlstm_bwd_sweep_kernel<kAttn>, SweepTile::BYTES);
  if (rc == 0) rc = set_smem(lstm_rows_product_kernel, DwhTile::BYTES);
  if (rc != 0) return rc;

  lstm_slots_kernel<<<1, kThreads, 0, s>>>(valid, slot_t, N, T);
  const size_t n_wp = (size_t)Hp * H4p;
  lstm_layout_kernel<<<(unsigned)((n_wp + 255) / 256), 256, 0, s>>>(wh, wp, H,
                                                                     Hp);
  for (int k = 0; k < T; ++k) {
    mlstm_stage_kernel<kModeStage><<<dim3(H4p / FwdTile::COLS,
                                          (unsigned)((M + FwdTile::ROWS - 1)
                                                     / FwdTile::ROWS)),
                                     kThreads, FwdTile::BYTES, s>>>(
        pixel, step, wp, slot_t, nullptr, hs, cs, sg, nullptr, N, P, H, Hp,
        T, k);
  }
  for (int k = T - 1; k >= 0; --k) {
    mlstm_bwd_sweep_kernel<kAttn><<<dim3(Hp / SweepTile::COLS,
                                          (unsigned)((M + SweepTile::ROWS - 1)
                                                     / SweepTile::ROWS)),
                                     kThreads,
                                     SweepTile::BYTES, s>>>(
        gout, attn, wp, slot_t, cs, sg, dc, dpix, N, P, H, Hp, T, k);
  }
  lstm_rows_product_kernel<<<dim3(H4p / DwhTile::COLS, Hp / DwhTile::ROWS,
                                  splits),
                             kThreads, DwhTile::BYTES, s>>>(
      hs, Hp, sg, H4p, slot_t, part, N, P, T, 1);
  lstm_weight_sum_kernel<<<blocks_of((size_t)H * 4 * H, 256), 256, 0, s>>>(
      part, dwh, H, Hp, 1, splits);
  mlstm_bwd_step_sums_kernel<<<dim3(blocks_of(4 * (size_t)H, 32), T, N),
                               dim3(32, 8), 0, s>>>(sg, valid, dstep, N, P, H,
                                                    Hp, T);
  if (kAttn) {
    const int chunks = (P + kAttnRows - 1) / kAttnRows;
    mlstm_bwd_attn_part_kernel<<<dim3(chunks, N * T), kThreads, 0, s>>>(
        gout, hs, valid, attn_part, N, P, H, Hp, T);
    // d_attn[n, t] = attn_part[n, t, :] summed in chunk order
    lstm_ordered_sum_kernel<<<dim3(blocks_of((size_t)N * T, 256), 1), 256, 0,
                              s>>>(attn_part, dattn, 1, chunks, N * T, 1,
                                   chunks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code; 0 is success.  The wrapper
// (ops/mlstm.py: mlstm_bwd_cuda, bwd_geometry) allocates the outputs and
// the scratch: wp [Hp, 4Hp], slot_t int [N*T + 2], stage_h and stage_c
// [T, N*P, Hp], stage_g [T, N*P, 4Hp], dc [N*P, Hp] and the d_W_h partials
// [splits, Hp, 4Hp]; Hp is H rounded up to a multiple of 128.  Every
// pointer 16-byte aligned.
extern "C" int mlstm_bwd(const float* pixel, const float* step,
                         const float* wh, const int* valid, const float* gout,
                         float* dpix, float* dstep, float* dwh, float* wp,
                         int* slot_t, float* stage_h, float* stage_c,
                         float* stage_g, float* dc, float* partials, int N,
                         int P, int H, int T, int Hp, int splits,
                         void* stream) {
  return bwd<false>(pixel, step, wh, valid, nullptr, gout, dpix, dstep, dwh,
                    nullptr, wp, slot_t, stage_h, stage_c, stage_g, dc,
                    partials, nullptr, N, P, H, T, Hp, splits, stream);
}

// B4: the same plus attn [N, T] in, d_attn [N, T] out, and the d_attn
// partials attn_part [N, T, ceil(P / 64)] (scratch); gout is dL/dacc.
extern "C" int mlstm_attn_bwd(const float* pixel, const float* step,
                              const float* wh, const int* valid,
                              const float* attn, const float* gout,
                              float* dpix, float* dstep, float* dwh,
                              float* dattn, float* wp, int* slot_t,
                              float* stage_h, float* stage_c, float* stage_g,
                              float* dc, float* partials, float* attn_part,
                              int N, int P, int H, int T, int Hp, int splits,
                              void* stream) {
  return bwd<true>(pixel, step, wh, valid, attn, gout, dpix, dstep, dwh,
                   dattn, wp, slot_t, stage_h, stage_c, stage_g, dc, partials,
                   attn_part, N, P, H, T, Hp, splits, stream);
}
