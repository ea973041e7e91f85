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
// g is dL/dacc, acc = sum over kept steps of attn[n, t] * h_t, so
//   * dh starts at 0 and gains attn[n, t] * g at every kept step, before
//     that step's cell gradient (g is read again from device memory at each
//     step: the sweep's registers are full);
//   * d_attn[n, t] = sum over pixels and units of g * h_t at a kept step
//     (0 at a masked one), where h_t = so * tanh(c_t) is the step's new h,
//     which the cell gradient computes anyway.  Each sweep block reduces its
//     tile's share in shared memory in a fixed tree order and writes it to
//     a partial [N, T, tiles]; a last kernel adds the tiles in order.
// Everything else (staging forward, d_W_h without slot 0, d_step) is B2's.
//
// Design.  The TPU kernel kept each tile's h/c trajectory in VMEM and summed
// d_step and d_W_h into output blocks that its sequential grid revisits.  A
// GPU has neither 0.5 GB of on-chip memory nor a sequential grid, so the
// work is five launches on one stream, with no float atomics (two calls give
// bit-identical gradients):
//   1. transpose W_h into W_h^T [4H, H] (scratch), so that the reverse
//      product streams contiguous rows;
//   2. the forward kernel of csrc/mlstm_fwd.cu with kStage: it writes the
//      previous h and c and the pre-activation gates of the k-th valid step
//      of each batch row to scratch slot k (T slots; 1.7 GB at the matching
//      shape N=1, P=9216, H=500, T=15);
//   3. the reverse sweep: one block owns a tile of pixels and ALL 4H gate
//      columns of them (each dh = dgates @ W_h^T needs every column).  A
//      thread owns 4 hidden units of 8 pixels, so the cell gradient of its
//      units needs no exchange and dh and dc stay in its registers between
//      steps.  dgates go to shared memory for the product and overwrite the
//      gates in scratch (in place: the same thread reads and writes those
//      elements); d_pixel is accumulated in device memory, which only this
//      block touches.  W_h^T streams from L2 in double-buffered cp.async
//      chunks, as W_h does in the forward.  The first step (last in the
//      sweep) needs no dh, so its product is skipped;
//   4. d_W_h = sum over (n, valid slot, p) of h_prev^T dgates: the tiled f32
//      product rows_product_kernel of csrc/common.cuh (64x64 output tile per
//      block, 4x4 per thread) whose K runs over the staged rows of every
//      valid step but the first (whose h_prev is 0).  When that gives too
//      few blocks the pixels are split into `splits` ranges, each block
//      writes a partial, and a second pass sums the partials in a fixed
//      order;
//   5. d_step = the column sum of dgates over pixels, in a fixed order
//      (column_sums_kernel of csrc/common.cuh).
//
// What bounds it on an H100: f32 FMAs on the CUDA cores.  Three products of
// 2*P*H*4H flops per valid step after the first (the staging forward, dh,
// d_W_h; at the first valid step h_prev = 0): 55 GFLOP per step at the
// matching shape, against 67 TFLOP/s peak (the staging forward still
// multiplies the first step's zero h, as B1 does), while the bytes
// the function must move (inputs once, outputs once) take about 0.05 ms.
// The scratch traffic (staging written, read back by the sweep, dgates
// written, d_pixel updated in place each step, dgates and h read again by
// the two reductions) is at least 4 GB at 7 valid steps, 1.2 ms of HBM
// time.  The products are simple register-tiled loops; wgmma in TF32 or
// bf16, TMA and fusing the reductions into the sweep are later work.

#include "common.cuh"

extern "C" int mlstm_fwd_stage(const float* pixel, const float* step,
                               const float* wh, const int* valid,
                               float* stage_h, float* stage_c, float* stage_g,
                               int N, int P, int H, int T, int tile, int kc,
                               void* stream);

namespace {

constexpr int kPixelsPerThread = 8;   // PP: pixels of a thread in the sweep
constexpr int kUnitsPerThread = 4;    // UU: hidden units of a thread
constexpr int kSweepThreads = 256;

// Copy rows [ch*kc, ch*kc + kc) of W_h^T [4H, H] into `dst`.
__device__ __forceinline__ void load_chunk(float* dst, const float* wt,
                                           int ch, int kc, int H) {
  const int k0 = ch * kc;
  load_rows(dst, wt, k0, min(kc, 4 * H - k0), H);
}

// Sum of v over the block in a fixed tree order (red_s: blockDim floats of
// shared memory); the result is valid in thread 0.  Every thread calls it.
__device__ __forceinline__ float block_sum(float v, float* red_s) {
  red_s[threadIdx.x] = v;
  __syncthreads();
  for (int s = kSweepThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s && threadIdx.x + s < blockDim.x) {
      red_s[threadIdx.x] += red_s[threadIdx.x + s];
    }
    __syncthreads();
  }
  return red_s[0];
}

// Cell gradient of one valid step (scratch slot `slot`, step t) for this
// thread's 4 units of 8 pixels.  Reads dh and updates dc in registers;
// writes dgates to shared memory (zeros for pixel rows past P), in place
// over the staged gates, and into d_pixel (stored at the first step of the
// sweep, added afterwards).  With kAttn, dh gains attn[n, t] * g first and
// the tile's share of d_attn[n, t] goes to attn_part.
template <bool kAttn>
__device__ __forceinline__ void cell_backward(
    float (&dh)[kPixelsPerThread][kUnitsPerThread],
    float (&dc)[kPixelsPerThread][kUnitsPerThread], float* dg_s,
    const float* __restrict__ stage_c, float* __restrict__ stage_g,
    float* __restrict__ dpix, const float* __restrict__ gout,
    const float* __restrict__ attn, float* __restrict__ attn_part,
    float* red_s, int n, int slot, int t, int p0, int r0, int u0, int P,
    int H, int T, bool first) {
  const int H4 = 4 * H;
  const float a = kAttn ? attn[n * T + t] : 0.0f;
  float gh = 0.0f;                // this thread's share of <g, h_t>
#pragma unroll
  for (int q = 0; q < kPixelsPerThread; ++q) {
    const int p = p0 + r0 + q;
    const bool live = p < P;
    const size_t row = ((size_t)n * T + slot) * P + min(p, P - 1);
    float* gr = stage_g + row * H4 + u0;
    float4 gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gate[g] = *reinterpret_cast<const float4*>(gr + g * H);
    }
    const float4 cp4 = *reinterpret_cast<const float4*>(stage_c + row * H + u0);
    float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kAttn) {
      g4 = *reinterpret_cast<const float4*>(
          gout + ((size_t)n * P + min(p, P - 1)) * H + u0);
    }
    const float* gi = &gate[0].x;
    const float* gj = &gate[1].x;
    const float* gf = &gate[2].x;
    const float* go = &gate[3].x;
    const float* cp = &cp4.x;
    const float* gv = &g4.x;
    float d[4][kUnitsPerThread];
#pragma unroll
    for (int u = 0; u < kUnitsPerThread; ++u) {
      const float si = sigmoid_f(gi[u]);
      const float tj = tanhf(gj[u]);
      const float sf = sigmoid_f(gf[u] + 1.0f);
      const float so = sigmoid_f(go[u]);
      const float tc = tanhf(cp[u] * sf + si * tj);
      if (kAttn) {
        if (live) gh = fmaf(gv[u], so * tc, gh);
        dh[q][u] += a * gv[u];
      }
      const float dhu = dh[q][u];
      const float dct = dc[q][u] + dhu * so * (1.0f - tc * tc);
      d[0][u] = dct * tj * si * (1.0f - si);
      d[1][u] = dct * si * (1.0f - tj * tj);
      d[2][u] = dct * cp[u] * sf * (1.0f - sf);
      d[3][u] = dhu * tc * so * (1.0f - so);
      dc[q][u] = dct * sf;
    }
    float* ds = dg_s + (r0 + q) * H4 + u0;
    float* dp = dpix + ((size_t)n * P + min(p, P - 1)) * H4 + u0;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 v = live ? make_float4(d[g][0], d[g][1], d[g][2], d[g][3])
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(ds + g * H) = v;
      if (live) {
        *reinterpret_cast<float4*>(gr + g * H) = v;
        float4* dpg = reinterpret_cast<float4*>(dp + g * H);
        if (first) {
          *dpg = v;
        } else {
          const float4 o = *dpg;
          *dpg = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
      }
    }
  }
  if (kAttn) {
    const float total = block_sum(gh, red_s);
    if (threadIdx.x == 0) {
      attn_part[((size_t)n * T + t) * gridDim.x + blockIdx.x] = total;
    }
  }
}

template <bool kAttn>
__global__ void __launch_bounds__(kSweepThreads)
mlstm_bwd_sweep_kernel(const float* __restrict__ gout,    // [N, P, H]
                       const float* __restrict__ wt,      // [4H, H]
                       const int* __restrict__ valid,     // [N, T]
                       const float* __restrict__ attn,    // [N, T] (kAttn)
                       const float* __restrict__ stage_c, // [N, T, P, H]
                       float* __restrict__ stage_g,       // [N, T, P, 4H]
                       float* __restrict__ dpix,          // [N, P, 4H]
                       float* __restrict__ attn_part,     // [N, T, tiles]
                       int P, int H, int T, int tile, int kc) {
  constexpr int PP = kPixelsPerThread;
  constexpr int UU = kUnitsPerThread;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H4 = 4 * H;
  float* const dg_s = smem;                   // [tile, 4H]
  float* const w_stages = dg_s + tile * H4;   // 2 x [kc, H]
  float* const red_s = w_stages + 2 * kc * H; // [kSweepThreads]
  const int stage_size = kc * H;

  const int n = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int groups = H / UU;
  const int u0 = UU * (threadIdx.x % groups);
  const int r0 = PP * (threadIdx.x / groups);
  const int* vrow = valid + n * T;
  const int n_valid = valid_before(vrow, T, T);

  float dh[PP][UU], dc[PP][UU];
#pragma unroll
  for (int q = 0; q < PP; ++q) {
    const int p = min(p0 + r0 + q, P - 1);
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);    // kAttn: dh starts at 0
    if (!kAttn) {
      gv = *reinterpret_cast<const float4*>(gout + ((size_t)n * P + p) * H + u0);
    }
    dh[q][0] = gv.x; dh[q][1] = gv.y; dh[q][2] = gv.z; dh[q][3] = gv.w;
#pragma unroll
    for (int u = 0; u < UU; ++u) dc[q][u] = 0.0f;
  }

  if (n_valid == 0) {              // nothing flows back to the inputs
#pragma unroll
    for (int q = 0; q < PP; ++q) {
      const int p = p0 + r0 + q;
      if (p >= P) continue;
      float* dp = dpix + ((size_t)n * P + p) * H4 + u0;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        *reinterpret_cast<float4*>(dp + g * H) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  const int n_chunks = (H4 + kc - 1) / kc;
  const int total = (n_valid - 1) * n_chunks;  // no dh after the first step
  int slot = n_valid - 1;
  int t = slot_step(vrow, T, slot);
  if (total > 0) load_chunk(w_stages, wt, 0, kc, H);
  cell_backward<kAttn>(dh, dc, dg_s, stage_c, stage_g, dpix, gout, attn,
                       attn_part, red_s, n, slot, t, p0, r0, u0, P, H, T,
                       true);

  for (int it = 0; it < total; ++it) {
    const int ch = it % n_chunks;
    if (ch == 0) {
#pragma unroll
      for (int q = 0; q < PP; ++q) {
#pragma unroll
        for (int u = 0; u < UU; ++u) dh[q][u] = 0.0f;
      }
    }
    cp_async_wait_all();           // chunk `it` has landed (own copies) ...
    __syncthreads();               // ... for every thread; dg_s is written
    if (it + 1 < total) {
      load_chunk(w_stages + ((it + 1) & 1) * stage_size, wt,
                 (it + 1) % n_chunks, kc, H);
    }
    const float* ws = w_stages + (it & 1) * stage_size + u0;
    const int k0 = ch * kc;
    const int rows = min(kc, H4 - k0);
    const float* dk = dg_s + r0 * H4 + k0;
    for (int kk = 0; kk < rows; kk += 4) {
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = *reinterpret_cast<const float4*>(ws + (kk + j) * H);
      }
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const float4 dv = *reinterpret_cast<const float4*>(dk + q * H4 + kk);
        const float dvs[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dh[q][0] = fmaf(dvs[j], w[j].x, dh[q][0]);
          dh[q][1] = fmaf(dvs[j], w[j].y, dh[q][1]);
          dh[q][2] = fmaf(dvs[j], w[j].z, dh[q][2]);
          dh[q][3] = fmaf(dvs[j], w[j].w, dh[q][3]);
        }
      }
    }
    if (ch == n_chunks - 1) {      // dh of the previous valid step is done
      --slot;
      do {
        --t;
      } while (vrow[t] == 0);
      __syncthreads();             // every thread has finished with dg_s
      cell_backward<kAttn>(dh, dc, dg_s, stage_c, stage_g, dpix, gout, attn,
                           attn_part, red_s, n, slot, t, p0, r0, u0, P, H, T,
                           false);
    }
  }
}

// d_attn[n, t] = sum over tiles of attn_part[n, t, tile] in tile order at a
// valid step, else 0.
__global__ void attn_sum_kernel(const float* __restrict__ attn_part,
                                const int* __restrict__ valid,
                                float* __restrict__ dattn, int NT, int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NT) return;
  float s = 0.0f;
  if (valid[i] != 0) {
    for (int k = 0; k < tiles; ++k) s += attn_part[(size_t)i * tiles + k];
  }
  dattn[i] = s;
}

template <bool kAttn>
int bwd(const float* pixel, const float* step, const float* wh,
        const int* valid, const float* attn, const float* gout, float* dpix,
        float* dstep, float* dwh, float* dattn, float* wt, float* stage_h,
        float* stage_c, float* stage_g, float* partials, float* attn_part,
        int N, int P, int H, int T, int fwd_tile, int fwd_kc, int tile,
        int kc, int splits, void* stream) {
  const int threads = (H / kUnitsPerThread) * (tile / kPixelsPerThread);
  if (N <= 0 || P <= 0 || T <= 0 || H <= 0 || H % 4 != 0 || N > 65535 ||
      T > 65535 || tile <= 0 || tile % kPixelsPerThread != 0 ||
      threads > kSweepThreads || kc <= 0 || kc % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H4 = 4 * H;

  int rc = launch_transpose(wh, wt, H, H4, s);
  if (rc != 0) return rc;
  rc = mlstm_fwd_stage(pixel, step, wh, valid, stage_h, stage_c, stage_g, N,
                       P, H, T, fwd_tile, fwd_kc, stream);
  if (rc != 0) return rc;

  const size_t smem = (size_t)4 * (tile * H4 + 2 * kc * H + kSweepThreads);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_sweep_kernel<kAttn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (P + tile - 1) / tile;
  mlstm_bwd_sweep_kernel<kAttn><<<dim3(tiles, N), threads, smem, s>>>(
      gout, wt, valid, attn, stage_c, stage_g, dpix, attn_part, P, H, T, tile,
      kc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // d_W_h: slot 0 is left out, its h_prev is the initial h = 0
  rc = launch_rows_product(stage_h, H, H, stage_g, H4, H4, valid, dwh,
                           partials, N, P, T, 1, splits, s);
  if (rc != 0) return rc;
  rc = launch_column_sums(stage_g, valid, dstep, N, P, H4, T, s);
  if (rc != 0 || !kAttn) return rc;
  attn_sum_kernel<<<(N * T + 255) / 256, 256, 0, s>>>(attn_part, valid, dattn,
                                                       N * T, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code; 0 is success.  The wrapper
// (ops/mlstm.py: mlstm_bwd_cuda) allocates the outputs and the scratch:
// wt [4H, H], stage_h and stage_c [N, T, P, H], stage_g [N, T, P, 4H] and,
// when splits > 1, partials [splits, H, 4H].  fwd_tile/fwd_kc are the
// forward's geometry (launch_geometry), tile/kc the sweep's
// (bwd_geometry).  H must be a multiple of 4, every pointer 16-byte
// aligned.
extern "C" int mlstm_bwd(const float* pixel, const float* step,
                         const float* wh, const int* valid, const float* gout,
                         float* dpix, float* dstep, float* dwh, float* wt,
                         float* stage_h, float* stage_c, float* stage_g,
                         float* partials, int N, int P, int H, int T,
                         int fwd_tile, int fwd_kc, int tile, int kc,
                         int splits, void* stream) {
  return bwd<false>(pixel, step, wh, valid, nullptr, gout, dpix, dstep, dwh,
                    nullptr, wt, stage_h, stage_c, stage_g, partials, nullptr,
                    N, P, H, T, fwd_tile, fwd_kc, tile, kc, splits, stream);
}

// B4: the same plus attn [N, T] in, d_attn [N, T] out, and the per-tile
// d_attn partials attn_part [N, T, ceil(P / tile)] (scratch); gout is
// dL/dacc.
extern "C" int mlstm_attn_bwd(const float* pixel, const float* step,
                              const float* wh, const int* valid,
                              const float* attn, const float* gout,
                              float* dpix, float* dstep, float* dwh,
                              float* dattn, float* wt, float* stage_h,
                              float* stage_c, float* stage_g, float* partials,
                              float* attn_part, int N, int P, int H, int T,
                              int fwd_tile, int fwd_kc, int tile, int kc,
                              int splits, void* stream) {
  return bwd<true>(pixel, step, wh, valid, attn, gout, dpix, dstep, dwh,
                   dattn, wt, stage_h, stage_c, stage_g, partials, attn_part,
                   N, P, H, T, fwd_tile, fwd_kc, tile, kc, splits, stream);
}
