// RecurAttn pixel-LSTM backward (B6) for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel `_recur_attn_bwd_kernel` (sketchyscenecolorization_
// tpu/ops/pallas_mlstm.py, called through `recur_attn_pallas_bwd`).  Given
// the inputs of the forward (csrc/recur_attn_fwd.cu) and g = dL/dh_final
// [N, P, H], it returns d_h0 [N, P, H], d_lang [N, T, w], d_Wp [H, w],
// d_bp [w], d_Wm [w + H, 4H] and d_bm [4H], with the algebra of the TPU
// kernel: per kept step, backwards,
//
//     dgates = the TF cell gradient of (dh, dc)       (as csrc/mlstm_bwd.cu)
//     dx     = dgates @ Wm_a^T                       (Wm_a = Wm[:w])
//     dattn  = dx . lang[t] for every t;  dlogits = attn * (dattn - <dattn, attn>)
//     dhp    = dlogits @ lang
//     dh     = dhp @ Wp^T + dgates @ Wm_h^T          (Wm_h = Wm[w:])
//     d_Wm  += [x, h_prev]^T dgates;  d_bm += dgates;  d_Wp += h_prev^T dhp;
//     d_bp  += dhp;  d_lang[n] += attn^T dx + dlogits^T h_proj
//
// and d_h0 is the dh left after the first kept step.  A masked step leaves
// dh and dc unchanged and contributes nothing.  Takes w == H, H a multiple
// of 64 up to 512, T <= 16 (the forward's limits).
//
// Design: a staging forward, a reverse sweep whose blocks carry the
// recurrence of their pixels, and ordered reductions, with no float
// atomics, so two calls give bit-identical gradients.  Launches on one
// stream:
//   1. transpose Wm [2H, 4H] and Wp [H, H] (scratch), so that the reverse
//      products stream contiguous rows;
//   2. the forward kernel with kStage: for the k-th kept step of each batch
//      row, scratch slot k receives [x, h_prev], c_prev, the gates, h_proj
//      and attn (1.3 GB at the RecurAttn shape N=1, P=9216, H=256, T=15);
//   3. the reverse sweep: one block owns a tile of pixels and all columns of
//      them; a thread owns 2 units of 8 pixels, so its cell gradient needs
//      no exchange and dh and dc stay in its registers between steps.  Per
//      kept step: the cell gradient writes dgates to shared memory and over
//      the staged gates; [dx, dh] = dgates @ Wm^T streams Wm^T in chunks of
//      kc rows; one warp per pixel row then computes dattn, dlogits and
//      dhp = dlogits @ lang (lang[n] resident in shared memory), writes dhp
//      to scratch and adds the tile's attn^T dx + dlogits^T h_proj to a
//      d_lang partial that the block keeps in shared memory for the whole
//      sweep; dh += dhp @ Wp^T streams Wp^T in chunks of 2*kc rows.  The
//      first kept step (last in the sweep) has a real product too: h0 is
//      not 0 and its dh is d_h0, which trains the visual projection;
//   4. the reductions: d_Wm = sum of [x, h_prev]^T dgates and d_Wp = sum of
//      h_prev^T dhp over every kept step from slot 0, both by
//      rows_product_kernel (csrc/common.cuh) with split partials summed in
//      order; d_bm and d_bp as per-step column sums (column_sums_kernel)
//      summed in order; d_lang as the per-tile partials summed in tile
//      order (sum_rows_kernel).
//
// What bounds it on an H100: f32 FMAs on the CUDA cores.  Per pixel and
// kept step it needs the forward's products (staging) plus dgates @ Wm^T
// (2H*4H), dx . lang and dlogits @ lang (2*T*w), dhp @ Wp^T (H*w), and the
// weight-gradient products [x, h]^T dgates (2H*4H), h^T dhp (H*w) and the
// two d_lang products (2*T*w): 3x B5's work, 231 GFLOP at the
// RecurAttn shape with 7 kept steps, 3.45 ms at 67 TFLOP/s.  wgmma in TF32
// or bf16, TMA and fusing the reductions into the sweep are later work.

#include "common.cuh"

extern "C" int recur_attn_fwd_stage(const float* h0, const float* lang,
                                    const float* wp, const float* bp,
                                    const float* wm, const float* bm,
                                    const int* valid, float* stage_xh,
                                    float* stage_c, float* stage_g,
                                    float* stage_hp, float* stage_attn, int N,
                                    int P, int H, int T, int tile, int kc,
                                    void* stream);

namespace {

constexpr int kPixelsPerThread = 8;   // PP: pixels of a thread in the sweep
constexpr int kThreads = 256;
constexpr int kMaxT = 16;

// Cell gradient of one kept step (scratch slot `slot`) for this thread's 2
// units of 8 pixels.  Reads dh and updates dc in registers; writes dgates
// to shared memory (zeros for pixel rows past P) and in place over the
// staged gates.
__device__ __forceinline__ void cell_backward(
    float (&dh)[kPixelsPerThread][2], float (&dc)[kPixelsPerThread][2],
    float* dg_s, const float* __restrict__ stage_c,
    float* __restrict__ stage_g, int n, int slot, int p0, int r0, int u0,
    int P, int H, int T) {
  const int H4 = 4 * H;
#pragma unroll
  for (int q = 0; q < kPixelsPerThread; ++q) {
    const int p = p0 + r0 + q;
    const bool live = p < P;
    const size_t row = ((size_t)n * T + slot) * P + min(p, P - 1);
    float* gr = stage_g + row * H4 + u0;
    float2 gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gate[g] = *reinterpret_cast<const float2*>(gr + g * H);
    }
    const float2 cp2 = *reinterpret_cast<const float2*>(stage_c + row * H + u0);
    const float* gi = &gate[0].x;
    const float* gj = &gate[1].x;
    const float* gf = &gate[2].x;
    const float* go = &gate[3].x;
    const float* cp = &cp2.x;
    float d[4][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float si = sigmoid_f(gi[u]);
      const float tj = tanhf(gj[u]);
      const float sf = sigmoid_f(gf[u] + 1.0f);
      const float so = sigmoid_f(go[u]);
      const float tc = tanhf(cp[u] * sf + si * tj);
      const float dhu = dh[q][u];
      const float dct = dc[q][u] + dhu * so * (1.0f - tc * tc);
      d[0][u] = dct * tj * si * (1.0f - si);
      d[1][u] = dct * si * (1.0f - tj * tj);
      d[2][u] = dct * cp[u] * sf * (1.0f - sf);
      d[3][u] = dhu * tc * so * (1.0f - so);
      dc[q][u] = dct * sf;
    }
    float* ds = dg_s + (r0 + q) * H4 + u0;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float2 v = live ? make_float2(d[g][0], d[g][1])
                            : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(ds + g * H) = v;
      if (live) *reinterpret_cast<float2*>(gr + g * H) = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
recur_attn_sweep_kernel(const float* __restrict__ gout,       // [N, P, H]
                        const float* __restrict__ lang,       // [N, T, H]
                        const float* __restrict__ wmt,        // [4H, 2H]
                        const float* __restrict__ wpt,        // [H, H]
                        const int* __restrict__ valid,        // [N, T]
                        const float* __restrict__ stage_c,    // [N, T, P, H]
                        float* __restrict__ stage_g,          // [N, T, P, 4H]
                        const float* __restrict__ stage_hp,   // [N, T, P, H]
                        const float* __restrict__ stage_attn, // [N, T, P, T]
                        float* __restrict__ dhp_out,          // [N, T, P, H]
                        float* __restrict__ dh0,              // [N, P, H]
                        float* __restrict__ lang_part,  // [N, tiles, T, H]
                        int P, int H, int T, int tile, int kc) {
  constexpr int PP = kPixelsPerThread;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H2 = 2 * H, H4 = 4 * H;
  float* const dg_s = smem;                       // [tile, 4H]
  float* const w_stages = dg_s + tile * H4;       // 2 x [kc * 2H]
  float* const dx_s = w_stages + 2 * kc * H2;     // [tile, H]
  float* const dhp_s = dx_s + tile * H;           // [tile, H]
  float* const hp_s = dhp_s + tile * H;           // [tile, H]
  float* const at_s = hp_s + tile * H;            // [tile, kMaxT]
  float* const dl_s = at_s + tile * kMaxT;        // [tile, kMaxT]
  float* const lang_s = dl_s + tile * kMaxT;      // [T, H]
  float* const dlang_s = lang_s + T * H;          // [T, H]
  const int stage_size = kc * H2;

  const int n = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int half_h = H / 2;
  const int u0 = 2 * (threadIdx.x % half_h);
  const int r0 = PP * (threadIdx.x / half_h);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const int* vrow = valid + n * T;
  const int n_valid = valid_before(vrow, T, T);
  float* const part = lang_part + ((size_t)n * gridDim.x + blockIdx.x) * T * H;

  float dh[PP][2], dc[PP][2], dxa[PP][2];
#pragma unroll
  for (int q = 0; q < PP; ++q) {
    const int p = min(p0 + r0 + q, P - 1);
    const float2 gv =
        *reinterpret_cast<const float2*>(gout + ((size_t)n * P + p) * H + u0);
    dh[q][0] = gv.x; dh[q][1] = gv.y;
    dc[q][0] = dc[q][1] = 0.0f;
  }
  for (int i = threadIdx.x; i < T * H; i += blockDim.x) {
    lang_s[i] = lang[(size_t)n * T * H + i];
    dlang_s[i] = 0.0f;
  }

  const int kp = 2 * kc;                          // Wp^T rows per chunk
  const int n1 = (H4 + kc - 1) / kc;              // Wm^T chunks per step
  const int n2 = (H + kp - 1) / kp;               // Wp^T chunks per step
  const int per_step = n1 + n2;
  const int total = n_valid * per_step;
  int slot = n_valid - 1;
  if (total > 0) {
    load_rows(w_stages, wmt, 0, min(kc, H4), H2);
    cell_backward(dh, dc, dg_s, stage_c, stage_g, n, slot, p0, r0, u0, P, H,
                  T);
  }

  for (int it = 0; it < total; ++it) {
    const int ch = it % per_step;
    if (ch == 0) {
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        dh[q][0] = dh[q][1] = 0.0f;
        dxa[q][0] = dxa[q][1] = 0.0f;
      }
    }
    cp_async_wait_all();           // chunk `it` has landed (own copies) ...
    __syncthreads();               // ... for every thread; dg_s, dhp_s written
    if (it + 1 < total) {
      const int nx = (it + 1) % per_step;
      float* dst = w_stages + ((it + 1) & 1) * stage_size;
      if (nx < n1) {
        load_rows(dst, wmt, nx * kc, min(kc, H4 - nx * kc), H2);
      } else {
        const int k0 = (nx - n1) * kp;
        load_rows(dst, wpt, k0, min(kp, H - k0), H);
      }
    }
    const float* ws = w_stages + (it & 1) * stage_size + u0;
    if (ch < n1) {                 // [dx, dh] += dgates @ Wm^T
      const int k0 = ch * kc;
      const int rows = min(kc, H4 - k0);
      const float* dk = dg_s + r0 * H4 + k0;
      for (int kk = 0; kk < rows; kk += 4) {
        float2 wx[4], wh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wx[j] = *reinterpret_cast<const float2*>(ws + (kk + j) * H2);
          wh[j] = *reinterpret_cast<const float2*>(ws + (kk + j) * H2 + H);
        }
#pragma unroll
        for (int q = 0; q < PP; ++q) {
          const float4 dv = *reinterpret_cast<const float4*>(dk + q * H4 + kk);
          const float dvs[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dxa[q][0] = fmaf(dvs[j], wx[j].x, dxa[q][0]);
            dxa[q][1] = fmaf(dvs[j], wx[j].y, dxa[q][1]);
            dh[q][0] = fmaf(dvs[j], wh[j].x, dh[q][0]);
            dh[q][1] = fmaf(dvs[j], wh[j].y, dh[q][1]);
          }
        }
      }
      if (ch == n1 - 1) {          // dx is complete: the attention backward
#pragma unroll
        for (int q = 0; q < PP; ++q) {
          *reinterpret_cast<float2*>(dx_s + (r0 + q) * H + u0) =
              make_float2(dxa[q][0], dxa[q][1]);
        }
        __syncthreads();
        for (int r = warp; r < tile; r += n_warps) {   // one warp per row
          const int p = p0 + r;
          const size_t row = ((size_t)n * T + slot) * P + min(p, P - 1);
          const float* dxr = dx_s + r * H;
          float a[kMaxT], dl[kMaxT];
          float s = 0.0f;
#pragma unroll
          for (int tt = 0; tt < kMaxT; ++tt) {
            a[tt] = dl[tt] = 0.0f;
            if (tt < T) {
              float part_d = 0.0f;
              for (int k = lane; k < H; k += 32) {
                part_d = fmaf(dxr[k], lang_s[tt * H + k], part_d);
              }
              dl[tt] = warp_sum(part_d);             // dattn
              a[tt] = stage_attn[row * T + tt];
              s = fmaf(dl[tt], a[tt], s);
            }
          }
#pragma unroll
          for (int tt = 0; tt < kMaxT; ++tt) dl[tt] = a[tt] * (dl[tt] - s);
          if (lane == 0) {
#pragma unroll
            for (int tt = 0; tt < kMaxT; ++tt) {
              at_s[r * kMaxT + tt] = a[tt];
              dl_s[r * kMaxT + tt] = dl[tt];
            }
          }
          for (int col = lane; col < H; col += 32) {
            float v = 0.0f;
#pragma unroll
            for (int tt = 0; tt < kMaxT; ++tt) {
              if (tt < T) v = fmaf(dl[tt], lang_s[tt * H + col], v);
            }
            dhp_s[r * H + col] = v;
            hp_s[r * H + col] = stage_hp[row * H + col];
            if (p < P) dhp_out[row * H + col] = v;
          }
        }
        __syncthreads();
        // d_lang partial: this thread's columns, all T, over the tile
        for (int col = threadIdx.x; col < H; col += blockDim.x) {
          for (int tt = 0; tt < T; ++tt) {
            float v = dlang_s[tt * H + col];
            for (int r = 0; r < tile; ++r) {
              v = fmaf(at_s[r * kMaxT + tt], dx_s[r * H + col], v);
              v = fmaf(dl_s[r * kMaxT + tt], hp_s[r * H + col], v);
            }
            dlang_s[tt * H + col] = v;
          }
        }
      }
    } else {                       // dh += dhp @ Wp^T
      const int k0 = (ch - n1) * kp;
      const int rows = min(kp, H - k0);
      const float* dk = dhp_s + r0 * H + k0;
      for (int kk = 0; kk < rows; kk += 4) {
        float2 w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = *reinterpret_cast<const float2*>(ws + (kk + j) * H);
        }
#pragma unroll
        for (int q = 0; q < PP; ++q) {
          const float4 dv = *reinterpret_cast<const float4*>(dk + q * H + kk);
          const float dvs[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dh[q][0] = fmaf(dvs[j], w[j].x, dh[q][0]);
            dh[q][1] = fmaf(dvs[j], w[j].y, dh[q][1]);
          }
        }
      }
      if (ch == per_step - 1 && slot > 0) {   // dh of the previous kept step
        --slot;
        cell_backward(dh, dc, dg_s, stage_c, stage_g, n, slot, p0, r0, u0, P,
                      H, T);
      }
    }
  }

  // d_h0: the dh left after the first kept step (g itself without one)
#pragma unroll
  for (int q = 0; q < PP; ++q) {
    const int p = p0 + r0 + q;
    if (p < P) {
      *reinterpret_cast<float2*>(dh0 + ((size_t)n * P + p) * H + u0) =
          make_float2(dh[q][0], dh[q][1]);
    }
  }
  // the d_lang partial, written by the threads that summed it (zeros for a
  // row with no kept step)
  for (int col = threadIdx.x; col < H; col += blockDim.x) {
    for (int tt = 0; tt < T; ++tt) part[tt * H + col] = dlang_s[tt * H + col];
  }
}

}  // namespace

// Returns a cudaError_t code; 0 is success.  The wrapper
// (ops/recur_attn.py: recur_attn_bwd_cuda) allocates the outputs and the
// scratch: wmt [4H, 2H], wpt [H, H], stage_xh [N, T, P, 2H], stage_c and
// stage_hp [N, T, P, H], stage_g [N, T, P, 4H], stage_attn [N, T, P, T],
// dhp [N, T, P, H], colsum [N, T, 4H], lang_part [N, tiles, T, H] and
// partials (max(split_wm * 2H * 4H, split_wp * H * H) floats).  tile/kc
// are recur_geometry's, for the staging forward and the sweep alike.
// Every pointer 16-byte aligned.
extern "C" int recur_attn_bwd(
    const float* h0, const float* lang, const float* wp, const float* bp,
    const float* wm, const float* bm, const int* valid, const float* gout,
    float* dh0, float* dlang, float* dwp, float* dbp, float* dwm, float* dbm,
    float* wmt, float* wpt, float* stage_xh, float* stage_c, float* stage_g,
    float* stage_hp, float* stage_attn, float* dhp, float* colsum,
    float* lang_part, float* partials, int N, int P, int H, int T, int tile,
    int kc, int split_wm, int split_wp, void* stream) {
  const int threads = (H / 2) * (tile / kPixelsPerThread);
  if (N <= 0 || N > 65535 || P <= 0 || T <= 0 || T > kMaxT || H <= 0 ||
      H % 64 != 0 || tile <= 0 || tile % kPixelsPerThread != 0 ||
      kc <= 0 || kc % 4 != 0 || threads > kThreads ||
      threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H2 = 2 * H, H4 = 4 * H;

  int rc = launch_transpose(wm, wmt, H2, H4, s);
  if (rc != 0) return rc;
  rc = launch_transpose(wp, wpt, H, H, s);
  if (rc != 0) return rc;
  rc = recur_attn_fwd_stage(h0, lang, wp, bp, wm, bm, valid, stage_xh,
                            stage_c, stage_g, stage_hp, stage_attn, N, P, H,
                            T, tile, kc, stream);
  if (rc != 0) return rc;

  const size_t smem = (size_t)4 * (tile * H4 + 2 * kc * H2
                                   + 3 * tile * H + 2 * tile * kMaxT
                                   + 2 * T * H);
  cudaError_t err = cudaFuncSetAttribute(
      recur_attn_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (P + tile - 1) / tile;
  recur_attn_sweep_kernel<<<dim3(tiles, N), threads, smem, s>>>(
      gout, lang, wmt, wpt, valid, stage_c, stage_g, stage_hp, stage_attn,
      dhp, dh0, lang_part, P, H, T, tile, kc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // d_Wm = sum of [x, h_prev]^T dgates; d_Wp = sum of h_prev^T dhp; every
  // kept step from slot 0 (h0 is not 0)
  rc = launch_rows_product(stage_xh, H2, H2, stage_g, H4, H4, valid, dwm,
                           partials, N, P, T, 0, split_wm, s);
  if (rc != 0) return rc;
  rc = launch_rows_product(stage_xh + H, H2, H, dhp, H, H, valid, dwp,
                           partials, N, P, T, 0, split_wp, s);
  if (rc != 0) return rc;
  // d_bm, d_bp: per-step column sums, then the N*T steps in order
  rc = launch_column_sums(stage_g, valid, colsum, N, P, H4, T, s);
  if (rc != 0) return rc;
  rc = launch_sum_rows(colsum, dbm, N * T, H4, 1, s);
  if (rc != 0) return rc;
  rc = launch_column_sums(dhp, valid, colsum, N, P, H, T, s);
  if (rc != 0) return rc;
  rc = launch_sum_rows(colsum, dbp, N * T, H, 1, s);
  if (rc != 0) return rc;
  // d_lang[n] = the tiles' partials in tile order
  return launch_sum_rows(lang_part, dlang, tiles, T * H, N, s);
}
