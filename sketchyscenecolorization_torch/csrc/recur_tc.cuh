// The RecurAttn recurrence's forward kernels for Hopper (sm_90a), shared by
// B5 (csrc/recur_attn_fwd.cu) and the staging forward of B6
// (csrc/recur_attn_bwd.cu), as B1 and B2 share mlstm_stage_kernel
// (csrc/lstm_tc.cuh).  One slot rank k (slot k of batch row n is its k-th
// kept step, from the slot table) is three launches over all N*P pixel rows:
//
//   F1 h_proj = h_{k-1} @ Wp + bp              (3xTF32, 64x64 tiles)
//   F2 logits = h_proj . lang[n, t] for all T, attn = their softmax,
//      x = attn @ lang[n]                      (CUDA cores, one warp a row)
//   F3 gates = [x, h_{k-1}] @ Wm + bm, then the TF cell
//                                              (3xTF32, 128x128 tiles)
//
// H = w is padded to Hp, a multiple of 128: Wm's gate columns permuted to
// (unit block of 32, gate, unit) as W_h (its x rows and h rows each padded
// to Hp), Wp, lang and h0 zero-padded; a padded unit's gates are 0, so its
// c and h stay 0, and padded lang columns are 0, so the logits are
// unchanged.  Slot 0 has real products: h_{-1} = h0 is not 0.
//
// kFinal selects the buffers:
//   false, B6's staging: [x, h] in stage_xh [T, N*P, 2Hp] (F3 writes the
//     new h into slot k + 1), c in cs [T, N*P, Hp], h_proj in stage_hp
//     [T, N*P, Hp]; F2 keeps attn in stage_attn [T, N*P, T] and F3 the
//     pre-activation gates in sg [T, N*P, 4Hp], for the reverse sweep.
//   true, B5: [x, h] ping-pong in xh [2, N*P, 2Hp] (slot k reads slot k & 1,
//     F3 writes the new h into slot (k + 1) & 1), c in cs [2, N*P, Hp], h_proj
//     in one [N*P, Hp]; nothing else is stored, and F3 writes h to out [N*P,
//     H] at a row's last kept slot.
#pragma once

#include "lstm_tc.cuh"

namespace {

using ProjTile = Tile<64, 64, false, true, 3>;   // h @ Wp: Wp stored [k][n]

constexpr int kWarps = kThreads / 32;

// dst[r * ld + c] = src[r * cols + c] where r < src_rows and c < cols, else
// 0, for r < rows and c < width.
__global__ void recur_pad_kernel(const float* __restrict__ src, int src_rows,
                                 int cols, float* __restrict__ dst, int rows,
                                 int width, int ld) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * width) return;
  const int r = (int)(i / width), c = (int)(i % width);
  dst[(size_t)r * ld + c] =
      (r < src_rows && c < cols) ? src[(size_t)r * cols + c] : 0.0f;
}

// F1, slot rank k: h_proj = h_{k-1} @ Wp + bp for the rows that have a slot
// k, h_{k-1} the h half of xh's slot k (k & 1 with kFinal).
template <bool kFinal>
__global__ void __launch_bounds__(kThreads, 3)
recur_proj_kernel(const float* __restrict__ xh,        // [T or 2, N*P, 2Hp]
                  const float* __restrict__ wpp,       // [Hp, Hp]
                  const float* __restrict__ bp,        // [H]
                  const int* __restrict__ slot_t,      // [N, T] (+2)
                  float* __restrict__ hp,              // [T or 1, N*P, Hp]
                  int N, int P, int H, int Hp, int T, int k) {
  using G = ProjTile;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* row_live = reinterpret_cast<int*>(smem + G::FLOATS);   // [ROWS]
  const int M = N * P;
  const int m0 = blockIdx.y * G::ROWS, c0 = blockIdx.x * G::COLS;
  const size_t slot = kFinal ? (k & 1) : k, hp_slot = kFinal ? 0 : k;
  int live = 0;
  if (threadIdx.x < G::ROWS) {
    const int m = m0 + threadIdx.x;
    live = m < M && slot_t[(m / P) * T + k] >= 0;
    row_live[threadIdx.x] = live;
  }
  if (!__syncthreads_or(live)) return;

  float acc[G::MT][G::NT][4];
  const float* a_src = xh + (slot * M + m0) * 2 * Hp + Hp;
  tile_product<G>(acc, smem, Hp / kBK, [&](float* As, float* Bs, int kt) {
    stage_inner<G::LDA>(As, a_src + kt * kBK, 2 * Hp, G::ROWS, M - 1 - m0);
    stage_outer<G::LDB>(Bs, wpp + (size_t)kt * kBK * Hp + c0, Hp, G::COLS,
                        [](int) { return true; });
  });
  store_tile<G>(acc, smem);
  __syncthreads();
  for (int i = threadIdx.x; i < G::ROWS * G::COLS; i += kThreads) {
    const int r = i / G::COLS, v = c0 + i % G::COLS;
    if (!row_live[r]) continue;
    hp[(hp_slot * M + m0 + r) * Hp + v] =
        smem[r * G::LDC + i % G::COLS] + (v < H ? bp[v] : 0.0f);
  }
}

// F2, slot rank k, one warp per pixel row of batch row n = blockIdx.y, `rows`
// rows a block: logits[t] = h_proj . lang[n, t] for all T, attn = their
// softmax (to stage_attn without kFinal), x = attn @ lang[n] (to the x half
// of xh's slot k, k & 1 with kFinal).  Shared memory: lang[n] [T, Hp], then
// per warp an h_proj row and its T logits.
template <bool kFinal>
__global__ void __launch_bounds__(kThreads)
recur_softmax_kernel(const float* __restrict__ hp,         // [T or 1, N*P, Hp]
                     const float* __restrict__ langp,      // [N, T, Hp]
                     const int* __restrict__ slot_t,       // [N, T] (+2)
                     float* __restrict__ stage_attn,       // [T, N*P, T]
                     float* __restrict__ xh,               // [T or 2, N*P, 2Hp]
                     int N, int P, int Hp, int T, int k, int rows) {
  const int n = blockIdx.y;
  if (slot_t[n * T + k] < 0) return;
  extern __shared__ float4 smem4[];
  float* const lang_s = reinterpret_cast<float*>(smem4);     // [T, Hp]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* const hr = lang_s + T * Hp + warp * (Hp + T);       // [Hp]
  float* const lg = hr + Hp;                                 // [T]
  const float4* src = reinterpret_cast<const float4*>(langp + (size_t)n * T * Hp);
  for (int i = threadIdx.x; i < T * Hp / 4; i += kThreads) {
    reinterpret_cast<float4*>(lang_s)[i] = src[i];
  }
  __syncthreads();
  const int M = N * P, p0 = blockIdx.x * rows;
  const size_t slot = kFinal ? (k & 1) : k, hp_slot = kFinal ? 0 : k;
  for (int r = warp; r < rows && p0 + r < P; r += kWarps) {
    const size_t m = (size_t)n * P + p0 + r;
    const size_t row = (size_t)k * M + m;               // (!kFinal)
    const float* hsrc = hp + (hp_slot * M + m) * Hp;
    for (int c = lane; c < Hp; c += 32) hr[c] = hsrc[c];
    __syncwarp();
    for (int t = 0; t < T; ++t) {
      float part = 0.0f;
      for (int c = lane; c < Hp; c += 32) {
        part = fmaf(hr[c], lang_s[t * Hp + c], part);
      }
      part = warp_sum(part);
      if (lane == 0) lg[t] = part;
    }
    __syncwarp();
    float mx = lg[0];
    for (int t = 1; t < T; ++t) mx = fmaxf(mx, lg[t]);
    float sum = 0.0f;
    for (int t = 0; t < T; ++t) sum += expf(lg[t] - mx);
    __syncwarp();                         // every lane has read the logits
    for (int t = lane; t < T; t += 32) {
      const float a = expf(lg[t] - mx) / sum;
      lg[t] = a;
      if (!kFinal) stage_attn[row * T + t] = a;
    }
    __syncwarp();
    float* xr = xh + (slot * M + m) * 2 * Hp;
    for (int c = lane; c < Hp; c += 32) {
      float x = 0.0f;
      for (int t = 0; t < T; ++t) x = fmaf(lg[t], lang_s[t * Hp + c], x);
      xr[c] = x;
    }
    __syncwarp();                         // hr and lg are free again
  }
}

// F3, slot rank k, over a 128-row x 128-column tile (32 units, 4 gates):
// gates = [x, h_{k-1}] @ Wm + bm (xh's slot k @ wmp, K = 2Hp), then the cell:
// c to cs's slot k and h to the h half of xh's slot k + 1 (slots k & 1 and
// (k + 1) & 1 with kFinal).  Without kFinal the gates go to sg's slot k; with
// it h goes to out at the row's last kept slot.
template <bool kFinal>
__global__ void __launch_bounds__(kThreads, 2)
recur_gates_kernel(float* __restrict__ xh,              // [T or 2, N*P, 2Hp]
                   const float* __restrict__ wmp,       // [2Hp, 4Hp]
                   const float* __restrict__ bm,        // [4H]
                   const int* __restrict__ slot_t,      // [N, T] (+2)
                   float* __restrict__ cs,              // [T or 2, N*P, Hp]
                   float* __restrict__ sg,              // [T, N*P, 4Hp]
                   float* __restrict__ out,             // [N*P, H] (kFinal)
                   int N, int P, int H, int Hp, int T, int k) {
  using G = FwdTile;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* row_live = reinterpret_cast<int*>(smem + G::FLOATS);   // [ROWS]
  int* row_last = row_live + G::ROWS;                         // [ROWS]
  const int M = N * P, H4p = 4 * Hp;
  const size_t H2p = 2 * (size_t)Hp;
  const int m0 = blockIdx.y * G::ROWS, c0 = blockIdx.x * G::COLS;
  const size_t cur = kFinal ? (k & 1) : k;
  const size_t prev = kFinal ? ((k + 1) & 1) : k - 1;      // (k > 0)
  const size_t next = kFinal ? ((k + 1) & 1) : k + 1;
  int live = 0;
  if (threadIdx.x < G::ROWS) {
    const int m = m0 + threadIdx.x;
    int last = 0;
    if (m < M) {
      const int* srow = slot_t + (m / P) * T;
      live = srow[k] >= 0;
      last = k + 1 == T || srow[k + 1] < 0;
    }
    row_live[threadIdx.x] = live;
    row_last[threadIdx.x] = last;
  }
  if (!__syncthreads_or(live)) return;

  float acc[G::MT][G::NT][4];
  const float* a_src = xh + (cur * M + m0) * H2p;
  tile_product<G>(acc, smem, 2 * Hp / kBK, [&](float* As, float* Bs, int kt) {
    stage_inner<G::LDA>(As, a_src + kt * kBK, H2p, G::ROWS, M - 1 - m0);
    stage_outer<G::LDB>(Bs, wmp + (size_t)kt * kBK * H4p + c0, H4p, G::COLS,
                        [](int) { return true; });
  });
  store_tile<G>(acc, smem);
  __syncthreads();

  const int uu = threadIdx.x % kUnits;
  const int u = blockIdx.x * kUnits + uu;
  for (int r = threadIdx.x / kUnits; r < G::ROWS; r += kThreads / kUnits) {
    if (!row_live[r]) continue;
    const size_t m = m0 + r;
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gate[g] = smem[r * G::LDC + g * kUnits + uu] + (u < H ? bm[g * H + u] : 0.0f);
      if (!kFinal) sg[((size_t)k * M + m) * H4p + c0 + g * kUnits + uu] = gate[g];
    }
    float c = 0.0f, h = 0.0f;
    if (u < H) {
      const float c_prev = k > 0 ? cs[(prev * M + m) * Hp + u] : 0.0f;
      c = c_prev * sigmoid_f(gate[2] + 1.0f)
          + sigmoid_f(gate[0]) * tanhf(gate[1]);
      h = sigmoid_f(gate[3]) * tanhf(c);
      if (kFinal && row_last[r]) out[m * H + u] = h;
    }
    cs[(cur * M + m) * Hp + u] = c;
    if (kFinal || k + 1 < T) xh[(next * M + m) * H2p + Hp + u] = h;
  }
}

}  // namespace
