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
// and d_h0 is the dh left after the first kept step (g for a row without
// one).  A masked step leaves dh and dc unchanged and contributes nothing.
// Takes w == H (the RecurAttn configuration sets both to 256), any H, and
// any T whose lang[n] fits in shared memory beside the attention kernels'
// rows (ops/recur_attn.py: recur_bwd_geometry; T <= 198 at H = 256).  The
// softmax runs over all T and is not masked, so T is never padded.
//
// Design: the per-step tensor-core machinery of B2 (csrc/lstm_tc.cuh): the
// recurrence is carried from launch to launch, one slot rank k per launch
// (slot k of batch row n is its k-th kept step, from the slot table), each
// large product is one grid-wide 3xTF32 product over all N*P pixel rows
// with the cell or its gradient in the epilogue, there is no host sync, and
// no float atomics, so two calls give bit-identical gradients.  H = w is
// padded to Hp, a multiple of 128: Wm's gate columns are permuted to (unit
// block of 32, gate, unit) as B2's W_h (its x rows and h rows each padded to
// Hp), Wp, lang and h0 are zero-padded; a padded unit's gates are 0, so its
// c and h stay 0, and padded lang columns are 0, so the logits are
// unchanged.  Launches on one stream:
//   1. layout: the slot table; Wm permuted to wmp [2Hp, 4Hp]; Wp, lang and
//      h0 padded (h0 into the h half of slot 0 of stage_xh); the d_lang
//      partials zeroed;
//   2. staging forward, k = 0 .. T-1, three launches each (csrc/recur_tc.cuh,
//      the kernels of B5 without kFinal):
//      F1 h_proj = h_{k-1} @ Wp + bp (64x64 tiles) -> stage_hp slot k;
//      F2 one warp per row on the CUDA cores: the T logits against lang[n]
//         (in shared memory), the softmax over all T, x = attn @ lang ->
//         stage_attn and the x half of stage_xh slot k;
//      F3 gates = [x, h_{k-1}] @ Wm + bm (K = 2Hp, 128x128 tiles), the cell in
//         the epilogue: gates -> stage_g, c -> stage_c slot k, h -> the h
//         half of stage_xh slot k + 1;
//      slot 0 has real products (h_{-1} = h0 is not 0);
//   3. reverse sweep, k = T-1 .. 0, three launches each, then one more:
//      S3 dh = [dgates_{k+1}, dhp_{k+1}] @ [Wm_h; Wp]^T (one product, K =
//         5Hp, 64x64 tiles; no product at a row's last kept slot, where dh
//         = g), the cell gradient of slot k in the epilogue: dgates_k over
//         stage_g slot k, dc in an [N*P, Hp] buffer; each row is aligned at
//         its own last kept slot;
//      S1 dx = dgates_k @ Wm_a^T (64x64 tiles) -> an [N*P, Hp] buffer;
//      S2 one warp per row on the CUDA cores: dattn, dlogits, dhp = dlogits
//         @ lang -> stage_dhp slot k, and attn^T dx + dlogits^T h_proj of the
//         block's rows added to its own d_lang partial;
//      S3 once more with k = -1: the same product at slot 0 is d_h0;
//   4. reductions: d_Wm = sum of [x, h_prev]^T dgates and d_Wp = sum of
//      h_prev^T dhp over every kept slot from 0, each one split-K 3xTF32
//      product over the staged rows (lstm_rows_product_kernel, dead rows
//      zero-filled) with its partials summed in a fixed order; d_bm and d_bp
//      as column sums over row chunks, the chunks summed in order; d_lang as
//      the blocks' partials summed in block order.
// Staging holds [x, h] [T, N*P, 2Hp], c, h_proj and dhp [T, N*P, Hp], the
// gates [T, N*P, 4Hp] and attn [T, N*P, T]: 1.3 GB at the RecurAttn shape
// (N = 1, P = 9216, H = 256, T = 15).
//
// What bounds it on an H100: the products.  Per pixel and kept step the
// staging forward's (H*w + (w + H)*4H multiply-adds), the sweep's dgates @
// Wm^T ((w + H)*4H) and dhp @ Wp^T (H*w), and the weight gradients' (w + H)
// *4H + H*w, plus the attention's 6*T*w on the CUDA cores: 231 GFLOP at the
// RecurAttn shape with 7 kept steps, 3.45 ms in f32 at 67 TFLOP/s and 1.43
// ms as the 3xTF32 products it runs (three TF32 products per f32 product at
// 495 TFLOP/s).  The staged trajectory moves about 3 GB through HBM, 0.9 ms.

#include "recur_tc.cuh"

namespace {

// S3 at slot rank k over a 64-row x 64-unit tile: dh = [dgates_{k+1},
// dhp_{k+1}] @ [Wm_h; Wp]^T for the rows that have a slot k+1 (K = 5Hp;
// dh = g at a row's last kept slot), then the cell gradient of slot k:
// dgates_k over stage_g[k], dc updated.  With k = -1 every row gets d_h0:
// the product at slot 0, or g for a row without a kept step.
__global__ void __launch_bounds__(kThreads, 3)
recur_bwd_sweep_kernel(const float* __restrict__ gout,      // [N*P, H]
                       const float* __restrict__ wmp,       // [2Hp, 4Hp]
                       const float* __restrict__ wpp,       // [Hp, Hp]
                       const int* __restrict__ slot_t,      // [N, T] (+2)
                       const float* __restrict__ cs,        // [T, N*P, Hp]
                       float* __restrict__ sg,              // [T, N*P, 4Hp]
                       const float* __restrict__ stage_dhp, // [T, N*P, Hp]
                       float* __restrict__ dc,              // [N*P, Hp]
                       float* __restrict__ dh0,             // [N*P, H]
                       int N, int P, int H, int Hp, int T, int k) {
  using G = SweepTile;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* row_live = reinterpret_cast<int*>(smem + G::FLOATS);   // [ROWS]
  int* row_more = row_live + G::ROWS;                         // [ROWS]
  const int M = N * P, H4p = 4 * Hp;
  const int m0 = blockIdx.y * G::ROWS, u0 = blockIdx.x * G::COLS;
  int live = 0, more = 0;
  if (threadIdx.x < G::ROWS) {
    const int m = m0 + threadIdx.x;
    if (m < M) {
      const int* srow = slot_t + (m / P) * T;
      live = k < 0 || srow[k] >= 0;
      more = live && k + 1 < T && srow[k + 1] >= 0;
    }
    row_live[threadIdx.x] = live;
    row_more[threadIdx.x] = more;
  }
  if (!__syncthreads_or(live)) return;
  const bool product = __syncthreads_or(more);

  float acc[G::MT][G::NT][4];
  const int n4 = H4p / kBK;
  const size_t next = product ? (size_t)(k + 1) * M + m0 : 0;
  tile_product<G>(acc, smem, product ? n4 + Hp / kBK : 0,
                  [&](float* As, float* Bs, int kt) {
    if (kt < n4) {
      stage_inner<G::LDA>(As, sg + next * H4p + kt * kBK, H4p, G::ROWS,
                          M - 1 - m0);
      stage_inner<G::LDB>(Bs, wmp + (size_t)(Hp + u0) * H4p + kt * kBK, H4p,
                          G::COLS, G::COLS - 1);
    } else {
      const int kd = (kt - n4) * kBK;
      stage_inner<G::LDA>(As, stage_dhp + next * Hp + kd, Hp, G::ROWS,
                          M - 1 - m0);
      stage_inner<G::LDB>(Bs, wpp + (size_t)u0 * Hp + kd, Hp, G::COLS,
                          G::COLS - 1);
    }
  });
  store_tile<G>(acc, smem);
  __syncthreads();

  const int uu = threadIdx.x % G::COLS;
  const int u = u0 + uu;
  for (int r = threadIdx.x / G::COLS; r < G::ROWS; r += kThreads / G::COLS) {
    if (!row_live[r]) continue;
    const size_t m = m0 + r;
    const bool first = !row_more[r];      // the row's last slot: dh = g
    const float dh = first ? (u < H ? gout[m * H + u] : 0.0f)
                           : smem[r * G::LDC + uu];
    if (k < 0) {
      if (u < H) dh0[m * H + u] = dh;
      continue;
    }
    float* gr = sg + ((size_t)k * M + m) * H4p;
    if (u >= H) {                         // padding: dgates 0
#pragma unroll
      for (int g = 0; g < 4; ++g) gr[perm_col(g, u)] = 0.0f;
      continue;
    }
    const float c_prev = k > 0 ? cs[((size_t)(k - 1) * M + m) * Hp + u] : 0.0f;
    float d[4];
    cell_backward(gr, u, c_prev, dh, dc + m * Hp + u, first, d);
#pragma unroll
    for (int g = 0; g < 4; ++g) gr[perm_col(g, u)] = d[g];
  }
}

// S1 at slot rank k over a 64-row x 64-column tile: dx = dgates_k @ Wm_a^T
// into dx [N*P, Hp] for the rows that have a slot k.
__global__ void __launch_bounds__(kThreads, 3)
recur_bwd_dx_kernel(const float* __restrict__ wmp,         // [2Hp, 4Hp]
                    const int* __restrict__ slot_t,        // [N, T] (+2)
                    const float* __restrict__ sg,          // [T, N*P, 4Hp]
                    float* __restrict__ dx,                // [N*P, Hp]
                    int N, int P, int Hp, int T, int k) {
  using G = SweepTile;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = N * P, H4p = 4 * Hp;
  const int m0 = blockIdx.y * G::ROWS, v0 = blockIdx.x * G::COLS;
  int live = 0;
  if (threadIdx.x < G::ROWS) {
    const int m = m0 + threadIdx.x;
    live = m < M && slot_t[(m / P) * T + k] >= 0;
  }
  if (!__syncthreads_or(live)) return;

  float acc[G::MT][G::NT][4];
  const float* a_src = sg + ((size_t)k * M + m0) * H4p;
  tile_product<G>(acc, smem, H4p / kBK, [&](float* As, float* Bs, int kt) {
    stage_inner<G::LDA>(As, a_src + kt * kBK, H4p, G::ROWS, M - 1 - m0);
    stage_inner<G::LDB>(Bs, wmp + (size_t)v0 * H4p + kt * kBK, H4p, G::COLS,
                        G::COLS - 1);
  });
  store_tile<G>(acc, smem);
  __syncthreads();
  for (int i = threadIdx.x; i < G::ROWS * G::COLS; i += kThreads) {
    const int r = i / G::COLS;
    if (m0 + r < M) {
      dx[(size_t)(m0 + r) * Hp + v0 + i % G::COLS] = smem[r * G::LDC + i % G::COLS];
    }
  }
}

// S2 at slot rank k for `rows` pixel rows of batch row n = blockIdx.y, one
// warp per row: dattn[t] = dx . lang[n, t], dlogits = attn * (dattn -
// <dattn, attn>), dhp = dlogits @ lang[n] (to stage_dhp[k]); then the
// block's d_lang partial [T, Hp] gains attn^T dx + dlogits^T h_proj over
// its rows (one partial per block, added to in slot order).  Shared memory:
// lang[n] [T, Hp], dx and h_proj rows [rows, Hp], attn and dlogits [rows,
// T].
__global__ void __launch_bounds__(kThreads)
recur_bwd_attn_kernel(const float* __restrict__ dx,          // [N*P, Hp]
                      const float* __restrict__ stage_hp,    // [T, N*P, Hp]
                      const float* __restrict__ stage_attn,  // [T, N*P, T]
                      const float* __restrict__ langp,       // [N, T, Hp]
                      const int* __restrict__ slot_t,        // [N, T] (+2)
                      float* __restrict__ stage_dhp,         // [T, N*P, Hp]
                      float* __restrict__ lang_part,  // [N, blocks, T, Hp]
                      int N, int P, int Hp, int T, int k, int rows) {
  const int n = blockIdx.y;
  if (slot_t[n * T + k] < 0) return;
  extern __shared__ float4 smem4[];
  float* const lang_s = reinterpret_cast<float*>(smem4);   // [T, Hp]
  float* const dx_s = lang_s + T * Hp;                     // [rows, Hp]
  float* const hp_s = dx_s + rows * Hp;                    // [rows, Hp]
  float* const at_s = hp_s + rows * Hp;                    // [rows, T]
  float* const dl_s = at_s + rows * T;                     // [rows, T]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int M = N * P, p0 = blockIdx.x * rows;
  const int here = min(rows, P - p0);
  const size_t base = (size_t)k * M + (size_t)n * P + p0;   // staged row of p0
  const float4* lsrc = reinterpret_cast<const float4*>(langp + (size_t)n * T * Hp);
  for (int i = threadIdx.x; i < T * Hp / 4; i += kThreads) {
    reinterpret_cast<float4*>(lang_s)[i] = lsrc[i];
  }
  for (int i = threadIdx.x; i < rows * Hp; i += kThreads) {
    const int r = i / Hp, c = i % Hp;
    const bool in = r < here;
    dx_s[i] = in ? dx[((size_t)n * P + p0 + r) * Hp + c] : 0.0f;
    hp_s[i] = in ? stage_hp[(base + r) * Hp + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < rows * T; i += kThreads) {
    at_s[i] = i / T < here ? stage_attn[base * T + i] : 0.0f;
    dl_s[i] = 0.0f;
  }
  __syncthreads();
  for (int r = warp; r < here; r += kWarps) {
    const float* dxr = dx_s + r * Hp;
    const float* a = at_s + r * T;
    float* dl = dl_s + r * T;
    for (int t = 0; t < T; ++t) {
      float part = 0.0f;
      for (int c = lane; c < Hp; c += 32) {
        part = fmaf(dxr[c], lang_s[t * Hp + c], part);
      }
      part = warp_sum(part);
      if (lane == 0) dl[t] = part;                        // dattn
    }
    __syncwarp();
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s = fmaf(dl[t], a[t], s);
    __syncwarp();                         // every lane has read dattn
    for (int t = lane; t < T; t += 32) dl[t] = a[t] * (dl[t] - s);
    __syncwarp();
    for (int c = lane; c < Hp; c += 32) {
      float v = 0.0f;
      for (int t = 0; t < T; ++t) v = fmaf(dl[t], lang_s[t * Hp + c], v);
      stage_dhp[(base + r) * Hp + c] = v;
    }
  }
  __syncthreads();
  float* part = lang_part + ((size_t)n * gridDim.x + blockIdx.x) * T * Hp;
  for (int i = threadIdx.x; i < T * Hp; i += kThreads) {
    const int t = i / Hp, c = i % Hp;
    float v = part[i];
    for (int r = 0; r < here; ++r) {
      v = fmaf(at_s[r * T + t], dx_s[r * Hp + c], v);
      v = fmaf(dl_s[r * T + t], hp_s[r * Hp + c], v);
    }
    part[i] = v;
  }
}

// part[chunk, col] = the sum over the kept staged rows of chunk `chunk`
// (`chunk_rows` rows of [T, N*P, *] slot-major scratch, `ld` floats each)
// of column col, or with `gates` of gate column col (g*H + u, stored at
// perm_col(g, u)), in ordered_column_sum's order.  Block (32 columns, 8 row
// lanes).
__global__ void recur_bwd_col_parts_kernel(const float* __restrict__ src,
                                           int ld,
                                           const int* __restrict__ slot_t,
                                           float* __restrict__ part, int N,
                                           int P, int T, int H, int width,
                                           bool gates, int chunk_rows) {
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int M = N * P;
  const int r0 = blockIdx.y * chunk_rows;
  const int r1 = min(r0 + chunk_rows, slot_t[N * T] * M);
  const int sc = col < width && gates ? perm_col(col / H, col % H) : col;
  const float total = ordered_column_sum(
      src, ld, sc, col < width, r0, r1,
      [&](int r) { return slot_t[(r % M) / P * T + r / M] >= 0; });
  if (threadIdx.y == 0 && col < width) {
    part[(size_t)blockIdx.y * width + col] = total;
  }
}

}  // namespace

// Returns a cudaError_t code; 0 is success.  The wrapper
// (ops/recur_attn.py: recur_attn_bwd_cuda, recur_bwd_geometry) allocates the
// outputs and the scratch: wmp [2Hp, 4Hp], wpp [Hp, Hp], langp [N, T, Hp],
// slot_t int [N*T + 2], stage_xh [T, N*P, 2Hp], stage_c, stage_hp and
// stage_dhp [T, N*P, Hp], stage_g [T, N*P, 4Hp], stage_attn [T, N*P, T], dx
// and dc [N*P, Hp], lang_part [N, ceil(P / attn_rows), T, Hp] and `part`
// (the largest of splits_wm*2Hp*4Hp, splits_wp*Hp*Hp and col_chunks*4H
// floats).  Hp is H rounded up to a multiple of 128; attn_rows pixel rows
// per attention block; col_chunks row chunks of the bias sums.  Every
// pointer 16-byte aligned.
extern "C" int recur_attn_bwd(
    const float* h0, const float* lang, const float* wp, const float* bp,
    const float* wm, const float* bm, const int* valid, const float* gout,
    float* dh0, float* dlang, float* dwp, float* dbp, float* dwm, float* dbm,
    float* wmp, float* wpp, float* langp, int* slot_t, float* stage_xh,
    float* stage_c, float* stage_g, float* stage_hp, float* stage_attn,
    float* stage_dhp, float* dx, float* dc, float* lang_part, float* part,
    int N, int P, int H, int T, int Hp, int splits_wm, int splits_wp,
    int attn_rows, int col_chunks, void* stream) {
  const long long M = (long long)N * P;
  if (N <= 0 || P <= 0 || T <= 0 || H <= 0 || Hp < H || Hp % kPad != 0 ||
      N > 65535 || T > 65535 || M > 65535LL * SweepTile::ROWS ||
      splits_wm <= 0 || splits_wp <= 0 || splits_wm > 65535 ||
      splits_wp > 65535 || attn_rows <= 0 || col_chunks <= 0 ||
      M * T + kBK * (long long)(splits_wm + splits_wp) >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H4p = 4 * Hp, Mi = (int)M;
  const int attn_blocks = (P + attn_rows - 1) / attn_rows;
  const int soft_smem = 4 * (T * Hp + kWarps * (Hp + T));
  const int attn_smem = 4 * (T * Hp + 2 * attn_rows * (Hp + T));
  int rc = set_smem(recur_proj_kernel<false>, ProjTile::BYTES);
  if (rc == 0) rc = set_smem(recur_gates_kernel<false>, FwdTile::BYTES);
  if (rc == 0) rc = set_smem(recur_bwd_sweep_kernel, SweepTile::BYTES);
  if (rc == 0) rc = set_smem(recur_bwd_dx_kernel, SweepTile::BYTES);
  if (rc == 0) rc = set_smem(recur_softmax_kernel<false>, soft_smem);
  if (rc == 0) rc = set_smem(recur_bwd_attn_kernel, attn_smem);
  if (rc == 0) rc = set_smem(lstm_rows_product_kernel, DwhTile::BYTES);
  if (rc != 0) return rc;

  // 1. layout
  lstm_slots_kernel<<<1, kThreads, 0, s>>>(valid, slot_t, N, T);
  const size_t n_wp = (size_t)Hp * H4p;
  lstm_layout_kernel<<<blocks_of(n_wp, 256), 256, 0, s>>>(wm, wmp, H, Hp);
  lstm_layout_kernel<<<blocks_of(n_wp, 256), 256, 0, s>>>(
      wm + (size_t)H * 4 * H, wmp + n_wp, H, Hp);
  recur_pad_kernel<<<blocks_of((size_t)Hp * Hp, 256), 256, 0, s>>>(
      wp, H, H, wpp, Hp, Hp, Hp);
  recur_pad_kernel<<<blocks_of((size_t)N * T * Hp, 256), 256, 0, s>>>(
      lang, N * T, H, langp, N * T, Hp, Hp);
  recur_pad_kernel<<<blocks_of((size_t)M * Hp, 256), 256, 0, s>>>(
      h0, Mi, H, stage_xh + Hp, Mi, Hp, 2 * Hp);
  cudaError_t err = cudaMemsetAsync(
      lang_part, 0, sizeof(float) * (size_t)N * attn_blocks * T * Hp, s);
  if (err != cudaSuccess) return (int)err;

  // 2. staging forward
  const dim3 proj_grid(Hp / ProjTile::COLS, blocks_of(M, ProjTile::ROWS));
  const dim3 attn_grid(attn_blocks, N);
  const dim3 gates_grid(H4p / FwdTile::COLS, blocks_of(M, FwdTile::ROWS));
  for (int k = 0; k < T; ++k) {
    recur_proj_kernel<false><<<proj_grid, kThreads, ProjTile::BYTES, s>>>(
        stage_xh, wpp, bp, slot_t, stage_hp, N, P, H, Hp, T, k);
    recur_softmax_kernel<false><<<attn_grid, kThreads, soft_smem, s>>>(
        stage_hp, langp, slot_t, stage_attn, stage_xh, N, P, Hp, T, k,
        attn_rows);
    recur_gates_kernel<false><<<gates_grid, kThreads, FwdTile::BYTES, s>>>(
        stage_xh, wmp, bm, slot_t, stage_c, stage_g, nullptr, N, P, H, Hp, T,
        k);
  }

  // 3. reverse sweep
  const dim3 sweep_grid(Hp / SweepTile::COLS, blocks_of(M, SweepTile::ROWS));
  for (int k = T - 1; k >= -1; --k) {
    recur_bwd_sweep_kernel<<<sweep_grid, kThreads, SweepTile::BYTES, s>>>(
        gout, wmp, wpp, slot_t, stage_c, stage_g, stage_dhp, dc, dh0, N, P,
        H, Hp, T, k);
    if (k < 0) break;
    recur_bwd_dx_kernel<<<sweep_grid, kThreads, SweepTile::BYTES, s>>>(
        wmp, slot_t, stage_g, dx, N, P, Hp, T, k);
    recur_bwd_attn_kernel<<<attn_grid, kThreads, attn_smem, s>>>(
        dx, stage_hp, stage_attn, langp, slot_t, stage_dhp, lang_part, N, P,
        Hp, T, k, attn_rows);
  }

  // 4. reductions
  lstm_rows_product_kernel<<<dim3(H4p / DwhTile::COLS, 2 * Hp / DwhTile::ROWS,
                                  splits_wm),
                             kThreads, DwhTile::BYTES, s>>>(
      stage_xh, 2 * Hp, stage_g, H4p, slot_t, part, N, P, T, 0);
  lstm_weight_sum_kernel<<<blocks_of((size_t)8 * H * H, 256), 256, 0, s>>>(
      part, dwm, H, Hp, 2, splits_wm);
  lstm_rows_product_kernel<<<dim3(Hp / DwhTile::COLS, Hp / DwhTile::ROWS,
                                  splits_wp),
                             kThreads, DwhTile::BYTES, s>>>(
      stage_xh + Hp, 2 * Hp, stage_dhp, Hp, slot_t, part, N, P, T, 0);
  lstm_ordered_sum_kernel<<<dim3(blocks_of((size_t)H * H, 256), 1), 256, 0,
                            s>>>(part, dwp, (size_t)Hp * Hp, splits_wp, H, H,
                                 Hp);
  const int chunk_rows = (int)((M * T + col_chunks - 1) / col_chunks);
  recur_bwd_col_parts_kernel<<<dim3(blocks_of(4 * (size_t)H, 32), col_chunks),
                               dim3(32, 8), 0, s>>>(
      stage_g, H4p, slot_t, part, N, P, T, H, 4 * H, true, chunk_rows);
  lstm_ordered_sum_kernel<<<dim3(blocks_of(4 * (size_t)H, 256), 1), 256, 0,
                            s>>>(part, dbm, (size_t)4 * H, col_chunks, 1,
                                 4 * H, 4 * H);
  recur_bwd_col_parts_kernel<<<dim3(blocks_of(H, 32), col_chunks),
                               dim3(32, 8), 0, s>>>(
      stage_dhp, Hp, slot_t, part, N, P, T, H, H, false, chunk_rows);
  lstm_ordered_sum_kernel<<<dim3(blocks_of(H, 256), 1), 256, 0, s>>>(
      part, dbp, (size_t)H, col_chunks, 1, H, H);
  lstm_ordered_sum_kernel<<<dim3(blocks_of((size_t)T * H, 256), N), 256, 0,
                            s>>>(lang_part, dlang, (size_t)T * Hp,
                                 attn_blocks, T, H, Hp);
  return (int)cudaGetLastError();
}
