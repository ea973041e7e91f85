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
// Design.  The TPU kernel kept each tile's h/c trajectory in VMEM and carried
// the recurrence inside one grid step.  Here the recurrence is carried from
// one launch to the next: every launch is one grid-wide product over all
// N*P pixel rows for one slot rank k (slot k of row n is its k-th valid
// step), with the LSTM cell in the product's epilogue, so each W_h tile is
// read once per block instead of all of W_h once per block and step, and the
// kernel boundary is the barrier between steps.  All launches run on one
// stream without float atomics: two calls give bit-identical gradients.
//   1. Layout, once per call: a slot table (the step of each row's k-th valid
//      flag, and the largest count of valid flags) and W_h with its columns
//      permuted to (unit block of 32, gate, unit) and zero-padded to Hp, a
//      multiple of 128, in both dimensions ([Hp, 4Hp]), so that the i, j, f,
//      o columns of 32 hidden units fall in one 128-wide output tile.
//   2. Staging forward, k = 0 .. T-1: gates = h_{k-1} @ W_h (no product at
//      k = 0, where h = 0) in 128x128 tiles; the epilogue adds pixel_term and
//      step_term[n, t] (t the step of the row's slot k), writes the
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
//   4. d_W_h = sum over rows and slots k >= 1 of h_{k-1}^T dgates_k: one
//      product whose K runs over the staged rows (dead rows zero-filled),
//      split into `splits` interleaved K ranges whose partials are summed in
//      a fixed order, then un-permuted.
//   5. d_step: column sums of the dgates over pixels in a fixed order; B4's
//      d_attn: per-chunk partials of g . h_k summed in chunk order.
// Every product runs on the tensor cores with mma.sync m16n8k8 in 3xTF32
// (each f32 operand split into two TF32 values, big*big + big*small +
// small*big), which keeps the f32 reference's accuracy: the tensor cores
// round their sums toward zero, so their partial sums are added into the
// f32 accumulators with ordinary (round to nearest) adds after every k8
// step or every stage (stage_mma); left in one accumulator the drift
// reached 9e-5 of d_W_h.  Operand tiles come in through a 3-stage cp.async
// pipeline, the accumulator tile is staged through shared memory before the
// epilogue.  No host sync: all T slot ranks are launched, and blocks with
// nothing to do exit.
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

#include "common.cuh"

namespace {

constexpr int kUnits = 32;       // hidden units of one gate block (permuted)
constexpr int kPad = 128;        // Hp is a multiple of this
constexpr int kBK = 32;          // K depth of one shared-memory stage
constexpr int kThreads = 256;    // 8 warps per product block
constexpr int kAttnRows = 64;    // pixel rows of one d_attn partial

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Column of (gate g, unit u) in the permuted layout.
__device__ __forceinline__ int perm_col(int g, int u) {
  return (u / kUnits) * 4 * kUnits + g * kUnits + u % kUnits;
}

// Geometry of a BM x BN output tile.  A is stored in shared memory as [m][k]
// (kAOuter false: K-contiguous rows of the source) or [k][m]; B as [n][k] or
// [k][n].  Row strides are padded so that fragment loads are free of bank
// conflicts.  8 warps as WM x WN, each with MT x NT m16n8 accumulators.
template <int BM, int BN, bool kAOuter, bool kBOuter, int kDepth>
struct Tile {
  static constexpr int ROWS = BM, COLS = BN, STAGES = kDepth;
  static constexpr int WM = BN >= 128 ? 2 : 4;
  static constexpr int WN = kThreads / 32 / WM;
  static constexpr int TM = BM / WM, TN = BN / WN;
  static constexpr int MT = TM / 16, NT = TN / 8;
  static constexpr int LDA = kAOuter ? BM + 8 : kBK + 4;
  static constexpr int LDB = kBOuter ? BN + 8 : kBK + 4;
  static constexpr int A_SIZE = kAOuter ? kBK * LDA : BM * LDA;
  static constexpr int B_SIZE = kBOuter ? kBK * LDB : BN * LDB;
  static constexpr int STAGE = A_SIZE + B_SIZE;
  static constexpr int LDC = BN + 8;
  static constexpr int FLOATS = cmax(STAGES * STAGE, BM * LDC);
  static constexpr int BYTES = 4 * (FLOATS + 2 * BM);  // + per-row info
  // fold the tensor cores' sums into acc once per stage (a second set of
  // MT*NT*4 registers) where that fits, else once per k8 step
  static constexpr bool STAGE_FOLD = MT * NT <= 8;

  __device__ static float a(const float* As, int m, int k) {
    return kAOuter ? As[k * LDA + m] : As[m * LDA + k];
  }
  __device__ static float b(const float* Bs, int k, int n) {
    return kBOuter ? Bs[k * LDB + n] : Bs[n * LDB + k];
  }
};

// Two 128-row blocks (128 registers a thread) or three 64-row blocks (80)
// per SM.  The sweep takes the small tiles: at the matching shape its 1152
// blocks fill 2.9 waves of 396, where 576 128x64 blocks filled 2.2 waves of
// 264 and so ran three (4.8 -> 3.9 ms); the other two lose more to the
// smaller register budget than they gain (measured).
using FwdTile = Tile<128, 128, false, true, 3>;    // h @ W_h
using SweepTile = Tile<64, 64, false, false, 3>;   // dgates @ W_h^T
using DwhTile = Tile<128, 128, true, true, 3>;     // h^T dgates

// acc += the product of one kBK-deep stage, 3xTF32.  The tensor cores
// round a sum toward zero, so a long K run into one accumulator drifts by
// about half an ulp of it per product (up to 9e-5 of d_W_h at the matching
// shape, measured); so with kFold each k8 step's three products go into a
// fresh fragment that is added to acc in f32, round to nearest (without,
// the caller folds acc once per stage).
template <class G, bool kFold>
__device__ __forceinline__ void stage_mma(float (&acc)[G::MT][G::NT][4],
                                          const float* As, const float* Bs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m_w = (warp / G::WN) * G::TM, n_w = (warp % G::WN) * G::TN;
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    unsigned bb[G::NT][2], bs[G::NT][2];
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const int n = n_w + nt * 8 + gid;
      split_tf32(G::b(Bs, kk + tig, n), bb[nt][0], bs[nt][0]);
      split_tf32(G::b(Bs, kk + tig + 4, n), bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const int m = m_w + mt * 16 + gid;
      unsigned ab[4], as[4];
      split_tf32(G::a(As, m, kk + tig), ab[0], as[0]);
      split_tf32(G::a(As, m + 8, kk + tig), ab[1], as[1]);
      split_tf32(G::a(As, m, kk + tig + 4), ab[2], as[2]);
      split_tf32(G::a(As, m + 8, kk + tig + 4), ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {   // small terms first
        if (kFold) {
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(d, as, bb[nt]);
          mma_tf32(d, ab, bs[nt]);
          mma_tf32(d, ab, bb[nt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += d[i];
        } else {
          mma_tf32(acc[mt][nt], as, bb[nt]);
          mma_tf32(acc[mt][nt], ab, bs[nt]);
          mma_tf32(acc[mt][nt], ab, bb[nt]);
        }
      }
    }
  }
}

// acc = the product over n_k stages; load(As, Bs, kt) issues the cp.async
// copies of stage kt (without committing).  Ends with the pipeline drained
// and a barrier, so shared memory may be reused.
template <class G, class Load>
__device__ __forceinline__ void tile_product(float (&acc)[G::MT][G::NT][4],
                                             float* smem, int n_k, Load load) {
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
  }
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < n_k) load(smem + s * G::STAGE, smem + s * G::STAGE + G::A_SIZE, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<G::STAGES - 2>();  // stage kt has landed (own copies) ...
    __syncthreads();                   // ... for all; stage kt-1 is consumed
    const int nx = kt + G::STAGES - 1;
    if (nx < n_k) {
      float* st = smem + (nx % G::STAGES) * G::STAGE;
      load(st, st + G::A_SIZE, nx);
    }
    cp_async_commit();
    const float* st = smem + (kt % G::STAGES) * G::STAGE;
    if constexpr (G::STAGE_FOLD) {
      float part[G::MT][G::NT][4] = {};
      stage_mma<G, false>(part, st, st + G::A_SIZE);
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
        }
      }
    } else {
      stage_mma<G, true>(acc, st, st + G::A_SIZE);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The accumulators into the [BM][LDC] tile Cs.
template <class G>
__device__ __forceinline__ void store_tile(const float (&acc)[G::MT][G::NT][4],
                                           float* Cs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m_w = (warp / G::WN) * G::TM, n_w = (warp % G::WN) * G::TN;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const int r = m_w + mt * 16 + lane / 4;
      const int c = n_w + nt * 8 + 2 * (lane % 4);
      const float* v = acc[mt][nt];
      *reinterpret_cast<float2*>(Cs + r * G::LDC + c) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * G::LDC + c) =
          make_float2(v[2], v[3]);
    }
  }
}

// K-contiguous operand: `rows` rows of kBK floats, row i at src + i*ld (rows
// past `last` repeat row `last`: they feed only output rows never stored).
template <int LD>
__device__ __forceinline__ void stage_inner(float* dst, const float* src,
                                            size_t ld, int rows, int last) {
  for (int c = threadIdx.x; c < rows * (kBK / 4); c += kThreads) {
    const int i = c / (kBK / 4), q = c % (kBK / 4);
    cp_async16(dst + i * LD + 4 * q, src + (size_t)min(i, last) * ld + 4 * q);
  }
}

// K-outer operand: kBK rows of `width` floats, row kk at src + kk*ld, zeros
// where live(kk) is false.
template <int LD, class Live>
__device__ __forceinline__ void stage_outer(float* dst, const float* src,
                                            size_t ld, int width, Live live) {
  const int per_row = width / 4;
  for (int c = threadIdx.x; c < kBK * per_row; c += kThreads) {
    const int kk = c / per_row, q = c % per_row;
    const bool ok = live(kk);
    cp_async16_zfill(dst + kk * LD + 4 * q,
                     ok ? src + (size_t)kk * ld + 4 * q : src, ok);
  }
}

// slot_t[n, k] = the step of row n's k-th nonzero flag, -1 past its last;
// slot_t[N*T] = the largest count of nonzero flags of a row, slot_t[N*T+1]
// = 1 if every row has that many (then every staged row below it is live).
// One block.
__global__ void mlstm_bwd_slots_kernel(const int* __restrict__ valid,
                                       int* __restrict__ slot_t, int N,
                                       int T) {
  __shared__ int most_s[kThreads], least_s[kThreads];
  int most = 0, least = T;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    int k = 0;
    for (int t = 0; t < T; ++t) {
      if (valid[n * T + t] != 0) slot_t[n * T + k++] = t;
    }
    most = max(most, k);
    least = min(least, k);
    for (; k < T; ++k) slot_t[n * T + k] = -1;
  }
  most_s[threadIdx.x] = most;
  least_s[threadIdx.x] = least;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      most_s[threadIdx.x] = max(most_s[threadIdx.x], most_s[threadIdx.x + s]);
      least_s[threadIdx.x] = min(least_s[threadIdx.x],
                                 least_s[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    slot_t[N * T] = most_s[0];
    slot_t[N * T + 1] = least_s[0] == most_s[0];
  }
}

// wp[k, perm_col(g, u)] = w_h[k, g*H + u] for k, u < H, else 0: [Hp, 4Hp].
__global__ void mlstm_bwd_layout_kernel(const float* __restrict__ wh,
                                        float* __restrict__ wp, int H,
                                        int Hp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int H4p = 4 * Hp;
  if (i >= (size_t)Hp * H4p) return;
  const int k = (int)(i / H4p), col = (int)(i % H4p);
  const int g = (col / kUnits) % 4;
  const int u = col / (4 * kUnits) * kUnits + col % kUnits;
  wp[i] = (k < H && u < H) ? wh[(size_t)k * 4 * H + g * H + u] : 0.0f;
}

// Staging forward of slot rank k over a 128-row x 128-column tile (32
// units, 4 gates): gates = h_{k-1} @ W_h + pixel + step, then the cell.
__global__ void __launch_bounds__(kThreads, 2)
mlstm_bwd_stage_kernel(const float* __restrict__ pixel,   // [N*P, 4H]
                       const float* __restrict__ step,    // [N, T, 4H]
                       const float* __restrict__ wp,      // [Hp, 4Hp]
                       const int* __restrict__ slot_t,    // [N, T] (+2)
                       float* __restrict__ hs,            // [T, N*P, Hp]
                       float* __restrict__ cs,            // [T, N*P, Hp]
                       float* __restrict__ sg,            // [T, N*P, 4Hp]
                       int N, int P, int H, int Hp, int T, int k) {
  using G = FwdTile;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* row_t = reinterpret_cast<int*>(smem + G::FLOATS);   // [ROWS]
  const int M = N * P, H4 = 4 * H, H4p = 4 * Hp;
  const int m0 = blockIdx.y * G::ROWS, c0 = blockIdx.x * G::COLS;
  int live = 0;
  if (threadIdx.x < G::ROWS) {
    const int m = m0 + threadIdx.x;
    row_t[threadIdx.x] = m < M ? slot_t[(m / P) * T + k] : -1;
    live = row_t[threadIdx.x] >= 0;
  }
  if (!__syncthreads_or(live)) return;

  float acc[G::MT][G::NT][4];
  const float* a_src = k > 0 ? hs + ((size_t)(k - 1) * M + m0) * Hp : hs;
  tile_product<G>(acc, smem, k > 0 ? Hp / kBK : 0,
                  [&](float* As, float* Bs, int kt) {
    stage_inner<G::LDA>(As, a_src + kt * kBK, Hp, G::ROWS, M - 1 - m0);
    stage_outer<G::LDB>(Bs, wp + (size_t)kt * kBK * H4p + c0, H4p, G::COLS,
                        [](int) { return true; });
  });
  store_tile<G>(acc, smem);
  __syncthreads();

  const int uu = threadIdx.x % kUnits;
  const int u = blockIdx.x * kUnits + uu;
  for (int r = threadIdx.x / kUnits; r < G::ROWS; r += kThreads / kUnits) {
    const int t = row_t[r];
    if (t < 0) continue;
    const int m = m0 + r, n = m / P;
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gate[g] = smem[r * G::LDC + g * kUnits + uu];
      if (u < H) {
        gate[g] += pixel[(size_t)m * H4 + g * H + u]
                   + step[((size_t)n * T + t) * H4 + g * H + u];
      }
      sg[((size_t)k * M + m) * H4p + c0 + g * kUnits + uu] = gate[g];
    }
    float c = 0.0f, h = 0.0f;
    if (u < H) {
      const float c_prev =
          k > 0 ? cs[((size_t)(k - 1) * M + m) * Hp + u] : 0.0f;
      c = c_prev * sigmoid_f(gate[2] + 1.0f)
          + sigmoid_f(gate[0]) * tanhf(gate[1]);
      h = sigmoid_f(gate[3]) * tanhf(c);
    }
    cs[((size_t)k * M + m) * Hp + u] = c;
    hs[((size_t)k * M + m) * Hp + u] = h;
  }
}

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
  int pc[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) pc[g] = perm_col(g, u);
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
      for (int g = 0; g < 4; ++g) gr[pc[g]] = 0.0f;
      continue;
    }
    const bool first = !row_more[r];      // the row's last slot
    const float gv = gout[(size_t)m * H + u];
    float dh = first ? (kAttn ? 0.0f : gv) : smem[r * G::LDC + uu];
    if (kAttn) dh += attn[n * T + t] * gv;
    const float si = sigmoid_f(gr[pc[0]]);
    const float tj = tanhf(gr[pc[1]]);
    const float sf = sigmoid_f(gr[pc[2]] + 1.0f);
    const float so = sigmoid_f(gr[pc[3]]);
    const float c_prev = k > 0 ? cs[((size_t)(k - 1) * M + m) * Hp + u] : 0.0f;
    const float tc = tanhf(c_prev * sf + si * tj);
    float* dcp = dc + (size_t)m * Hp + u;
    const float dct = (first ? 0.0f : *dcp) + dh * so * (1.0f - tc * tc);
    float d[4];
    d[0] = dct * tj * si * (1.0f - si);
    d[1] = dct * si * (1.0f - tj * tj);
    d[2] = dct * c_prev * sf * (1.0f - sf);
    d[3] = dh * tc * so * (1.0f - so);
    *dcp = dct * sf;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gr[pc[g]] = d[g];
      dp[g * H] = first ? d[g] : dp[g * H] + d[g];
    }
  }
}

// part[z] [Hp, 4Hp] = sum over the staged rows r of K range z of
// h_{s-1}[r]^T dgates_s[r], s >= 1: the rows r = 0 .. (max valid - 1)*N*P
// of stage_h paired with the same rows of stage_g one slot later, in chunks
// of kBK rows, chunk c in range c % splits; rows of a slot the batch row
// does not have are zero-filled.
__global__ void __launch_bounds__(kThreads, 2)
mlstm_bwd_dwh_kernel(const float* __restrict__ hs,        // [T, N*P, Hp]
                     const float* __restrict__ sg,        // [T, N*P, 4Hp]
                     const int* __restrict__ slot_t,      // [N, T] (+2)
                     float* __restrict__ part,            // [splits, Hp, 4Hp]
                     int N, int P, int Hp, int T) {
  using G = DwhTile;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = N * P, H4p = 4 * Hp;
  const int j0 = blockIdx.x * G::COLS, i0 = blockIdx.y * G::ROWS;
  const int z = blockIdx.z, splits = gridDim.z;
  const int rows = max(slot_t[N * T] - 1, 0) * M;   // < 2^31 (host)
  const bool uniform = slot_t[N * T + 1] != 0;
  const int chunks = (rows + kBK - 1) / kBK;
  const int n_k = chunks > z ? (chunks - 1 - z) / splits + 1 : 0;

  float acc[G::MT][G::NT][4];
  tile_product<G>(acc, smem, n_k, [&](float* As, float* Bs, int kt) {
    const int r0 = (z + kt * splits) * kBK;
    auto live = [&](int kk) {
      const int r = r0 + kk;
      if (r >= rows) return false;
      return uniform || slot_t[(r % M) / P * T + r / M + 1] >= 0;
    };
    stage_outer<G::LDA>(As, hs + (size_t)r0 * Hp + i0, Hp, G::ROWS, live);
    stage_outer<G::LDB>(Bs, sg + ((size_t)M + r0) * H4p + j0, H4p, G::COLS,
                        live);
  });
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m_w = (warp / G::WN) * G::TM, n_w = (warp % G::WN) * G::TN;
  float* out = part + (size_t)z * Hp * H4p;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const int i = i0 + m_w + mt * 16 + lane / 4;
      const int j = j0 + n_w + nt * 8 + 2 * (lane % 4);
      const float* v = acc[mt][nt];
      *reinterpret_cast<float2*>(out + (size_t)i * H4p + j) =
          make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(out + (size_t)(i + 8) * H4p + j) =
          make_float2(v[2], v[3]);
    }
  }
}

// d_W_h[k, g*H + u] = sum over z in order of part[z, k, perm_col(g, u)].
__global__ void mlstm_bwd_dwh_sum_kernel(const float* __restrict__ part,
                                         float* __restrict__ dwh, int H,
                                         int Hp, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int H4 = 4 * H;
  if (i >= (size_t)H * H4) return;
  const int k = (int)(i / H4), col = (int)(i % H4);
  const size_t src = (size_t)k * 4 * Hp + perm_col(col / H, col % H);
  const size_t plane = (size_t)Hp * 4 * Hp;
  float s = part[src];
  for (int z = 1; z < splits; ++z) s += part[z * plane + src];
  dwh[i] = s;
}

// d_step[n, t, col] = sum over p of the dgates of row n's slot for step t
// (0 at a masked step); block (32 columns, 8 pixel lanes), the lanes' sums
// added in lane order.
__global__ void mlstm_bwd_step_sums_kernel(const float* __restrict__ sg,
                                           const int* __restrict__ valid,
                                           float* __restrict__ dstep, int N,
                                           int P, int H, int Hp, int T) {
  __shared__ float part[8][33];
  const int H4 = 4 * H;
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int t = blockIdx.y, n = blockIdx.z;
  const int* vrow = valid + n * T;
  float sum = 0.0f;
  if (vrow[t] != 0 && col < H4) {
    const int k = valid_before(vrow, T, t);
    const float* rows = sg + ((size_t)k * N + n) * P * 4 * Hp
                        + perm_col(col / H, col % H);
    for (int p = threadIdx.y; p < P; p += 8) sum += rows[(size_t)p * 4 * Hp];
  }
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && col < H4) {
    float total = 0.0f;
    for (int q = 0; q < 8; ++q) total += part[q][threadIdx.x];
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

// d_attn[n, t] = sum over chunks in order of attn_part[n, t, chunk].
__global__ void mlstm_bwd_attn_sum_kernel(const float* __restrict__ attn_part,
                                          float* __restrict__ dattn, int NT,
                                          int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NT) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += attn_part[(size_t)i * chunks + c];
  dattn[i] = s;
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  int rc = set_smem(mlstm_bwd_stage_kernel, FwdTile::BYTES);
  if (rc == 0) rc = set_smem(mlstm_bwd_sweep_kernel<kAttn>, SweepTile::BYTES);
  if (rc == 0) rc = set_smem(mlstm_bwd_dwh_kernel, DwhTile::BYTES);
  if (rc != 0) return rc;

  mlstm_bwd_slots_kernel<<<1, kThreads, 0, s>>>(valid, slot_t, N, T);
  const size_t n_wp = (size_t)Hp * H4p;
  mlstm_bwd_layout_kernel<<<(unsigned)((n_wp + 255) / 256), 256, 0, s>>>(
      wh, wp, H, Hp);
  for (int k = 0; k < T; ++k) {
    mlstm_bwd_stage_kernel<<<dim3(H4p / FwdTile::COLS,
                                  (unsigned)((M + FwdTile::ROWS - 1)
                                             / FwdTile::ROWS)),
                             kThreads,
                             FwdTile::BYTES, s>>>(
        pixel, step, wp, slot_t, hs, cs, sg, N, P, H, Hp, T, k);
  }
  for (int k = T - 1; k >= 0; --k) {
    mlstm_bwd_sweep_kernel<kAttn><<<dim3(Hp / SweepTile::COLS,
                                          (unsigned)((M + SweepTile::ROWS - 1)
                                                     / SweepTile::ROWS)),
                                     kThreads,
                                     SweepTile::BYTES, s>>>(
        gout, attn, wp, slot_t, cs, sg, dc, dpix, N, P, H, Hp, T, k);
  }
  mlstm_bwd_dwh_kernel<<<dim3(H4p / DwhTile::COLS, Hp / DwhTile::ROWS, splits),
                         kThreads,
                         DwhTile::BYTES, s>>>(hs, sg, slot_t, part, N, P, Hp,
                                              T);
  const size_t n_dwh = (size_t)H * 4 * H;
  mlstm_bwd_dwh_sum_kernel<<<(unsigned)((n_dwh + 255) / 256), 256, 0, s>>>(
      part, dwh, H, Hp, splits);
  mlstm_bwd_step_sums_kernel<<<dim3((4 * H + 31) / 32, T, N), dim3(32, 8), 0,
                               s>>>(sg, valid, dstep, N, P, H, Hp, T);
  if (kAttn) {
    const int chunks = (P + kAttnRows - 1) / kAttnRows;
    mlstm_bwd_attn_part_kernel<<<dim3(chunks, N * T), kThreads, 0, s>>>(
        gout, hs, valid, attn_part, N, P, H, Hp, T);
    mlstm_bwd_attn_sum_kernel<<<(N * T + 255) / 256, 256, 0, s>>>(
        attn_part, dattn, N * T, chunks);
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
