// Tensor-core machinery of the per-step LSTM kernels for Hopper (sm_90a),
// shared by B1 and B3 (csrc/mlstm_fwd.cu), B2/B4 (csrc/mlstm_bwd.cu) and
// B5/B6 (csrc/recur_tc.cuh).
//
// The recurrence is carried from one launch to the next: every launch is one
// grid-wide product over all N*P pixel rows for one slot rank k (slot k of
// batch row n is its k-th valid step, from the slot table), with the LSTM
// cell or its gradient in the product's epilogue, so that each weight tile
// is read once per block instead of once per block and step, and the kernel
// boundary is the barrier between steps.  No host sync: all T slot ranks are
// launched, and blocks whose rows have no slot k exit.
//
// Every product runs on the tensor cores with mma.sync m16n8k8 in 3xTF32
// (each f32 operand split into two TF32 values, big*big + big*small +
// small*big), which keeps the f32 reference's accuracy: the tensor cores
// round their sums toward zero, so their partial sums are added into f32
// accumulators with ordinary (round to nearest) adds after every k8 step or
// every stage (stage_mma); left in one accumulator the drift reached 9e-5 of
// B2's d_W_h.  Operand tiles come in through a 3-stage cp.async pipeline.
//
// Gate layout: the weight columns of the four gates are permuted to (unit
// block of 32, gate, unit) and zero-padded to 4*Hp, Hp a multiple of 128
// (perm_col), so that a 128-column output tile holds the i, j, f, o columns
// of 32 hidden units and the cell runs in its epilogue.  A padded unit's
// gates are 0, so its c and h stay 0 and any hidden size works.
#pragma once

#include "common.cuh"

namespace {

constexpr int kUnits = 32;       // hidden units of one gate block (permuted)
constexpr int kPad = 128;        // Hp is a multiple of this
constexpr int kBK = 32;          // K depth of one shared-memory stage
constexpr int kThreads = 256;    // 8 warps per product block

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
// per SM.  The reverse sweeps take the small tiles: at B2's matching shape
// its 1152 blocks fill 2.9 waves of 396, where 576 128x64 blocks filled 2.2
// waves of 264 and so ran three (4.8 -> 3.9 ms); the other products lose
// more to the smaller register budget than they gain (measured).
using FwdTile = Tile<128, 128, false, true, 3>;    // x @ W: W stored [k][n]
using SweepTile = Tile<64, 64, false, false, 3>;   // x @ W^T: W stored [n][k]
using DwhTile = Tile<128, 128, true, true, 3>;     // x^T y over rows

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

// The TF cell's gradient at one kept step of one (row, unit): the
// pre-activation gates at gr[perm_col(g, u)], c_prev, the incoming dh, and
// dc from *dcp (0 at the row's last kept slot, `first`) give the four
// dgates in d; *dcp becomes the dc carried to the step before.
__device__ __forceinline__ void cell_backward(const float* gr, int u,
                                              float c_prev, float dh,
                                              float* dcp, bool first,
                                              float (&d)[4]) {
  const float si = sigmoid_f(gr[perm_col(0, u)]);
  const float tj = tanhf(gr[perm_col(1, u)]);
  const float sf = sigmoid_f(gr[perm_col(2, u)] + 1.0f);
  const float so = sigmoid_f(gr[perm_col(3, u)]);
  const float tc = tanhf(c_prev * sf + si * tj);
  const float dct = (first ? 0.0f : *dcp) + dh * so * (1.0f - tc * tc);
  d[0] = dct * tj * si * (1.0f - si);
  d[1] = dct * si * (1.0f - tj * tj);
  d[2] = dct * c_prev * sf * (1.0f - sf);
  d[3] = dh * tc * so * (1.0f - so);
  *dcp = dct * sf;
}

// slot_t[n, k] = the step of row n's k-th nonzero flag, -1 past its last;
// slot_t[N*T] = the largest count of nonzero flags of a row, slot_t[N*T+1]
// = 1 if every row has that many (then every staged row below it is live).
// One block.
__global__ void lstm_slots_kernel(const int* __restrict__ valid,
                                  int* __restrict__ slot_t, int N, int T) {
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
__global__ void lstm_layout_kernel(const float* __restrict__ wh,
                                   float* __restrict__ wp, int H, int Hp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int H4p = 4 * Hp;
  if (i >= (size_t)Hp * H4p) return;
  const int k = (int)(i / H4p), col = (int)(i % H4p);
  const int g = (col / kUnits) % 4;
  const int u = col / (4 * kUnits) * kUnits + col % kUnits;
  wp[i] = (k < H && u < H) ? wh[(size_t)k * 4 * H + g * H + u] : 0.0f;
}

// Modes of mlstm_stage_kernel.
constexpr int kModeStage = 0;   // B2/B4's staging forward
constexpr int kModeFinal = 1;   // B1: the final h
constexpr int kModeAttn = 2;    // B3: the attention-weighted sum of h

// The masked recurrence at slot rank k over a 128-row x 128-column tile (32
// units, 4 gates): gates = h_{k-1} @ W_h + pixel + step (t the step of the
// row's slot k; no product at k = 0, where h = 0), then the cell.
//   kModeStage, B2/B4's staging forward: the pre-activation gates go to
//     slot k of sg [T, N*P, 4Hp], c and h to slot k of cs, hs [T, N*P, Hp].
//   kModeFinal, B1: h and c ping-pong between slots k % 2 of hs, cs [2, N*P,
//     Hp], no gates are kept, and at a row's last kept slot its h goes to
//     out [N*P, H]; a row without a kept step gets zeros there at k = 0.
//   kModeAttn, B3: as B1, but out [N*P, H] is acc = the sum over the row's
//     kept slots of attn[n, t] * h: stored at k = 0, added to at every later
//     slot (by the one thread that owns the element in every launch, so in
//     slot order); a row without a kept step gets zeros at k = 0.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_stage_kernel(const float* __restrict__ pixel,   // [N*P, 4H]
                   const float* __restrict__ step,    // [N, T, 4H]
                   const float* __restrict__ wp,      // [Hp, 4Hp]
                   const int* __restrict__ slot_t,    // [N, T] (+2)
                   const float* __restrict__ attn,    // [N, T] (kModeAttn)
                   float* __restrict__ hs,
                   float* __restrict__ cs,
                   float* __restrict__ sg,            // (kModeStage)
                   float* __restrict__ out,           // [N*P, H]
                   int N, int P, int H, int Hp, int T, int k) {
  using G = FwdTile;
  constexpr bool kStaged = kMode == kModeStage;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* row_t = reinterpret_cast<int*>(smem + G::FLOATS);   // [ROWS]
  int* row_last = row_t + G::ROWS;                         // [ROWS]
  const int M = N * P, H4 = 4 * H, H4p = 4 * Hp;
  const int m0 = blockIdx.y * G::ROWS, c0 = blockIdx.x * G::COLS;
  const size_t cur = kStaged ? k : (k & 1);          // slot of this step's
  const size_t prev = kStaged ? k - 1 : ((k + 1) & 1);  // c, h; the last's
  int live = 0;
  if (threadIdx.x < G::ROWS) {
    const int m = m0 + threadIdx.x;
    int t = -1, last = 0;
    if (m < M) {
      const int* srow = slot_t + (m / P) * T;
      t = srow[k];
      last = k + 1 == T || srow[k + 1] < 0;
      if (!kStaged && k == 0 && t < 0) t = -2;   // no kept step: out = 0
    }
    row_t[threadIdx.x] = t;
    row_last[threadIdx.x] = last;
    live = t != -1;
  }
  if (!__syncthreads_or(live)) return;

  float acc[G::MT][G::NT][4];
  const float* a_src = k > 0 ? hs + (prev * M + m0) * Hp : hs;
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
    if (t == -1) continue;
    const int m = m0 + r, n = m / P;
    if (t == -2) {
      if (u < H) out[(size_t)m * H + u] = 0.0f;
      continue;
    }
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gate[g] = smem[r * G::LDC + g * kUnits + uu];
      if (u < H) {
        gate[g] += pixel[(size_t)m * H4 + g * H + u]
                   + step[((size_t)n * T + t) * H4 + g * H + u];
      }
      if (kStaged) sg[((size_t)k * M + m) * H4p + c0 + g * kUnits + uu] = gate[g];
    }
    float c = 0.0f, h = 0.0f;
    if (u < H) {
      const float c_prev = k > 0 ? cs[(prev * M + m) * Hp + u] : 0.0f;
      c = c_prev * sigmoid_f(gate[2] + 1.0f)
          + sigmoid_f(gate[0]) * tanhf(gate[1]);
      h = sigmoid_f(gate[3]) * tanhf(c);
      if (kMode == kModeFinal && row_last[r]) out[(size_t)m * H + u] = h;
      if (kMode == kModeAttn) {
        float* o = out + (size_t)m * H + u;
        const float v = attn[n * T + t] * h;
        *o = k == 0 ? v : *o + v;
      }
    }
    cs[(cur * M + m) * Hp + u] = c;
    hs[(cur * M + m) * Hp + u] = h;
  }
}

// part[z] [width_a, width_b] = sum over the staged rows r of K range z of
// A[r]^T B[r + shift*M]: A's rows r = 0 .. (max valid - shift)*N*P of
// slot-major scratch ([T, N*P, *], row stride lda, width_a columns used),
// paired with B's rows `shift` slots later (stride ldb, width_b columns), in
// chunks of kBK rows, chunk c in range c % splits; rows whose B slot the
// batch row does not have are zero-filled.  Grid (width_b / 128, width_a /
// 128, splits).
__global__ void __launch_bounds__(kThreads, 2)
lstm_rows_product_kernel(const float* __restrict__ A, int lda,
                         const float* __restrict__ B, int ldb,
                         const int* __restrict__ slot_t,   // [N, T] (+2)
                         float* __restrict__ part,  // [splits, wa, wb]
                         int N, int P, int T, int shift) {
  using G = DwhTile;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = N * P, wb = gridDim.x * G::COLS, wa = gridDim.y * G::ROWS;
  const int j0 = blockIdx.x * G::COLS, i0 = blockIdx.y * G::ROWS;
  const int z = blockIdx.z, splits = gridDim.z;
  const int rows = max(slot_t[N * T] - shift, 0) * M;   // < 2^31 (host)
  const bool uniform = slot_t[N * T + 1] != 0;
  const int chunks = (rows + kBK - 1) / kBK;
  const int n_k = chunks > z ? (chunks - 1 - z) / splits + 1 : 0;

  float acc[G::MT][G::NT][4];
  tile_product<G>(acc, smem, n_k, [&](float* As, float* Bs, int kt) {
    const int r0 = (z + kt * splits) * kBK;
    auto live = [&](int kk) {
      const int r = r0 + kk;
      if (r >= rows) return false;
      return uniform || slot_t[(r % M) / P * T + r / M + shift] >= 0;
    };
    stage_outer<G::LDA>(As, A + (size_t)r0 * lda + i0, lda, G::ROWS, live);
    stage_outer<G::LDB>(Bs, B + ((size_t)shift * M + r0) * ldb + j0, ldb,
                        G::COLS, live);
  });
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m_w = (warp / G::WN) * G::TM, n_w = (warp % G::WN) * G::TN;
  float* out = part + (size_t)z * wa * wb;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const int i = i0 + m_w + mt * 16 + lane / 4;
      const int j = j0 + n_w + nt * 8 + 2 * (lane % 4);
      const float* v = acc[mt][nt];
      *reinterpret_cast<float2*>(out + (size_t)i * wb + j) =
          make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(out + (size_t)(i + 8) * wb + j) =
          make_float2(v[2], v[3]);
    }
  }
}

// out[r, g*H + u] for r < blocks*H = sum over z < splits in order of part[z]
// ([blocks*Hp, 4Hp], lstm_rows_product_kernel's partials) at row (r / H)*Hp
// + r % H and column perm_col(g, u): a weight gradient's split-K partials
// summed, un-padded and un-permuted.  Its rows are `blocks` blocks of H rows,
// each padded to Hp: one for B2's d_W_h, two for B6's d_Wm (x rows, h rows).
__global__ void lstm_weight_sum_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int H, int Hp,
                                       int blocks, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int H4 = 4 * H;
  if (i >= (size_t)blocks * H * H4) return;
  const int row = (int)(i / H4), col = (int)(i % H4);
  const size_t src = ((size_t)(row / H) * Hp + row % H) * 4 * Hp
                     + perm_col(col / H, col % H);
  const size_t plane = (size_t)blocks * Hp * 4 * Hp;
  float s = part[src];
  for (int z = 1; z < splits; ++z) s += part[z * plane + src];
  out[i] = s;
}

// out[b, i] (i < rows*width) = sum over z < parts in order of part[b*parts
// + z] (planes of `plane` floats) at row i / width, column i % width (rows
// `ld` floats apart).  Grid (ceil(rows*width / 256), batches).
__global__ void lstm_ordered_sum_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, size_t plane,
                                        int parts, int rows, int width,
                                        int ld) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * width) return;
  const float* src = part + (size_t)blockIdx.y * parts * plane
                     + (size_t)(i / width) * ld + i % width;
  float s = src[0];
  for (int z = 1; z < parts; ++z) s += src[z * plane];
  out[(size_t)blockIdx.y * rows * width + i] = s;
}

// The sum of src[r*ld + sc] over the rows r0 <= r < r1 with live(r) (none
// where !active), by a block of (32 columns, 8 row lanes): each lane adds
// every 8th row in order, then the lanes' sums are added in lane order, so
// the result is repeatable.  Valid in the threads with threadIdx.y == 0;
// every thread of the block calls it.
template <class Live>
__device__ __forceinline__ float ordered_column_sum(const float* src,
                                                   size_t ld, int sc,
                                                   bool active, int r0,
                                                   int r1, Live live) {
  __shared__ float lanes[8][33];
  float sum = 0.0f;
  if (active) {
    for (int r = r0 + threadIdx.y; r < r1; r += 8) {
      if (live(r)) sum += src[(size_t)r * ld + sc];
    }
  }
  lanes[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.y == 0) {
    for (int q = 0; q < 8; ++q) total += lanes[q][threadIdx.x];
  }
  return total;
}

inline unsigned blocks_of(size_t n, int per) {
  return (unsigned)((n + per - 1) / per);
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
