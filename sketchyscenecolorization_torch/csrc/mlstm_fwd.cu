// Masked pixel-LSTM forwards for Hopper (sm_90a), plain C interface for
// ctypes: B1 and B3.
//
// B1 replaces the TPU kernel `_mlstm_kernel` (sketchyscenecolorization_tpu/
// ops/pallas_mlstm.py, called through `mlstm_pallas`).  For every (batch n,
// pixel p) it runs T masked steps of TF's BasicLSTMCell
//
//     gates = pixel_term[n, p] + step_term[n, t] + h @ W_h      (4H wide)
//     i, j, f, o = split(gates);  c' = c*sig(f + 1) + sig(i)*tanh(j)
//     h' = sig(o)*tanh(c');  c, h keep their old values where valid[n, t] == 0
//
// and writes the final h [N, P, H] (zeros for a row without a kept step).
// It is the launch sequence of csrc/lstm_tc.cuh on one stream, with no host
// sync: the slot table (lstm_slots_kernel), W_h permuted to (unit block of
// 32, gate, unit) and zero-padded to [Hp, 4Hp], Hp a multiple of 128
// (lstm_layout_kernel), then T launches of mlstm_stage_kernel<true>, the
// staging forward of B2 (csrc/mlstm_bwd.cu) that keeps only the running c
// and h: slot rank k multiplies h_{k-1} @ W_h on the tensor cores in 3xTF32
// in 128x128 tiles (no product at k = 0, where h = 0), the cell runs in the
// epilogue, c and h ping-pong between two [N*P, Hp] buffers, and each row
// writes its h to the output at its own last kept slot.  The slot table
// maps rank k to the k-th valid flag, so end-padded (matching, t < seq_len)
// and front-padded (text fusions, token != 0) masks take the same path, and
// blocks whose rows have no slot k exit.  Any H: a padded unit's gates are 0,
// so its c and h stay 0.
//
// What bounds B1 on an H100: the products, one [P, H] x [H, 4H] per batch
// row and kept step after the first: 113 GFLOP at the matching shape (N=1,
// P=9216, H=500, 7 kept steps), 1.65 ms in f32 on the CUDA cores (67
// TFLOP/s), 0.69 ms as the 3xTF32 products it runs (three TF32 products per
// f32 product at 495 TFLOP/s).  The bytes it must move take 0.06 ms; the
// running c and h and the pixel term read at every step move about 1 GB
// through HBM at that shape (0.3 ms).  What holds it back is what holds
// B2's products back (csrc/mlstm_bwd.cu): per-warp fragment splits, and a
// cell epilogue that does not overlap the product.
//
// B3, the word-attention variant, replaces the TPU kernel
// `_mlstm_attn_kernel` (pallas_mlstm.py, called through `mlstm_attn_pallas`):
// the same recurrence, but it writes acc = sum over kept steps of attn[n, t]
// * h_t [N, P, H].  acc lives in the output buffer itself, which only the
// thread that owns a (pixel, unit) touches: stored at the first kept step,
// added to at every later one, after the cell loop so that the gate
// accumulators are dead (a read and a write of [P, H] per kept step, 37 MB
// at the matching shape, about 0.01 ms of HBM time).  Shared memory and
// registers are full with h, c, W_h stages and accumulators, which is why
// acc is not there; even so the kernel spills about 100 bytes at 128
// registers.  A row with no kept step writes zeros.  Pure f32: no tensor
// cores.
//
// B3's design.  One block owns one (batch, pixel tile) pair and ALL H hidden
// units of its pixels, because every step needs the whole previous h.  The
// blocks carry nothing between them, so the grid is simply (tiles, N).
//   * A thread owns 2 neighbouring hidden units for 8 pixels and computes
//     their four gate columns (j, H+j, 2H+j, 3H+j), so the cell update
//     needs no exchange and c is only ever touched by its owner (it lives
//     in shared memory: in registers it would push the 64 accumulators
//     into spills at 512 threads).  Each W_h value a thread reads feeds 8
//     FMAs and each h value 8.
//   * W_h [H, 4H] (4 MB at H=500, 16 MB at H=1024) does not fit in shared
//     memory.  Every step streams it from L2 in chunks of kc rows, double-
//     buffered with cp.async: the block loads chunk c+1 while it computes
//     on chunk c, and the first chunk of the next step is loaded during the
//     last chunk of this one.  Each W_h value crosses L2 once per block and
//     step.
//   * h is double-buffered in shared memory: a step reads h_cur, writes
//     h_nxt, and the barrier before the next chunk makes it visible.
//     Shared memory (h twice, c, two W_h stages) is 4*H*(3*tile + 8*kc)
//     bytes, 224 KB at H=512 (tile 16, kc 8) and at H=1024 (tile 8, kc 4):
//     dynamic shared memory above the 48 KB default.
//   * The pixel and step terms are added from device memory when a step's
//     h @ W_h is complete, which leaves shared memory to W_h.
//   * Ragged edges are masked: pixel rows past P read the last row (no
//     out-of-bounds access) and are never written back; pixel_term is not
//     padded.  H must be a multiple of 4 up to 1024: the wrapper
//     (ops/mlstm.py) zero-pads each gate block to a multiple of 4.
//   * A step whose flag is 0 is skipped by the whole block, which freezes c
//     and h.
//
// What bounds B3: f32 FMAs on the CUDA cores (B1's products, 1.65 ms at the
// matching shape; it also multiplies the first step's h = 0), shared-memory
// bandwidth and the per-step W_h stream from L2 (every block reads all of
// W_h every step).  Its redesign on B1's tensor-core path is later work.

#include "lstm_tc.cuh"

namespace {

constexpr int kPixelsPerThread = 8;    // PP
constexpr int kMaxThreads = 512;

// Copy rows [ch*kc, ch*kc + kc) of W_h (contiguous in memory) into `dst`.
__device__ __forceinline__ void load_chunk(float* dst, const float* wh,
                                           int ch, int kc, int H) {
  const int k0 = ch * kc;
  load_rows(dst, wh, k0, min(kc, H - k0), 4 * H);
}

__global__ void __launch_bounds__(kMaxThreads)
mlstm_attn_fwd_kernel(const float* __restrict__ pixel,   // [N, P, 4H]
                      const float* __restrict__ step,    // [N, T, 4H]
                      const float* __restrict__ wh,      // [H, 4H]
                      const int* __restrict__ valid,     // [N, T]
                      const float* __restrict__ attn,    // [N, T]
                      float* __restrict__ out,           // [N, P, H]
                      int P, int H, int T, int tile, int kc) {
  constexpr int PP = kPixelsPerThread;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H4 = 4 * H;
  float* h_cur = smem;                        // [tile, H]
  float* h_nxt = h_cur + tile * H;            // [tile, H]
  float* const c_s = h_nxt + tile * H;        // [tile, H]
  float* const w_stages = c_s + tile * H;     // 2 x [kc, 4H]
  const int stage_size = kc * H4;

  const int n = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int half_h = H / 2;
  const int u0 = 2 * (threadIdx.x % half_h);  // this thread's first unit
  const int r0 = PP * (threadIdx.x / half_h); // this thread's first tile row

  int n_valid = 0;
  for (int t = 0; t < T; ++t) n_valid += valid[n * T + t] != 0;
  const int n_chunks = (H + kc - 1) / kc;
  const int total = n_valid * n_chunks;

  for (int i = threadIdx.x; i < tile * H; i += blockDim.x) {
    h_cur[i] = 0.0f;
    c_s[i] = 0.0f;
  }
  if (total > 0) load_chunk(w_stages, wh, 0, kc, H);

  float acc[4][PP][2];

  int t = -1;
  for (int it = 0; it < total; ++it) {
    const int ch = it % n_chunks;
    if (ch == 0) {                 // a new valid step
      do {
        ++t;
      } while (valid[n * T + t] == 0);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int q = 0; q < PP; ++q) acc[g][q][0] = acc[g][q][1] = 0.0f;
      }
    }
    cp_async_wait_all();           // chunk `it` has landed (own copies) ...
    __syncthreads();               // ... for every thread; h_nxt is written
    if (it + 1 < total) {
      load_chunk(w_stages + ((it + 1) & 1) * stage_size, wh,
                 (it + 1) % n_chunks, kc, H);
    }
    const float* ws = w_stages + (it & 1) * stage_size + u0;
    const int k0 = ch * kc;
    const int rows = min(kc, H - k0);
    const float* hk = h_cur + r0 * H + k0;
#pragma unroll 2
    for (int kk = 0; kk < rows; ++kk) {
      const float* wr = ws + kk * H4;
      float2 w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        w[g] = *reinterpret_cast<const float2*>(wr + g * H);
      }
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const float hq = hk[q * H + kk];     // a broadcast within the warp
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g][q][0] = fmaf(hq, w[g].x, acc[g][q][0]);
          acc[g][q][1] = fmaf(hq, w[g].y, acc[g][q][1]);
        }
      }
    }
    if (ch == n_chunks - 1) {      // h @ W_h is complete: add the pixel
      const float* st = step + ((size_t)n * T + t) * H4 + u0;   // and step
#pragma unroll                                                  // terms,
      for (int q = 0; q < PP; ++q) {                            // LSTM cell
        const int p = p0 + r0 + q;
        const float* pq = pixel + ((size_t)n * P + min(p, P - 1)) * H4 + u0;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 sv = *reinterpret_cast<const float2*>(st + g * H);
          const float2 pv = *reinterpret_cast<const float2*>(pq + g * H);
          acc[g][q][0] += pv.x + sv.x;
          acc[g][q][1] += pv.y + sv.y;
        }
        float2* cq = reinterpret_cast<float2*>(c_s + (r0 + q) * H + u0);
        const float2 c_old = *cq;
        float cn[2], hn[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          cn[u] = (u ? c_old.y : c_old.x) * sigmoid_f(acc[2][q][u] + 1.0f)
                  + sigmoid_f(acc[0][q][u]) * tanhf(acc[1][q][u]);
          hn[u] = sigmoid_f(acc[3][q][u]) * tanhf(cn[u]);
        }
        *cq = make_float2(cn[0], cn[1]);
        *reinterpret_cast<float2*>(h_nxt + (r0 + q) * H + u0) =
            make_float2(hn[0], hn[1]);
      }
      {                            // acc (+)= attn[n, t] * h_t, after the
        const float a = attn[n * T + t];   // cell loop: the accumulators
#pragma unroll                             // are dead by then
        for (int q = 0; q < PP; ++q) {
          const int p = p0 + r0 + q;
          if (p >= P) continue;
          const float2 h2 =
              *reinterpret_cast<const float2*>(h_nxt + (r0 + q) * H + u0);
          float2* o = reinterpret_cast<float2*>(out + ((size_t)n * P + p) * H
                                                + u0);
          float2 v = make_float2(a * h2.x, a * h2.y);
          if (it >= n_chunks) {
            const float2 prev = *o;
            v.x += prev.x;
            v.y += prev.y;
          }
          *o = v;
        }
      }
      float* tmp = h_cur;
      h_cur = h_nxt;
      h_nxt = tmp;
    }
  }

  if (n_valid > 0) return;         // acc is written
#pragma unroll
  for (int q = 0; q < PP; ++q) {   // acc = 0 of a row without a kept step
    const int p = p0 + r0 + q;
    if (p < P) {
      *reinterpret_cast<float2*>(out + ((size_t)n * P + p) * H + u0) =
          make_float2(0.f, 0.f);
    }
  }
}

}  // namespace

// B1.  Returns a cudaError_t code; 0 is success.  The wrapper
// (ops/mlstm.py: mlstm_cuda) allocates the output and the scratch: wp [Hp,
// 4Hp] (the permuted W_h), slot_t int [N*T + 2] and hc [2, 2, N*P, Hp] (the
// running h and c, each in two slots); Hp is H rounded up to a multiple of
// 128.  Every pointer 16-byte aligned.
extern "C" int mlstm_fwd(const float* pixel, const float* step,
                         const float* wh, const int* valid, float* out,
                         float* wp, int* slot_t, float* hc, int N, int P,
                         int H, int T, int Hp, void* stream) {
  const long long M = (long long)N * P;
  if (N <= 0 || P <= 0 || T <= 0 || H <= 0 || Hp < H || Hp % kPad != 0 ||
      N > 65535 || T > 65535 || M > 65535LL * FwdTile::ROWS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H4p = 4 * Hp;
  const int rc = set_smem(mlstm_stage_kernel<true>, FwdTile::BYTES);
  if (rc != 0) return rc;
  lstm_slots_kernel<<<1, kThreads, 0, s>>>(valid, slot_t, N, T);
  const size_t n_wp = (size_t)Hp * H4p;
  lstm_layout_kernel<<<(unsigned)((n_wp + 255) / 256), 256, 0, s>>>(wh, wp, H,
                                                                     Hp);
  float* hs = hc;
  float* cs = hc + 2 * M * Hp;
  for (int k = 0; k < T; ++k) {
    mlstm_stage_kernel<true><<<dim3(H4p / FwdTile::COLS,
                                    (unsigned)((M + FwdTile::ROWS - 1)
                                               / FwdTile::ROWS)),
                               kThreads, FwdTile::BYTES, s>>>(
        pixel, step, wp, slot_t, hs, cs, nullptr, out, N, P, H, Hp, T, k);
  }
  return (int)cudaGetLastError();
}

// B3: acc = sum over kept steps of attn[n, t] * h_t [N, P, H].  The wrapper
// (ops/mlstm.py: launch_geometry) picks `tile` (pixels per block, 8 or 16)
// and `kc` (W_h rows per shared-memory chunk, a multiple of 4); H must be a
// multiple of 4, every pointer 16-byte aligned.
extern "C" int mlstm_attn_fwd(const float* pixel, const float* step,
                              const float* wh, const int* valid,
                              const float* attn, float* out, int N, int P,
                              int H, int T, int tile, int kc, void* stream) {
  const int threads = (H / 2) * (tile / kPixelsPerThread);
  if (N <= 0 || P <= 0 || T <= 0 || H <= 0 || H % 4 != 0 ||
      tile % kPixelsPerThread != 0 || tile <= 0 || kc <= 0 || kc % 4 != 0 ||
      threads > kMaxThreads || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)4 * H * (3 * tile + 8 * kc);
  const int rc = set_smem(mlstm_attn_fwd_kernel, (int)smem);
  if (rc != 0) return rc;
  const dim3 grid((P + tile - 1) / tile, N);
  mlstm_attn_fwd_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      pixel, step, wh, valid, attn, out, P, H, T, tile, kc);
  return (int)cudaGetLastError();
}
