// RecurAttn pixel-LSTM forward (B5) for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel `_recur_attn_kernel` (sketchyscenecolorization_tpu/
// ops/pallas_mlstm.py, called through `recur_attn_pallas`).  For every
// (batch n, pixel p), h starts at h0[n, p] and each kept word step runs
//
//     h_proj = h @ Wp + bp                                     [w]
//     attn   = softmax over all T of h_proj . lang[n, t]       [T]
//     x      = attn @ lang[n]                                  [w]
//     gates  = [x, h] @ Wm + bm                                [4H]
//     i, j, f, o = split(gates);  c' = c*sig(f + 1) + sig(i)*tanh(j)
//     h' = sig(o)*tanh(c');  c, h keep their old values where valid[n, t] == 0
//
// and the final h [N, P, H] is written.  The softmax is not masked (pad
// rows of lang take weight), so T is never padded.  This kernel takes w == H
// (the RecurAttn configuration sets both to 256), H a multiple of 64 up to
// 512 and any T whose lang[n] and logits fit in shared memory with the rest
// (ops/recur_attn.py: recur_geometry; T <= 63 at H = 256, T <= 32 at
// H = 512).  Pure f32: no tensor cores.
//
// Design.  Unlike B1 there is no pixel term: every step's input depends on
// h, so all five products run inside the kernel each step.  One block owns
// a tile of 16 pixels (8 at H > 256) and ALL H units of them.
//   * Shared memory holds two [tile, w + H] buffers with the gate product's
//     input row [x, h] (the step reads h from one and writes the new h into
//     the other), c, h_proj, lang[n] (resident for the whole run: T x w,
//     15 KB at the RecurAttn shape), the [tile, T] logits and two weight
//     stages of kc*4H floats: 176 KB at H = 256, T = 15.
//   * Per kept step: (A) h_proj = h @ Wp + bp with Wp streamed in chunks of
//     4*kc rows; (B) one warp per pixel row computes the T logits (each a
//     dot product over w split across the lanes and summed with shuffles)
//     into shared memory, the softmax over them, and x = attn @ lang,
//     which goes into the x part of the current input row; (C) gates =
//     [x, h] @ Wm + bm with Wm streamed in chunks of kc rows, then the cell.
//     All weight chunks of a step, Wp's then Wm's, go through one pair of
//     double-buffered cp.async stages: the block loads chunk c+1 while it
//     computes on chunk c, so the first Wm chunk is in flight during (B).
//   * In (A) and (C) a thread owns 2 neighbouring columns (h_proj columns,
//     hidden units) of 8 pixels: the cell update needs no exchange, and each
//     weight value read from shared memory feeds 8 FMAs.
//   * A step whose flag is 0 is skipped by the whole block.  Pixel rows
//     past P read the last row and are never written.
//
// What bounds it on an H100: f32 FMAs on the CUDA cores.  Per pixel and
// kept step the products need H*w + 2*T*w + (w + H)*4H multiply-adds
// (0.597 M at H = w = 256, T = 15): 77 GFLOP at the RecurAttn shape
// (P = 9216, 7 kept steps), 1.15 ms at 67 TFLOP/s; the bytes it must move
// (h0 read, h written) take 0.006 ms.  Every block streams Wp (256 KB) and
// Wm (2 MB) from L2 each step.  Its redesign on the tensor-core machinery
// of csrc/lstm_tc.cuh, as B6's staging forward (csrc/recur_attn_bwd.cu)
// runs the same recurrence, is later work.

#include "common.cuh"

namespace {

constexpr int kPixelsPerThread = 8;    // PP
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
recur_attn_fwd_kernel(const float* __restrict__ h0,     // [N, P, H]
                      const float* __restrict__ lang,   // [N, T, H]
                      const float* __restrict__ wp,     // [H, H]
                      const float* __restrict__ bp,     // [H]
                      const float* __restrict__ wm,     // [2H, 4H]
                      const float* __restrict__ bm,     // [4H]
                      const int* __restrict__ valid,    // [N, T]
                      float* __restrict__ out,          // [N, P, H]
                      int P, int H, int T, int tile, int kc) {
  constexpr int PP = kPixelsPerThread;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H2 = 2 * H, H4 = 4 * H;
  float* const xh_s = smem;                       // 2 x [tile, 2H]
  float* const c_s = xh_s + 2 * tile * H2;        // [tile, H]
  float* const hp_s = c_s + tile * H;             // [tile, H]
  float* const lang_s = hp_s + tile * H;          // [T, H]
  float* const lg_s = lang_s + T * H;             // [tile, T]
  float* const w_stages = lg_s + tile * T;        // 2 x [kc * 4H]
  const int stage_size = kc * H4;

  const int n = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int half_h = H / 2;
  const int u0 = 2 * (threadIdx.x % half_h);      // this thread's columns
  const int r0 = PP * (threadIdx.x / half_h);     // and first tile row
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;

  const int n_valid = valid_before(valid + n * T, T, T);
  const int kp = 4 * kc;                          // Wp rows per chunk
  const int n_pc = (H + kp - 1) / kp;             // Wp chunks per step
  const int n_mc = (H2 + kc - 1) / kc;            // Wm chunks per step
  const int per_step = n_pc + n_mc;
  const int total = n_valid * per_step;

  for (int i = threadIdx.x; i < tile * H; i += blockDim.x) {
    const int r = i / H, u = i % H;
    xh_s[r * H2 + H + u] = h0[((size_t)n * P + min(p0 + r, P - 1)) * H + u];
    c_s[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < T * H; i += blockDim.x) {
    lang_s[i] = lang[(size_t)n * T * H + i];
  }
  if (total > 0) load_rows(w_stages, wp, 0, min(kp, H), H);

  float acc[4][PP][2];            // (C) gate accumulators
  float pacc[PP][2];              // (A) h_proj accumulators
  int b = 0;                      // which xh buffer holds the current h
  for (int it = 0; it < total; ++it) {
    const int ch = it % per_step;
    if (ch == 0) {                // a new valid step
#pragma unroll
      for (int q = 0; q < PP; ++q) pacc[q][0] = pacc[q][1] = 0.0f;
    }
    if (ch == n_pc) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int q = 0; q < PP; ++q) acc[g][q][0] = acc[g][q][1] = 0.0f;
      }
    }
    cp_async_wait_all();          // chunk `it` has landed (own copies) ...
    __syncthreads();              // ... for every thread; x and h are written
    if (it + 1 < total) {
      const int nx = (it + 1) % per_step;
      float* dst = w_stages + ((it + 1) & 1) * stage_size;
      if (nx < n_pc) {
        load_rows(dst, wp, nx * kp, min(kp, H - nx * kp), H);
      } else {
        const int k0 = (nx - n_pc) * kc;
        load_rows(dst, wm, k0, min(kc, H2 - k0), H4);
      }
    }
    const float* ws = w_stages + (it & 1) * stage_size + u0;
    float* const cur = xh_s + b * tile * H2;
    if (ch < n_pc) {              // (A) h_proj = h @ Wp + bp
      const int k0 = ch * kp;
      const int rows = min(kp, H - k0);
      const float* hk = cur + r0 * H2 + H + k0;
#pragma unroll 4
      for (int kk = 0; kk < rows; ++kk) {
        const float2 w = *reinterpret_cast<const float2*>(ws + kk * H);
#pragma unroll
        for (int q = 0; q < PP; ++q) {
          const float hq = hk[q * H2 + kk];
          pacc[q][0] = fmaf(hq, w.x, pacc[q][0]);
          pacc[q][1] = fmaf(hq, w.y, pacc[q][1]);
        }
      }
      if (ch == n_pc - 1) {
        const float2 bv = *reinterpret_cast<const float2*>(bp + u0);
#pragma unroll
        for (int q = 0; q < PP; ++q) {
          *reinterpret_cast<float2*>(hp_s + (r0 + q) * H + u0) =
              make_float2(pacc[q][0] + bv.x, pacc[q][1] + bv.y);
        }
        __syncthreads();          // h_proj of the tile is complete
        // (B) one warp per pixel row: logits, softmax, x = attn @ lang
        for (int r = warp; r < tile; r += n_warps) {
          const float* hr = hp_s + r * H;
          float* lg = lg_s + r * T;
          for (int tt = 0; tt < T; ++tt) {
            float part = 0.0f;
            for (int k = lane; k < H; k += 32) {
              part = fmaf(hr[k], lang_s[tt * H + k], part);
            }
            part = warp_sum(part);
            if (lane == 0) lg[tt] = part;
          }
          __syncwarp();
          float mx = lg[0];
          for (int tt = 1; tt < T; ++tt) mx = fmaxf(mx, lg[tt]);
          float sum = 0.0f;
          for (int tt = 0; tt < T; ++tt) sum += expf(lg[tt] - mx);
          __syncwarp();               // every lane has read the logits
          for (int tt = lane; tt < T; tt += 32) lg[tt] = expf(lg[tt] - mx) / sum;
          __syncwarp();
          float* xr = cur + r * H2;
          for (int col = lane; col < H; col += 32) {
            float x = 0.0f;
            for (int tt = 0; tt < T; ++tt) {
              x = fmaf(lg[tt], lang_s[tt * H + col], x);
            }
            xr[col] = x;
          }
        }
      }
    } else {                      // (C) gates = [x, h] @ Wm + bm
      const int k0 = (ch - n_pc) * kc;
      const int rows = min(kc, H2 - k0);
      const float* hk = cur + r0 * H2 + k0;
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
          const float hq = hk[q * H2 + kk];     // a broadcast within the warp
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[g][q][0] = fmaf(hq, w[g].x, acc[g][q][0]);
            acc[g][q][1] = fmaf(hq, w[g].y, acc[g][q][1]);
          }
        }
      }
      if (ch == per_step - 1) {   // the gates are complete: the cell
        float* const nxt = xh_s + (b ^ 1) * tile * H2;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 bv = *reinterpret_cast<const float2*>(bm + g * H + u0);
#pragma unroll
          for (int q = 0; q < PP; ++q) {
            acc[g][q][0] += bv.x;
            acc[g][q][1] += bv.y;
          }
        }
#pragma unroll
        for (int q = 0; q < PP; ++q) {
          const int p = p0 + r0 + q;
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
          *reinterpret_cast<float2*>(nxt + (r0 + q) * H2 + H + u0) =
              make_float2(hn[0], hn[1]);
        }
        b ^= 1;
      }
    }
  }

  __syncthreads();
  const float* fin = xh_s + b * tile * H2 + H;
#pragma unroll
  for (int q = 0; q < PP; ++q) {
    const int p = p0 + r0 + q;
    if (p < P) {
      *reinterpret_cast<float2*>(out + ((size_t)n * P + p) * H + u0) =
          *reinterpret_cast<const float2*>(fin + (r0 + q) * H2 + u0);
    }
  }
}

}  // namespace

// Returns a cudaError_t code; 0 is success.  The wrapper
// (ops/recur_attn.py: recur_geometry) picks `tile` (pixels per block) and
// `kc` (Wm rows per shared-memory chunk, a multiple of 4) and checks that
// the shared memory fits; every pointer 16-byte aligned.
extern "C" int recur_attn_fwd(const float* h0, const float* lang,
                              const float* wp, const float* bp,
                              const float* wm, const float* bm,
                              const int* valid, float* out, int N, int P,
                              int H, int T, int tile, int kc, void* stream) {
  const int threads = (H / 2) * (tile / kPixelsPerThread);
  if (N <= 0 || N > 65535 || P <= 0 || T <= 0 || H <= 0 || H % 64 != 0 ||
      tile <= 0 || tile % kPixelsPerThread != 0 || kc <= 0 || kc % 4 != 0 ||
      threads > kThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)4 * (2 * tile * 2 * H + 2 * tile * H + T * H
                                   + tile * T + 2 * kc * 4 * H);
  cudaError_t err = cudaFuncSetAttribute(
      recur_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + tile - 1) / tile, N);
  recur_attn_fwd_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      h0, lang, wp, bp, wm, bm, valid, out, P, H, T, tile, kc);
  return (int)cudaGetLastError();
}
