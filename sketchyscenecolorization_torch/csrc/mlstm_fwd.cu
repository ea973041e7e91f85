// Masked pixel-LSTM forwards for Hopper (sm_90a), plain C interface for
// ctypes: B1 and B3, one launch sequence in two modes.
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
// (lstm_layout_kernel), then T launches of mlstm_stage_kernel<kModeFinal>,
// the staging forward of B2 (csrc/mlstm_bwd.cu) that keeps only the running
// c and h: slot rank k multiplies h_{k-1} @ W_h on the tensor cores in 3xTF32
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
// * h_t [N, P, H] (zeros for a row without a kept step).  It is the same
// launch sequence with mlstm_stage_kernel<kModeAttn>: the epilogue of slot
// rank k stores attn[n, t] * h (t the row's step at slot k) into the output
// at k = 0 and adds it at every later slot, in the reference's order (acc +
// a*h in f32).  Each output element belongs to one thread of one block in
// every launch, so there are no atomics and two calls are bit-identical.
// Over B1 that costs a read and a write of [P, H] per kept slot: 0.26 GB at
// the matching shape, about 0.08 ms of HBM time.  Its bound is B1's.

#include "lstm_tc.cuh"

namespace {

// B1 or B3 (kMode kModeFinal or kModeAttn) on one stream, no host sync.
template <int kMode>
int forward(const float* pixel, const float* step, const float* wh,
            const int* valid, const float* attn, float* out, float* wp,
            int* slot_t, float* hc, int N, int P, int H, int T, int Hp,
            void* stream) {
  const long long M = (long long)N * P;
  if (N <= 0 || P <= 0 || T <= 0 || H <= 0 || Hp < H || Hp % kPad != 0 ||
      N > 65535 || T > 65535 || M > 65535LL * FwdTile::ROWS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H4p = 4 * Hp;
  const int rc = set_smem(mlstm_stage_kernel<kMode>, FwdTile::BYTES);
  if (rc != 0) return rc;
  lstm_slots_kernel<<<1, kThreads, 0, s>>>(valid, slot_t, N, T);
  const size_t n_wp = (size_t)Hp * H4p;
  lstm_layout_kernel<<<blocks_of(n_wp, 256), 256, 0, s>>>(wh, wp, H, Hp);
  float* hs = hc;
  float* cs = hc + 2 * M * Hp;
  const dim3 grid(H4p / FwdTile::COLS, blocks_of(M, FwdTile::ROWS));
  for (int k = 0; k < T; ++k) {
    mlstm_stage_kernel<kMode><<<grid, kThreads, FwdTile::BYTES, s>>>(
        pixel, step, wp, slot_t, attn, hs, cs, nullptr, out, N, P, H, Hp, T,
        k);
  }
  return (int)cudaGetLastError();
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
  return forward<kModeFinal>(pixel, step, wh, valid, nullptr, out, wp, slot_t,
                             hc, N, P, H, T, Hp, stream);
}

// B3: acc = sum over kept steps of attn[n, t] * h_t [N, P, H]; attn [N, T]
// and the rest as B1's (ops/mlstm.py: mlstm_attn_cuda).
extern "C" int mlstm_attn_fwd(const float* pixel, const float* step,
                              const float* wh, const int* valid,
                              const float* attn, float* out, float* wp,
                              int* slot_t, float* hc, int N, int P, int H,
                              int T, int Hp, void* stream) {
  return forward<kModeAttn>(pixel, step, wh, valid, attn, out, wp, slot_t, hc,
                            N, P, H, T, Hp, stream);
}
