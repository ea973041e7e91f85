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
// and the final h [N, P, H] is written (h0 for a row without a kept step).
// The softmax is not masked (pad rows of lang take weight), so T is never
// padded.  Takes w == H (the RecurAttn configuration sets both to 256), any
// H, and any T whose lang[n] fits in F2's shared memory beside its eight
// warps' rows (ops/recur_attn.py: recur_geometry; T <= 212 at H = 256).
//
// Design: B6's staging forward without the stores (csrc/recur_tc.cuh, the
// kernels with kFinal), as B1 is B2's.  The recurrence is carried from
// launch to launch, one slot rank k (the k-th kept step of each batch row,
// from the slot table) per three launches: F1 h_proj (3xTF32 on the tensor
// cores, 64x64 tiles), F2 the logits, softmax and x (CUDA cores, lang[n] in
// shared memory), F3 gates = [x, h] @ Wm + bm (3xTF32, 128x128 tiles) with
// the cell in the epilogue.  [x, h] and c ping-pong between two slots, and
// each row writes its h to the output at its own last kept slot; the output
// starts as a copy of h0, which rows without a kept step keep.  Launches on
// one stream, no host sync, no atomics: the slot table, Wm permuted to
// (unit block of 32, gate, unit) and zero-padded to [2Hp, 4Hp], Wp, lang and
// h0 zero-padded to Hp (h0 into the h half of slot 0), out <- h0, then F1,
// F2, F3 for k = 0 .. T-1 (blocks whose rows have no slot k exit).
//
// What bounds it on an H100: the products.  Per pixel and kept step h @ Wp
// (H*w multiply-adds) and [x, h] @ Wm ((w + H)*4H) on the tensor cores, and
// the logits and attn @ lang (2*T*w) on the CUDA cores: 77 GFLOP at the
// RecurAttn shape (P = 9216, H = w = 256, T = 15, 7 kept steps), 1.15 ms in
// f32 at 67 TFLOP/s, 0.48 ms with the products in 3xTF32 (three TF32
// products per f32 product at 495 TFLOP/s).  The bytes it must move (h0
// read, h written) take 0.006 ms; the running [x, h], c and h_proj move
// about 0.6 GB through HBM (0.2 ms).

#include "recur_tc.cuh"

namespace {

constexpr int kSoftmaxRows = 32;   // pixel rows of one F2 block

}  // namespace

// Returns a cudaError_t code; 0 is success.  The wrapper
// (ops/recur_attn.py: recur_attn_cuda, recur_geometry) allocates the output
// and the scratch: wmp [2Hp, 4Hp], wpp [Hp, Hp], langp [N, T, Hp], slot_t
// int [N*T + 2], xh [2, N*P, 2Hp], cs [2, N*P, Hp] and hp [N*P, Hp]; Hp is
// H rounded up to a multiple of 128.  Every pointer 16-byte aligned.
extern "C" int recur_attn_fwd(const float* h0, const float* lang,
                              const float* wp, const float* bp,
                              const float* wm, const float* bm,
                              const int* valid, float* out, float* wmp,
                              float* wpp, float* langp, int* slot_t,
                              float* xh, float* cs, float* hp, int N, int P,
                              int H, int T, int Hp, void* stream) {
  const long long M = (long long)N * P;
  if (N <= 0 || P <= 0 || T <= 0 || H <= 0 || Hp < H || Hp % kPad != 0 ||
      N > 65535 || T > 65535 || M > 65535LL * ProjTile::ROWS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H4p = 4 * Hp, Mi = (int)M;
  const int soft_smem = 4 * (T * Hp + kWarps * (Hp + T));
  int rc = set_smem(recur_proj_kernel<true>, ProjTile::BYTES);
  if (rc == 0) rc = set_smem(recur_softmax_kernel<true>, soft_smem);
  if (rc == 0) rc = set_smem(recur_gates_kernel<true>, FwdTile::BYTES);
  if (rc != 0) return rc;

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
      h0, Mi, H, xh + Hp, Mi, Hp, 2 * Hp);
  const cudaError_t err = cudaMemcpyAsync(
      out, h0, sizeof(float) * (size_t)M * H, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;

  const dim3 proj_grid(Hp / ProjTile::COLS, blocks_of(M, ProjTile::ROWS));
  const dim3 soft_grid((P + kSoftmaxRows - 1) / kSoftmaxRows, N);
  const dim3 gates_grid(H4p / FwdTile::COLS, blocks_of(M, FwdTile::ROWS));
  for (int k = 0; k < T; ++k) {
    recur_proj_kernel<true><<<proj_grid, kThreads, ProjTile::BYTES, s>>>(
        xh, wpp, bp, slot_t, hp, N, P, H, Hp, T, k);
    recur_softmax_kernel<true><<<soft_grid, kThreads, soft_smem, s>>>(
        hp, langp, slot_t, nullptr, xh, N, P, Hp, T, k, kSoftmaxRows);
    recur_gates_kernel<true><<<gates_grid, kThreads, FwdTile::BYTES, s>>>(
        xh, wmp, bm, slot_t, cs, nullptr, out, N, P, H, Hp, T, k);
  }
  return (int)cudaGetLastError();
}
