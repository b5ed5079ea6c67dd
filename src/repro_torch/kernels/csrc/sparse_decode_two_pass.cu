// Two-pass sparse-MHA decode for Hopper (sm_90a): the decode thresholds
// (kernel 3), then the attention over the keys they admit (kernel 5) —
// the bisection tier of the fused decode (sparse_decode.cu), with output
// identical to it.
//
// Replaces the TPU kernels decode_topl_thresholds_kernel
// (src/repro/kernels/topl_select/topl_select.py:161, its pl.pallas_call
// at :193) and sparse_decode_attention_kernel
// (src/repro/kernels/sparse_attention/sparse_attention.py:254, its
// pl.pallas_call at :292).
//
// What bounds them: memory, as the fused kernel (decode_attention.cuh):
// the code row and validity row per kv group, and for kernel 5 the K/V
// rows of the selected keys.
//
// Design: both kernels walk the fused kernel's splits with its passes.
// Kernel 3 is hist_kernel (per-split score histograms in shared memory)
// then thr_kernel, which sums the splits and reduces to [t, need] with the
// fused kernel's own reduction, so the two tiers get equal [t, need].
// Kernel 5 takes [t, need] (G, R_out, 2).  Its tie budget counts the ties
// at newer slots across the whole row, so it first counts, per split, the
// ties at bucket t (tie_kernel: one re-read of the int8 code row), then
// runs the fused kernel's attention body (SEL_GIVEN) with the newer
// splits' tie count as its starting budget, and the same combine.  Given
// equal [t, need], every eligibility decision, softmax update and sum
// happens in the fused kernel's order: the outputs are bit-identical.
#include "decode_attention.cuh"

// Kernel 3.  codes_q (G, R, M) int32, codes_k (G, S, M) int8, kv_valid
// (B, S) bool, G = B * hk -> thr (G, R_out, 2) int32 [t, need].  Scratch:
// hist_part (G, ns, R_out, max_score + 1) int32, splits as kernel 6.
extern "C" int repro_decode_thresholds(
    const void* codes_q, const void* codes_k, const void* kv_valid,
    void* thr, void* hist_part, int G, int S, int R, int M, int hk, int l,
    int max_score, int sum_rows, int ns, int sp, void* stream) {
  const int r_out = sum_rows ? 1 : R;
  if (!decode_args_ok(G, S, R, 8, M, hk, r_out * (max_score + 1), ns, sp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* hp = static_cast<int32_t*>(hist_part);
  hist_kernel<Contig><<<dim3(G, ns), THREADS, 0, st>>>(
      static_cast<const int32_t*>(codes_q),
      static_cast<const int8_t*>(codes_k),
      static_cast<const uint8_t*>(kv_valid), Contig{S}, hp, S, R, M, hk,
      max_score, sum_rows, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  thr_kernel<<<G, 32, 0, st>>>(hp, static_cast<int32_t*>(thr), r_out, ns,
                               max_score, l);
  return (int)cudaGetLastError();
}

// Kernel 5.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  q
// (G, R, dh); k, v (G, S, dh); codes as kernel 3; thr (G, R_out, 2)
// int32.  Scratch: tie_part (G, ns, R_out) int32 and part (G, ns, R,
// dh + 2) float32.
extern "C" int repro_sparse_decode_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* codes_q, const void* codes_k, const void* thr,
    const void* kv_valid, void* out, void* tie_part, void* part, int G,
    int S, int R, int dh, int M, int hk, int sum_rows, float scale, int ns,
    int sp, void* stream) {
  if (!decode_args_ok(G, S, R, dh, M, hk, 0, ns, sp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cqp = static_cast<const int32_t*>(codes_q);
  const int8_t* ckp = static_cast<const int8_t*>(codes_k);
  const uint8_t* vp = static_cast<const uint8_t*>(kv_valid);
  const int32_t* tp = static_cast<const int32_t*>(thr);
  int32_t* ties = static_cast<int32_t*>(tie_part);
  float* pp = static_cast<float*>(part);
  const Contig addr{S};
  tie_kernel<Contig><<<dim3(G, ns), THREADS, 0, st>>>(
      cqp, ckp, vp, addr, tp, ties, S, R, M, hk, sum_rows, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return attend_and_combine<float, Contig, SEL_GIVEN>(
        q, k, v, cqp, ckp, vp, addr, tp, ties, pp, nullptr, out, G, S, R, dh,
        M, hk, 0, 0, sum_rows, scale, ns, sp, st);
  if (dtype == 1)
    return attend_and_combine<__nv_bfloat16, Contig, SEL_GIVEN>(
        q, k, v, cqp, ckp, vp, addr, tp, ties, pp, nullptr, out, G, S, R, dh,
        M, hk, 0, 0, sum_rows, scale, ns, sp, st);
  return (int)cudaErrorInvalidValue;
}
