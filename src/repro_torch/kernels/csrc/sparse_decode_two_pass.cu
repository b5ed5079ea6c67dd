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
// Kernel 3 is one launch of hist_kernel, the fused kernel's first pass
// (per-split score histograms in shared memory from 16-byte code-row
// loads), in which the last block of each kv group to finish sums the
// group's splits and reduces them to [t, need] with one warp a row
// (decode_attention.cuh, warp_reduce_thr: the numbers of
// topl_select.hist_reduce), so the two tiers get equal [t, need].
// Kernel 5 takes [t, need] (G, R_out, 2).  Its tie budget counts the ties
// at newer slots across the whole row, so it first counts, per split, the
// ties at bucket t (tie_kernel: one re-read of the int8 code row), then
// runs the fused kernel's attention body (SEL_GIVEN: the selected keys
// listed in shared memory, their K/V rows streamed through a cp.async
// ring) with the newer splits' tie count as its starting budget, and the
// same combine.  Given equal [t, need], every eligibility decision, list
// entry, softmax update and sum happens in the fused kernel's order: the
// outputs are bit-identical.
//
// A cache whose sequence splits over ranks: kernel 3 also writes the
// summed histogram of each row (hist_sum), which the ranks add up to the
// whole row's [t, need], and kernel 5 also writes each row's log-sum-exp
// (lse), by which the ranks' partial outputs combine.
#include "decode_attention.cuh"

// Kernel 3.  codes_q (G, R, M) int32, codes_k (G, S, M) int8, kv_valid
// (B, S) bool, G = B * hk -> thr (G, R_out, 2) int32 [t, need].  Scratch:
// hist_part (G, ns, R_out, max_score + 1) int32, splits as kernel 6, and
// arrive (G,) int32, zero before the launch and left zero by it.
// hist_sum (G, R_out, max_score + 1) int32, or null: each row's histogram
// summed over the splits.
extern "C" int repro_decode_thresholds(
    const void* codes_q, const void* codes_k, const void* kv_valid,
    void* thr, void* hist_part, void* hist_sum, void* arrive, int G, int S,
    int R, int M, int hk, int l, int max_score, int sum_rows, int ns, int sp,
    void* stream) {
  const int r_out = sum_rows ? 1 : R;
  if (!decode_args_ok(G, S, R, 8, M, hk, r_out * (max_score + 1), ns, sp))
    return (int)cudaErrorInvalidValue;
  return (int)launch_hist(
      static_cast<const int32_t*>(codes_q),
      static_cast<const int8_t*>(codes_k),
      static_cast<const uint8_t*>(kv_valid), Contig{S},
      static_cast<int32_t*>(hist_part), static_cast<int32_t*>(thr),
      static_cast<int32_t*>(hist_sum), static_cast<int32_t*>(arrive), G, S,
      R, M, hk, max_score, sum_rows, l, ns, sp,
      static_cast<cudaStream_t>(stream));
}

// Kernel 5.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  q
// (G, R, dh); k, v (G, S, dh); codes as kernel 3; thr (G, R_out, 2)
// int32.  Scratch: tie_part (G, ns, R_out) int32 and part (G, ns, R,
// dh + 2) float32; the ring stages as kernel 6.  lse (G, R) float32, or
// null: each row's log-sum-exp of its selected logits (-inf: none).
extern "C" int repro_sparse_decode_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* codes_q, const void* codes_k, const void* thr,
    const void* kv_valid, void* out, void* lse, void* tie_part, void* part,
    int G, int S, int R, int dh, int M, int hk, int sum_rows, float scale,
    int ns, int sp, int stages, void* stream) {
  if (!decode_args_ok(G, S, R, dh, M, hk, 0, ns, sp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cqp = static_cast<const int32_t*>(codes_q);
  const int8_t* ckp = static_cast<const int8_t*>(codes_k);
  const uint8_t* vp = static_cast<const uint8_t*>(kv_valid);
  const int32_t* tp = static_cast<const int32_t*>(thr);
  int32_t* ties = static_cast<int32_t*>(tie_part);
  float* pp = static_cast<float*>(part);
  float* lp = static_cast<float*>(lse);
  const Contig addr{S};
  cudaError_t err = launch_ties(cqp, ckp, vp, addr, tp, ties, G, S, R, M,
                                hk, sum_rows, ns, sp, st);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return attend_and_combine<float, Contig, SEL_GIVEN>(
        q, k, v, cqp, ckp, vp, addr, tp, ties, pp, nullptr, out, G, S, R, dh,
        M, hk, 0, 0, sum_rows, scale, ns, sp, stages, st, lp);
  if (dtype == 1)
    return attend_and_combine<__nv_bfloat16, Contig, SEL_GIVEN>(
        q, k, v, cqp, ckp, vp, addr, tp, ties, pp, nullptr, out, G, S, R, dh,
        M, hk, 0, 0, sum_rows, scale, ns, sp, stages, st, lp);
  return (int)cudaErrorInvalidValue;
}
