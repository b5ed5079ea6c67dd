// Fused one-pass sparse-MHA decode attention for Hopper (sm_90a), on the
// contiguous cache (kernel 6) and read through a page table (kernel 7).
//
// Replaces the TPU kernels fused_sparse_decode_attention_kernel
// (src/repro/kernels/sparse_attention/sparse_attention.py:400, its
// pl.pallas_call at :443) and fused_sparse_decode_attention_paged_kernel
// (:510, its pl.pallas_call at :582).
//
// What bounds them: memory.  Per (batch, kv head) the work is the PQ code
// row (S*M int8, read twice), the validity row, and the K/V rows of the
// selected keys (about top_fraction of the cache per query row); the
// arithmetic is one dh-long dot product and one dh-long axpy per selected
// (key, row).
//
// Design: the R query rows of a kv head travel together, so every code,
// K and V byte is read once per kv group, never per query head.  The cache
// of each (b, kv head) is cut into NS splits of SP slots (a multiple of
// the 128-slot tile) so that B*Hk*NS blocks fill the card:
//  1. hist_kernel, one block per (kv group, split): scores its slots'
//     codes straight from global memory into a shared-memory histogram
//     and writes it out.  The TPU kernel pinned the whole code row on
//     chip instead (512 KB at S = 32k).
//  2. attend_kernel (SEL_FUSED), same grid: sums the splits' histograms
//     into the full one and reduces it to [t, need] per row exactly as
//     topl_select.hist_reduce does; the histograms of the newer splits,
//     read at bucket t, give the ties already taken before this split.
//     It then sweeps its slots newest first in 128-slot tiles, one slot
//     per thread: keys with score > t are taken, keys with score == t
//     while the ties at newer slots number fewer than need (a block-wide
//     scan of warp ballots, carried across tiles by a running count).
//     A tile with no eligible key skips all K/V reads; only eligible K
//     and V rows are loaded.  The softmax is an f32 online softmax whose
//     (max, sum, acc) per split go to a scratch buffer.
//  3. combine_kernel: merges the splits' partial softmaxes.
// The paged form walks the same splits of the MP*ps-slot view, finding
// each slot's row through the page table (decode_attention.cuh, Paged),
// so over the same data it is bit-identical to the contiguous form over
// gathered views: no (B, Hk, S, .) view is ever built.  The TPU grid's
// carried scratch (tie budget, softmax state) becomes the loop inside a
// block plus the two cross-split reductions above, since blocks run in no
// order.
#include "decode_attention.cuh"

namespace {

template <typename T, typename Addr>
int launch_fused(const void* q, const void* k, const void* v,
                 const int32_t* cq, const int8_t* ck, const uint8_t* vp,
                 Addr addr, void* out, int32_t* tp, int32_t* hist_part,
                 float* part, int G, int S, int R, int dh, int M, int hk,
                 int l, int max_score, int sum_rows, float scale, int ns,
                 int sp, cudaStream_t st) {
  hist_kernel<Addr><<<dim3(G, ns), THREADS, 0, st>>>(
      cq, ck, vp, addr, hist_part, S, R, M, hk, max_score, sum_rows, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return attend_and_combine<T, Addr, SEL_FUSED>(
      q, k, v, cq, ck, vp, addr, hist_part, nullptr, part, tp, out, G, S, R,
      dh, M, hk, l, max_score, sum_rows, scale, ns, sp, st);
}

template <typename Addr>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* codes_q, const void* codes_k, const void* kv_valid,
             Addr addr, void* out, void* thr_out, void* hist_part, void* part,
             int G, int S, int R, int dh, int M, int hk, int l,
             int max_score, int sum_rows, float scale, int ns, int sp,
             void* stream) {
  const int r_out = sum_rows ? 1 : R;
  if (!decode_args_ok(G, S, R, dh, M, hk, r_out * (max_score + 1), ns, sp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cqp = static_cast<const int32_t*>(codes_q);
  const int8_t* ckp = static_cast<const int8_t*>(codes_k);
  const uint8_t* vp = static_cast<const uint8_t*>(kv_valid);
  int32_t* tp = static_cast<int32_t*>(thr_out);
  int32_t* hp = static_cast<int32_t*>(hist_part);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return launch_fused<float, Addr>(q, k, v, cqp, ckp, vp, addr, out, tp,
                                     hp, pp, G, S, R, dh, M, hk, l,
                                     max_score, sum_rows, scale, ns, sp, st);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16, Addr>(
        q, k, v, cqp, ckp, vp, addr, out, tp, hp, pp, G, S, R, dh, M, hk, l,
        max_score, sum_rows, scale, ns, sp, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 6.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  q
// (G, R, dh); k, v (G, S, dh); codes_q (G, R, M) int32; codes_k (G, S, M)
// int8; kv_valid (B, S) bool, G = B * hk.  thr_out may be null; else
// (G, R_out, 2) int32 receives [t, need].  Scratch from the caller:
// hist_part (G, ns, R_out, max_score + 1) int32 and part (G, ns, R,
// dh + 2) float32, for ns splits of sp slots (sp a multiple of 128,
// (ns - 1) * sp < S <= ns * sp).  Returns the cudaError_t of the launches.
extern "C" int repro_fused_sparse_decode(
    int dtype, const void* q, const void* k, const void* v,
    const void* codes_q, const void* codes_k, const void* kv_valid, void* out,
    void* thr_out, void* hist_part, void* part, int G, int S, int R, int dh,
    int M, int hk, int l, int max_score, int sum_rows, float scale, int ns,
    int sp, void* stream) {
  return dispatch(dtype, q, k, v, codes_q, codes_k, kv_valid, Contig{S}, out,
                  thr_out, hist_part, part, G, S, R, dh, M, hk, l, max_score,
                  sum_rows, scale, ns, sp, stream);
}

// Kernel 7: kernel 6 over (P, Hk, ps, .) pools (k_pool, v_pool,
// codes_pool int8) through page_table (B, MP) int32 with every id in
// [0, P) (the caller clamps unallocated -1 entries to page 0, whose rows
// kv_valid (B, MP * ps) leaves out).  S = MP * ps view slots; the rest as
// kernel 6.
extern "C" int repro_fused_sparse_decode_paged(
    int dtype, const void* page_table, const void* q, const void* k_pool,
    const void* v_pool, const void* codes_q, const void* codes_pool,
    const void* kv_valid, void* out, void* thr_out, void* hist_part,
    void* part, int G, int MP, int ps, int R, int dh, int M, int hk, int l,
    int max_score, int sum_rows, float scale, int ns, int sp, void* stream) {
  if (MP < 1 || ps < 1) return (int)cudaErrorInvalidValue;
  const Paged addr{static_cast<const int32_t*>(page_table), MP, ps, hk};
  return dispatch(dtype, q, k_pool, v_pool, codes_q, codes_pool, kv_valid,
                  addr, out, thr_out, hist_part, part, G, MP * ps, R, dh, M,
                  hk, l, max_score, sum_rows, scale, ns, sp, stream);
}
