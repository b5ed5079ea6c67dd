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
// (key, row).  The selected rows are scattered, so what matters is how
// many row copies are in flight on each SM.
//
// Design: the R query rows of a kv head travel together, so every code,
// K and V byte is read once per kv group, never per query head.  The cache
// of each (b, kv head) is cut into NS splits of SP slots (a multiple of
// the 128-slot tile, kernels.decode_splits) so that B*Hk*NS blocks fill
// the card:
//  1. hist_kernel, one block per (kv group, split): scores its valid
//     slots' codes straight from global memory (16-byte rows, four books
//     a word) into a shared-memory histogram and writes it out.  The TPU
//     kernel pinned the whole code row on chip instead (512 KB at
//     S = 32k).
//  2. attend_kernel (SEL_FUSED), same grid (decode_attention.cuh): sums
//     the splits' histograms and reduces them to [t, need] per row exactly
//     as topl_select.hist_reduce does; the histograms of the newer
//     splits, read at bucket t, give the ties already taken before this
//     split.  It then selects, newest first, the keys with score > t and
//     those at t while the ties at newer slots number fewer than need,
//     into a compact list in shared memory, and streams only the listed
//     K and V rows through a 3-stage cp.async ring (coalesced 16-byte
//     copies, two chunks in flight while one computes); each warp
//     computes QK, an f32 online softmax and PV on its 8 rows of every
//     32-row chunk from shared memory, and the warps merge in a fixed
//     order.  Its (max, sum, acc) per split go to a scratch buffer.
//  3. combine_kernel, one block per (kv group, query row): merges the
//     splits' partial softmaxes.
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
                 int sp, int stages, cudaStream_t st) {
  cudaError_t err = launch_hist(cq, ck, vp, addr, hist_part, nullptr, nullptr,
                                nullptr, G, S, R, M, hk, max_score,
                                sum_rows, l, ns, sp, st);
  if (err != cudaSuccess) return (int)err;
  return attend_and_combine<T, Addr, SEL_FUSED>(
      q, k, v, cq, ck, vp, addr, hist_part, nullptr, part, tp, out, G, S, R,
      dh, M, hk, l, max_score, sum_rows, scale, ns, sp, stages, st);
}

template <typename Addr>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* codes_q, const void* codes_k, const void* kv_valid,
             Addr addr, void* out, void* thr_out, void* hist_part, void* part,
             int G, int S, int R, int dh, int M, int hk, int l,
             int max_score, int sum_rows, float scale, int ns, int sp,
             int stages, void* stream) {
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
                                     max_score, sum_rows, scale, ns, sp,
                                     stages, st);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16, Addr>(
        q, k, v, cqp, ckp, vp, addr, out, tp, hp, pp, G, S, R, dh, M, hk, l,
        max_score, sum_rows, scale, ns, sp, stages, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 6.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  q
// (G, R, dh); k, v (G, S, dh); codes_q (G, R, M) int32; codes_k (G, S, M)
// int8; kv_valid (B, S) bool, G = B * hk.  thr_out may be null; else
// (G, R_out, 2) int32 receives [t, need].  Scratch from the caller:
// hist_part (G, ns, R_out, max_score + 1) int32 and part (G, ns, R,
// dh + 2) float32, for ns splits of sp slots (sp a multiple of 128,
// (ns - 1) * sp < S <= ns * sp); stages: the attention pass's ring
// stages (kernels.decode_stages).  k and v rows start on 16 bytes.
// Returns the cudaError_t of the launches.
extern "C" int repro_fused_sparse_decode(
    int dtype, const void* q, const void* k, const void* v,
    const void* codes_q, const void* codes_k, const void* kv_valid, void* out,
    void* thr_out, void* hist_part, void* part, int G, int S, int R, int dh,
    int M, int hk, int l, int max_score, int sum_rows, float scale, int ns,
    int sp, int stages, void* stream) {
  return dispatch(dtype, q, k, v, codes_q, codes_k, kv_valid, Contig{S}, out,
                  thr_out, hist_part, part, G, S, R, dh, M, hk, l, max_score,
                  sum_rows, scale, ns, sp, stages, stream);
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
    int max_score, int sum_rows, float scale, int ns, int sp, int stages,
    void* stream) {
  if (MP < 1 || ps < 1) return (int)cudaErrorInvalidValue;
  const Paged addr{static_cast<const int32_t*>(page_table), MP, ps, hk};
  return dispatch(dtype, q, k_pool, v_pool, codes_q, codes_pool, kv_valid,
                  addr, out, thr_out, hist_part, part, G, MP * ps, R, dh, M,
                  hk, l, max_score, sum_rows, scale, ns, sp, stages, stream);
}
