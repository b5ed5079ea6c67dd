// Dense single-token decode attention read through a page table, for
// Hopper (sm_90a): kernel 8, the paged decode of the dense baseline
// (SPT's sparse MHA off).
//
// Replaces the TPU kernel dense_decode_attention_paged_kernel
// (src/repro/kernels/sparse_attention/sparse_attention.py:630, its
// pl.pallas_call at :673).
//
// What bounds it: memory.  Every valid slot's K and V row of each kv
// group is read once (2 * dh elements per slot); the arithmetic is one
// dh-long dot product and one dh-long axpy per (valid slot, query row),
// far below the bytes at R = 2 rows per kv head.
//
// Design: the R query rows of a kv head travel together, so each K/V row
// is read once per kv group.  One block per (kv group, split): a split of
// 512 slots per block when B*Hk alone (64 at 8 slots x 8 kv heads) would
// leave most of the 132 SMs idle.  The block runs the sparse decode
// kernels' attention body (decode_attention.cuh) with every valid slot
// eligible (SEL_DENSE: no codes, no thresholds): 128-slot tiles, one slot
// per thread computing its R dot products, an f32 online softmax per row,
// tiles with no valid slot skipped, the slot's row found through the page
// table (Paged).  A combine pass merges the splits' partial softmaxes; a
// row with no valid slot outputs 0, as the TPU kernel's _write_out does.
#include "decode_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, pools, out).  page_table (B, MP)
// int32, every id in [0, P); q (G, R, dh), G = B * hk; k_pool, v_pool
// (P, hk, ps, dh); kv_valid (B, MP * ps) bool.  Scratch: part (G, ns, R,
// dh + 2) float32, ns splits of sp slots as the sparse decode kernels.
extern "C" int repro_dense_decode_paged(
    int dtype, const void* page_table, const void* q, const void* k_pool,
    const void* v_pool, const void* kv_valid, void* out, void* part, int G,
    int MP, int ps, int R, int dh, int hk, float scale, int ns, int sp,
    void* stream) {
  if (MP < 1 || ps < 1 || !decode_args_ok(G, MP * ps, R, dh, 1, hk, 0, ns, sp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Paged addr{static_cast<const int32_t*>(page_table), MP, ps, hk};
  const uint8_t* vp = static_cast<const uint8_t*>(kv_valid);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return attend_and_combine<float, Paged, SEL_DENSE>(
        q, k_pool, v_pool, nullptr, nullptr, vp, addr, nullptr, nullptr, pp,
        nullptr, out, G, MP * ps, R, dh, 0, hk, 0, 0, 0, scale, ns, sp, st);
  if (dtype == 1)
    return attend_and_combine<__nv_bfloat16, Paged, SEL_DENSE>(
        q, k_pool, v_pool, nullptr, nullptr, vp, addr, nullptr, nullptr, pp,
        nullptr, out, G, MP * ps, R, dh, 0, hk, 0, 0, 0, scale, ns, sp, st);
  return (int)cudaErrorInvalidValue;
}
