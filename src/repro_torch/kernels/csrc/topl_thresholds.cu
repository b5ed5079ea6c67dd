// Top-L selection thresholds for train/prefill sparse MHA, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel topl_thresholds_kernel
// (src/repro/kernels/topl_select/topl_select.py:69, its pl.pallas_call at
// :87).
//
// Computes, for every query row i of every query group g, the histogram
// over buckets 0..max_score of the PQ match scores s(q_i, k_j) of the keys
// j its causal / window mask admits (key positions j <= q_offset + i when
// causal, j > q_offset + i - window when windowed), and reduces it as
// topl_select.hist_reduce does: t = the highest bucket where #(s >= t)
// reaches l (0 if none does) and need = l - #(s > t).  Output [t, need]
// (G, nq, 2) int32, equal to the plain version bit for bit.
//
// What bounds it: integer compares.  Each admitted (query, key) pair costs
// M compares (O(nq nk M) against O((nq + nk) M) code bytes), so the
// kernel is compute-bound at these sizes.
//
// Design: one warp per query row, 8 rows (one query tile) per block.  The
// row's M codes sit in registers; the warp streams its admitted keys in
// tiles of 32, one key per lane, each lane reading its key-code row as
// 16-byte vectors (the warp's reads cover 32 consecutive rows).
// Lanes holding equal scores find each other with __match_any_sync and
// the lowest of them adds the group's size to the row's histogram in
// shared memory (M + 1 int32 per row), so no atomics are needed.  The kv
// head of a query head is indexed directly (GQA: b * Hk + h / R); the
// TPU version repeated the key codes per query head in device memory.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int WARPS = 8;              // query rows per block
constexpr int THREADS = WARPS * 32;
constexpr int M_MAX = 32;             // PQ books
constexpr int NB_MAX = 33;            // max_score + 1

template <bool VEC>
__global__ void __launch_bounds__(THREADS) topl_thresholds_kernel(
    const int32_t* __restrict__ codes_q, const int32_t* __restrict__ codes_k,
    int32_t* __restrict__ thr, int nq, int nk, int M, int hq, int rep, int l,
    int max_score, int causal, int window, int q_offset) {
  __shared__ int hist[WARPS][NB_MAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= nq) return;                          // whole warp
  int* h = hist[warp];
  for (int b = lane; b <= max_score; b += 32) h[b] = 0;
  __syncwarp();
  int qc[M_MAX];
  load_query_codes<M_MAX>(codes_q + ((size_t)g * nq + i) * M, M, qc);
  const int32_t* ck = codes_k + (size_t)kv_group(g, hq, rep) * nk * M;
  const int qpos = q_offset + i;
  const int k_hi = causal ? min(nk, qpos + 1) : nk;
  const int k_lo = window > 0 ? max(0, qpos - window + 1) : 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += 32) {
    const int key = k0 + lane;
    const int s =
        key < k_hi ? match_count<M_MAX, VEC>(ck + (size_t)key * M, M, qc) : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, s);
    if (s >= 0 && lane == __ffs(peers) - 1) h[s] += __popc(peers);
  }
  __syncwarp();
  if (lane == 0) {
    int ge = 0, t = 0, n_above = -1;
    for (int vb = max_score; vb >= 0; --vb) {
      if (ge + h[vb] >= l) {
        t = vb;
        n_above = ge;                           // #(s > t)
        break;
      }
      ge += h[vb];
    }
    if (n_above < 0) n_above = ge - h[0];       // no bucket reaches l: t = 0
    int32_t* out = thr + ((size_t)g * nq + i) * 2;
    out[0] = t;
    out[1] = l - n_above;
  }
}

}  // namespace

// codes_q: (G, nq, M) int32; codes_k: (Gk, nk, M) int32 with G = B * hq and
// Gk = B * hq / rep; thr: (G, nq, 2) int32.  window <= 0 means none.
// Returns the cudaError_t of the launch.
extern "C" int repro_topl_thresholds(const void* codes_q, const void* codes_k,
                                     void* thr, int G, int nq, int nk, int M,
                                     int hq, int rep, int l, int max_score,
                                     int causal, int window, int q_offset,
                                     void* stream) {
  if (G < 1 || nq < 1 || nk < 1 || M < 1 || M > M_MAX || hq < 1 || rep < 1 ||
      hq % rep || G % hq || l < 1 || max_score < M || max_score >= NB_MAX ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((nq + WARPS - 1) / WARPS, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cq = static_cast<const int32_t*>(codes_q);
  const int32_t* ck = static_cast<const int32_t*>(codes_k);
  int32_t* tp = static_cast<int32_t*>(thr);
  if (M % 4 == 0 && reinterpret_cast<uintptr_t>(ck) % 16 == 0)
    topl_thresholds_kernel<true><<<grid, THREADS, 0, st>>>(
        cq, ck, tp, nq, nk, M, hq, rep, l, max_score, causal, window,
        q_offset);
  else
    topl_thresholds_kernel<false><<<grid, THREADS, 0, st>>>(
        cq, ck, tp, nq, nk, M, hq, rep, l, max_score, causal, window,
        q_offset);
  return (int)cudaGetLastError();
}
