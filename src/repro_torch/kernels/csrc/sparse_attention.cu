// Thresholded sparse MHA for train/prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparse_attention_kernel
// (src/repro/kernels/sparse_attention/sparse_attention.py:115, its
// pl.pallas_call at :144).
//
// Computes, for every query row i of query group g (kv group
// b * Hk + h / R under GQA), attention over the keys its top-L selection
// keeps, given [t, need] from the threshold kernel: a key admitted by the
// causal / window mask is kept when its PQ match score s > t, or when
// s == t and fewer than `need` keys with s == t sit at newer (higher)
// positions.  Softmax over the kept keys in f32; a row that keeps nothing
// outputs 0; the output has q's dtype.
//
// What bounds it: per kept (query, key) pair, one dh-long dot product and
// one dh-long axpy (4 dh flops) plus the M code compares of every
// admitted pair; per row it reads about L of the kv group's K and V rows.
//
// Design: one warp per query row, 8 rows per block.  The TPU kernel walked
// (Tq x Tk) tiles newest first and carried the tie budget and the online
// softmax from one grid step to the next; here the warp of a row walks
// its admitted keys newest first in tiles of 32, one key per lane (lane 0
// the newest), so the walk is sequential and the "ties at newer
// positions" count is exact: a warp ballot of the tile's ties, the
// popcount of the lanes before this one, plus a running count carried
// across tiles.  A tile with no kept key skips all K/V reads.  For each
// kept key the warp reads its K row (dh / 32 elements per lane,
// coalesced) and sums q . k with a butterfly; the tile's logits update an
// f32 online softmax (max, sum, dh / 32 accumulators per lane) and the
// kept keys' V rows are folded in.  Only the kept K and V rows are read
// (the CUDA-core FMA here touches L * dh per row, not nk * dh); tensor
// cores over dense tiles are a later trade.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int WARPS = 8;              // query rows per block
constexpr int THREADS = WARPS * 32;
constexpr int M_MAX = 32;             // PQ books

// ND consecutive elements (the lane's slice of a head-dim row) as floats.
template <int ND>
__device__ __forceinline__ void load_slice(const float* p, float (&o)[ND]) {
  if constexpr (ND % 4 == 0) {
#pragma unroll
    for (int c = 0; c < ND / 4; ++c) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + c);
      o[4 * c] = a.x; o[4 * c + 1] = a.y; o[4 * c + 2] = a.z; o[4 * c + 3] = a.w;
    }
  } else if constexpr (ND == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = __ldg(p);
  }
}
template <int ND>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* p,
                                           float (&o)[ND]) {
  if constexpr (ND == 8) {
    load8(p, o);
  } else if constexpr (ND == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (ND == 2) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = to_f(p[0]);
  }
}

template <typename T, int ND, bool VEC>
__global__ void __launch_bounds__(THREADS) sparse_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ codes_q, const int32_t* __restrict__ codes_k,
    const int32_t* __restrict__ thr, T* __restrict__ out, int nq, int nk,
    int M, int hq, int rep, float scale, int causal, int window,
    int q_offset) {
  constexpr int DH = ND * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lane_lt = (1u << lane) - 1u;
  const int g = blockIdx.y;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= nq) return;                          // whole warp
  const size_t row = (size_t)g * nq + i;
  const int kvg = kv_group(g, hq, rep);
  const T* kg = k + (size_t)kvg * nk * DH + lane * ND;
  const T* vg = v + (size_t)kvg * nk * DH + lane * ND;
  const int32_t* ck = codes_k + (size_t)kvg * nk * M;

  float qv[ND];
  load_slice<ND>(q + row * DH + lane * ND, qv);
  int qc[M_MAX];
  load_query_codes<M_MAX>(codes_q + row * M, M, qc);
  const int t = thr[row * 2], need = thr[row * 2 + 1];
  const int qpos = q_offset + i;
  const int k_hi = causal ? min(nk, qpos + 1) : nk;
  const int k_lo = window > 0 ? max(0, qpos - window + 1) : 0;

  int taken = 0;                                // ties kept at newer keys
  float m_run = -INFINITY, l_run = 0.f, acc[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) acc[e] = 0.f;

  for (int tile_end = k_hi; tile_end > k_lo; tile_end -= 32) {
    const int key = tile_end - 1 - lane;        // lane 0 = newest key
    const int s =
        key >= k_lo ? match_count<M_MAX, VEC>(ck + (size_t)key * M, M, qc)
                    : -1;
    const bool at = s == t;                     // t >= 0, so s = -1 never
    const unsigned ties = __ballot_sync(FULL_MASK, at);
    const bool take_tie = at && taken + __popc(ties & lane_lt) < need;
    const bool kept = s > t || take_tie;
    taken += __popc(__ballot_sync(FULL_MASK, take_tie));
    const unsigned kept_mask = __ballot_sync(FULL_MASK, kept);
    if (kept_mask == 0) continue;               // uniform: skip the tile

    float lg = -INFINITY;                       // lane j: logit of key j
    for (unsigned rem = kept_mask; rem; rem &= rem - 1) {
      const int j = __ffs(rem) - 1;
      float kv[ND];
      load_slice<ND>(kg + (size_t)(tile_end - 1 - j) * DH, kv);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < ND; ++e) part = fmaf(qv[e], kv[e], part);
      const float dot = warp_sum(part);
      if (lane == j) lg = dot * scale;
    }
    const float m_new = fmaxf(m_run, warp_max(lg));   // finite: a key kept
    const float alpha = expf(m_run - m_new);          // 0 on the first tile
    const float p = kept ? expf(lg - m_new) : 0.f;
    l_run = l_run * alpha + warp_sum(p);
    m_run = m_new;
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[e] *= alpha;
    for (unsigned rem = kept_mask; rem; rem &= rem - 1) {
      const int j = __ffs(rem) - 1;
      const float pj = __shfl_sync(FULL_MASK, p, j);
      float vv[ND];
      load_slice<ND>(vg + (size_t)(tile_end - 1 - j) * DH, vv);
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
    }
  }
  const float inv = l_run > 0.f ? 1.f / fmaxf(l_run, 1e-30f) : 0.f;
  T* o = out + row * DH + lane * ND;
#pragma unroll
  for (int e = 0; e < ND; ++e) o[e] = from_f<T>(acc[e] * inv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int32_t* cq,
           const int32_t* ck, const int32_t* thr, void* out, int G, int nq,
           int nk, int dh, int M, int hq, int rep, float scale, int causal,
           int window, int q_offset, cudaStream_t st) {
  dim3 grid((nq + WARPS - 1) / WARPS, G);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(ck) % 16 == 0;
#define REPRO_SA_LAUNCH(ND)                                                  \
  if (vec)                                                                   \
    sparse_attention_kernel<T, ND, true><<<grid, THREADS, 0, st>>>(          \
        qp, kp, vp, cq, ck, thr, op, nq, nk, M, hq, rep, scale, causal,      \
        window, q_offset);                                                   \
  else                                                                       \
    sparse_attention_kernel<T, ND, false><<<grid, THREADS, 0, st>>>(         \
        qp, kp, vp, cq, ck, thr, op, nq, nk, M, hq, rep, scale, causal,      \
        window, q_offset)
  switch (dh) {
    case 32: REPRO_SA_LAUNCH(1); break;
    case 64: REPRO_SA_LAUNCH(2); break;
    case 128: REPRO_SA_LAUNCH(4); break;
    case 256: REPRO_SA_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  q: (G, nq, dh);
// k, v: (Gk, nk, dh); codes_q: (G, nq, M) and codes_k: (Gk, nk, M) int32;
// thr: (G, nq, 2) int32 [t, need]; G = B * hq, Gk = B * hq / rep.  dh is
// 32, 64, 128 or 256; window <= 0 means none.  Returns the cudaError_t of
// the launch.
extern "C" int repro_sparse_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* codes_q, const void* codes_k, const void* thr, void* out,
    int G, int nq, int nk, int dh, int M, int hq, int rep, float scale,
    int causal, int window, int q_offset, void* stream) {
  if (G < 1 || nq < 1 || nk < 1 || M < 1 || M > M_MAX || hq < 1 || rep < 1 ||
      hq % rep || G % hq || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cq = static_cast<const int32_t*>(codes_q);
  const int32_t* ck = static_cast<const int32_t*>(codes_k);
  const int32_t* tp = static_cast<const int32_t*>(thr);
  if (dtype == 0)
    return launch<float>(q, k, v, cq, ck, tp, out, G, nq, nk, dh, M, hq, rep,
                         scale, causal, window, q_offset, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, cq, ck, tp, out, G, nq, nk, dh, M,
                                 hq, rep, scale, causal, window, q_offset, st);
  return (int)cudaErrorInvalidValue;
}
