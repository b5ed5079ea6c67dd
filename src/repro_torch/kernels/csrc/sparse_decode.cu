// Fused one-pass sparse-MHA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_sparse_decode_attention_kernel
// (src/repro/kernels/sparse_attention/sparse_attention.py:400, its
// pl.pallas_call at :443).
//
// What bounds it: memory.  Per (batch, kv head) the work is the PQ code
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
//     (M+1 buckets per row for "qhead", R*M+1 for "kvgroup") and writes
//     it out.  The TPU kernel pinned the whole code row on chip instead
//     (512 KB at S = 32k).
//  2. attend_kernel, same grid: sums the splits' histograms into the full
//     one and reduces it to [t, need] per row exactly as
//     topl_select.hist_reduce does; the histograms of the newer splits,
//     read at bucket t, give the ties already taken before this split.
//     It then sweeps its slots newest first in 128-slot tiles, one slot
//     per thread: keys with score > t are taken, keys with score == t
//     while the ties at newer slots number fewer than need.  The
//     newer-tie count within a tile is a block-wide scan (warp ballots +
//     per-warp totals), carried across tiles by a running count.  The
//     eligible slots of a tile are compacted into a list; a tile with
//     none skips all K/V reads; only eligible K and V rows are loaded.
//     The softmax is an f32 online softmax whose (max, sum, acc) per
//     split go to a scratch buffer.
//  3. combine_kernel: merges the splits' partial softmaxes; a row with
//     nothing selected outputs 0.
// The TPU grid's carried scratch (tie budget, softmax state) becomes the
// loop inside a block plus the two cross-split reductions above, since
// blocks run in no order.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;          // slots per tile, one per thread
constexpr int WARPS = THREADS / 32;
constexpr int R_MAX = 8;              // query heads per kv head
constexpr int M_MAX = 32;             // PQ books
constexpr int HIST_MAX = 264;         // >= R_out * (max_score + 1)
constexpr int D_MAX = 256;            // head dim
constexpr int ND = D_MAX / THREADS;   // head-dim columns per thread

// Match counts of one cached slot against the R query code rows; summed
// into sc[0] for the GQA-shared ("kvgroup") selection.
__device__ __forceinline__ void slot_scores(const int8_t* row, const int* cq,
                                            int R, int M, int sum_rows,
                                            int (&sc)[R_MAX]) {
#pragma unroll
  for (int r = 0; r < R_MAX; ++r) sc[r] = 0;
  for (int m = 0; m < M; ++m) {
    const int cm = row[m];
#pragma unroll
    for (int r = 0; r < R_MAX; ++r)
      if (r < R) sc[r] += (cq[r * M + m] == cm);
  }
  if (sum_rows) {
    int t = 0;
#pragma unroll
    for (int r = 0; r < R_MAX; ++r) t += sc[r];
    sc[0] = t;
  }
}

__device__ __forceinline__ void load_codes_q(int* cq, const int32_t* codes_q,
                                             int g, int R, int M) {
  for (int i = threadIdx.x; i < R * M; i += THREADS)
    cq[i] = codes_q[(size_t)g * R * M + i];
}

__global__ void __launch_bounds__(THREADS) hist_kernel(
    const int32_t* __restrict__ codes_q, const int8_t* __restrict__ codes_k,
    const uint8_t* __restrict__ kv_valid, int32_t* __restrict__ hist_part,
    int S, int R, int M, int hk, int max_score, int sum_rows, int SP) {
  __shared__ int cq[R_MAX * M_MAX];
  __shared__ int hist[HIST_MAX];
  const int g = blockIdx.x, j = blockIdx.y, ns = gridDim.y;
  const int r_out = sum_rows ? 1 : R;
  const int nb = max_score + 1;
  const int lo = j * SP, hi = min(S, lo + SP);
  const uint8_t* valid_row = kv_valid + (size_t)(g / hk) * S;
  const int8_t* ck = codes_k + (size_t)g * S * M;
  load_codes_q(cq, codes_q, g, R, M);
  for (int i = threadIdx.x; i < r_out * nb; i += THREADS) hist[i] = 0;
  __syncthreads();
  for (int s = lo + threadIdx.x; s < hi; s += THREADS) {
    if (!valid_row[s]) continue;
    int sc[R_MAX];
    slot_scores(ck + (size_t)s * M, cq, R, M, sum_rows, sc);
#pragma unroll
    for (int r = 0; r < R_MAX; ++r)
      if (r < r_out) atomicAdd(&hist[r * nb + sc[r]], 1);
  }
  __syncthreads();
  int32_t* out = hist_part + ((size_t)g * ns + j) * r_out * nb;
  for (int i = threadIdx.x; i < r_out * nb; i += THREADS) out[i] = hist[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) attend_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ codes_q,
    const int8_t* __restrict__ codes_k, const uint8_t* __restrict__ kv_valid,
    const int32_t* __restrict__ hist_part, float* __restrict__ part,
    int32_t* __restrict__ thr_out, int S, int R, int dh, int M, int hk,
    int l, int max_score, int sum_rows, float scale, int SP) {
  __shared__ int cq[R_MAX * M_MAX];
  __shared__ int thr[R_MAX * 3];                  // t, need, ties taken
  __shared__ float qs[R_MAX * D_MAX];
  __shared__ float ps[R_MAX * THREADS];
  __shared__ float red_max[R_MAX * WARPS];
  __shared__ float red_sum[R_MAX * WARPS];
  __shared__ int tie_cnt[R_MAX * WARPS];
  __shared__ int elig_cnt[WARPS];
  __shared__ int list[THREADS];

  const int g = blockIdx.x, j = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lane_lt = (1u << lane) - 1u;
  const int r_out = sum_rows ? 1 : R;
  const int nb = max_score + 1;
  const int lo = j * SP, hi = min(S, lo + SP);
  const uint8_t* valid_row = kv_valid + (size_t)(g / hk) * S;
  const int8_t* ck = codes_k + (size_t)g * S * M;
  const T* kg = k + (size_t)g * S * dh;
  const T* vg = v + (size_t)g * S * dh;

  load_codes_q(cq, codes_q, g, R, M);
  for (int i = tid; i < R * dh; i += THREADS) qs[i] = to_f(q[(size_t)g * R * dh + i]);
  if (tid < r_out) {
    // full histogram = sum of the splits'; t = highest bucket where
    // #(score >= t) reaches l (0 if none does); need = l - #(score > t)
    const int32_t* hp = hist_part + (size_t)g * ns * r_out * nb + tid * nb;
    const size_t stride = (size_t)r_out * nb;     // between splits
    int ge = 0, t = 0, n_above = -1, h0 = 0;
    for (int vb = max_score; vb >= 0; --vb) {
      int h = 0;
      for (int s = 0; s < ns; ++s) h += hp[s * stride + vb];
      if (ge + h >= l) { t = vb; n_above = ge; break; }
      ge += h;
      h0 = h;
    }
    if (n_above < 0) n_above = ge - h0;           // loop ended at vb = 0
    const int need = l - n_above;
    int newer = 0;                                // ties in newer splits
    for (int s = j + 1; s < ns; ++s) newer += hp[s * stride + t];
    thr[3 * tid] = t;
    thr[3 * tid + 1] = need;
    thr[3 * tid + 2] = min(newer, need);
    if (thr_out != nullptr && j == 0) {
      thr_out[((size_t)g * r_out + tid) * 2] = t;
      thr_out[((size_t)g * r_out + tid) * 2 + 1] = need;
    }
  }
  __syncthreads();

  int taken[R_MAX];
  float m_run[R_MAX], l_run[R_MAX], acc[R_MAX][ND];
#pragma unroll
  for (int r = 0; r < R_MAX; ++r) {
    taken[r] = r < r_out ? thr[3 * r + 2] : 0;
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int jj = 0; jj < ND; ++jj) acc[r][jj] = 0.f;
  }

  for (int tile_end = hi; tile_end > lo; tile_end -= THREADS) {
    const int slot = tile_end - 1 - tid;            // tid 0 = newest slot
    const bool live = slot >= lo && valid_row[slot];
    int sc[R_MAX];
    if (live) slot_scores(ck + (size_t)slot * M, cq, R, M, sum_rows, sc);
    bool above[R_MAX], at[R_MAX];
    int pre[R_MAX];
#pragma unroll
    for (int r = 0; r < R_MAX; ++r) {
      above[r] = at[r] = false;
      pre[r] = 0;
      if (r < r_out) {
        const int sm = live ? sc[r] : -1;
        const int t = thr[3 * r];
        above[r] = sm > t;
        at[r] = sm == t;
        const unsigned mask = __ballot_sync(FULL_MASK, at[r]);
        pre[r] = __popc(mask & lane_lt);
        if (lane == 0) tie_cnt[r * WARPS + warp] = __popc(mask);
      }
    }
    __syncthreads();
    unsigned bits = 0;
#pragma unroll
    for (int r = 0; r < R_MAX; ++r) {
      if (r < r_out) {
        int before = 0, total = 0;
        for (int w = 0; w < WARPS; ++w) {
          const int c = tie_cnt[r * WARPS + w];
          total += c;
          if (w < warp) before += c;
        }
        const int need = thr[3 * r + 1];
        if (above[r] || (at[r] && taken[r] + before + pre[r] < need))
          bits |= 1u << r;
        taken[r] += min(total, max(need - taken[r], 0));
      }
    }
    const unsigned em = __ballot_sync(FULL_MASK, bits != 0);
    if (lane == 0) elig_cnt[warp] = __popc(em);
    __syncthreads();
    int base = 0, n_list = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) base += elig_cnt[w];
      n_list += elig_cnt[w];
    }
    if (n_list == 0) continue;                      // uniform: skip tile
    if (bits) list[base + __popc(em & lane_lt)] = tid;

    float lg[R_MAX];
#pragma unroll
    for (int r = 0; r < R_MAX; ++r) lg[r] = -INFINITY;
    if (bits) {
      float dot[R_MAX];
#pragma unroll
      for (int r = 0; r < R_MAX; ++r) dot[r] = 0.f;
      const T* krow = kg + (size_t)slot * dh;
      for (int d0 = 0; d0 < dh; d0 += 8) {
        float kv8[8];
        load8(krow + d0, kv8);
#pragma unroll
        for (int r = 0; r < R_MAX; ++r) {
          if (r < R) {
#pragma unroll
            for (int e = 0; e < 8; ++e) dot[r] += kv8[e] * qs[r * dh + d0 + e];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R_MAX; ++r) {
        const bool e = sum_rows ? (bits & 1u) : ((bits >> r) & 1u);
        if (r < R && e) lg[r] = dot[r] * scale;
      }
    }
#pragma unroll
    for (int r = 0; r < R_MAX; ++r) {
      if (r < R) {
        const float mx = warp_max(lg[r]);
        if (lane == 0) red_max[r * WARPS + warp] = mx;
      }
    }
    __syncthreads();
    float alpha[R_MAX];
#pragma unroll
    for (int r = 0; r < R_MAX; ++r) {
      alpha[r] = 1.f;
      if (r < R) {
        float tmax = -INFINITY;
        for (int w = 0; w < WARPS; ++w) tmax = fmaxf(tmax, red_max[r * WARPS + w]);
        const float m_new = fmaxf(m_run[r], tmax);
        const bool finite = m_new > -INFINITY;
        const float m_safe = finite ? m_new : 0.f;
        alpha[r] = finite ? expf(m_run[r] - m_safe) : 1.f;
        m_run[r] = m_new;
        const float p = lg[r] == -INFINITY ? 0.f : expf(lg[r] - m_safe);
        ps[r * THREADS + tid] = p;
        const float sum = warp_sum(p);
        if (lane == 0) red_sum[r * WARPS + warp] = sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R_MAX; ++r) {
      if (r < R) {
        float tsum = 0.f;
        for (int w = 0; w < WARPS; ++w) tsum += red_sum[r * WARPS + w];
        l_run[r] = l_run[r] * alpha[r] + tsum;
#pragma unroll
        for (int jj = 0; jj < ND; ++jj) acc[r][jj] *= alpha[r];
      }
    }
#pragma unroll 4
    for (int e = 0; e < n_list; ++e) {
      const int i = list[e];
      const T* vrow = vg + (size_t)(tile_end - 1 - i) * dh;
#pragma unroll
      for (int jj = 0; jj < ND; ++jj) {
        const int d = tid + jj * THREADS;
        if (d < dh) {
          const float vv = to_f(vrow[d]);
#pragma unroll
          for (int r = 0; r < R_MAX; ++r)
            if (r < R) acc[r][jj] += ps[r * THREADS + i] * vv;
        }
      }
    }
    __syncthreads();
  }

  // partial softmax of this split: (acc[dh], max, sum) per row
#pragma unroll
  for (int r = 0; r < R_MAX; ++r) {
    if (r < R) {
      float* pr = part + (((size_t)g * ns + j) * R + r) * (dh + 2);
#pragma unroll
      for (int jj = 0; jj < ND; ++jj) {
        const int d = tid + jj * THREADS;
        if (d < dh) pr[d] = acc[r][jj];
      }
      if (tid == 0) {
        pr[dh] = m_run[r];
        pr[dh + 1] = l_run[r];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int R, int dh,
    int ns) {
  const int g = blockIdx.x;
  for (int r = 0; r < R; ++r) {
    const size_t stride = (size_t)R * (dh + 2);    // between splits
    const float* p0 = part + ((size_t)g * ns * R + r) * (dh + 2);
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, p0[s * stride + dh]);
    float den = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float m = p0[s * stride + dh];
      if (m > -INFINITY) den += expf(m - mx) * p0[s * stride + dh + 1];
    }
    for (int d = threadIdx.x; d < dh; d += THREADS) {
      float num = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float m = p0[s * stride + dh];
        if (m > -INFINITY) num += expf(m - mx) * p0[s * stride + d];
      }
      out[((size_t)g * R + r) * dh + d] =
          from_f<T>(den > 0.f ? num / fmaxf(den, 1e-30f) : 0.f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int32_t* cq,
           const int8_t* ck, const uint8_t* vp, void* out, int32_t* tp,
           int32_t* hist_part, float* part, int G, int S, int R, int dh,
           int M, int hk, int l, int max_score, int sum_rows, float scale,
           int ns, int sp, cudaStream_t st) {
  dim3 grid(G, ns);
  hist_kernel<<<grid, THREADS, 0, st>>>(cq, ck, vp, hist_part, S, R, M, hk,
                                        max_score, sum_rows, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attend_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cq, ck, vp, hist_part, part, tp, S, R, dh, M,
      hk, l, max_score, sum_rows, scale, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<G, THREADS, 0, st>>>(part, static_cast<T*>(out), R, dh,
                                          ns);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  thr_out may be
// null; else (G, R_out, 2) int32 receives [t, need].  Scratch from the
// caller: hist_part (G, ns, R_out, max_score + 1) int32 and part (G, ns,
// R, dh + 2) float32, for ns splits of sp slots (sp a multiple of 128,
// (ns - 1) * sp < S <= ns * sp).  Returns the cudaError_t of the launches.
extern "C" int repro_fused_sparse_decode(
    int dtype, const void* q, const void* k, const void* v,
    const void* codes_q, const void* codes_k, const void* kv_valid, void* out,
    void* thr_out, void* hist_part, void* part, int G, int S, int R, int dh,
    int M, int hk, int l, int max_score, int sum_rows, float scale, int ns,
    int sp, void* stream) {
  const int r_out = sum_rows ? 1 : R;
  if (G < 1 || S < 1 || R < 1 || R > R_MAX || M < 1 || M > M_MAX ||
      dh < 8 || dh % 8 || dh > D_MAX || hk < 1 ||
      r_out * (max_score + 1) > HIST_MAX || ns < 1 || sp < THREADS ||
      sp % THREADS || (long long)(ns - 1) * sp >= S ||
      (long long)ns * sp < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cqp = static_cast<const int32_t*>(codes_q);
  const int8_t* ckp = static_cast<const int8_t*>(codes_k);
  const uint8_t* vp = static_cast<const uint8_t*>(kv_valid);
  int32_t* tp = static_cast<int32_t*>(thr_out);
  int32_t* hp = static_cast<int32_t*>(hist_part);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return launch<float>(q, k, v, cqp, ckp, vp, out, tp, hp, pp, G, S, R, dh,
                         M, hk, l, max_score, sum_rows, scale, ns, sp, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, cqp, ckp, vp, out, tp, hp, pp, G,
                                 S, R, dh, M, hk, l, max_score, sum_rows,
                                 scale, ns, sp, st);
  return (int)cudaErrorInvalidValue;
}
