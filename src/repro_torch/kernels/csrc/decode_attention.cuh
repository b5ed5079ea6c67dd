// Shared passes of the port's decode attention kernels (sm_90a):
// sparse_decode.cu (fused one-pass, kernels 6 and 7),
// sparse_decode_two_pass.cu (thresholds then attention, kernels 3 and 5)
// and dense_decode_paged.cu (kernel 8).
//
// Every pass walks the cache of one kv group g = b * Hk + h in splits of
// SP slots (a multiple of the 128-slot tile), one block per (g, split),
// and is templated on how slot s of group g is addressed:
//   Contig: k[g, s] in (G, S, .) caches;
//   Paged:  k_pool[pt[b, s / ps], h, s % ps] in (P, Hk, ps, .) pools,
//           through the (B, MP) page table (S = MP * ps view slots).
// The validity row is (B, S) in both, so one pass body serves both, and
// a paged run over the same split boundaries reads the same values in
// the same order as a contiguous run over the gathered view: codes,
// [t, need] and outputs are bit-identical.
//
// Passes:
//  hist_kernel   per-split score histograms (M+1 buckets per row for
//                "qhead", R*M+1 for "kvgroup") into hist_part;
//  thr_kernel    [t, need] per row from the summed histograms;
//  tie_kernel    per-split count of the ties at t (given [t, need]);
//  attend_kernel the split's online-softmax partial (acc, max, sum per
//                row), keys newest first in 128-slot tiles, one slot per
//                thread.  Selection modes: SEL_FUSED derives [t, need]
//                and the newer splits' ties from hist_part (one pass);
//                SEL_GIVEN reads [t, need] and tie_part (two-pass);
//                SEL_DENSE takes every valid slot (no codes).
//  combine_kernel merges the splits' partials; a row with nothing
//                selected outputs 0.
// Everything here is internal to the including source.
#pragma once
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

enum Sel { SEL_FUSED = 0, SEL_GIVEN = 1, SEL_DENSE = 2 };

struct Contig {
  int S;
  __device__ __forceinline__ size_t row(int g, int s) const {
    return (size_t)g * S + s;
  }
};

struct Paged {
  const int32_t* pt;                  // (B, MP), ids in [0, P)
  int mp, ps, hk;
  __device__ __forceinline__ size_t row(int g, int s) const {
    const int page = __ldg(pt + (size_t)(g / hk) * mp + s / ps);
    return ((size_t)page * hk + g % hk) * ps + s % ps;
  }
};

// The launchers' argument contract (returns false on a shape the passes
// do not take): ns splits of sp slots cover S exactly once.
inline bool decode_args_ok(int G, int S, int R, int dh, int M, int hk,
                           int hist_buckets, int ns, int sp) {
  return G >= 1 && S >= 1 && R >= 1 && R <= R_MAX && M >= 1 &&
         M <= M_MAX && dh >= 8 && dh % 8 == 0 && dh <= D_MAX && hk >= 1 &&
         hist_buckets <= HIST_MAX && ns >= 1 && sp >= THREADS &&
         sp % THREADS == 0 && (long long)(ns - 1) * sp < S &&
         (long long)ns * sp >= S;
}

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

// [t, need] of one row from its per-split histograms (hp: split 0,
// bucket 0 of the row; stride: between splits): t = the highest bucket
// where #(score >= t) reaches l (0 if none does), need = l - #(score > t)
// — topl_select.hist_reduce.
__device__ __forceinline__ void reduce_thr(const int32_t* hp, size_t stride,
                                           int ns, int max_score, int l,
                                           int& t, int& need) {
  int ge = 0, n_above = -1, h0 = 0;
  t = 0;
  for (int vb = max_score; vb >= 0; --vb) {
    int h = 0;
    for (int s = 0; s < ns; ++s) h += hp[s * stride + vb];
    if (ge + h >= l) { t = vb; n_above = ge; break; }
    ge += h;
    h0 = h;
  }
  if (n_above < 0) n_above = ge - h0;             // loop ended at vb = 0
  need = l - n_above;
}

template <typename Addr>
__global__ void __launch_bounds__(THREADS) hist_kernel(
    const int32_t* __restrict__ codes_q, const int8_t* __restrict__ codes_k,
    const uint8_t* __restrict__ kv_valid, Addr addr,
    int32_t* __restrict__ hist_part, int S, int R, int M, int hk,
    int max_score, int sum_rows, int SP) {
  __shared__ int cq[R_MAX * M_MAX];
  __shared__ int hist[HIST_MAX];
  const int g = blockIdx.x, j = blockIdx.y, ns = gridDim.y;
  const int r_out = sum_rows ? 1 : R;
  const int nb = max_score + 1;
  const int lo = j * SP, hi = min(S, lo + SP);
  const uint8_t* valid_row = kv_valid + (size_t)(g / hk) * S;
  load_codes_q(cq, codes_q, g, R, M);
  for (int i = threadIdx.x; i < r_out * nb; i += THREADS) hist[i] = 0;
  __syncthreads();
  for (int s = lo + threadIdx.x; s < hi; s += THREADS) {
    if (!valid_row[s]) continue;
    int sc[R_MAX];
    slot_scores(codes_k + addr.row(g, s) * M, cq, R, M, sum_rows, sc);
#pragma unroll
    for (int r = 0; r < R_MAX; ++r)
      if (r < r_out) atomicAdd(&hist[r * nb + sc[r]], 1);
  }
  __syncthreads();
  int32_t* out = hist_part + ((size_t)g * ns + j) * r_out * nb;
  for (int i = threadIdx.x; i < r_out * nb; i += THREADS) out[i] = hist[i];
}

// grid G, one thread per row: (G, R_out, 2) [t, need]
__global__ void thr_kernel(const int32_t* __restrict__ hist_part,
                           int32_t* __restrict__ thr, int r_out, int ns,
                           int max_score, int l) {
  const int g = blockIdx.x, r = threadIdx.x;
  if (r >= r_out) return;
  const int nb = max_score + 1;
  int t, need;
  reduce_thr(hist_part + (size_t)g * ns * r_out * nb + r * nb,
             (size_t)r_out * nb, ns, max_score, l, t, need);
  thr[((size_t)g * r_out + r) * 2] = t;
  thr[((size_t)g * r_out + r) * 2 + 1] = need;
}

// grid (G, ns): tie_part (G, ns, R_out) = #(valid slots of the split
// with score == t), the newer-tie counts the attention pass needs.
template <typename Addr>
__global__ void __launch_bounds__(THREADS) tie_kernel(
    const int32_t* __restrict__ codes_q, const int8_t* __restrict__ codes_k,
    const uint8_t* __restrict__ kv_valid, Addr addr,
    const int32_t* __restrict__ thr, int32_t* __restrict__ tie_part, int S,
    int R, int M, int hk, int sum_rows, int SP) {
  __shared__ int cq[R_MAX * M_MAX];
  __shared__ int ts[R_MAX];
  __shared__ int cnt[R_MAX];
  const int g = blockIdx.x, j = blockIdx.y, ns = gridDim.y;
  const int r_out = sum_rows ? 1 : R;
  const int lo = j * SP, hi = min(S, lo + SP);
  const uint8_t* valid_row = kv_valid + (size_t)(g / hk) * S;
  load_codes_q(cq, codes_q, g, R, M);
  if (threadIdx.x < r_out) {
    ts[threadIdx.x] = thr[((size_t)g * r_out + threadIdx.x) * 2];
    cnt[threadIdx.x] = 0;
  }
  __syncthreads();
  for (int s = lo + threadIdx.x; s < hi; s += THREADS) {
    if (!valid_row[s]) continue;
    int sc[R_MAX];
    slot_scores(codes_k + addr.row(g, s) * M, cq, R, M, sum_rows, sc);
#pragma unroll
    for (int r = 0; r < R_MAX; ++r)
      if (r < r_out && sc[r] == ts[r]) atomicAdd(&cnt[r], 1);
  }
  __syncthreads();
  if (threadIdx.x < r_out)
    tie_part[((size_t)g * ns + j) * r_out + threadIdx.x] = cnt[threadIdx.x];
}

// grid (G, ns).  sel: SEL_FUSED hist_part (G, ns, R_out, max_score + 1);
// SEL_GIVEN thresholds (G, R_out, 2), with ties = tie_part (G, ns,
// R_out); SEL_DENSE unused (codes too).  part (G, ns, R, dh + 2) gets
// (acc[dh], max, sum) per row; thr_out (SEL_FUSED, may be null) the
// [t, need] used.
template <typename T, typename Addr, int SEL>
__global__ void __launch_bounds__(THREADS) attend_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ codes_q,
    const int8_t* __restrict__ codes_k, const uint8_t* __restrict__ kv_valid,
    Addr addr, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ ties, float* __restrict__ part,
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
  const int lo = j * SP, hi = min(S, lo + SP);
  const uint8_t* valid_row = kv_valid + (size_t)(g / hk) * S;

  for (int i = tid; i < R * dh; i += THREADS) qs[i] = to_f(q[(size_t)g * R * dh + i]);
  if constexpr (SEL != SEL_DENSE) {
    load_codes_q(cq, codes_q, g, R, M);
    if (tid < r_out) {
      int t, need, newer = 0;                     // newer: ties in newer splits
      if constexpr (SEL == SEL_FUSED) {
        const int nb = max_score + 1;
        const int32_t* hp = sel + (size_t)g * ns * r_out * nb + tid * nb;
        const size_t stride = (size_t)r_out * nb;
        reduce_thr(hp, stride, ns, max_score, l, t, need);
        for (int s = j + 1; s < ns; ++s) newer += hp[s * stride + t];
        if (thr_out != nullptr && j == 0) {
          thr_out[((size_t)g * r_out + tid) * 2] = t;
          thr_out[((size_t)g * r_out + tid) * 2 + 1] = need;
        }
      } else {
        t = sel[((size_t)g * r_out + tid) * 2];
        need = sel[((size_t)g * r_out + tid) * 2 + 1];
        for (int s = j + 1; s < ns; ++s)
          newer += ties[((size_t)g * ns + s) * r_out + tid];
      }
      thr[3 * tid] = t;
      thr[3 * tid + 1] = need;
      thr[3 * tid + 2] = min(newer, need);
    }
  }
  __syncthreads();

  int taken[R_MAX];
  float m_run[R_MAX], l_run[R_MAX], acc[R_MAX][ND];
#pragma unroll
  for (int r = 0; r < R_MAX; ++r) {
    taken[r] = (SEL != SEL_DENSE && r < r_out) ? thr[3 * r + 2] : 0;
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int jj = 0; jj < ND; ++jj) acc[r][jj] = 0.f;
  }

  for (int tile_end = hi; tile_end > lo; tile_end -= THREADS) {
    const int slot = tile_end - 1 - tid;            // tid 0 = newest slot
    const bool live = slot >= lo && valid_row[slot];
    const size_t srow = live ? addr.row(g, slot) : 0;
    unsigned bits = 0;
    if constexpr (SEL == SEL_DENSE) {
      if (live) bits = (1u << R) - 1u;
    } else {
      int sc[R_MAX];
      if (live) slot_scores(codes_k + srow * M, cq, R, M, sum_rows, sc);
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
      const T* krow = k + srow * dh;
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
      const T* vrow = v + addr.row(g, tile_end - 1 - i) * dh;
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

// The attention pass, then the combine, on stream st.
template <typename T, typename Addr, int SEL>
int attend_and_combine(const void* q, const void* k, const void* v,
                       const int32_t* cq, const int8_t* ck,
                       const uint8_t* vp, Addr addr, const int32_t* sel,
                       const int32_t* ties, float* part, int32_t* thr_out,
                       void* out, int G, int S, int R, int dh, int M, int hk,
                       int l, int max_score, int sum_rows, float scale,
                       int ns, int sp, cudaStream_t st) {
  attend_kernel<T, Addr, SEL><<<dim3(G, ns), THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cq, ck, vp, addr, sel, ties, part, thr_out,
      S, R, dh, M, hk, l, max_score, sum_rows, scale, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<G, THREADS, 0, st>>>(part, static_cast<T*>(out), R, dh,
                                          ns);
  return (int)cudaGetLastError();
}

}  // namespace
