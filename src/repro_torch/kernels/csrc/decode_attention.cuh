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
//                "qhead", R*M+1 for "kvgroup") into hist_part; for
//                kernel 3 the last block of each kv group to finish also
//                reduces them to [t, need] per row (one launch), and
//                writes the summed histogram where asked (hist_sum: the
//                row's histogram over a sequence split across ranks);
//  tie_kernel    per-split count of the ties at t (given [t, need]);
//  attend_kernel the split's online-softmax partial (acc, max, sum per
//                row) over the keys it selects.  Selection modes:
//                SEL_FUSED derives [t, need] and the newer splits' ties
//                from hist_part (one pass); SEL_GIVEN reads [t, need] and
//                tie_part (two-pass); SEL_DENSE takes every valid slot
//                (no codes).
//  combine_kernel merges the splits' partials, one block per (kv group,
//                query row); a row with nothing selected outputs 0.
//
// What bounds the attention pass: memory.  It must read each selected
// key's K and V row once (256 bytes each in bf16 at dh = 128); its
// arithmetic is one dot product and one axpy per (selected key, row).
// The selected rows are scattered (sparse modes) or, under a page table,
// contiguous only within a page, so the pass has to keep many coalesced
// row copies in flight per SM.
//
// attend_kernel's design: selection is separated from data movement, and
// the arithmetic is spread so that no long chain of dependent steps runs
// per row.
//  1. Select.  The split is cut into windows of LIST_MAX slots, newest
//     first.  The loads of a window (validity, page-table entry, code
//     row of each of its 4 x 128 slots, one slot per thread and tile) are
//     sent together; then, tile by tile, warp ballots and a block scan
//     of the ties decide each slot's query-row bits (ties at t taken
//     newest first while the running count stays under need, carried
//     across tiles and windows), and the eligible slots are appended,
//     newest first, to a compact list in shared memory: the slot's K/V
//     row and its bits.
//  2. Move.  The list is streamed in chunks of CHUNK = 32 rows through a
//     shared-memory ring of 2-3 stages by cp.async: 16-byte copies, 16
//     consecutive lanes per 256-byte row, so a 128-thread instruction
//     moves 8 whole rows; the next chunks are in flight while one
//     computes, and one barrier a chunk hands the stages over.
//  3. Compute from shared memory, each warp on its own 8 rows of every
//     chunk with its own f32 online softmax (max, sum, acc): QK with 4
//     lanes per row (a quarter of dh each, two shuffles), the softmax over
//     the warp's 8 rows by shuffles, PV with each lane owning 4-column
//     quads of every query row and summing the warp's rows in list order.
//     The query rows are a template parameter RT (R padded to 1, 2, 4, 8
//     or 16 with zero rows), so these loops unroll without branches.  At
//     the end the 4 warps' states merge in warp order.
// Query rows: R <= 16 per kv group (MQA stacks such as RecurrentGemma's
// 16 heads on one kv head).  Each pass's shared arrays are sized from its
// row room (8 for R <= 8, else 16; attend_kernel's from RT): the R <= 8
// instances keep the arrays and code they had when 8 was the limit, and
// only the 16-row instances hold 16 x (M_MAX + 1) = 528 histogram
// buckets ("qhead" at M = 32; "kvgroup" needs 16 x 32 + 1).  At RT = 16 a
// row's query bits take 16 bits, so the list keeps them as uint16_t and
// a slot's flags (above, at, live) as 64 bits.
// The sum order depends on the list alone, so contiguous and paged runs
// over the same splits, and a run and the next, are bit-identical.
// Everything here is internal to the including source.
#pragma once
#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;          // threads a block; slots a tile
constexpr int WARPS = THREADS / 32;
constexpr int R_MAX = 16;             // query heads per kv head
constexpr int R_NARROW = 8;           // the row room of R <= 8 instances
constexpr int M_MAX = 32;             // PQ books
constexpr int HIST_NARROW = 264;      // their histogram buckets

// Row room and histogram buckets (>= R_out * (max_score + 1)) of an
// instance for RT query rows.
__host__ __device__ constexpr int row_room(int rt) {
  return rt <= R_NARROW ? R_NARROW : R_MAX;
}
__host__ __device__ constexpr int hist_room(int rt) {
  return rt <= R_NARROW ? HIST_NARROW : R_MAX * (M_MAX + 1);
}
constexpr int D_MAX = 256;            // head dim
constexpr int LIST_MAX = 512;         // slots a selection window
constexpr int WIN_TILES = LIST_MAX / THREADS;
constexpr int CHUNK = 32;             // list rows a ring stage
constexpr int ROWS_W = CHUNK / WARPS; // rows of a chunk each warp computes
constexpr int LPR = 32 / ROWS_W;      // lanes per row in QK
constexpr int SEG_MAX = D_MAX / 8 / LPR;   // 8-wide segments a lane, at most
constexpr int NQ = D_MAX / 4 / 32;    // 4-column quads a lane owns in PV
constexpr int RING_MAX = 131072;      // ring bytes, at most

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
         hist_buckets <= hist_room(R) && ns >= 1 && sp >= THREADS &&
         sp % THREADS == 0 && (long long)(ns - 1) * sp < S &&
         (long long)ns * sp >= S;
}

// The ring's contract: 2 or 3 stages of CHUNK K and V rows of dh elements
// of elem bytes (kernels.decode_stages picks the count).
inline bool ring_ok(int stages, int dh, int elem) {
  return (stages == 2 || stages == 3) &&
         (long long)stages * CHUNK * 2 * dh * elem <= RING_MAX;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight consecutive elements of a shared-memory row as floats (16-byte
// aligned).
__device__ __forceinline__ void lds8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Four consecutive elements of a shared-memory row as floats (8-byte
// aligned for bf16, 16-byte for float).
__device__ __forceinline__ void lds4(const float* p, float out[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// Match counts of one cached slot against the R query code rows; summed
// into sc[0] for the GQA-shared ("kvgroup") selection.
template <int N>
__device__ __forceinline__ void slot_scores(const int8_t* row, const int* cq,
                                            int R, int M, int sum_rows,
                                            int (&sc)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) sc[r] = 0;
  for (int m = 0; m < M; ++m) {
    const int cm = row[m];
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r < R) sc[r] += (cq[r * M + m] == cm);
  }
  if (sum_rows) {
    int t = 0;
#pragma unroll
    for (int r = 0; r < N; ++r) t += sc[r];
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

// Cached code rows as bytes, four books a word.
constexpr int CW_MAX = M_MAX / 4;

// The launchers' code-row load width: 2 = 16-byte loads (M % 16 == 0),
// 1 = 4-byte loads (M % 4 == 0), 0 = bytes; every row must start aligned.
inline int code_vec(const void* codes, int M) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(codes);
  return M % 16 == 0 && a % 16 == 0 ? 2 : M % 4 == 0 && a % 4 == 0 ? 1 : 0;
}

// The M int8 codes of one cached row as CW_MAX words (words past M hold
// 0), loaded vec-wide.
__device__ __forceinline__ void load_code_words(const int8_t* row, int M,
                                                int vec,
                                                uint32_t (&w)[CW_MAX]) {
#pragma unroll
  for (int i = 0; i < CW_MAX; ++i) w[i] = 0;
  if (vec == 2) {
#pragma unroll
    for (int c = 0; c < CW_MAX / 4; ++c)
      if (16 * c < M) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + c);
        w[4 * c] = x.x; w[4 * c + 1] = x.y; w[4 * c + 2] = x.z; w[4 * c + 3] = x.w;
      }
  } else if (vec == 1) {
#pragma unroll
    for (int c = 0; c < CW_MAX; ++c)
      if (4 * c < M) w[c] = __ldg(reinterpret_cast<const uint32_t*>(row) + c);
  } else {
#pragma unroll
    for (int m = 0; m < M_MAX; ++m)
      if (m < M) w[m / 4] |= (uint32_t)(uint8_t)row[m] << (8 * (m % 4));
  }
}

// Books in which a query word a and a cached word b differ: bytes that
// differ, plus those marked in never (0x80 in books past M and in query
// codes outside int8's range, which no cached int8 code equals).
__device__ __forceinline__ int book_misses(uint32_t a, uint32_t b,
                                           uint32_t never) {
  const uint32_t x = a ^ b;
  return __popc(((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) | never) &
                0x80808080u);
}

// [t, need] of one row from its histogram h (nb buckets, in shared
// memory) by one warp, the same numbers as reduce_thr: chunks of 32
// buckets from the top, lane i on bucket top - 1 - i, a shuffle scan for
// #(score >= bucket), a ballot for the highest bucket where it reaches l.
__device__ __forceinline__ void warp_reduce_thr(const int* h, int nb, int l,
                                                int lane, int& t,
                                                int& need) {
  int carry = 0, ge1 = 0;                 // #(score >= chunk top), >= 1
  for (int top = nb; top > 0; top -= 32) {
    const int b = top - 1 - lane;
    int ge = b >= 0 ? h[b] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, ge, o);
      if (lane >= o) ge += y;
    }
    ge += carry;                          // #(score >= b)
    if (top >= 2 && top - 32 <= 1)       // bucket 1 is in this chunk
      ge1 = __shfl_sync(FULL_MASK, ge, top - 2);
    const unsigned meets = __ballot_sync(FULL_MASK, b >= 0 && ge >= l);
    if (meets) {                          // lowest lane: highest bucket
      const int jl = __ffs(meets) - 1;
      const int newer = __shfl_sync(FULL_MASK, ge, jl > 0 ? jl - 1 : 0);
      t = top - 1 - jl;
      need = l - (jl > 0 ? newer : carry);
      return;
    }
    carry = __shfl_sync(FULL_MASK, ge, 31);
  }
  t = 0;                                  // no bucket reaches l
  need = l - ge1;
}

// grid (G, ns), RM = row_room(R): per-split score histograms (M+1 buckets
// per row for "qhead", R*M+1 for "kvgroup") into hist_part (G, ns, R_out,
// nb).  Each thread scores two slots a round: their validity, then the
// 16-byte code rows of the valid ones, are loaded first, each of the R
// query rows is compared four books a word, and each score is one shared
// atomic (tried and slower on this card:
// one atomic per distinct score of a warp by __match_any_sync or by ballots,
// 512-thread blocks, and a thread-block cluster reduction in place of the
// last block).  Kernels 6 and 7 launch it with thr = null: their attention
// pass reduces the histograms.  For kernel 3 the last block of each kv group
// to finish also reduces them to thr (G, R_out, 2) [t, need]: after a
// barrier, one thread counts the block in arrive[g] with an acquire-release
// atomic, so the block's histogram is visible before its arrival is; the
// block that counts ns sums the ns histograms into shared memory, reduces
// each row with one warp (warp_reduce_thr) and sets arrive[g] back to
// zero.  arrive (G,) int32 is zero before the launch and after it, so
// launches in stream order (and a captured graph's replays) reuse it.
// hist_sum (G, R_out, max_score + 1), when not null, gets the summed
// histogram the last block reduced.
template <typename Addr, int RM>
__global__ void __launch_bounds__(THREADS) hist_kernel(
    const int32_t* __restrict__ codes_q, const int8_t* __restrict__ codes_k,
    const uint8_t* __restrict__ kv_valid, Addr addr,
    int32_t* __restrict__ hist_part, int32_t* __restrict__ thr,
    int32_t* __restrict__ hist_sum, int32_t* __restrict__ arrive, int S,
    int R, int M, int hk, int max_score, int sum_rows, int l, int SP,
    int vec) {
  __shared__ uint32_t qw[RM][CW_MAX];         // query codes as bytes
  __shared__ uint32_t qn[RM][CW_MAX];         // books they never match
  __shared__ int hist[hist_room(RM)];
  __shared__ int last;
  const int g = blockIdx.x, j = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_out = sum_rows ? 1 : R;
  const int nb = max_score + 1;
  const int cw = (M + 3) / 4;
  const int lo = j * SP, hi = min(S, lo + SP);
  const uint8_t* valid_row = kv_valid + (size_t)(g / hk) * S;
  // a round's slots: their rows (a page-table read for Paged) and
  // validity bytes are loaded together, then the code rows of valid slots
  uint32_t kw[2][CW_MAX];
  bool live[2];
  auto load_round = [&](int base) {
    size_t row[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = base + u * THREADS + tid;
      row[u] = addr.row(g, s < hi ? s : lo);
      live[u] = s < hi;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      live[u] = live[u] && valid_row[base + u * THREADS + tid];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (live[u]) {
        load_code_words(codes_k + row[u] * M, M, vec, kw[u]);
      } else {
#pragma unroll
        for (int w = 0; w < CW_MAX; ++w) kw[u][w] = 0;
      }
    }
  };
  int cq4[4];                   // query codes: loads sent before any wait
  const int qr = tid / CW_MAX, qwi = tid % CW_MAX;
  if (tid < R * CW_MAX)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      cq4[b] = 4 * qwi + b < M ? codes_q[((size_t)g * R + qr) * M + 4 * qwi + b]
                               : 0;
  load_round(lo);
  if (tid < R * CW_MAX) {
    uint32_t word = 0, never = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = cq4[b];
      word |= (uint32_t)(c & 0xff) << (8 * b);
      if (4 * qwi + b >= M || c < -128 || c > 127) never |= 0x80u << (8 * b);
    }
    qw[qr][qwi] = word;
    qn[qr][qwi] = never;
  }
  for (int i = tid; i < r_out * nb; i += THREADS) hist[i] = 0;
  __syncthreads();
  for (int base = lo;;) {                                    // uniform trips
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      int sc[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        int miss = 0;
        if (r < R)
#pragma unroll
          for (int w = 0; w < CW_MAX; ++w)
            if (w < cw) miss += book_misses(qw[r][w], kw[u][w], qn[r][w]);
        sc[r] = 4 * cw - miss;
      }
      if (sum_rows) {
        int t = 0;
#pragma unroll
        for (int r = 0; r < RM; ++r) t += r < R ? sc[r] : 0;
        sc[0] = t;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
        if (r < r_out && live[u]) atomicAdd(&hist[r * nb + sc[r]], 1);
    }
    base += 2 * THREADS;
    if (base >= hi) break;
    load_round(base);
  }
  __syncthreads();
  int32_t* out = hist_part + ((size_t)g * ns + j) * r_out * nb;
  for (int i = tid; i < r_out * nb; i += THREADS) out[i] = hist[i];
  if (thr == nullptr) return;                               // uniform
  __syncthreads();
  if (tid == 0) {   // arrival, ordered after the block's writes (release)
    int before;       // and before the last block's reads (acquire)
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(arrive + g)
                 : "memory");
    last = before == ns - 1;
  }
  __syncthreads();
  if (!last) return;
  // sum the group's ns histograms: SUM_LOADS loads a thread in flight at
  // once, so the common case (ns * R_out * nb <= 1024) is one round trip
  constexpr int SUM_LOADS = 8;
  const int rn = r_out * nb, total = ns * rn;
  const int32_t* hg = hist_part + (size_t)g * total;
  for (int i = tid; i < rn; i += THREADS) hist[i] = 0;
  __syncthreads();
  for (int base = tid; base < total; base += THREADS * SUM_LOADS) {
    int h[SUM_LOADS];
#pragma unroll
    for (int k = 0; k < SUM_LOADS; ++k) {
      const int i = base + k * THREADS;
      h[k] = i < total ? __ldcg(hg + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < SUM_LOADS; ++k)
      if (h[k]) atomicAdd(&hist[(base + k * THREADS) % rn], h[k]);
  }
  __syncthreads();
  if (hist_sum != nullptr)                                  // uniform
    for (int i = tid; i < rn; i += THREADS)
      hist_sum[(size_t)g * rn + i] = hist[i];
  for (int r = warp; r < r_out; r += WARPS) {
    int t, need;
    warp_reduce_thr(hist + r * nb, nb, l, lane, t, need);
    if (lane == 0) {
      thr[((size_t)g * r_out + r) * 2] = t;
      thr[((size_t)g * r_out + r) * 2 + 1] = need;
    }
  }
  if (tid == 0) arrive[g] = 0;
}

// hist_kernel at the row room of R on stream st.
template <typename Addr>
cudaError_t launch_hist(const int32_t* cq, const int8_t* ck,
                        const uint8_t* vp, Addr addr, int32_t* hist_part,
                        int32_t* thr, int32_t* hist_sum, int32_t* arrive,
                        int G, int S, int R, int M, int hk, int max_score,
                        int sum_rows, int l, int ns, int sp,
                        cudaStream_t st) {
  const int vec = code_vec(ck, M);
  if (R <= R_NARROW)
    hist_kernel<Addr, R_NARROW><<<dim3(G, ns), THREADS, 0, st>>>(
        cq, ck, vp, addr, hist_part, thr, hist_sum, arrive, S, R, M, hk,
        max_score, sum_rows, l, sp, vec);
  else
    hist_kernel<Addr, R_MAX><<<dim3(G, ns), THREADS, 0, st>>>(
        cq, ck, vp, addr, hist_part, thr, hist_sum, arrive, S, R, M, hk,
        max_score, sum_rows, l, sp, vec);
  return cudaGetLastError();
}

// grid (G, ns): tie_part (G, ns, R_out) = #(valid slots of the split
// with score == t), the newer-tie counts the attention pass needs.
template <typename Addr, int RM>
__global__ void __launch_bounds__(THREADS) tie_kernel(
    const int32_t* __restrict__ codes_q, const int8_t* __restrict__ codes_k,
    const uint8_t* __restrict__ kv_valid, Addr addr,
    const int32_t* __restrict__ thr, int32_t* __restrict__ tie_part, int S,
    int R, int M, int hk, int sum_rows, int SP) {
  __shared__ int cq[RM * M_MAX];
  __shared__ int ts[RM];
  __shared__ int cnt[RM];
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
    int sc[RM];
    slot_scores(codes_k + addr.row(g, s) * M, cq, R, M, sum_rows, sc);
#pragma unroll
    for (int r = 0; r < RM; ++r)
      if (r < r_out && sc[r] == ts[r]) atomicAdd(&cnt[r], 1);
  }
  __syncthreads();
  if (threadIdx.x < r_out)
    tie_part[((size_t)g * ns + j) * r_out + threadIdx.x] = cnt[threadIdx.x];
}

// tie_kernel at the row room of R on stream st.
template <typename Addr>
cudaError_t launch_ties(const int32_t* cq, const int8_t* ck,
                        const uint8_t* vp, Addr addr, const int32_t* thr,
                        int32_t* ties, int G, int S, int R, int M, int hk,
                        int sum_rows, int ns, int sp, cudaStream_t st) {
  if (R <= R_NARROW)
    tie_kernel<Addr, R_NARROW><<<dim3(G, ns), THREADS, 0, st>>>(
        cq, ck, vp, addr, thr, ties, S, R, M, hk, sum_rows, sp);
  else
    tie_kernel<Addr, R_MAX><<<dim3(G, ns), THREADS, 0, st>>>(
        cq, ck, vp, addr, thr, ties, S, R, M, hk, sum_rows, sp);
  return cudaGetLastError();
}

// grid (G, ns), THREADS threads, attend_smem_bytes<T, RT>(stages, dh) of
// dynamic shared memory; R <= RT query rows per kv group (the rows past R
// are zero padding).  sel: SEL_FUSED hist_part (G, ns, R_out,
// max_score + 1); SEL_GIVEN thresholds (G, R_out, 2), with ties =
// tie_part (G, ns, R_out); SEL_DENSE unused (codes too).  part (G, ns, R,
// dh + 2) gets (acc[dh], max, sum) per row; thr_out (SEL_FUSED, may be
// null) the [t, need] used.
template <typename T, int RT>
inline size_t attend_smem_bytes(int stages, int dh) {
  return (size_t)stages * CHUNK * 2 * dh * sizeof(T) +
         (size_t)RT * dh * sizeof(float);
}

template <typename T, typename Addr, int SEL, int RT>
__global__ void __launch_bounds__(THREADS, RT <= 4 ? 4 : 2) attend_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ codes_q,
    const int8_t* __restrict__ codes_k, const uint8_t* __restrict__ kv_valid,
    Addr addr, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ ties, float* __restrict__ part,
    int32_t* __restrict__ thr_out, int S, int R, int dh, int M, int hk,
    int l, int max_score, int sum_rows, float scale, int SP, int stages) {
  // a slot's flags: LIVE | above bits | at bits << AT; a list row's bits
  using Flags = typename std::conditional<(RT > R_NARROW),
                                          unsigned long long, unsigned>::type;
  using Bits = typename std::conditional<(RT > R_NARROW), uint16_t,
                                         uint8_t>::type;
  constexpr int AT = RT > R_NARROW ? 16 : 8;
  constexpr Flags LIVE = Flags(1) << (2 * AT);
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ int cq[row_room(RT) * M_MAX];
  __shared__ int hsum[hist_room(RT)];             // SEL_FUSED: all splits
  __shared__ int thr[RT * 3];                     // t, need, ties taken
  // K/V row of each list entry: 32 bits hold it, since 2^32 rows of K and
  // V at >= 16 bytes each would not fit a card
  __shared__ uint32_t list_row[LIST_MAX];
  __shared__ Bits list_bits[LIST_MAX];            // its query-row bits
  __shared__ int tie_cnt[2][RT * WARPS];          // by tile parity
  __shared__ int elig_cnt[2][WARPS];
  __shared__ float warp_ml[WARPS][2][RT];         // each warp's max, sum

  const int g = blockIdx.x, j = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lane_lt = (1u << lane) - 1u;
  const int r_out = sum_rows ? 1 : R;
  const int lo = j * SP, hi = min(S, lo + SP);
  const uint8_t* valid_row = kv_valid + (size_t)(g / hk) * S;
  const int row_bytes = dh * (int)sizeof(T);
  const int stage_bytes = CHUNK * 2 * row_bytes;  // K rows, then V rows
  float* qs = reinterpret_cast<float*>(ring + stages * stage_bytes);

  for (int i = tid; i < RT * dh; i += THREADS)
    qs[i] = i < R * dh ? to_f(q[(size_t)g * R * dh + i]) : 0.f;
  if constexpr (SEL != SEL_DENSE) {
    load_codes_q(cq, codes_q, g, R, M);
    const int nb = max_score + 1;
    if constexpr (SEL == SEL_FUSED) {             // sum the splits at once
      const size_t stride = (size_t)r_out * nb;
      const int32_t* hp = sel + (size_t)g * ns * stride;
      for (int i = tid; i < r_out * nb; i += THREADS) {
        int h = 0;
        for (int s = 0; s < ns; ++s) h += hp[s * stride + i];
        hsum[i] = h;
      }
      __syncthreads();
    }
    if (tid < r_out) {
      int t, need, newer = 0;                     // newer: ties in newer splits
      if constexpr (SEL == SEL_FUSED) {
        const size_t stride = (size_t)r_out * nb;
        const int32_t* hp = sel + (size_t)g * ns * stride + tid * nb;
        reduce_thr(hsum + tid * nb, 0, 1, max_score, l, t, need);
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

  int taken[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
    taken[r] = (SEL != SEL_DENSE && r < r_out) ? thr[3 * r + 2] : 0;

  // this warp's online softmax over its rows: lanes hold equal m, l
  float m_run[RT], l_run[RT], acc[RT][NQ][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;
  }
  const int quarter = lane % LPR;
  const int my_row = warp * ROWS_W + lane / LPR;  // QK: this lane's row
  // copies: thread tid starts at row ci0, 16-byte piece cp0 of a chunk
  // and steps THREADS pieces at a time
  const int pieces = row_bytes / 16;
  const int ci0 = tid / pieces, cp0 = tid - ci0 * pieces;
  const int cdi = THREADS / pieces, cdp = THREADS - cdi * pieces;

  int parity = 0;
  for (int w_end = hi; w_end > lo; w_end -= LIST_MAX) {
    // 1. the window's eligible slots, newest first, into the list
    const int w_lo = max(lo, w_end - LIST_MAX);
    const int n_tiles = (w_end - w_lo + THREADS - 1) / THREADS;
    uint32_t rows[WIN_TILES];
    Flags flags[WIN_TILES];
#pragma unroll
    for (int tl = 0; tl < WIN_TILES; ++tl) {
      const int slot = w_end - 1 - tl * THREADS - tid;   // tid 0 = newest
      rows[tl] = 0;
      flags[tl] = 0;
      if (slot >= w_lo) {
        rows[tl] = (uint32_t)addr.row(g, slot);
        if (valid_row[slot]) flags[tl] = LIVE;
      }
    }
    if constexpr (SEL != SEL_DENSE) {
#pragma unroll
      for (int tl = 0; tl < WIN_TILES; ++tl) {
        if (flags[tl]) {
          int sc[RT];
          slot_scores(codes_k + (size_t)rows[tl] * M, cq, R, M, sum_rows, sc);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            if (r < r_out) {
              const int t = thr[3 * r];
              flags[tl] |= (Flags)(sc[r] > t) << r;
              flags[tl] |= (Flags)(sc[r] == t) << (AT + r);
            }
          }
        }
      }
    }
    int n = 0;
#pragma unroll
    for (int tl = 0; tl < WIN_TILES; ++tl) {
      if (tl >= n_tiles) break;                     // uniform
      unsigned bits = 0;
      if constexpr (SEL == SEL_DENSE) {
        if (flags[tl]) bits = (1u << R) - 1u;
      } else {
        int pre[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          pre[r] = 0;
          if (r < r_out) {
            const unsigned mask =
                __ballot_sync(FULL_MASK, (int)((flags[tl] >> (AT + r)) & 1u));
            pre[r] = __popc(mask & lane_lt);
            if (lane == 0) tie_cnt[parity][r * WARPS + warp] = __popc(mask);
          }
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < r_out) {
            int before = 0, total = 0;
            for (int w = 0; w < WARPS; ++w) {
              const int c = tie_cnt[parity][r * WARPS + w];
              total += c;
              if (w < warp) before += c;
            }
            const int need = thr[3 * r + 1];
            const bool above = (flags[tl] >> r) & 1u;
            const bool at = (flags[tl] >> (AT + r)) & 1u;
            if (above || (at && taken[r] + before + pre[r] < need))
              bits |= 1u << r;
            taken[r] += min(total, max(need - taken[r], 0));
          }
        }
      }
      const unsigned em = __ballot_sync(FULL_MASK, bits != 0);
      if (lane == 0) elig_cnt[parity][warp] = __popc(em);
      __syncthreads();
      int base = 0, tile_n = 0;
      for (int w = 0; w < WARPS; ++w) {
        const int c = elig_cnt[parity][w];
        if (w < warp) base += c;
        tile_n += c;
      }
      if (bits) {
        const int e = n + base + __popc(em & lane_lt);
        list_row[e] = rows[tl];
        list_bits[e] = (Bits)bits;
      }
      n += tile_n;
      parity ^= 1;
    }
    __syncthreads();                                // the list is written
    if (n == 0) continue;                           // uniform: no K/V reads

    // 2. stream the list's K/V rows through the ring
    const int nch = (n + CHUNK - 1) / CHUNK;
    auto fetch = [&](int c) {
      const int c0 = c * CHUNK, cn = min(CHUNK, n - c0);
      unsigned char* st = ring + (c % stages) * stage_bytes;
      for (int i = ci0, pc = cp0; i < cn;) {
        const size_t off = (size_t)list_row[c0 + i] * row_bytes + pc * 16;
        cp16(smem_u32(st + i * row_bytes + pc * 16),
             reinterpret_cast<const unsigned char*>(k) + off);
        cp16(smem_u32(st + (CHUNK + i) * row_bytes + pc * 16),
             reinterpret_cast<const unsigned char*>(v) + off);
        i += cdi;
        pc += cdp;
        if (pc >= pieces) {
          pc -= pieces;
          ++i;
        }
      }
    };
    for (int c = 0; c < stages - 1; ++c) {
      if (c < nch) fetch(c);
      cp_commit();
    }
    for (int c = 0; c < nch; ++c) {
      if (stages == 3) cp_wait<1>(); else cp_wait<0>();
      __syncthreads();          // chunk c landed; chunk c - 1 is consumed
      if (c + stages - 1 < nch) fetch(c + stages - 1);
      cp_commit();
      const int c0 = c * CHUNK, cn = min(CHUNK, n - c0);
      const T* ks =
          reinterpret_cast<const T*>(ring + (c % stages) * stage_bytes);
      const T* vs = ks + CHUNK * dh;

      // 3. QK: 4 lanes per row, each on every 4th 8-wide segment
      float dot[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) dot[r] = 0.f;
      if (my_row < cn) {
#pragma unroll
        for (int sg = 0; sg < SEG_MAX; ++sg) {
          const int s8 = (quarter + sg * LPR) * 8;
          if (s8 < dh) {
            float kf[8];
            lds8(ks + my_row * dh + s8, kf);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              float qf[8];
              lds8(qs + r * dh + s8, qf);
#pragma unroll
              for (int e = 0; e < 8; ++e) dot[r] += kf[e] * qf[e];
            }
          }
        }
      }
      const unsigned bits = my_row < cn ? list_bits[c0 + my_row] : 0u;
      float p[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          dot[r] += __shfl_xor_sync(FULL_MASK, dot[r], o);
        const bool e = sum_rows ? (bits & 1u) : ((bits >> r) & 1u);
        const float lg = e ? dot[r] * scale : -INFINITY;
        // online softmax over the warp's ROWS_W rows
        float mx = lg;
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
        const float m_new = fmaxf(m_run[r], mx);
        const bool finite = m_new > -INFINITY;
        const float m_safe = finite ? m_new : 0.f;
        const float alpha = finite ? expf(m_run[r] - m_safe) : 1.f;
        p[r] = lg == -INFINITY ? 0.f : expf(lg - m_safe);
        float sum = p[r];
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          sum += __shfl_xor_sync(FULL_MASK, sum, o);
        m_run[r] = m_new;
        l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
        for (int c4 = 0; c4 < NQ; ++c4)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) acc[r][c4][e4] *= alpha;
      }
      // PV: the warp's rows in list order
#pragma unroll
      for (int ii = 0; ii < ROWS_W; ++ii) {
        const int i = warp * ROWS_W + ii;
        if (i >= cn) break;                         // uniform in the warp
        float pr[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          pr[r] = __shfl_sync(FULL_MASK, p[r], ii * LPR);
#pragma unroll
        for (int c4 = 0; c4 < NQ; ++c4) {
          const int col = (lane + 32 * c4) * 4;
          if (col < dh) {
            float vf[4];
            lds4(vs + i * dh + col, vf);
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
              for (int e4 = 0; e4 < 4; ++e4) acc[r][c4][e4] += pr[r] * vf[e4];
          }
        }
      }
    }
    cp_wait<0>();                                   // only empty groups left
  }

  // merge the warps' states in warp order: the split's partial softmax,
  // (acc[dh], max, sum) per row
  __syncthreads();                                  // the ring is free
  float* wacc = reinterpret_cast<float*>(ring);     // (WARPS, RT, dh)
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c4 = 0; c4 < NQ; ++c4) {
      const int col = (lane + 32 * c4) * 4;
      if (col < dh)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4)
          wacc[(warp * RT + r) * dh + col + e4] = acc[r][c4][e4];
    }
    if (lane == 0) {
      warp_ml[warp][0][r] = m_run[r];
      warp_ml[warp][1][r] = l_run[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < R * (dh + 2); i += THREADS) {
    const int r = i / (dh + 2), d = i - r * (dh + 2);
    float mx = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, warp_ml[w][0][r]);
    float val = 0.f;
    if (d == dh) {
      val = mx;
    } else {
      for (int w = 0; w < WARPS; ++w) {
        const float mw = warp_ml[w][0][r];
        if (mw > -INFINITY)
          val += expf(mw - mx) *
                 (d < dh ? wacc[(w * RT + r) * dh + d] : warp_ml[w][1][r]);
      }
    }
    part[(((size_t)g * ns + j) * R + r) * (dh + 2) + d] = val;
  }
}

// grid (G, R): one block per (kv group, query row).  lse (G, R) f32, when
// not null, gets the row's log-sum-exp of its selected logits (-inf for a
// row with nothing selected): what a sequence split across ranks combines
// its parts by.
template <typename T>
__global__ void __launch_bounds__(THREADS) combine_kernel(
    const float* __restrict__ part, T* __restrict__ out,
    float* __restrict__ lse, int R, int dh, int ns) {
  const int g = blockIdx.x, r = blockIdx.y;
  const size_t stride = (size_t)R * (dh + 2);      // between splits
  const float* p0 = part + ((size_t)g * ns * R + r) * (dh + 2);
  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, p0[s * stride + dh]);
  float den = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float m = p0[s * stride + dh];
    if (m > -INFINITY) den += expf(m - mx) * p0[s * stride + dh + 1];
  }
  if (lse != nullptr && threadIdx.x == 0)
    lse[(size_t)g * R + r] = den > 0.f ? mx + logf(den) : -INFINITY;
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

template <typename T, typename Addr, int SEL, int RT>
cudaError_t launch_attend(const void* q, const void* k, const void* v,
                          const int32_t* cq, const int8_t* ck,
                          const uint8_t* vp, Addr addr, const int32_t* sel,
                          const int32_t* ties, float* part, int32_t* thr_out,
                          int G, int S, int R, int dh, int M, int hk, int l,
                          int max_score, int sum_rows, float scale, int ns,
                          int sp, int stages, cudaStream_t st) {
  const size_t smem = attend_smem_bytes<T, RT>(stages, dh);
  auto kern = attend_kernel<T, Addr, SEL, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)                         // room for 4 blocks an SM
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<dim3(G, ns), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cq, ck, vp, addr, sel, ties, part, thr_out,
      S, R, dh, M, hk, l, max_score, sum_rows, scale, sp, stages);
  return cudaGetLastError();
}

// The attention pass (R padded to RT = 1, 2, 4, 8 or 16 query rows), then
// the combine, on stream st.
template <typename T, typename Addr, int SEL>
int attend_and_combine(const void* q, const void* k, const void* v,
                       const int32_t* cq, const int8_t* ck,
                       const uint8_t* vp, Addr addr, const int32_t* sel,
                       const int32_t* ties, float* part, int32_t* thr_out,
                       void* out, int G, int S, int R, int dh, int M, int hk,
                       int l, int max_score, int sum_rows, float scale,
                       int ns, int sp, int stages, cudaStream_t st,
                       float* lse = nullptr) {
  if (!ring_ok(stages, dh, (int)sizeof(T))) return (int)cudaErrorInvalidValue;
#define REPRO_ATTEND(RT)                                                   \
  launch_attend<T, Addr, SEL, RT>(q, k, v, cq, ck, vp, addr, sel, ties,    \
                                  part, thr_out, G, S, R, dh, M, hk, l,    \
                                  max_score, sum_rows, scale, ns, sp,      \
                                  stages, st)
  cudaError_t err = R <= 1   ? REPRO_ATTEND(1)
                    : R <= 2 ? REPRO_ATTEND(2)
                    : R <= 4 ? REPRO_ATTEND(4)
                    : R <= 8 ? REPRO_ATTEND(8)
                             : REPRO_ATTEND(16);
#undef REPRO_ATTEND
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<dim3(G, R), THREADS, 0, st>>>(
      part, static_cast<T*>(out), lse, R, dh, ns);
  return (int)cudaGetLastError();
}

}  // namespace
