// Thresholded sparse MHA for train/prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparse_attention_kernel
// (src/repro/kernels/sparse_attention/sparse_attention.py:115, its
// pl.pallas_call at :142).
//
// Computes, for every query row i of query group g (kv group
// b * Hk + h / R under GQA), attention over the keys its top-L selection
// keeps, given [t, need] from the threshold kernel: a key admitted by the
// causal / window mask is kept when its PQ match score s > t, or when
// s == t and fewer than `need` keys with s == t sit at newer (higher)
// positions.  Softmax over the kept keys in f32; a row that keeps nothing
// outputs 0; the output has q's dtype.  Any head dim, any number of PQ
// books and any int32 codes, as the JAX kernel takes them: three bodies,
// chosen at the launcher by what fits (never as a fallback), below.
//
// What bounds it: per (64-query, 64-key) tile that the mask admits, the M
// code compares of each of its pairs and, when any pair of the tile is
// kept, the QK and PV products over dh.  With top-1/8 selection nearly
// every admitted tile keeps some key, so the causal half of the (nq, nk)
// plane is the work: at the training shape ~17 GFLOP of bf16 products
// and ~0.5 G code compares.
//
// Design, bf16 (the main path) — the JAX kernel's dense-tile form on the
// tensor cores (FlashAttention-2's fragment layout):
//  * one block per (query group, 64 query rows), 4 warps of 16 rows; the
//    blocks with the longest causal rows start first;
//  * the block walks key tiles of 64 newest first, from the newest key its
//    last row admits down to the oldest its first row's window admits
//    (tiles outside are never loaded);
//  * K, V and the tile's int32 code rows are staged by cp.async into a
//    2-stage shared-memory ring (the next tile is in flight while one
//    computes); Q is staged once; rows past nq / nk arrive as zeros, and
//    the columns that pad dh to the mma depth of 16 are zero;
//  * each warp packs the tile's key codes four books to a word and scores
//    its 16 x 64 pairs in the mma accumulator layout (a row's 64 columns
//    spread over a quad of lanes).  The compare takes one of three forms,
//    chosen per tile and uniform in the warp (every warp packs the same
//    tile; the query side is its own rows'), from the OR of the codes it
//    compares, as kernel 2 chooses per tile: codes in [0, 128) (E <= 128,
//    the main path): a byte of q ^ k is nonzero iff adding 0x7f carries
//    into its top bit, so four words cost one popcount; codes in
//    [0, 256) (E = 256): the same with the top bit ORed in; any other
//    int32 codes, or more than 32 books: one int32 compare a book, the
//    key codes from the staged tile, the query codes through L1.  Where
//    the caller vouches that the codes lie in [0, 128) (the train path:
//    they come from a codebook of at most 128 words) an instance without
//    the per-tile test runs the first form alone.  The
//    mask (-1 outside it) is applied per pair only in the
//    tiles that cross a row's causal / window edge or nq / nk.  Ties at t
//    are taken newest first: the quad ORs its 64-bit tie masks, a tie's
//    rank is the popcount of the tie bits at higher columns plus the
//    row's count from newer tiles;
//  * a warp whose rows keep nothing in the tile skips both products (the
//    JAX kernel's pl.when(any(eligible)) per 16 rows); otherwise S = QK^T
//    by mma.sync m16n8k16 (bf16 in, f32 accumulators; ldmatrix from
//    conflict-free padded rows), logits of unkept pairs -inf, an f32
//    online softmax per row in base 2, P rounded to bf16 (the row sum l
//    adds the rounded values, so the output stays a convex combination of
//    V rows; O is rescaled only when a row's max moved) and O += P V by
//    mma.sync with V through ldmatrix.trans;
//  * O / l in f32 at the end, 0 for a row with l = 0.
// Every sum runs in a fixed order: two launches give identical bits.
//
// It takes dh a multiple of 8 up to 256 (o, 16 rows x dh, lives in the
// accumulator registers; rows come in 16-byte pieces) where its shared
// memory (Q, a 2-stage ring of K, V and code tiles) fits a block: at dh
// 256 up to ~64 books.
//
// Design, f32 (CUDA cores; no TF32, so the f32 train step holds to the
// oracle): one warp per query row walks its admitted keys newest first,
// 32 at a time, one key per lane; a warp ballot and popcounts rank the
// ties.  For each kept key the warp reads its K row and V row in slices
// of ND = 1, 2, 4 or 8 floats a lane (lanes past dh idle) and folds it
// into an f32 online softmax.  dh a multiple of 8 up to 256, M <= 32
// (the query codes in registers); any codes.
//
// Design, any shape (sparse_attention_any_kernel, either dtype): the f32
// body's walk with nothing in registers that grows with the shape — any
// dh (dh 20, 320, 512, ...), any M, any codes.  A warp a query row; its
// q row and its running output O (dh floats each) live in shared memory,
// so a lane walks the head dim 32 apart; a key's score compares M int32
// codes (the query's through broadcast loads); the kept keys' logits are
// warp sums over dh, their P in shared memory for the PV pass.  All
// arithmetic in f32 (a bf16 input's P is not rounded to bf16 as on the
// tensor cores).  dh past 256 has no room on the tensor cores: O of 16
// rows would need 2 x dh accumulator registers a lane, and a 2-stage K/V
// ring of 64 keys at dh 512 is 256 KB, past a block's 227 KB.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int M_MAX = 32;             // PQ books of the f32 body
constexpr int D_MAX = 256;            // head dim of the f32 and bf16 bodies
constexpr int SMEM_MAX = 232448;      // shared memory a block may use

// ------------------------------------------------------------- f32 body
constexpr int F_WARPS = 8;            // query rows per block
constexpr int F_THREADS = F_WARPS * 32;

// ND consecutive floats (a lane's slice of a head-dim row).
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

template <int ND, bool VEC>
__global__ void __launch_bounds__(F_THREADS) sparse_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int32_t* __restrict__ codes_q,
    const int32_t* __restrict__ codes_k, const int32_t* __restrict__ thr,
    float* __restrict__ out, int nq, int nk, int dh, int M, int hq, int rep,
    float scale, int causal, int window, int q_offset) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lane_lt = (1u << lane) - 1u;
  const int g = blockIdx.y;
  const int i = blockIdx.x * F_WARPS + warp;
  if (i >= nq) return;                          // whole warp
  const size_t row = (size_t)g * nq + i;
  const int kvg = kv_group(g, hq, rep);
  const bool on = lane * ND < dh;               // dh % ND == 0: whole slice
  const int off = lane * ND;
  const float* kg = k + (size_t)kvg * nk * dh + off;
  const float* vg = v + (size_t)kvg * nk * dh + off;
  const int32_t* ck = codes_k + (size_t)kvg * nk * M;

  float qv[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) qv[e] = 0.f;
  if (on) load_slice<ND>(q + row * dh + off, qv);
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
      float part = 0.f;
      if (on) {
        load_slice<ND>(kg + (size_t)(tile_end - 1 - j) * dh, kv);
#pragma unroll
        for (int e = 0; e < ND; ++e) part = fmaf(qv[e], kv[e], part);
      }
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
      if (on) {
        float vv[ND];
        load_slice<ND>(vg + (size_t)(tile_end - 1 - j) * dh, vv);
#pragma unroll
        for (int e = 0; e < ND; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
      }
    }
  }
  if (!on) return;
  const float inv = l_run > 0.f ? 1.f / fmaxf(l_run, 1e-30f) : 0.f;
  float* o = out + row * dh + off;
#pragma unroll
  for (int e = 0; e < ND; ++e) o[e] = acc[e] * inv;
}

// ----------------------------------------------------- any-shape body
// Shared memory a warp (a query row): its q row and running O (dh floats
// each) and the 32 P values of a key tile.
__host__ __device__ inline size_t any_warp_bytes(int dh) {
  return ((size_t)2 * dh + 32) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS) sparse_attention_any_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ codes_q, const int32_t* __restrict__ codes_k,
    const int32_t* __restrict__ thr, T* __restrict__ out, int nq, int nk,
    int dh, int M, int hq, int rep, float scale, int causal, int window,
    int q_offset) {
  extern __shared__ float any_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned lane_lt = (1u << lane) - 1u;
  const int g = blockIdx.y;
  const int i = blockIdx.x * warps + warp;
  if (i >= nq) return;                          // whole warp
  float* qs = any_smem + (size_t)warp * (2 * dh + 32);
  float* os = qs + dh;
  float* ps = os + dh;
  const size_t row = (size_t)g * nq + i;
  const int kvg = kv_group(g, hq, rep);
  const T* kg = k + (size_t)kvg * nk * dh;
  const T* vg = v + (size_t)kvg * nk * dh;
  const int32_t* ck = codes_k + (size_t)kvg * nk * M;
  const int32_t* cq = codes_q + row * M;
  for (int d = lane; d < dh; d += 32) {
    qs[d] = to_f(q[row * dh + d]);
    os[d] = 0.f;
  }
  __syncwarp();
  const int t = thr[row * 2], need = thr[row * 2 + 1];
  const int qpos = q_offset + i;
  const int k_hi = causal ? min(nk, qpos + 1) : nk;
  const int k_lo = window > 0 ? max(0, qpos - window + 1) : 0;

  int taken = 0;                                // ties kept at newer keys
  float m_run = -INFINITY, l_run = 0.f;
  for (int tile_end = k_hi; tile_end > k_lo; tile_end -= 32) {
    const int key = tile_end - 1 - lane;        // lane 0 = newest key
    int s = -1;
    if (key >= k_lo) {
      const int32_t* kr = ck + (size_t)key * M;
      s = 0;
      for (int m = 0; m < M; ++m) s += kr[m] == __ldg(cq + m);
    }
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
      const T* kr = kg + (size_t)(tile_end - 1 - j) * dh;
      float part = 0.f;
      for (int d = lane; d < dh; d += 32) part = fmaf(qs[d], to_f(kr[d]), part);
      const float dot = warp_sum(part);
      if (lane == j) lg = dot * scale;
    }
    const float m_new = fmaxf(m_run, warp_max(lg));   // finite: a key kept
    const float alpha = expf(m_run - m_new);          // 0 on the first tile
    const float p = kept ? expf(lg - m_new) : 0.f;
    l_run = l_run * alpha + warp_sum(p);
    m_run = m_new;
    ps[lane] = p;
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float acc = os[d] * alpha;
      for (unsigned rem = kept_mask; rem; rem &= rem - 1) {
        const int j = __ffs(rem) - 1;
        acc = fmaf(ps[j], to_f(vg[(size_t)(tile_end - 1 - j) * dh + d]), acc);
      }
      os[d] = acc;                              // only this lane's columns
    }
    __syncwarp();                               // ps is rewritten next tile
  }
  const float inv = l_run > 0.f ? 1.f / fmaxf(l_run, 1e-30f) : 0.f;
  for (int d = lane; d < dh; d += 32) out[row * dh + d] = from_f<T>(os[d] * inv);
}

// Warps a block of the any-shape body: 8, fewer where their shared memory
// would pass a block's.
inline int any_warps(int dh) {
  int w = F_WARPS;
  while (w > 1 && w * any_warp_bytes(dh) > SMEM_MAX) w >>= 1;
  return w;
}

// ------------------------------------------------------------ bf16 body
constexpr int BQ = 64;                // query rows a block, 16 a warp
constexpr int BK = 64;                // keys a tile
constexpr int B_WARPS = BQ / 16;
constexpr int B_THREADS = B_WARPS * 32;
constexpr int STAGES = 2;             // K/V/code tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// Asynchronous copies to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices from shared memory (lanes 8j..8j+7 give the row
// addresses of matrix j), as mma fragments; trans: transposed.
__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b for one m16n8k16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Books in which the code bytes of a and b differ.  B8 false (codes below
// 128): a byte of v = a ^ b is nonzero iff adding 0x7f carries into its
// top bit.  B8 (codes below 256): the same over the low seven bits, or
// the top bit set.
template <int CW, bool B8>
__device__ __forceinline__ int book_misses(const uint32_t (&a)[CW],
                                           const uint32_t (&b)[CW]) {
  int miss = 0;
#pragma unroll
  for (int w0 = 0; w0 < CW; w0 += 4) {
    uint32_t m = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t v = a[w0 + w] ^ b[w0 + w];
      const uint32_t f =
          B8 ? (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) : v + 0x7f7f7f7fu;
      m |= (f & 0x80808080u) >> w;
    }
    miss += __popc(m);
  }
  return miss;
}

__device__ __forceinline__ float ex2(float x) {          // 2^x; -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the bf16 body: Q (BQ rows), then STAGES x (K rows, V
// rows, BK x M int32 codes), then each warp's packed codes (BK x CW
// words).  Rows hold dp = dh padded to 16, plus 8 elements so that the 8
// row addresses of an ldmatrix fall on distinct banks.
__host__ __device__ inline int bf16_row_stride(int dh) {
  return ((dh + 15) & ~15) + 8;
}
__host__ __device__ inline size_t bf16_stage_bytes(int dh, int M) {
  return (size_t)2 * BK * bf16_row_stride(dh) * 2 + (size_t)BK * M * 4;
}
template <int CW>
inline size_t bf16_smem_bytes(int dh, int M) {
  return (size_t)BQ * bf16_row_stride(dh) * 2 + STAGES * bf16_stage_bytes(dh, M) +
         (size_t)B_WARPS * BK * CW * 4;
}

// Scores of a thread's two rows against its 16 columns of a key tile
// (column c = 8 nt + 2 qd + e, local bit j = 2 nt + e): above: s > t;
// at: s == t, placed at bit 8 nt + e of a 64-bit column mask (shifted by
// 2 qd later).  MASK: apply nq, nk and the causal / window mask per pair
// (-1 outside it); without it the whole tile is admitted for the warp.
// B8: codes in [0, 256) (else [0, 128)).
template <bool MASK, int CW, bool B8>
__device__ __forceinline__ void score_tile(
    const uint32_t* packed, const uint32_t (&qw)[2][CW], const int (&lim)[2],
    const bool (&rok)[2], const int (&qpos)[2], int kb, int qd, int nk,
    int causal, int window, uint32_t (&above)[2],
    unsigned long long (&at)[2]) {
  above[0] = above[1] = 0;
  at[0] = at[1] = 0;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + 2 * qd + e, key = kb + c;
      uint32_t kw[CW];
#pragma unroll
      for (int w = 0; w < CW; w += 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(packed + c * CW + w);
        kw[w] = x.x; kw[w + 1] = x.y; kw[w + 2] = x.z; kw[w + 3] = x.w;
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int miss = book_misses<CW, B8>(qw[ri], kw);
        bool ok = true;
        if constexpr (MASK)
          ok = rok[ri] && key < nk && (!causal || key <= qpos[ri]) &&
               (window <= 0 || key > qpos[ri] - window);
        above[ri] |= (uint32_t)(ok && miss < lim[ri]) << (2 * nt + e);
        at[ri] |= (unsigned long long)(ok && miss == lim[ri]) << (8 * nt + e);
      }
    }
}

// score_tile over raw int32 codes (any values, any M): one compare a
// book, the key codes from the staged tile (row c at cs + c M), the
// thread's two query rows through L1; lim = M - t.
template <bool MASK>
__device__ __forceinline__ void score_tile_raw(
    const int32_t* cs, const int32_t* __restrict__ qr0,
    const int32_t* __restrict__ qr1, int M, const int (&lim)[2],
    const bool (&rok)[2], const int (&qpos)[2], int kb, int qd, int nk,
    int causal, int window, uint32_t (&above)[2],
    unsigned long long (&at)[2]) {
  above[0] = above[1] = 0;
  at[0] = at[1] = 0;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + 2 * qd + e, key = kb + c;
      const int32_t* kr = cs + c * M;
      int miss[2] = {0, 0};
      for (int m = 0; m < M; ++m) {
        const int kc = kr[m];
        miss[0] += kc != __ldg(qr0 + m);
        miss[1] += kc != __ldg(qr1 + m);
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        bool ok = true;
        if constexpr (MASK)
          ok = rok[ri] && key < nk && (!causal || key <= qpos[ri]) &&
               (window <= 0 || key > qpos[ri] - window);
        above[ri] |= (uint32_t)(ok && miss[ri] < lim[ri]) << (2 * nt + e);
        at[ri] |= (unsigned long long)(ok && miss[ri] == lim[ri]) << (8 * nt + e);
      }
    }
}

// DB: head dims up to DB (64, 128 or 256) share the register tiles; CW:
// code words a row (4 for M <= 16, 8 above: past 32 books only the int32
// form runs).  GEN: the per-tile choice of the compare's form; without it
// (the caller vouches that every code lies in [0, 128) and M <= 4 CW:
// the main path, whose codes come from a codebook of at most 128 words)
// the body is the 7-bit form alone, with no per-tile test.
template <int DB, int CW, bool GEN>
__global__ void __launch_bounds__(B_THREADS) sparse_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ codes_q,
    const int32_t* __restrict__ codes_k, const int32_t* __restrict__ thr,
    __nv_bfloat16* __restrict__ out, int nq, int nk, int dh, int M, int hq,
    int rep, float scale, int causal, int window, int q_offset,
    int codes_vec) {
  constexpr int NT = DB / 8;            // 8-column tiles of O, at most
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, qd = lane & 3;      // fragment row, column pair
  const int g = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
  const int kvg = kv_group(g, hq, rep);
  const int dp = (dh + 15) & ~15;
  const int rs = dp + 8;                        // row stride, elements
  const int tile_el = BK * rs;
  const int stage_bytes = (int)bf16_stage_bytes(dh, M);
  const float sl2 = scale * LOG2E;              // logits in base 2
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + (size_t)BQ * rs * 2;
  uint32_t* packed =
      reinterpret_cast<uint32_t*>(ring + STAGES * stage_bytes) + warp * BK * CW;

  // the block's key tiles: newest admitted key of its last row down to
  // the oldest its first row's window admits
  const int row_hi = min(q0 + BQ, nq);
  const int k_hi = causal ? min(nk, q_offset + row_hi) : nk;
  const int k_lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int t_hi = (k_hi - 1) / BK;
  const int n_tiles = k_hi > k_lo ? t_hi - k_lo / BK + 1 : 0;
  // this warp's rows: a tile inside all their masks needs no per-pair mask
  const int wq = q0 + warp * 16;
  const bool w_rows = wq + 16 <= nq;
  const int wp_lo = q_offset + wq, wp_hi = wp_lo + 15;

  // this thread's two rows (fragment rows gr and gr + 8 of its warp):
  // lim = 4 CW - t, so s > t <=> misses < lim and s == t <=> misses == lim
  // limr = M - t: the same for the int32 form
  int qpos[2], lim[2], limr[2], need[2];
  bool rok[2];
  uint32_t qw[2][CW];
  const int32_t* qrow[2];
  const bool packable = !GEN || M <= 4 * CW;
  uint32_t qor = 0;                             // OR of the rows' codes
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = wq + gr + 8 * ri;
    rok[ri] = r < nq;
    qpos[ri] = q_offset + r;
    const int t = rok[ri] ? thr[((size_t)g * nq + r) * 2] : 0;
    lim[ri] = 4 * CW - t;
    limr[ri] = M - t;
    need[ri] = rok[ri] ? thr[((size_t)g * nq + r) * 2 + 1] : 0;
    qrow[ri] = codes_q + ((size_t)g * nq + (rok[ri] ? r : 0)) * M;
    if (GEN && rok[ri] && !packable)
      for (int m = 0; m < M; ++m) qor |= (uint32_t)qrow[ri][m];
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int m = 4 * w + b;        // books past M: 0x7f, keys' are 0
        const uint32_t c = rok[ri] && m < M ? (uint32_t)qrow[ri][m] : 0x7fu;
        if (GEN && rok[ri] && m < M) qor |= c;
        word |= (c & 0xffu) << (8 * b);
      }
      qw[ri][w] = word;
    }
  }
  if (GEN) qor = __reduce_or_sync(FULL_MASK, qor);

  float o[NT][4];
#pragma unroll
  for (int nd = 0; nd < NT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  int seen[2] = {0, 0};                         // ties at newer keys

  if (n_tiles > 0) {
    // zero the columns that pad dh to dp (Q, and K and V of each stage)
    if (dp > dh)
      for (int i = tid; i < BQ + STAGES * 2 * BK; i += B_THREADS) {
        __nv_bfloat16* rowp =
            i < BQ ? qs + (size_t)i * rs
                   : reinterpret_cast<__nv_bfloat16*>(
                         ring + ((i - BQ) / (2 * BK)) * stage_bytes) +
                         (size_t)((i - BQ) % (2 * BK)) * rs;
        *reinterpret_cast<uint4*>(rowp + dh) = make_uint4(0, 0, 0, 0);
      }
    // copies: thread tid starts at row r0, 16-byte piece c0 of a tile and
    // steps B_THREADS pieces at a time
    const int pieces = dh / 8;
    const int r0 = tid / pieces, c0 = tid - r0 * pieces;
    const int dr = B_THREADS / pieces, dc = B_THREADS - dr * pieces;
    for (int r = r0, c = c0; r < BQ;) {
      const bool ok = q0 + r < nq;
      cp16(smem_u32(qs + r * rs + c * 8),
           q + ((size_t)g * nq + (ok ? q0 + r : 0)) * dh + c * 8, ok ? 16 : 0);
      r += dr;
      c += dc;
      if (c >= pieces) {
        c -= pieces;
        ++r;
      }
    }
    auto load_tile = [&](int tile, int s) {
      __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(ring + s * stage_bytes);
      const int kb = tile * BK;
      for (int r = r0, c = c0; r < BK;) {
        const bool ok = kb + r < nk;
        const size_t src = ((size_t)kvg * nk + (ok ? kb + r : 0)) * dh + c * 8;
        cp16(smem_u32(ks + r * rs + c * 8), k + src, ok ? 16 : 0);
        cp16(smem_u32(ks + tile_el + r * rs + c * 8), v + src, ok ? 16 : 0);
        r += dr;
        c += dc;
        if (c >= pieces) {
          c -= pieces;
          ++r;
        }
      }
      int32_t* cs = reinterpret_cast<int32_t*>(ks + 2 * tile_el);
      const int32_t* cg = codes_k + (size_t)kvg * nk * M;
      if (codes_vec) {                          // M % 4 == 0, 16-byte rows
        const int cpr = M / 4;
        for (int i = tid; i < BK * cpr; i += B_THREADS) {
          const int r = i / cpr, c = i - r * cpr;
          const bool ok = kb + r < nk;
          cp16(smem_u32(cs + r * M + c * 4),
               cg + (size_t)(ok ? kb + r : 0) * M + c * 4, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < BK * M; i += B_THREADS) {
          const int r = i / M;
          const bool ok = kb + r < nk;
          cp4(smem_u32(cs + i), cg + (size_t)(ok ? kb + r : 0) * M + (i - r * M),
              ok ? 4 : 0);
        }
      }
    };
    load_tile(t_hi, 0);
    cp_commit();

    // ldmatrix row addresses of this lane: Q (A operand), K (B, two
    // n-tiles a call), V (B through .trans, two n-tiles a call)
    const uint32_t qa =
        smem_u32(qs + (warp * 16 + (lane & 15)) * rs + (lane >> 4) * 8);
    const int k_off = ((lane >> 4) * 8 + (lane & 7)) * rs + ((lane >> 3) & 1) * 8;
    const int v_off = (lane & 15) * rs + (lane >> 4) * 8;

    for (int it = 0; it < n_tiles; ++it) {
      const int tile = t_hi - it, kb = tile * BK;
      cp_wait_all();
      __syncthreads();              // tile landed; the other stage is free
      if (it + 1 < n_tiles) load_tile(tile - 1, (it + 1) & 1);
      cp_commit();
      const __nv_bfloat16* ks =
          reinterpret_cast<const __nv_bfloat16*>(ring + (it & 1) * stage_bytes);
      const int32_t* cs = reinterpret_cast<const int32_t*>(ks + 2 * tile_el);

      // 1. the warp's copy of the tile's key codes, four books a word, and
      // the compare's form: 0 codes in [0, 128), 1 in [0, 256), 2 int32
      uint32_t kor = 0;
      if (packable) {
        for (int i = lane; i < BK * CW; i += 32) {
          const int r = i / CW, w = i - r * CW;
          uint32_t word = 0;
          if (M % 4 == 0) {
            if (4 * w < M) {
              const int4 c = *reinterpret_cast<const int4*>(cs + r * M + 4 * w);
              if (GEN) kor |= (uint32_t)(c.x | c.y | c.z | c.w);
              word = (c.x & 0xff) | (c.y & 0xff) << 8 | (c.z & 0xff) << 16 |
                     (c.w & 0xff) << 24;
            }
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (4 * w + b < M) {
                const int c = cs[r * M + 4 * w + b];
                if (GEN) kor |= (uint32_t)c;
                word |= (uint32_t)(c & 0xff) << (8 * b);
              }
          }
          packed[i] = word;
        }
      }
      int form = 0;
      if constexpr (GEN) {
        const uint32_t codes_or = __reduce_or_sync(FULL_MASK, kor) | qor;
        form = !packable ? 2 : codes_or < 128u ? 0 : codes_or < 256u ? 1 : 2;
      }
      __syncwarp();

      // 2. scores and selection; kept: local bit j = 2 nt + e
      uint32_t above[2];
      unsigned long long at[2];
      const bool inside = w_rows && kb + BK <= nk &&
                          (!causal || kb + BK - 1 <= wp_lo) &&
                          (window <= 0 || kb > wp_hi - window);
      if (form == 0) {                          // uniform in the warp
        if (inside)
          score_tile<false, CW, false>(packed, qw, lim, rok, qpos, kb, qd, nk,
                                       causal, window, above, at);
        else
          score_tile<true, CW, false>(packed, qw, lim, rok, qpos, kb, qd, nk,
                                      causal, window, above, at);
      } else if constexpr (GEN) {
        if (form == 1) {
          if (inside)
            score_tile<false, CW, true>(packed, qw, lim, rok, qpos, kb, qd,
                                        nk, causal, window, above, at);
          else
            score_tile<true, CW, true>(packed, qw, lim, rok, qpos, kb, qd,
                                       nk, causal, window, above, at);
        } else if (inside) {
          score_tile_raw<false>(cs, qrow[0], qrow[1], M, limr, rok, qpos, kb,
                                qd, nk, causal, window, above, at);
        } else {
          score_tile_raw<true>(cs, qrow[0], qrow[1], M, limr, rok, qpos, kb,
                               qd, nk, causal, window, above, at);
        }
      }
      uint32_t kept[2];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        // the row's ties in the tile, by column; ranked newest first
        unsigned long long all = at[ri] << (2 * qd);
        all |= __shfl_xor_sync(FULL_MASK, all, 1);
        all |= __shfl_xor_sync(FULL_MASK, all, 2);
        kept[ri] = above[ri];
        if (all) {                              // uniform in the quad
          const unsigned long long mine = all >> (2 * qd);  // bit 8 nt + e
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int b = 8 * nt + e;
              if (((at[ri] >> b) & 1ull) &&
                  seen[ri] + __popcll(mine >> (b + 1)) < need[ri])
                kept[ri] |= 1u << (2 * nt + e);
            }
          seen[ri] += __popcll(all);
        }
      }
      if (!__any_sync(FULL_MASK, (kept[0] | kept[1]) != 0)) continue;

      // 3. S = Q K^T, 16 rows x 64 keys a warp
      float sacc[BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
      const uint32_t ka = smem_u32(ks + k_off);
#pragma unroll
      for (int kk = 0; kk < DB / 16; ++kk) {
        if (kk * 16 < dp) {
          uint32_t a[4];
          ldsm4(qa + kk * 32, a);
#pragma unroll
          for (int np = 0; np < BK / 16; ++np) {
            uint32_t b[4];
            ldsm4(ka + (np * 16 * rs + kk * 16) * 2, b);
            mma16816(sacc[2 * np], a, b[0], b[1]);
            mma16816(sacc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }

      // 4. online softmax per row over its kept keys, in base 2; P in bf16
      bool rescale = false;
      float alpha[2];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = ((kept[ri] >> (2 * nt + e)) & 1u)
                                ? sacc[nt][2 * ri + e] * sl2
                                : -INFINITY;
            sacc[nt][2 * ri + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_run[ri], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        alpha[ri] = m_new == m_run[ri] ? 1.f : ex2(m_run[ri] - m_safe);
        rescale |= alpha[ri] != 1.f;
        m_run[ri] = m_new;
        float ls = 0.f;
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = __bfloat162float(__float2bfloat16(
                ex2(sacc[nt][2 * ri + e] - m_safe)));
            sacc[nt][2 * ri + e] = p;
            ls += p;
          }
        l_run[ri] = l_run[ri] * alpha[ri] + ls;   // this lane's columns
      }
      if (__any_sync(FULL_MASK, rescale)) {
#pragma unroll
        for (int nd = 0; nd < NT; ++nd) {
          o[nd][0] *= alpha[0];
          o[nd][1] *= alpha[0];
          o[nd][2] *= alpha[1];
          o[nd][3] *= alpha[1];
        }
      }

      // 5. O += P V: the S accumulators of two n-tiles are one A fragment
      const uint32_t va = smem_u32(ks + tile_el + v_off);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
        a[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
        a[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
        a[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (np * 16 < dp) {
            uint32_t b[4];
            ldsm4_t(va + (kk * 16 * rs + np * 16) * 2, b);
            mma16816(o[2 * np], a, b[0], b[1]);
            mma16816(o[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }

  // O / l: l summed over the quad; rows with nothing kept output 0
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(FULL_MASK, l, 1);
    l += __shfl_xor_sync(FULL_MASK, l, 2);
    if (!rok[ri]) continue;
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    __nv_bfloat16* orow = out + ((size_t)g * nq + wq + gr + 8 * ri) * dh;
#pragma unroll
    for (int nd = 0; nd < NT; ++nd)
      if (nd * 8 < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * qd) =
            __floats2bfloat162_rn(o[nd][2 * ri] * inv, o[nd][2 * ri + 1] * inv);
  }
}

template <int DB, int CW, bool GEN>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int32_t* cq, const int32_t* ck,
                        const int32_t* thr, void* out, int G, int nq, int nk,
                        int dh, int M, int hq, int rep, float scale,
                        int causal, int window, int q_offset, int codes_vec,
                        cudaStream_t st) {
  const size_t smem = bf16_smem_bytes<CW>(dh, M);
  auto kern = sparse_attention_bf16_kernel<DB, CW, GEN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((nq + BQ - 1) / BQ, G), B_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), cq, ck, thr,
      static_cast<__nv_bfloat16*>(out), nq, nk, dh, M, hq, rep, scale, causal,
      window, q_offset, codes_vec);
  return cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const int32_t* cq,
               const int32_t* ck, const int32_t* thr, void* out, int G, int nq,
               int nk, int dh, int M, int hq, int rep, float scale, int causal,
               int window, int q_offset, bool vec, cudaStream_t st) {
  dim3 grid((nq + F_WARPS - 1) / F_WARPS, G);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
#define REPRO_SA_F32(ND)                                                     \
  if (vec)                                                                   \
    sparse_attention_f32_kernel<ND, true><<<grid, F_THREADS, 0, st>>>(       \
        qp, kp, vp, cq, ck, thr, op, nq, nk, dh, M, hq, rep, scale, causal,  \
        window, q_offset);                                                   \
  else                                                                       \
    sparse_attention_f32_kernel<ND, false><<<grid, F_THREADS, 0, st>>>(      \
        qp, kp, vp, cq, ck, thr, op, nq, nk, dh, M, hq, rep, scale, causal,  \
        window, q_offset)
  if (dh <= 32) {
    REPRO_SA_F32(1);
  } else if (dh <= 64) {
    REPRO_SA_F32(2);
  } else if (dh <= 128) {
    REPRO_SA_F32(4);
  } else {
    REPRO_SA_F32(8);
  }
#undef REPRO_SA_F32
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* q, const void* k, const void* v, const int32_t* cq,
               const int32_t* ck, const int32_t* thr, void* out, int G, int nq,
               int nk, int dh, int M, int hq, int rep, float scale, int causal,
               int window, int q_offset, cudaStream_t st) {
  const int warps = any_warps(dh);
  const size_t smem = warps * any_warp_bytes(dh);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_attention_any_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sparse_attention_any_kernel<T>
      <<<dim3((nq + warps - 1) / warps, G), warps * 32, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), cq, ck, thr, static_cast<T*>(out), nq, nk,
          dh, M, hq, rep, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// The body a shape runs: 0 the f32 body, 1 the bf16 tensor-core body, 2
// the any-shape body.
inline int body_of(int dtype, int dh, int M) {
  if (dh % 8 == 0 && dh <= D_MAX) {
    if (dtype == 0 && M <= M_MAX) return 0;
    if (dtype == 1 && (M <= 16 ? bf16_smem_bytes<4>(dh, M)
                               : bf16_smem_bytes<8>(dh, M)) <= SMEM_MAX)
      return 1;
  }
  return 2;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  q: (G, nq, dh);
// k, v: (Gk, nk, dh); codes_q: (G, nq, M) and codes_k: (Gk, nk, M) int32
// (any values); thr: (G, nq, 2) int32 [t, need]; G = B * hq, Gk = B * hq /
// rep.  Any dh and M; window <= 0 means none.  code_bound > 0: the caller
// vouches that every code lies in [0, code_bound) (0: nothing known).  q,
// k and v start on 16 bytes.  Returns the cudaError_t of the launch.
extern "C" int repro_sparse_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* codes_q, const void* codes_k, const void* thr, void* out,
    int G, int nq, int nk, int dh, int M, int hq, int rep, float scale,
    int causal, int window, int q_offset, int code_bound, void* stream) {
  if (G < 1 || G > 65535 || nq < 1 || nk < 1 || M < 1 || hq < 1 || rep < 1 ||
      hq % rep || G % hq || q_offset < 0 || dh < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cq = static_cast<const int32_t*>(codes_q);
  const int32_t* ck = static_cast<const int32_t*>(codes_k);
  const int32_t* tp = static_cast<const int32_t*>(thr);
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(ck) % 16 == 0;
  const int body = body_of(dtype, dh, M);
  if (body == 2)
    return dtype == 0
               ? launch_any<float>(q, k, v, cq, ck, tp, out, G, nq, nk, dh, M,
                                   hq, rep, scale, causal, window, q_offset, st)
               : launch_any<__nv_bfloat16>(q, k, v, cq, ck, tp, out, G, nq, nk,
                                           dh, M, hq, rep, scale, causal,
                                           window, q_offset, st);
  if (body == 0)
    return launch_f32(q, k, v, cq, ck, tp, out, G, nq, nk, dh, M, hq, rep,
                      scale, causal, window, q_offset, vec, st);
#define REPRO_SA_BF16(DB, CW, GEN)                                           \
  launch_bf16<DB, CW, GEN>(q, k, v, cq, ck, tp, out, G, nq, nk, dh, M, hq,   \
                           rep, scale, causal, window, q_offset, (int)vec, st)
#define REPRO_SA_BF16_CW(DB, CW)                                             \
  (seven ? REPRO_SA_BF16(DB, CW, false) : REPRO_SA_BF16(DB, CW, true))
  const int dp = (dh + 15) & ~15;
  const bool seven = M <= 32 && code_bound > 0 && code_bound <= 128;
  const cudaError_t err =
      M <= 16 ? (dp <= 64    ? REPRO_SA_BF16_CW(64, 4)
                 : dp <= 128 ? REPRO_SA_BF16_CW(128, 4)
                             : REPRO_SA_BF16_CW(256, 4))
              : (dp <= 64    ? REPRO_SA_BF16_CW(64, 8)
                 : dp <= 128 ? REPRO_SA_BF16_CW(128, 8)
                             : REPRO_SA_BF16_CW(256, 8));
#undef REPRO_SA_BF16_CW
#undef REPRO_SA_BF16
  return (int)err;
}

// Dynamic shared memory the launcher asks for at (dtype, dh, M): the bf16
// body's or the any-shape body's; the f32 body uses none.
extern "C" int repro_sparse_attention_smem(int dtype, int dh, int M) {
  const int body = body_of(dtype, dh, M);
  if (body == 2) return (int)(any_warps(dh) * any_warp_bytes(dh));
  if (body == 0) return 0;
  return (int)(M <= 16 ? bf16_smem_bytes<4>(dh, M)
                       : bf16_smem_bytes<8>(dh, M));
}
