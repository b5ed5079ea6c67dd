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
// (G, nq, 2) int32, equal to the plain version bit for bit.  Codes may be
// any int32 values.
//
// What bounds it: integer issue.  Every admitted (query, key) pair costs a
// score and a histogram increment, against (nq + nk) M code words read
// once: at the training shape 33.6M pairs against 6.8 MB.
//
// Design:
//  * a block serves one kv group: 128 query rows of it, taken across the
//    R = rep query heads that read the group (row j of the group is
//    position j / R of head j % R), so one staged key tile serves all R
//    heads.  Two threads per row, each scoring half of every key tile,
//    four keys at a time (independent chains); a thread's row codes sit
//    in registers, packed;
//  * the block streams the key-code tiles its rows admit (64 keys a tile)
//    through a 2-stage cp.async ring and packs each tile once, in two
//    forms: bytes (four books a word) and nibble slices (below).  Every
//    lane of a warp reads the same packed key, so the shared loads are
//    broadcasts;
//  * scores are exact compares of packed codes, a few logic operations
//    and one popcount a pair (books past M are zero on both sides and
//    never miss).  Codes in [0, 16) take the nibble-slice compare (four
//    operations a pair for up to 16 books), codes in [0, 256) the byte
//    compare, anything else an int32 compare per book; the choice is made
//    per tile from the tile's and the block's query codes, block-uniform
//    (__syncthreads_or), so any int32 codes stay exact;
//  * the histogram counts misses (M - s) in shared memory as
//    [bucket][row], one shared-memory atomic increment a pair: the 32
//    lanes of a warp hold 32 rows, so their increments fall in distinct
//    banks;
//  * the causal / window mask is applied per pair only in the tiles that
//    cross a row's edge (or nk); blocks are issued heaviest first (the
//    last query rows, with the longest causal spans) across all kv
//    groups;
//  * up to 64 books the packed words cover the books in chunks of 32 (one
//    popcount a chunk); the histogram, (M + 1) x 128 ints (33 KB at
//    M = 64), is dynamic shared memory.
//
// Any number of books beyond 64 (the JAX kernel compares int32 codes over
// any number of books) takes the general body: int32 compares, a row a
// thread, the rows' codes staged transposed in shared memory beside the
// histogram and a tile of key codes; a block takes 128 rows and 32 keys a
// tile, fewer of each where those would pass a block's 227 KB.  Scores
// above M never occur, so max_score (>= M) changes nothing in either
// body: buckets above M stay empty.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int ROWS = 128;             // query rows a block
constexpr int KSPLIT = 2;             // threads a row, each half a tile
constexpr int THREADS = ROWS * KSPLIT;
constexpr int BK = 64;                // keys a tile
constexpr int PART = BK / KSPLIT;     // keys a thread scores per tile
constexpr int ILP = 4;                // keys scored together
constexpr int M_PACKED = 64;          // books of the packed body
constexpr int SMEM_MAX = 232448;      // shared memory a block may use

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

// Codes 8c .. 8c + 7 of a staged row of M (books past M read as 0);
// vec: M % 4 == 0, so the row's 16-byte pieces are aligned and whole.
__device__ __forceinline__ void load_codes8(const int32_t* row, int M, int c,
                                            int vec, uint32_t (&v)[8]) {
  if (vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int4 x = make_int4(0, 0, 0, 0);
      if (8 * c + 4 * h < M) x = reinterpret_cast<const int4*>(row + 8 * c)[h];
      v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z; v[4 * h + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int b = 0; b < 8; ++b)
      v[b] = 8 * c + b < M ? (uint32_t)row[8 * c + b] : 0u;
  }
}

// Books in which two rows of byte codes (four books a word) differ: a
// byte of v = a ^ b is nonzero iff adding 0x7f to its low seven bits
// carries into its top bit, or the top bit is set; word w's flags are
// shifted down by w % 8, so eight words (32 books) share one popcount.
template <int CW>
__device__ __forceinline__ int byte_misses(const uint32_t (&a)[CW],
                                           const uint32_t (&b)[CW]) {
  int n = 0;
#pragma unroll
  for (int w0 = 0; w0 < CW; w0 += 8) {
    uint32_t flags = 0;
#pragma unroll
    for (int w = w0; w < CW && w < w0 + 8; ++w) {
      const uint32_t v = a[w] ^ b[w];
      flags |= ((((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u) >>
               (w - w0);
    }
    n += __popc(flags);
  }
  return n;
}

// Books in which two rows of codes in [0, 16) differ, from their nibble
// slices: slice s of a row is a pair of words (A, B) over books 16s ..
// 16s + 15 (nibble words w0, w1 of books 16s .., 16s + 8 ..): A holds bits
// 0-1 of every book (w0 & 0x33.. | (w1 & 0x33..) << 2), B bits 2-3
// ((w0 >> 2) & 0x33.. | w1 & 0xcc..), two bits a book at the same place
// in both.  So x = (qA ^ kA) | (qB ^ kB) has a book's two bits nonzero
// iff it missed, and (x | x >> 1) & 0x55.. keeps one bit a book; two
// slices (32 books) share one popcount.
template <int S>
__device__ __forceinline__ int slice_misses(const uint32_t (&a)[2 * S],
                                            const uint32_t (&b)[2 * S]) {
  int n = 0;
#pragma unroll
  for (int s0 = 0; s0 < S; s0 += 2) {
    uint32_t flags = 0;
#pragma unroll
    for (int s = s0; s < S && s < s0 + 2; ++s) {
      const uint32_t x = (a[2 * s] ^ b[2 * s]) | (a[2 * s + 1] ^ b[2 * s + 1]);
      flags |= ((x | (x >> 1)) & 0x55555555u) << (s - s0);
    }
    n += __popc(flags);
  }
  return n;
}

// Nibble slice (A, B) contributions of nibble word c of a row: word 2s is
// w0 of slice s, word 2s + 1 its w1; the two contributions are disjoint.
__device__ __forceinline__ void slice_part(uint32_t n, int c, uint32_t& a,
                                           uint32_t& b) {
  if (c & 1) {
    a = (n & 0x33333333u) << 2;
    b = n & 0xccccccccu;
  } else {
    a = n & 0x33333333u;
    b = (n >> 2) & 0x33333333u;
  }
}

template <int N>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[N]) {
  if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[c];
      w[4 * c] = v.x; w[4 * c + 1] = v.y; w[4 * c + 2] = v.z; w[4 * c + 3] = v.w;
    }
  }
}

// This thread's part of a packed key tile into its row's histogram
// column, ILP keys at a time (independent chains between the broadcast
// loads and the increments).  MASK: admit key kb + c only when lo <=
// kb + c < hi (tiles crossing an edge); otherwise every key is admitted.
// NIB: packed holds nibble slices (CW = 2 S words a key), else byte words.
template <bool NIB, int CW, bool MASK>
__device__ __forceinline__ void score_packed(const uint32_t* packed,
                                             const uint32_t (&q)[CW],
                                             int* hcol, int kb, int lo,
                                             int hi) {
#pragma unroll
  for (int c0 = 0; c0 < PART; c0 += ILP) {
    int miss[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      uint32_t k[CW];
      load_words<CW>(packed + (c0 + u) * CW, k);
      if constexpr (NIB)
        miss[u] = slice_misses<CW / 2>(q, k);
      else
        miss[u] = byte_misses<CW>(q, k);
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u)
      if (!MASK || (unsigned)(kb + c0 + u - lo) < (unsigned)(hi - lo))
        atomicAdd(hcol + miss[u] * ROWS, 1);
  }
}

// The same over the raw int32 codes (any values): one compare per book.
template <bool MASK>
__device__ __forceinline__ void score_int32(const int32_t* raw,
                                            const int32_t* qrow, int M,
                                            int* hcol, int kb, int lo,
                                            int hi) {
  for (int c = 0; c < PART; ++c) {
    if (MASK && (unsigned)(kb + c - lo) >= (unsigned)(hi - lo)) continue;
    int s = 0;
    for (int m = 0; m < M; ++m) s += raw[c * M + m] == __ldg(qrow + m);
    atomicAdd(hcol + (M - s) * ROWS, 1);
  }
}

// MB: books the packed words hold (8, 16, 32 or 64; M <= MB).  Dynamic
// shared memory: the histogram, (M + 1) x ROWS ints.
template <int MB>
__global__ void __launch_bounds__(THREADS, 4) topl_thresholds_kernel(
    const int32_t* __restrict__ codes_q, const int32_t* __restrict__ codes_k,
    int32_t* __restrict__ thr, int nq, int nk, int M, int gk, int rep, int l,
    int causal, int window, int q_offset, int ck_vec) {
  constexpr int C8 = MB / 4, C4 = MB / 8;  // byte words, nibble words
  constexpr int CS = C4 > 1 ? C4 : 2;          // nibble-slice words
  __shared__ __align__(16) int32_t ring[2][BK * MB];
  __shared__ __align__(16) uint32_t pk8[BK * C8];
  __shared__ __align__(16) uint32_t pkn[BK * CS];
  extern __shared__ int hist[];         // [bucket][row]
  const int tid = threadIdx.x;
  const int part = tid / ROWS;          // warp-uniform
  // heaviest first: blocks of equal rank over all kv groups, last rows first
  const int kvg = blockIdx.x % gk;
  const int n_row_tiles = gridDim.x / gk;
  const int j0 = (n_row_tiles - 1 - (int)(blockIdx.x / gk)) * ROWS;
  const int rows = rep * nq;            // rows of the kv group
  const int j = j0 + tid % ROWS;
  const bool ok = j < rows;
  const int i = j / rep;
  const int g = kvg * rep + (j - i * rep);
  const int qpos = q_offset + i;
  // this row's admitted keys [lo, hi)
  int hi = causal ? min(nk, qpos + 1) : nk;
  int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  if (!ok) lo = hi = 0;
  // the block's: keys any row admits, and keys every row admits
  const int i_lo = j0 / rep, i_hi = (min(j0 + ROWS, rows) - 1) / rep;
  const int k_hi = causal ? min(nk, q_offset + i_hi + 1) : nk;
  const int k_lo = window > 0 ? max(0, q_offset + i_lo - window + 1) : 0;
  const int all_hi = causal ? min(nk, q_offset + i_lo + 1) : nk;
  const int all_lo = window > 0 ? max(0, q_offset + i_hi - window + 1) : 0;

  int* hcol = hist + tid % ROWS;        // the row's column
  if (part == 0)
    for (int b = 0; b <= M; ++b) hcol[b * ROWS] = 0;

  const int32_t* qrow = codes_q + ((size_t)g * nq + (ok ? i : 0)) * M;
  uint32_t q8[C8], q4[C4], qn[CS];
  bool q_wide = false, q_byte = false;  // codes beyond [0, 16) / [0, 256)
#pragma unroll
  for (int w = 0; w < C8; ++w) q8[w] = 0;
#pragma unroll
  for (int w = 0; w < C4; ++w) q4[w] = 0;
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const uint32_t c = ok && m < M ? (uint32_t)__ldg(qrow + m) : 0u;
    q_wide |= c >= 16u;
    q_byte |= c >= 256u;
    q8[m / 4] |= (c & 0xffu) << (8 * (m % 4));
    q4[m / 8] |= (c & 0xfu) << (4 * (m % 8));
  }
#pragma unroll
  for (int w = 0; w < CS; ++w) qn[w] = 0;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    uint32_t a, b;
    slice_part(q4[c], c, a, b);
    qn[c / 2 * 2] |= a;
    qn[c / 2 * 2 + 1] |= b;
  }

  const int t_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - 1) / BK - t_lo + 1 : 0;
  const int32_t* cg = codes_k + (size_t)kvg * nk * M;
  auto stage = [&](int tile, int s) {
    const int kb = tile * BK;
    const int avail = (min(kb + BK, nk) - kb) * M;      // ints in range
    const int32_t* src = cg + (size_t)kb * M;
    if (ck_vec) {                                       // M % 4 == 0
      for (int c = tid; c < BK * M / 4; c += THREADS) {
        const bool in = 4 * c < avail;
        cp16(smem_u32(&ring[s][4 * c]), in ? src + 4 * c : cg, in ? 16 : 0);
      }
    } else {
      for (int c = tid; c < BK * M; c += THREADS) {
        const bool in = c < avail;
        cp4(smem_u32(&ring[s][c]), in ? src + c : cg, in ? 4 : 0);
      }
    }
  };
  if (n_tiles > 0) stage(t_lo, 0);
  cp_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = (t_lo + it) * BK;
    cp_wait_all();
    __syncthreads();                    // tile landed; the other stage free
    if (it + 1 < n_tiles) stage(t_lo + it + 1, (it + 1) & 1);
    cp_commit();
    const int32_t* raw = ring[it & 1];
    bool wide = q_wide, byte = q_byte;
    for (int w = tid; w < BK * C4; w += THREADS) {   // books 8c .. 8c + 7
      const int key = w / C4, c = w - key * C4;
      uint32_t v[8];
      load_codes8(raw + key * M, M, c, ck_vec, v);
      uint32_t n4 = 0, b0 = 0, b1 = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        wide |= v[b] >= 16u;
        byte |= v[b] >= 256u;
        n4 |= (v[b] & 0xfu) << (4 * b);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        b0 |= (v[b] & 0xffu) << (8 * b);
        b1 |= (v[b + 4] & 0xffu) << (8 * b);
      }
      pk8[key * C8 + 2 * c] = b0;
      pk8[key * C8 + 2 * c + 1] = b1;
      uint32_t a, b;
      slice_part(n4, c, a, b);
      if (C4 > 1) {                     // word c ^ 1 sits in the next lane
        a |= __shfl_xor_sync(FULL_MASK, a, 1);
        b |= __shfl_xor_sync(FULL_MASK, b, 1);
      }
      if (!(c & 1)) {
        pkn[key * CS + c] = a;
        pkn[key * CS + c + 1] = b;
      }
    }
    const int kh = kb + part * PART;    // this thread's part of the tile
    const bool full = kb >= all_lo && kb + BK <= all_hi;
    if (!__syncthreads_or(wide)) {      // codes in [0, 16): nibbles
      if (ok) {
        if (full)
          score_packed<true, CS, false>(pkn + part * PART * CS, qn, hcol, kh, lo, hi);
        else
          score_packed<true, CS, true>(pkn + part * PART * CS, qn, hcol, kh, lo, hi);
      }
    } else if (!__syncthreads_or(byte)) {   // codes in [0, 256): bytes
      if (ok) {
        if (full)
          score_packed<false, C8, false>(pk8 + part * PART * C8, q8, hcol, kh, lo, hi);
        else
          score_packed<false, C8, true>(pk8 + part * PART * C8, q8, hcol, kh, lo, hi);
      }
    } else if (ok) {                    // any int32 codes
      if (full)
        score_int32<false>(raw + part * PART * M, qrow, M, hcol, kh, lo, hi);
      else
        score_int32<true>(raw + part * PART * M, qrow, M, hcol, kh, lo, hi);
    }
  }
  __syncthreads();
  if (part || !ok) return;
  // hist_reduce over scores M .. 0 (bucket M - s counts the keys with s
  // matches; buckets above M stay empty)
  int ge = 0, t = 0, n_above = -1;
  for (int s = M; s >= 0; --s) {
    const int h = hcol[(M - s) * ROWS];
    if (ge + h >= l) {
      t = s;
      n_above = ge;                       // #(s > t)
      break;
    }
    ge += h;
  }
  if (n_above < 0) n_above = ge - hcol[M * ROWS];      // t = 0
  int32_t* out = thr + ((size_t)g * nq + i) * 2;
  out[0] = t;
  out[1] = l - n_above;
}

template <int MB>
int launch(const int32_t* cq, const int32_t* ck, int32_t* tp, int gk, int nq,
           int nk, int M, int rep, int l, int causal, int window,
           int q_offset, int ck_vec, cudaStream_t st) {
  if (MB > 32) {                 // static + dynamic past 48 KB: opt in once
    static bool opted = false;
    if (!opted) {
      const cudaError_t err = cudaFuncSetAttribute(
          topl_thresholds_kernel<MB>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          (M_PACKED + 1) * ROWS * (int)sizeof(int));
      if (err != cudaSuccess) return (int)err;
      opted = true;
    }
  }
  const int row_tiles = (rep * nq + ROWS - 1) / ROWS;
  topl_thresholds_kernel<MB><<<gk * row_tiles, THREADS,
                               (M + 1) * ROWS * sizeof(int), st>>>(
      cq, ck, tp, nq, nk, M, gk, rep, l, causal, window, q_offset, ck_vec);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- any number of books
constexpr int G_ROWS = 128;           // rows a block, at most
constexpr int G_KEYS = 32;            // keys a tile, at most

// Shared memory of the general body at rb rows and bk keys a tile: the
// histogram (M + 1) x rb, the rows' codes M x rb, a key tile bk x M.
__host__ __device__ inline size_t any_smem_bytes(int M, int rb, int bk) {
  return ((size_t)(M + 1) * rb + (size_t)M * rb + (size_t)bk * M) * 4;
}
// Its rows a block and keys a tile: 128 and 32, halved (rows first, to
// 32) while the three do not fit a block.
inline void any_tiles(int M, int& rb, int& bk) {
  rb = G_ROWS;
  bk = G_KEYS;
  while (any_smem_bytes(M, rb, bk) > SMEM_MAX && rb > 32) rb >>= 1;
  while (any_smem_bytes(M, rb, bk) > SMEM_MAX && bk > 1) bk >>= 1;
  while (any_smem_bytes(M, rb, bk) > SMEM_MAX && rb > 1) rb >>= 1;
}

__global__ void __launch_bounds__(G_ROWS) topl_thresholds_any_kernel(
    const int32_t* __restrict__ codes_q, const int32_t* __restrict__ codes_k,
    int32_t* __restrict__ thr, int nq, int nk, int M, int gk, int rep, int l,
    int causal, int window, int q_offset, int rb, int bk) {
  extern __shared__ int smem[];
  int* hist = smem;                              // [bucket][row]
  int32_t* qs = smem + (size_t)(M + 1) * rb;     // [book][row]
  int32_t* ks = qs + (size_t)M * rb;             // [key][book]
  const int tid = threadIdx.x;
  const int kvg = blockIdx.x % gk;
  const int n_row_tiles = gridDim.x / gk;
  const int j0 = (n_row_tiles - 1 - (int)(blockIdx.x / gk)) * rb;
  const int rows = rep * nq;
  const int j = j0 + tid;
  const bool ok = j < rows;
  const int i = j / rep;
  const int g = kvg * rep + (j - i * rep);
  const int qpos = q_offset + i;
  int hi = causal ? min(nk, qpos + 1) : nk;
  int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  if (!ok) lo = hi = 0;
  const int i_lo = j0 / rep, i_hi = (min(j0 + rb, rows) - 1) / rep;
  const int k_hi = causal ? min(nk, q_offset + i_hi + 1) : nk;
  const int k_lo = window > 0 ? max(0, q_offset + i_lo - window + 1) : 0;
  int* hcol = hist + tid;
  for (int b = 0; b <= M; ++b) hcol[(size_t)b * rb] = 0;
  const int32_t* qrow = codes_q + ((size_t)g * nq + (ok ? i : 0)) * M;
  for (int m = 0; m < M; ++m) qs[(size_t)m * rb + tid] = ok ? qrow[m] : 0;
  const int32_t* cg = codes_k + (size_t)kvg * nk * M;
  for (int kb = k_lo; kb < k_hi; kb += bk) {
    const int n = min(bk, k_hi - kb);
    __syncthreads();                  // the last tile's reads are done
    for (int e = tid; e < n * M; e += blockDim.x)
      ks[e] = cg[(size_t)kb * M + e];
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const int key = kb + c;
      if (key < lo || key >= hi) continue;
      int s = 0;
      for (int m = 0; m < M; ++m) s += ks[c * M + m] == qs[(size_t)m * rb + tid];
      ++hcol[(size_t)(M - s) * rb];   // a row's column is its thread's own
    }
  }
  if (!ok) return;
  int ge = 0, t = 0, n_above = -1;
  for (int sc = M; sc >= 0; --sc) {
    const int h = hcol[(size_t)(M - sc) * rb];
    if (ge + h >= l) {
      t = sc;
      n_above = ge;                   // #(s > t)
      break;
    }
    ge += h;
  }
  if (n_above < 0) n_above = ge - hcol[(size_t)M * rb];    // t = 0
  int32_t* out = thr + ((size_t)g * nq + i) * 2;
  out[0] = t;
  out[1] = l - n_above;
}

int launch_any(const int32_t* cq, const int32_t* ck, int32_t* tp, int gk,
               int nq, int nk, int M, int rep, int l, int causal, int window,
               int q_offset, cudaStream_t st) {
  int rb, bk;
  any_tiles(M, rb, bk);
  const size_t smem = any_smem_bytes(M, rb, bk);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      topl_thresholds_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (rep * nq + rb - 1) / rb;
  topl_thresholds_any_kernel<<<gk * row_tiles, rb, smem, st>>>(
      cq, ck, tp, nq, nk, M, gk, rep, l, causal, window, q_offset, rb, bk);
  return (int)cudaGetLastError();
}

}  // namespace

// codes_q: (G, nq, M) int32; codes_k: (Gk, nk, M) int32 with G = B * hq and
// Gk = B * hq / rep (query group g reads kv group g / rep); thr: (G, nq, 2)
// int32.  Any M >= 1 and max_score >= M; window <= 0 means none.  Returns
// the cudaError_t of the launch.
extern "C" int repro_topl_thresholds(const void* codes_q, const void* codes_k,
                                     void* thr, int G, int nq, int nk, int M,
                                     int hq, int rep, int l, int max_score,
                                     int causal, int window, int q_offset,
                                     void* stream) {
  if (G < 1 || nq < 1 || nk < 1 || M < 1 || hq < 1 || rep < 1 ||
      hq % rep || G % hq || l < 1 || max_score < M || q_offset < 0 ||
      (long long)rep * nq > (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cq = static_cast<const int32_t*>(codes_q);
  const int32_t* ck = static_cast<const int32_t*>(codes_k);
  int32_t* tp = static_cast<int32_t*>(thr);
  const int ck_vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(ck) % 16 == 0;
  const int gk = G / rep;
#define REPRO_TOPL(MB)                                                       \
  launch<MB>(cq, ck, tp, gk, nq, nk, M, rep, l, causal, window, q_offset,    \
             ck_vec, st)
  if (M <= 8) return REPRO_TOPL(8);
  if (M <= 16) return REPRO_TOPL(16);
  if (M <= 32) return REPRO_TOPL(32);
  if (M <= M_PACKED) return REPRO_TOPL(64);
#undef REPRO_TOPL
  return launch_any(cq, ck, tp, gk, nq, nk, M, rep, l, causal, window,
                    q_offset, st);
}

// Dynamic shared memory the launcher asks for at M books: the packed
// body's histogram, or the general body's three arrays.
extern "C" int repro_topl_thresholds_smem(int M) {
  if (M <= M_PACKED) return (M + 1) * ROWS * (int)sizeof(int);
  int rb, bk;
  any_tiles(M, rb, bk);
  return (int)any_smem_bytes(M, rb, bk);
}
