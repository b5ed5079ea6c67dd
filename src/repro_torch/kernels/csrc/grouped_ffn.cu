// Grouped routed-FFN kernel with in-kernel token gather, for Hopper (sm_90a).
//
// Replaces the TPU kernel grouped_ffn_kernel
// (src/repro/kernels/routed_ffn/routed_ffn.py:187, its pl.pallas_call at
// :264).
//
// Computes, per (batch b, group g, tile of capacity slots c):
//   x_c = x[b, min(index[b, g, c], S - 1)]          (S marks an empty slot)
//   h   = act(x_c W_gate[g] + s (x_c B_gate) C_gate[g])
//         * (x_c W_I[g] + s (x_c B_I) C_I[g])        (ungated: act(up))
//   y[b, g, c] = h W_O[g] + s (h B_O[g]) C_O
// with every product accumulated in f32.  Empty or dropped slots produce
// finite rows that the torch combine scatter discards.
//
// What bounds it: arithmetic.  Per kept slot it does 2*d*F*(2 or 3)
// flops against d inputs and d outputs; at the (8, 1024) prefill bucket
// that is ~50 GFLOP, 0.05 ms at the tensor cores' bf16 rate.  Two bodies,
// chosen by dtype at the launcher (never as a fallback):
//
// bf16 — tensor cores (grouped_ffn_kernel_wgmma).  One block of two
//   warpgroups takes 64 capacity slots of one (b, g) (wgmma's M).  The
//   gathered x tile (64 x d) comes in by 16-byte cp.async and stays in
//   shared memory as bf16 (128 KB at d = 1024), K-major with the 128-byte
//   swizzle; h (64 x F) is rounded to bf16 into a second such tile (48 KB
//   at F = 384), so neither the (B, G, C, d) dispatch buffer nor h ever
//   exists in device memory.  The weight matrices are row-major (K x N),
//   so their tiles are "MN-major" B operands: 32 k-rows x 64-column
//   swizzled atoms, streamed through a 3-stage cp.async ring (two tiles in
//   flight while the third is multiplied).  Products are
//   wgmma.mma_async m64n64k16 (x W_I and x W_gate, 64 hidden columns per
//   warpgroup, 128 per pass) and m64n128k16 (h W_O, 128 output columns
//   per warpgroup), bf16 operands from shared memory, f32 accumulators in
//   registers.  The gate product is compiled in only for gated FFNs (a
//   template flag, not a branch around the wgmma).  The blocks of one
//   group are adjacent in the grid, so its weights stay in L2.  A tile
//   none of whose 64 indices is below S keeps no slot: it writes zero
//   rows and exits (the plan packs each row's kept slots first, so these
//   are each row's trailing tiles; any index order is computed right).
//   LoRA rides the same tensor-core passes as K extensions: x [B_I |
//   B_gate] (one m64n64 pass) is scaled by s, rounded to bf16 and
//   appended to x as extra contraction columns against C_I / C_gate rows;
//   likewise s (h B_O[g]) against C_O rows.  The wrapper rounds the LoRA
//   leaves to bf16 for this (an error of ~2^-9 of a LoRA term, well inside
//   bf16 tolerance) and pads the rank with zeros to a multiple of 8.
//   Ranks up to 32: s x [B_I | B_gate] (64 x 2r) waits in the last h
//   tile, which only the last phase-1 pass writes; there is no room for a
//   second tile (the x and h tiles take 230,656 of 232,448 bytes at d
//   1024 / F 384).  Past rank 32 the LoRA term (which grows with the
//   rank) needs more precision than one bf16 rounding of U, V and h
//   gives (scripts/torch_ffn_rounding.py emulates the roundings in f32: at
//   d 3072 / F 1024, rank 128, rounding each once put 481,033 of 50M kept
//   outputs past the per-element 2e-2 rule, with the LoRA factors as bf16
//   halves 44,543, with U, V and h as halves too none; rank 64: 5,624,
//   36, none).  So
//   ranks past 32 take the wide form's GEN instances, where h is in device
//   memory anyway: the wrapper hands the LoRA pairs as bf16 halves
//   (routed_ffn/ops.py, _split_pairs), U and V run through their one tile
//   64 columns at a time as bf16 halves, and h goes to device memory as
//   bf16 halves, each contracted in turn (the down pass reads h twice).
//   What holds it back: each stage waits for its own wgmma (wait_group 0)
//   before the next barrier, and ptxas reports (C7520) that it serializes
//   the wgmma instructions behind a compiler-inserted warpgroup arrive;
//   a warp-specialised producer with mbarriers is the next step.
//
//   Any d and F: rows are copied in 16-byte cp.async pieces where they are
//   whole and aligned (d and F multiples of 8: every load), and the
//   pieces of a row that is not (d or F not a multiple of 8, whose rows
//   start on any 2-byte boundary) are predicated element loads with zeros
//   past the row's end (ld8), never a padded copy of the weights; outputs
//   take element stores there (st2).  These and the rank's chunks are
//   compiled into instances of their own (GEN), so the shapes that need
//   neither run code without them.  The resident x and h tiles fit a
//   block's 227 KB up to qwen3's d = 1024, F = 384; wider FFNs (every
//   paper block) run the wide form below: two tensor-core kernels with h
//   in device memory between them.
//
// f32 — CUDA cores (grouped_ffn_kernel<RT>), the body of the port's first
//   version, now for f32 data only: the x and h tiles in shared memory as f32,
//   weight tiles staged through shared memory, FMA loops with each thread
//   owning an (RT x 4) register tile.  It is kept for f32 data because the
//   f32 serve and train agreements hold the kernels to the plain version
//   within 1e-4 of f32, which TF32 or a bf16-rounded h would not meet.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;   // 32 column lanes x 8 row lanes
constexpr int COLS = 128;      // output columns per pass (4 per lane)
constexpr int KT = 32;         // k rows per staged weight tile
constexpr int LOAD = KT * COLS / THREADS;   // tile elements per thread

// acc[i][j] += sum_k A[row_i, k] * W[k, n0 + col_j] for k < K, where
// row_i = ty + 8 i (A in shared memory, row stride lda) and col_j = tx +
// 32 j masked to n < N (W in global memory, row stride ldw).  ws: KT x
// COLS floats of shared staging.  Called by all threads.
template <int RT>
__device__ __forceinline__ void gemm_acc(const float* A, int lda,
                                         const float* __restrict__ W, int ldw,
                                         int K, int n0, int N, float* ws,
                                         float (&acc)[RT][4]) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int lc = tid % COLS, lr = tid / COLS;   // loader column / row phase
  const bool col_ok = n0 + lc < N;
  float pre[LOAD];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < LOAD; ++e) {
      const int k = k0 + lr + e * (THREADS / COLS);
      pre[e] = (col_ok && k < K) ? W[(size_t)k * ldw + n0 + lc] : 0.f;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();                              // previous tile consumed
#pragma unroll
    for (int e = 0; e < LOAD; ++e)
      ws[(lr + e * (THREADS / COLS)) * COLS + lc] = pre[e];
    __syncthreads();
    if (k0 + KT < K) fetch(k0 + KT);              // in flight during compute
    const int kmax = min(KT, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float xv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) xv[i] = A[(ty + 8 * i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = ws[kk * COLS + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][j] += xv[i] * w;
      }
    }
  }
  __syncthreads();                                // ws free for reuse
}

template <int RT>
__device__ __forceinline__ void zero(float (&acc)[RT][4]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Store columns [n0, n0 + 128) of an accumulator tile into a shared
// (TC x N) matrix, masked to n < N.
template <int RT>
__device__ __forceinline__ void store_smem(float* out, int N, int n0,
                                           const float (&acc)[RT][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 32 * j;
    if (n < N) {
#pragma unroll
      for (int i = 0; i < RT; ++i) out[(ty + 8 * i) * N + n] = acc[i][j];
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(THREADS) grouped_ffn_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ index,
    const float* __restrict__ w_inner, const float* __restrict__ w_gate,
    const float* __restrict__ w_outer, const float* __restrict__ li_b,
    const float* __restrict__ li_c, const float* __restrict__ lg_b,
    const float* __restrict__ lg_c, const float* __restrict__ lo_b,
    const float* __restrict__ lo_c, float* __restrict__ y, int S, int d,
    int G, int C, int F, int r, float scale, int act) {
  constexpr int TC = 8 * RT;
  extern __shared__ float smem[];
  float* ws = smem;                 // (KT, COLS) weight staging
  float* xs = ws + KT * COLS;       // (TC, d)
  float* hs = xs + TC * d;          // (TC, F)
  float* xb = hs + TC * F;          // (TC, r)  x B_I
  float* xbg = xb + TC * r;         // (TC, r)  x B_gate
  float* hb = xbg + TC * r;         // (TC, r)  h B_O
  int* rows = reinterpret_cast<int*>(hb + TC * r);

  const int c0 = blockIdx.x * TC, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const bool lora = li_b != nullptr && r > 0;
  const bool gated = w_gate != nullptr;

  if (tid < TC) {
    const int c = c0 + tid;
    const int idx = c < C ? index[((size_t)b * G + g) * C + c] : S;
    rows[tid] = min(idx, S - 1);                     // empty slot: clamp
  }
  __syncthreads();
  for (int e = tid; e < TC * d; e += THREADS) {
    const int c = e / d, kk = e - c * d;
    xs[e] = x[((size_t)b * S + rows[c]) * d + kk];
  }
  // (gemm_acc's leading barrier orders these writes before their reads)
  float acc[RT][4], acc2[RT][4];
  for (int n0 = 0; lora && n0 < r; n0 += COLS) {  // x B, 128 ranks a pass
    zero(acc);
    gemm_acc(xs, d, li_b, r, d, n0, r, ws, acc);
    store_smem(xb, r, n0, acc);
    if (gated) {
      zero(acc);
      gemm_acc(xs, d, lg_b, r, d, n0, r, ws, acc);
      store_smem(xbg, r, n0, acc);
    }
  }

  // h = act(gate) * up over the group's F hidden columns
  const float* wi = w_inner + (size_t)g * d * F;
  const float* wg = gated ? w_gate + (size_t)g * d * F : nullptr;
  for (int f0 = 0; f0 < F; f0 += COLS) {
    zero(acc);
    gemm_acc(xs, d, wi, F, d, f0, F, ws, acc);
    if (lora) {
      zero(acc2);
      gemm_acc(xb, r, li_c + (size_t)g * r * F, F, r, f0, F, ws, acc2);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += scale * acc2[i][j];
    }
    if (gated) {
      zero(acc2);
      gemm_acc(xs, d, wg, F, d, f0, F, ws, acc2);
      if (lora) {
        float acc3[RT][4];
        zero(acc3);
        gemm_acc(xbg, r, lg_c + (size_t)g * r * F, F, r, f0, F, ws, acc3);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[i][j] += scale * acc3[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = gated ? activate(acc2[i][j], act) * acc[i][j]
                          : activate(acc[i][j], act);
    store_smem(hs, F, f0, acc);
  }
  for (int n0 = 0; lora && n0 < r; n0 += COLS) {  // h B_O
    zero(acc);
    gemm_acc(hs, F, lo_b + (size_t)g * F * r, r, F, n0, r, ws, acc);
    store_smem(hb, r, n0, acc);
  }

  // y = h W_O + s (h B_O) C_O in column passes over d
  const float* wo = w_outer + (size_t)g * F * d;
  for (int n0 = 0; n0 < d; n0 += COLS) {
    zero(acc);
    gemm_acc(hs, F, wo, d, F, n0, d, ws, acc);
    if (lora) {
      zero(acc2);
      gemm_acc(hb, r, lo_c, d, r, n0, d, ws, acc2);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 32 * j;
      if (n >= d) continue;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int c = ty + 8 * i;
        if (c0 + c >= C) continue;
        y[(((size_t)b * G + g) * C + c0 + c) * d + n] =
            acc[i][j] + (lora ? scale * acc2[i][j] : 0.f);
      }
    }
  }
}

size_t smem_bytes(int tc, int d, int F, int r) {
  return sizeof(float) * ((size_t)KT * COLS + (size_t)tc * d +
                          (size_t)tc * F + 3 * (size_t)tc * r) +
         sizeof(int) * tc;
}

template <int RT>
int launch(const float* x, const int32_t* index, const float* wi,
           const float* wg, const float* wo, const float* const* lo, float* y,
           int B, int S, int d, int G, int C, int F, int r, float scale,
           int act, size_t bytes, cudaStream_t st) {
  auto kern = grouped_ffn_kernel<RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + 8 * RT - 1) / (8 * RT), G, B);
  kern<<<grid, THREADS, bytes, st>>>(x, index, wi, wg, wo, lo[0], lo[1],
                                     lo[2], lo[3], lo[4], lo[5], y, S, d, G,
                                     C, F, r, scale, act);
  return (int)cudaGetLastError();
}

// The f32 launcher: the largest row tile whose x and h tiles fit the
// 227 KB a block may use.
int launch_f32(const void* x, const void* index, const void* wi,
               const void* wg, const void* wo, const void* const* lo,
               void* y, int B, int S, int d, int G, int C, int F, int r,
               float scale, int act, cudaStream_t st) {
  int rt = 4;
  while (rt > 1 && smem_bytes(8 * rt, d, F, r) > 232448) rt >>= 1;
  const size_t bytes = smem_bytes(8 * rt, d, F, r);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  const float* lf[6] = {f(lo[0]), f(lo[1]), f(lo[2]), f(lo[3]), f(lo[4]),
                        f(lo[5])};
  const int32_t* ix = static_cast<const int32_t*>(index);
  float* yf = static_cast<float*>(y);
  if (rt == 4)
    return launch<4>(f(x), ix, f(wi), f(wg), f(wo), lf, yf, B, S, d, G, C, F,
                     r, scale, act, bytes, st);
  if (rt == 2)
    return launch<2>(f(x), ix, f(wi), f(wg), f(wo), lf, yf, B, S, d, G, C, F,
                     r, scale, act, bytes, st);
  return launch<1>(f(x), ix, f(wi), f(wg), f(wo), lf, yf, B, S, d, G, C, F,
                   r, scale, act, bytes, st);
}


// ----------------------------------------------- bf16: the tensor-core body
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int TM = 64;             // capacity slots per block (wgmma M)
constexpr int THREADS = 256;       // two warpgroups
constexpr int KR = 32;             // contraction rows per pipeline stage
constexpr int STAGES = 3;
constexpr int STAGE = 16384;       // bytes of one stage
constexpr int TILE = 8192;         // one 64 x 64 bf16 A tile (K-major)
constexpr int BLK = KR * 128;      // one 64-column block of a B stage
constexpr int HC = 128;            // hidden columns per phase-1 pass
constexpr int OC = 256;            // output columns per phase-2 pass
constexpr int ALIGN = 1024;        // a 128-byte-swizzle atom

// Byte offset of element (m, k) in K-major A tiles of 64 columns (row m
// of tile k / 64 is 128 bytes; its 16-byte chunks are XOR-swizzled by
// m % 8, the layout wgmma's 128-byte swizzle mode reads).
__device__ __forceinline__ uint32_t a_off(int m, int k) {
  return (k >> 6) * TILE + m * 128 + ((((k & 63) >> 3) ^ (m & 7)) << 4) +
         (k & 7) * 2;
}
// Byte offset of element (k, n) of an MN-major B stage: 64-column blocks
// of KR rows of 128 bytes, chunks swizzled by k % 8.
__device__ __forceinline__ uint32_t b_off(int k, int n) {
  return (n >> 6) * BLK + k * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4) +
         (n & 7) * 2;
}
// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading byte offset (B: the next 64-column block; ignored for K-major
// A) and the stride byte offset (the next 8 rows: 1024 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16-byte async copy; ok == false zero-fills the destination.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Eight bf16 at src, the first n of them in range (n <= 0: none), into
// the 16 bytes of shared memory at dst, zeros past n: one 16-byte cp.async
// where the eight are whole and src is 16-byte aligned (every load when d,
// F and the rank are multiples of 8), else element loads and one 16-byte
// store — the predicated tail of a row whose width is not a multiple of 8
// (such rows start on any 2-byte boundary).
__device__ __forceinline__ void ld8(uint32_t dst, const bf16* src, int n,
                                    const void* dummy) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp16(dst, src, true);
  } else if (n <= 0) {
    cp16(dst, dummy, false);
  } else {
    const unsigned short* e = reinterpret_cast<const unsigned short*>(src);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < n ? __ldg(e + 2 * i) : 0u;
      const uint32_t hi = 2 * i + 1 < n ? __ldg(e + 2 * i + 1) : 0u;
      w[i] = lo | hi << 16;
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}
// Two adjacent outputs at p, the first n of them in range: one 4-byte
// store where both are and p is 4-byte aligned, else element stores.
__device__ __forceinline__ void st2(bf16* p, float a, float b, int n) {
  if (n >= 2 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    if (n >= 1) p[0] = __float2bfloat16(a);
    if (n >= 2) p[1] = __float2bfloat16(b);
  }
}
// The instances without GEN (d, F multiples of 8, rank <= 32: every load
// whole and aligned, U one tile) take cp.async and 4-byte stores as they
// are; with GEN, ld8 and st2.
template <bool GEN>
__device__ __forceinline__ void ld16(uint32_t dst, const bf16* src, int n,
                                     const void* dummy) {
  if constexpr (GEN)
    ld8(dst, src, n, dummy);
  else
    cp16(dst, n > 0 ? src : dummy, n > 0);
}
template <bool GEN>
__device__ __forceinline__ void st2g(bf16* p, float a, float b, int n) {
  if constexpr (GEN)
    st2(p, a, b, n);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// Zeros into rows [c, c + nr) x columns [n0, n0 + nc) of a row-major
// matrix of width d: 16-byte stores where the span allows, else elements.
__device__ __forceinline__ void zero_rows(bf16* y, int d, size_t c, int nr,
                                          int n0, int nc) {
  const bool vec = d % 8 == 0 && n0 % 8 == 0 && nc % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (vec) {
    const int n8 = nc / 8;
    for (int e = threadIdx.x; e < nr * n8; e += blockDim.x) {
      const int m = e / n8;
      *reinterpret_cast<int4*>(y + (c + m) * d + n0 + (e - m * n8) * 8) =
          make_int4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < nr * nc; e += blockDim.x) {
      const int m = e / nc;
      y[(c + m) * d + n0 + (e - m * nc)] = __float2bfloat16(0.f);
    }
  }
}
__device__ __forceinline__ void cp_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}
// Generic-proxy writes (cp.async, st.shared) made visible to wgmma.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads across the wgmma
// wait (the asm above names no registers).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// D (64 x N, f32 registers) += A (64 x 16, K-major) B (16 x N, MN-major),
// both bf16 in shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Accumulator element i of a warpgroup thread: row and column within the
// 64 x N tile (the wgmma f32 accumulator layout).
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// n stages through the ring: load(t, ring stage address) issues stage t's
// cp.async copies, issue(t, address) multiplies it (and waits for its
// wgmma).  Two stages are in flight while one is multiplied; the barrier
// of step t also retires every reader of the buffer stage t + 2 reuses.
template <typename Load, typename Issue>
__device__ __forceinline__ void pipeline(int n, uint32_t ring, Load load,
                                         Issue issue) {
  __syncthreads();                        // the ring's last readers are done
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, ring + s * STAGE);
    cp_commit();
  }
  for (int t = 0; t < n; ++t) {
    cp_wait_stages();
    fence_async();
    __syncthreads();
    const int nt = t + STAGES - 1;
    if (nt < n) load(nt, ring + (nt % STAGES) * STAGE);
    cp_commit();
    issue(t, ring + (t % STAGES) * STAGE);
  }
}

template <bool GATED, bool GEN>
__global__ void __launch_bounds__(THREADS, 1) grouped_ffn_kernel_wgmma(
    const bf16* __restrict__ x, const int32_t* __restrict__ index,
    const bf16* __restrict__ wi, const bf16* __restrict__ wgt,
    const bf16* __restrict__ wo, const bf16* __restrict__ lib,
    const bf16* __restrict__ lic, const bf16* __restrict__ lgb,
    const bf16* __restrict__ lgc, const bf16* __restrict__ lob,
    const bf16* __restrict__ loc, bf16* __restrict__ y, int S, int d, int G,
    int C, int F, int r, float scale, int act) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x, w = tid >> 7;   // w: this thread's warpgroup
  const int c0 = blockIdx.x * TM, b = blockIdx.y, g = blockIdx.z;
  const size_t row0 = ((size_t)b * G + g) * C;  // y / index row of slot 0

  // A tile none of whose slots is kept (index S) writes zero rows (finite,
  // dropped by the combine) and exits.  The plan packs each row's kept
  // slots first, so these are the trailing tiles of each (b, g) row.
  if (!__syncthreads_or(tid < TM && c0 + tid < C &&
                        index[row0 + c0 + tid] < S)) {
    zero_rows(y, d, row0 + c0, min(TM, C - c0), 0, d);
    return;
  }

  const uint32_t s_raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - (s_raw & (ALIGN - 1))) & (ALIGN - 1);
  uint8_t* base = smem_raw + pad;              // generic view
  const uint32_t sb = s_raw + pad;             // shared-window view
  const int nkt = (d + 63) / 64;               // x tiles
  const int nht = 2 * ((F + HC - 1) / HC);     // h tiles
  // [x tiles | later s (h B_O)] [h tiles, the last one first holds
  // s x [B_I | B_gate]] [ring] [row ids]
  const uint32_t xs = 0, he = 0, hs = nkt * TILE;
  const uint32_t xe = hs + (nht - 1) * TILE, ring = hs + nht * TILE;
  int* rows = reinterpret_cast<int*>(base + ring + STAGES * STAGE);
  const bool lora = lib != nullptr && r > 0;

  if (tid < TM) {
    const int c = c0 + tid;
    const int idx = c < C ? index[row0 + c] : S;
    rows[tid] = min(idx, S - 1);               // empty slot: clamp
  }
  __syncthreads();
  {                                            // gather x rows (16 B each)
    const int cpr = nkt * 8;
    for (int e = tid; e < TM * cpr; e += THREADS) {
      const int m = e / cpr, k = (e - m * cpr) * 8;
      ld16<GEN>(sb + xs + a_off(m, k), x + ((size_t)b * S + rows[m]) * d + k,
                d - k, x);
    }
    cp_commit();
  }

  float acc_u[32], acc_g[32];
  const int nk1 = 2 * nkt;                     // stages over d
  const int nk2 = 2 * ((F + 63) / 64);         // stages over F
  // A operand of stage t: tile t / 2 of a K-major region, half t % 2
  auto a_desc = [&](uint32_t region, int t, int kk) {
    return desc(sb + region + (t >> 1) * TILE + (t & 1) * 64 + kk * 32, 16);
  };
  // WG 0 stores s * acc (64 x 64) as a bf16 A tile at `at`.
  auto store_scaled = [&](uint32_t at) {
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(base + at +
                                         a_off(acc_row(i), acc_col(i))) =
          __floats2bfloat162_rn(scale * acc_u[i], scale * acc_u[i + 1]);
  };

  // The LoRA down-projections have one 64-column B block, so their stages
  // hold 4 blocks of KR rows: 128 contraction rows a stage.  64 columns of
  // x [B_I | B_gate] (k < kmax = d rounded up to 64) or h B_O[g] into acc
  // (warpgroup 0).
  auto lora_down = [&](float (&acc)[32], uint32_t a_region, int kmax,
                       auto row_src) {
    zero(acc);
    pipeline(
        (kmax + 4 * KR - 1) / (4 * KR), sb + ring,
        [&](int t, uint32_t buf) {
          for (int e = tid; e < 4 * KR * 8; e += THREADS) {
            const int kr = e >> 3, col = (e & 7) * 8;
            const bf16* src = row_src(t * 4 * KR + kr, col);
            ld16<GEN>(buf + (kr / KR) * BLK + b_off(kr % KR, col),
                      src != nullptr ? src : x, src != nullptr ? 8 : 0, x);
          }
        },
        [&](int t, uint32_t buf) {
          if (w != 0) return;
          reg_fence(acc);
          wg_arrive();
#pragma unroll
          for (int j = 0; j < 8; ++j) {            // k16 steps of the stage
            const int k = t * 4 * KR + j * 16;
            if (k < kmax)
              wgmma_n64(acc,
                        desc(sb + a_region + (k >> 6) * TILE + (k & 63) * 2, 16),
                        desc(buf + (j >> 1) * BLK + (j & 1) * 2048, BLK));
          }
          wg_commit_wait();
          reg_fence(acc);
        });
  };
  // One contraction stage of KR rows of [C_I ; C_gate] from U column kk0
  // (C_I rows kk < r, C_gate rows kk - r), hidden columns [f0, f0 + 128).
  auto load_c = [&](uint32_t buf, int kk0, int f0) {
    for (int e = tid; e < (GATED ? 2 : 1) * KR * 16; e += THREADS) {
      const int prod = e / (KR * 16);          // 0: inner, 1: gate
      const int kr = (e >> 4) & (KR - 1), cc = e & 15;
      const int col = f0 + cc * 8;
      const int j = kk0 + kr - (prod ? r : 0);
      const bool ok = j >= 0 && j < r;
      ld16<GEN>(buf + prod * 2 * BLK + b_off(kr, cc * 8),
                (prod ? lgc : lic) + ((size_t)g * r + (ok ? j : 0)) * F + col,
                ok ? F - col : 0, x);
    }
  };

  if (lora) {                                  // x [B_I | B_gate] (d x 2r)
    lora_down(acc_u, xs, nkt * 64, [&](int k, int col) -> const bf16* {
      if (k >= d || col >= 2 * r || (col >= r && !GATED)) return nullptr;
      return col < r ? lib + (size_t)k * r + col
                     : lgb + (size_t)k * r + col - r;
    });
    if (w == 0) store_scaled(xe);
  }

  // Phase 1: h = act(x W_gate + ...) * (x W_I + ...), 128 hidden columns a
  // pass (64 per warpgroup); the LoRA C rows extend the contraction.
  const int nx1 = lora ? (2 * r + KR - 1) / KR : 0;
  for (int f0 = 0; f0 < F; f0 += HC) {
    zero(acc_u);
    zero(acc_g);
    pipeline(
        nk1 + nx1, sb + ring,
        [&](int t, uint32_t buf) {
          if (t >= nk1) {                      // rows of [C_I ; C_gate]
            load_c(buf, (t - nk1) * KR, f0);
            return;
          }
          for (int e = tid; e < (GATED ? 2 : 1) * KR * 16; e += THREADS) {
            const int prod = e / (KR * 16);    // 0: inner, 1: gate
            const int kr = (e >> 4) & (KR - 1), cc = e & 15;
            const int col = f0 + cc * 8;
            const int k = t * KR + kr;
            ld16<GEN>(buf + prod * 2 * BLK + b_off(kr, cc * 8),
                      (prod ? wgt : wi) + ((size_t)g * d + (k < d ? k : 0)) * F + col,
                      k < d ? F - col : 0, x);
          }
        },
        [&](int t, uint32_t buf) {
          reg_fence(acc_u);
          reg_fence(acc_g);
          wg_arrive();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint64_t a = t < nk1 ? a_desc(xs, t, kk)
                                       : desc(sb + xe + (t - nk1) * 64 + kk * 32, 16);
            wgmma_n64(acc_u, a, desc(buf + w * BLK + kk * 2048, BLK));
            if constexpr (GATED)
              wgmma_n64(acc_g, a, desc(buf + (2 + w) * BLK + kk * 2048, BLK));
          }
          wg_commit_wait();
          reg_fence(acc_u);
          reg_fence(acc_g);
        });
    __syncthreads();                           // XE's tile is read until here
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float h0 = activate(GATED ? acc_g[i] : acc_u[i], act);
      float h1 = activate(GATED ? acc_g[i + 1] : acc_u[i + 1], act);
      if (GATED) {
        h0 *= acc_u[i];
        h1 *= acc_u[i + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(
          base + hs + a_off(acc_row(i), f0 + w * 64 + acc_col(i))) =
          __floats2bfloat162_rn(h0, h1);
    }
  }

  if (lora) {                                  // h B_O[g] (F x r)
    lora_down(acc_u, hs, nht * 64, [&](int k, int col) -> const bf16* {
      if (k >= F || col >= r) return nullptr;
      return lob + ((size_t)g * F + k) * r + col;
    });
    if (w == 0) store_scaled(he);              // x tiles are dead by now
  }

  // Phase 2: y = h W_O[g] + s (h B_O) C_O, 256 output columns a pass (128
  // per warpgroup).
  float acc_y[64];
  const int nx2 = lora ? 1 : 0;
  for (int n0 = 0; n0 < d; n0 += OC) {
    zero(acc_y);
    pipeline(
        nk2 + nx2, sb + ring,
        [&](int t, uint32_t buf) {
          for (int e = tid; e < KR * 32; e += THREADS) {
            const int kr = e >> 5, cc = e & 31, col = n0 + cc * 8;
            const int k = t * KR + kr;
            const int j = (t - nk2) * KR + kr;        // a row of C_O
            const bool ok = t < nk2 ? k < F : j < r;
            ld16<GEN>(buf + b_off(kr, cc * 8),
                      !ok ? x : t < nk2 ? wo + ((size_t)g * F + k) * d + col
                                        : loc + (size_t)j * d + col,
                      ok ? d - col : 0, x);
          }
        },
        [&](int t, uint32_t buf) {
          reg_fence(acc_y);
          wg_arrive();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint64_t a = t < nk2 ? a_desc(hs, t, kk)
                                       : desc(sb + he + kk * 32, 16);
            wgmma_n128(acc_y, a, desc(buf + 2 * w * BLK + kk * 2048, BLK));
          }
          wg_commit_wait();
          reg_fence(acc_y);
        });
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int c = c0 + acc_row(i), n = n0 + w * 128 + acc_col(i);
      if (c < C && n < d)
        st2g<GEN>(y + (row0 + c) * d + n, acc_y[i], acc_y[i + 1], d - n);
    }
  }
}

// ------------------------------- the wide form: two passes through h
// Where the resident x and h tiles above exceed a block's shared memory
// (every paper block: d >= 1024 with F >= 512), the same function runs
// as two tensor-core kernels with h (B, G, C, F) in bf16 device memory
// between them.  Both stream their A operand as well as the weights
// through a 3-stage cp.async ring of 64-row stages: an A slice of 64
// slots x 64 contraction columns (one swizzled K-major tile) beside
// 64-row MN-major weight blocks.  Per 64-slot tile (kept tiles only, as
// above):
//   up:   one block per 128 hidden columns: x rows gathered per stage,
//         x W_I (and x W_gate) by m64n64k16, one warpgroup per 64
//         columns; LoRA: s x [B_I | B_gate] first (one pass over d),
//         then one extra stage of [C_I ; C_gate] rows; act (x gate) in
//         f32, h rounded to bf16 (as the resident body rounds it).  Past
//         rank 32, 64 of U's columns at a time through the one tile, a
//         pass over d and a stage of C rows each, after the main product.
//   down: one block per 256 output columns: h W_O[g] by m64n128k16;
//         LoRA: s h B_O[g] (one pass over F), then one stage of C_O rows;
//         past rank 64, 64 ranks at a time the same way.
//         A tile that keeps no slot writes zeros here.
constexpr int KS = 64;                   // contraction rows per stage
constexpr int WBLK = KS * 128;           // one 64-column B block (8 KB)
constexpr int WSTAGE = TILE + 4 * WBLK;  // A slice + 256 B columns: 40 KB

__device__ __forceinline__ uint32_t bw_off(int k, int n) {
  return (n >> 6) * WBLK + k * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4) +
         (n & 7) * 2;
}

// pipeline() over WSTAGE-byte stages.
template <typename Load, typename Issue>
__device__ __forceinline__ void pipeline_w(int n, uint32_t ring, Load load,
                                           Issue issue) {
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, ring + s * WSTAGE);
    cp_commit();
  }
  for (int t = 0; t < n; ++t) {
    cp_wait_stages();
    fence_async();
    __syncthreads();
    const int nt = t + STAGES - 1;
    if (nt < n) load(nt, ring + (nt % STAGES) * WSTAGE);
    cp_commit();
    issue(t, ring + (t % STAGES) * WSTAGE);
  }
}

// Warpgroup 0's 64 x 64 product of a stage's A slice (K = 64) with its
// first B block, into acc.
__device__ __forceinline__ void mma_slice_n64(float (&acc)[32],
                                              uint32_t a_tile,
                                              uint32_t b_block) {
  reg_fence(acc);
  wg_arrive();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_n64(acc, desc(a_tile + kk * 32, 16), desc(b_block + kk * 2048, WBLK));
  wg_commit_wait();
  reg_fence(acc);
}

// s * acc (64 x 64) as a bf16 K-major A tile at `at` (warpgroup 0); lo:
// the part of s * acc its bf16 rounding leaves out, bf16(v - bf16(v)).
__device__ __forceinline__ void store_scaled_tile(uint8_t* at, float scale,
                                                  const float (&acc)[32],
                                                  bool lo = false) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    float a = scale * acc[i], b = scale * acc[i + 1];
    if (lo) {
      const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(a, b));
      a -= hi.x;
      b -= hi.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(at + a_off(acc_row(i), acc_col(i))) =
        __floats2bfloat162_rn(a, b);
  }
}

// Whether any of the 64 slots from c0 is kept (index < S); every thread
// of the block gets the answer.
__device__ __forceinline__ bool tile_kept(const int32_t* __restrict__ index,
                                          size_t row0, int c0, int C, int S) {
  const int tid = threadIdx.x;
  return __syncthreads_or(tid < TM && c0 + tid < C &&
                          index[row0 + c0 + tid] < S);
}

template <bool GATED, bool GEN>
__global__ void __launch_bounds__(THREADS, 1) grouped_ffn_wide_up_wgmma(
    const bf16* __restrict__ x, const int32_t* __restrict__ index,
    const bf16* __restrict__ wi, const bf16* __restrict__ wgt,
    const bf16* __restrict__ lib, const bf16* __restrict__ lic,
    const bf16* __restrict__ lgb, const bf16* __restrict__ lgc,
    bf16* __restrict__ h, bf16* __restrict__ hl, int S, int d, int G, int C,
    int F, int r, float scale, int act, int n_ct) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x, w = tid >> 7;
  const int c0 = (blockIdx.x % n_ct) * TM, f0 = (blockIdx.x / n_ct) * HC;
  const int b = blockIdx.y, g = blockIdx.z;
  const size_t row0 = ((size_t)b * G + g) * C;
  if (!tile_kept(index, row0, c0, C, S)) return;  // its h rows go unread

  const uint32_t s_raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - (s_raw & (ALIGN - 1))) & (ALIGN - 1);
  uint8_t* base = smem_raw + pad;
  const uint32_t sb = s_raw + pad;
  // [s x [B_I | B_gate] tile] [ring] [row ids]
  const uint32_t xe = 0, ring = TILE;
  int* rows = reinterpret_cast<int*>(base + ring + STAGES * WSTAGE);
  const bool lora = lib != nullptr && r > 0;
  if (tid < TM) {
    const int c = c0 + tid;
    rows[tid] = min(c < C ? index[row0 + c] : S, S - 1);   // empty: clamp
  }
  __syncthreads();
  const int nk = (d + KS - 1) / KS;
  auto load_x = [&](int t, uint32_t buf) {        // x columns [64 t, +64)
    for (int e = tid; e < TM * 8; e += THREADS) {
      const int m = e >> 3, k = t * KS + (e & 7) * 8;
      ld16<GEN>(buf + a_off(m, (e & 7) * 8),
                x + ((size_t)b * S + rows[m]) * d + k, d - k, x);
    }
  };
  // s x [B_I | B_gate] columns [c0u, c0u + 64) (B_gate's from column r)
  // into acc (warpgroup 0), then as a bf16 A tile at XE.
  auto lora_u = [&](float (&acc)[32], int c0u) {
    zero(acc);
    pipeline_w(
        nk, sb + ring,
        [&](int t, uint32_t buf) {
          load_x(t, buf);
          for (int e = tid; e < KS * 8; e += THREADS) {
            const int kr = e >> 3, col = (e & 7) * 8, k = t * KS + kr;
            const int uc = c0u + col;
            const bool ok = k < d && (uc < r || (GATED && uc < 2 * r));
            const bf16* src = uc < r ? lib + (size_t)k * r + uc
                                     : lgb + (size_t)k * r + uc - r;
            ld16<GEN>(buf + TILE + bw_off(kr, col), ok ? src : x, ok ? 8 : 0, x);
          }
        },
        [&](int t, uint32_t buf) {
          if (w == 0) mma_slice_n64(acc, buf, buf + TILE);
        });
    if (w == 0) store_scaled_tile(base + xe, scale, acc);
  };
  // KS rows of [C_I ; C_gate] from U column kk0 (C_I rows kk < r, C_gate
  // rows kk - r), this block's hidden columns.
  auto load_c = [&](uint32_t buf, int kk0) {
    for (int e = tid; e < (GATED ? 2 : 1) * KS * 16; e += THREADS) {
      const int prod = e / (KS * 16);
      const int kr = (e >> 4) & (KS - 1), cc = e & 15, col = f0 + cc * 8;
      const int j = kk0 + kr - (prod ? r : 0);
      const bool ok = j >= 0 && j < r;
      ld16<GEN>(buf + TILE + prod * 2 * WBLK + bw_off(kr, cc * 8),
                (prod ? lgc : lic) + ((size_t)g * r + (ok ? j : 0)) * F + col,
                ok ? F - col : 0, x);
    }
  };
  // x W (and the C rows) against the A slice or the XE tile at a
  auto mma_up = [&](float (&au)[32], float (&ag)[32], uint32_t a,
                    uint32_t buf) {
    reg_fence(au);
    reg_fence(ag);
    wg_arrive();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_n64(au, desc(a + kk * 32, 16),
                desc(buf + TILE + w * WBLK + kk * 2048, WBLK));
      if constexpr (GATED)
        wgmma_n64(ag, desc(a + kk * 32, 16),
                  desc(buf + TILE + (2 + w) * WBLK + kk * 2048, WBLK));
    }
    wg_commit_wait();
    reg_fence(au);
    reg_fence(ag);
  };

  // U = x [B_I | B_gate] (64 x 2r).  Without GEN (ranks up to 32): one
  // XE tile, computed first, its C rows one stage of the main pipeline.
  // With GEN: 64 columns at a time after the main product, each a pass
  // over d, then its C rows against U's bf16 halves in turn (bf16(U), then
  // bf16(U - bf16(U))), so U enters the sum to ~2^-16 of itself.
  const int nuc = lora ? (2 * r + 63) / 64 : 0;
  const bool once = !GEN && nuc == 1;
  float acc_u[32], acc_g[32];
  if (once) lora_u(acc_u, 0);

  // x W_I (and x W_gate) over d, then the [C_I ; C_gate] rows against
  // the s x B tile; columns [f0 + 64 w, +64) per warpgroup.
  zero(acc_u);
  zero(acc_g);
  pipeline_w(
      nk + (once ? 1 : 0), sb + ring,
      [&](int t, uint32_t buf) {
        if (t >= nk) {                             // rows of [C_I ; C_gate]
          load_c(buf, 0);
          return;
        }
        load_x(t, buf);
        for (int e = tid; e < (GATED ? 2 : 1) * KS * 16; e += THREADS) {
          const int prod = e / (KS * 16);          // 0: inner, 1: gate
          const int kr = (e >> 4) & (KS - 1), cc = e & 15, col = f0 + cc * 8;
          const int k = t * KS + kr;
          ld16<GEN>(buf + TILE + prod * 2 * WBLK + bw_off(kr, cc * 8),
                    (prod ? wgt : wi) + ((size_t)g * d + (k < d ? k : 0)) * F + col,
                    k < d ? F - col : 0, x);
        }
      },
      [&](int t, uint32_t buf) {
        mma_up(acc_u, acc_g, t < nk ? buf : sb + xe, buf);
      });
  for (int cu = 0; GEN && cu < nuc; ++cu) {
    float acc_l[32];
    lora_u(acc_l, 64 * cu);                        // its hi half at XE
    for (int half = 0; half < 2; ++half) {
      if (half) {
        __syncthreads();                           // XE's hi half read
        if (w == 0) store_scaled_tile(base + xe, scale, acc_l, true);
      }
      pipeline_w(
          1, sb + ring, [&](int, uint32_t buf) { load_c(buf, 64 * cu); },
          [&](int, uint32_t buf) { mma_up(acc_u, acc_g, sb + xe, buf); });
    }
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int c = c0 + acc_row(i), f = f0 + w * 64 + acc_col(i);
    if (c >= C || f >= F) continue;
    float h0 = activate(GATED ? acc_g[i] : acc_u[i], act);
    float h1 = activate(GATED ? acc_g[i + 1] : acc_u[i + 1], act);
    if (GATED) {
      h0 *= acc_u[i];
      h1 *= acc_u[i + 1];
    }
    if constexpr (GEN) {             // h's bf16 halves: hi to h, lo to hl
      const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(h0, h1));
      st2g<GEN>(h + (row0 + c) * F + f, hi.x, hi.y, F - f);
      st2g<GEN>(hl + (row0 + c) * F + f, h0 - hi.x, h1 - hi.y, F - f);
    } else {
      st2g<GEN>(h + (row0 + c) * F + f, h0, h1, F - f);
    }
  }
}

template <bool GEN>
__global__ void __launch_bounds__(THREADS, 1) grouped_ffn_wide_down_wgmma(
    const bf16* __restrict__ h, const bf16* __restrict__ hl,
    const int32_t* __restrict__ index, const bf16* __restrict__ wo,
    const bf16* __restrict__ lob, const bf16* __restrict__ loc,
    bf16* __restrict__ y, int S, int d, int G, int C, int F, int r,
    float scale, int n_ct) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x, w = tid >> 7;
  const int c0 = (blockIdx.x % n_ct) * TM, n0 = (blockIdx.x / n_ct) * OC;
  const int b = blockIdx.y, g = blockIdx.z;
  const size_t row0 = ((size_t)b * G + g) * C;
  if (!tile_kept(index, row0, c0, C, S)) {         // zero rows, dropped
    zero_rows(y, d, row0 + c0, min(TM, C - c0), n0, min(OC, d - n0));
    return;
  }

  const uint32_t s_raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - (s_raw & (ALIGN - 1))) & (ALIGN - 1);
  uint8_t* base = smem_raw + pad;
  const uint32_t sb = s_raw + pad;
  const uint32_t he = 0, ring = TILE;              // [s h B_O tile] [ring]
  const bool lora = lob != nullptr && r > 0;
  const int nk = (F + KS - 1) / KS;
  // stages over h: its columns, then with GEN its lo half's (the same W_O
  // and B_O rows again)
  const int nkh = GEN ? 2 * nk : nk;
  auto load_h = [&](int t, uint32_t buf) {        // h columns [64 t, +64)
    const bf16* src = t < nk ? h : hl;
    t = t < nk ? t : t - nk;
    for (int e = tid; e < TM * 8; e += THREADS) {
      const int m = e >> 3, k = t * KS + (e & 7) * 8, c = c0 + m;
      ld16<GEN>(buf + a_off(m, (e & 7) * 8),
                src + (row0 + (c < C ? c : c0)) * F + k, c < C ? F - k : 0, h);
    }
  };
  // s h B_O[g] ranks [c0v, c0v + 64) into acc_l (warpgroup 0), then as a
  // bf16 A tile at HE
  auto lora_v = [&](float (&acc_l)[32], int c0v) {
    zero(acc_l);
    pipeline_w(
        nkh, sb + ring,
        [&](int t, uint32_t buf) {
          load_h(t, buf);
          for (int e = tid; e < KS * 8; e += THREADS) {
            const int kr = e >> 3, col = (e & 7) * 8;
            const int k = (t < nk ? t : t - nk) * KS + kr;
            const int rc = c0v + col;
            const bool ok = k < F && rc < r;
            ld16<GEN>(buf + TILE + bw_off(kr, col),
                      ok ? lob + ((size_t)g * F + k) * r + rc : h, ok ? 8 : 0, h);
          }
        },
        [&](int t, uint32_t buf) {
          if (w == 0) mma_slice_n64(acc_l, buf, buf + TILE);
        });
    if (w == 0) store_scaled_tile(base + he, scale, acc_l);
  };
  // KS rows of W_O[g] from row k0, or (co) of C_O from rank k0
  auto load_w = [&](uint32_t buf, int k0, bool co) {
    for (int e = tid; e < KS * 32; e += THREADS) {
      const int kr = e >> 5, cc = e & 31, col = n0 + cc * 8, k = k0 + kr;
      const bool ok = co ? k < r : k < F;
      ld16<GEN>(buf + TILE + bw_off(kr, cc * 8),
                !ok ? h : co ? loc + (size_t)k * d + col
                             : wo + ((size_t)g * F + k) * d + col,
                ok ? d - col : 0, h);
    }
  };
  auto mma_down = [&](float (&acc_y)[64], uint32_t a, uint32_t buf) {
    reg_fence(acc_y);
    wg_arrive();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n128(acc_y, desc(a + kk * 32, 16),
                 desc(buf + TILE + 2 * w * WBLK + kk * 2048, WBLK));
    wg_commit_wait();
    reg_fence(acc_y);
  };
  // V = s h B_O.  Without GEN (ranks up to 32) one HE tile first, its C_O
  // rows one stage of the main pipeline.  With GEN: 64 ranks at a time
  // after it, each a pass over h's halves, then its C_O rows against V's
  // bf16 halves in turn, as U's above.
  const int nvc = lora ? (r + 63) / 64 : 0;
  const bool once = !GEN && nvc == 1;
  float acc_y[64];
  if (once) {
    float acc_l[32];
    lora_v(acc_l, 0);
  }

  zero(acc_y);
  pipeline_w(
      nkh + (once ? 1 : 0), sb + ring,
      [&](int t, uint32_t buf) {
        if (t < nkh) {
          load_h(t, buf);
          load_w(buf, (t < nk ? t : t - nk) * KS, false);
        } else {
          load_w(buf, 0, true);
        }
      },
      [&](int t, uint32_t buf) {
        mma_down(acc_y, t < nkh ? buf : sb + he, buf);
      });
  for (int cv = 0; GEN && cv < nvc; ++cv) {
    float acc_l[32];
    lora_v(acc_l, 64 * cv);                        // its hi half at HE
    for (int half = 0; half < 2; ++half) {
      if (half) {
        __syncthreads();                           // HE's hi half read
        if (w == 0) store_scaled_tile(base + he, scale, acc_l, true);
      }
      pipeline_w(
          1, sb + ring, [&](int, uint32_t buf) { load_w(buf, 64 * cv, true); },
          [&](int, uint32_t buf) { mma_down(acc_y, sb + he, buf); });
    }
  }
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int c = c0 + acc_row(i), n = n0 + w * 128 + acc_col(i);
    if (c < C && n < d)
      st2g<GEN>(y + (row0 + c) * d + n, acc_y[i], acc_y[i + 1], d - n);
  }
}

size_t wide_smem_bytes() {
  return ALIGN + TILE + (size_t)STAGES * WSTAGE + TM * sizeof(int);
}

template <bool GATED, bool GEN>
int launch_wide(const void* x, const void* index, const void* wi,
                const void* wgt, const void* wo, const void* const* lo,
                void* h, void* y, int B, int S, int d, int G, int C, int F,
                int r, float scale, int act, cudaStream_t st) {
  const size_t bytes = wide_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      grouped_ffn_wide_up_wgmma<GATED, GEN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_ffn_wide_down_wgmma<GEN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  if (err != cudaSuccess) return (int)err;
  auto p = [](const void* q) { return static_cast<const bf16*>(q); };
  const int32_t* ix = static_cast<const int32_t*>(index);
  const int n_ct = (C + TM - 1) / TM;
  // a group's blocks adjacent, as in the resident body
  // with GEN, h's lo half follows its hi half in the scratch
  bf16* hh = static_cast<bf16*>(h);
  bf16* hl = GEN ? hh + (size_t)B * G * C * F : nullptr;
  grouped_ffn_wide_up_wgmma<GATED, GEN>
      <<<dim3(n_ct * ((F + HC - 1) / HC), B, G), THREADS, bytes, st>>>(
          p(x), ix, p(wi), p(wgt), p(lo[0]), p(lo[1]), p(lo[2]), p(lo[3]),
          hh, hl, S, d, G, C, F, r, scale, act, n_ct);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grouped_ffn_wide_down_wgmma<GEN><<<dim3(n_ct * ((d + OC - 1) / OC), B, G),
                                     THREADS, bytes, st>>>(
      hh, hl, ix, p(wo), p(lo[4]), p(lo[5]), static_cast<bf16*>(y), S, d, G,
      C, F, r, scale, n_ct);
  return (int)cudaGetLastError();
}

size_t smem_bytes(int d, int F) {
  const int nkt = (d + 63) / 64, nht = 2 * ((F + HC - 1) / HC);
  return ALIGN + (size_t)(nkt + nht) * TILE + (size_t)STAGES * STAGE +
         TM * sizeof(int);
}

template <bool GATED, bool GEN>
int launch_k(const void* x, const void* index, const void* wi,
             const void* wgt, const void* wo, const void* const* lo, void* y,
             int B, int S, int d, int G, int C, int F, int r, float scale,
             int act, size_t bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_ffn_kernel_wgmma<GATED, GEN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  auto p = [](const void* q) { return static_cast<const bf16*>(q); };
  dim3 grid((C + TM - 1) / TM, B, G);          // one group's tiles adjacent
  grouped_ffn_kernel_wgmma<GATED, GEN><<<grid, THREADS, bytes, st>>>(
      p(x), static_cast<const int32_t*>(index), p(wi), p(wgt), p(wo),
      p(lo[0]), p(lo[1]), p(lo[2]), p(lo[3]), p(lo[4]), p(lo[5]),
      static_cast<bf16*>(y), S, d, G, C, F, r, scale, act);
  return (int)cudaGetLastError();
}

// The resident body when its x and h tiles fit a block's shared memory
// and U fits its one tile (ranks up to 32; past that the wide form).
bool resident_fits(int d, int F, int r) {
  return smem_bytes(d, F) <= 232448 && r <= 32;
}

// The GEN instances: tails (d or F not a multiple of 8), or the rank
// past one U tile.
bool gen_of(int d, int F, int r) { return d % 8 || F % 8 || r > 32; }

int launch(const void* x, const void* index, const void* wi, const void* wgt,
           const void* wo, const void* const* lo, void* h, void* y, int B,
           int S, int d, int G, int C, int F, int r, float scale, int act,
           cudaStream_t st) {
  if (r % 8 || B > 65535 || G > 65535) return (int)cudaErrorInvalidValue;
  const bool gen = gen_of(d, F, r);
  const bool gated = wgt != nullptr;
  if (!resident_fits(d, F, r)) {
    if (h == nullptr) return (int)cudaErrorInvalidValue;
#define REPRO_WIDE(GATED, GEN)                                              \
  launch_wide<GATED, GEN>(x, index, wi, wgt, wo, lo, h, y, B, S, d, G, C,   \
                          F, r, scale, act, st)
    return gated ? (gen ? REPRO_WIDE(true, true) : REPRO_WIDE(true, false))
                 : (gen ? REPRO_WIDE(false, true) : REPRO_WIDE(false, false));
#undef REPRO_WIDE
  }
  const size_t bytes = smem_bytes(d, F);
#define REPRO_RESIDENT(GATED, GEN)                                          \
  launch_k<GATED, GEN>(x, index, wi, wgt, wo, lo, y, B, S, d, G, C, F, r,   \
                       scale, act, bytes, st)
  return gated ? (gen ? REPRO_RESIDENT(true, true) : REPRO_RESIDENT(true, false))
               : (gen ? REPRO_RESIDENT(false, true)
                      : REPRO_RESIDENT(false, false));
#undef REPRO_RESIDENT
}

}  // namespace wg

}  // namespace

// Elements of h scratch per capacity slot the launcher needs at a LoRA
// rank r (padded to 8; 0 without LoRA): where the bf16 body takes its
// wide form, F (h (B, G, C, F) bf16 between its two kernels), 2 F in its
// GEN instances (h's lo half after it); else 0.
extern "C" int repro_grouped_ffn_h_elems(int dtype, int d, int F, int r) {
  if (dtype != 1 || wg::resident_fits(d, F, r)) return 0;
  return wg::gen_of(d, F, r) ? 2 * F : F;
}

// dtype 0 = float32: x, weights, y and the LoRA leaves in float32 (CUDA-core
// body, any rank).  dtype 1 = bfloat16: x, weights, y and the LoRA leaves
// in bfloat16 (tensor-core body; any d and F, the rank padded to a
// multiple of 8, the LoRA leaves 16-byte aligned; h: bf16 scratch of
// repro_grouped_ffn_h_elems(...) per slot, null when that is 0).  w_gate
// null = ungated; li_b null = no LoRA (then all LoRA pointers are
// ignored).  act: 0 relu, 1 gelu (tanh), 2 silu.
extern "C" int repro_grouped_ffn(
    int dtype, const void* x, const void* index, const void* w_inner,
    const void* w_gate, const void* w_outer, const void* li_b,
    const void* li_c, const void* lg_b, const void* lg_c, const void* lo_b,
    const void* lo_c, void* h, void* y, int B, int S, int d, int G, int C,
    int F, int r, float scale, int act, void* stream) {
  const int lr = li_b != nullptr ? r : 0;
  if (B < 1 || S < 1 || d < 1 || G < 1 || C < 1 || F < 1 || lr < 0 ||
      act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* lo[6] = {li_b, li_c, lg_b, lg_c, lo_b, lo_c};
  if (dtype == 1)
    return wg::launch(x, index, w_inner, w_gate, w_outer, lo, h, y, B, S, d,
                      G, C, F, lr, scale, act, st);
  if (dtype == 0)
    return launch_f32(x, index, w_inner, w_gate, w_outer, lo, y, B, S, d, G,
                      C, F, lr, scale, act, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory the launcher asks for at (dtype, d, F, rank): the
// bf16 resident body's, or its wide form's where that does not fit; the
// f32 body's at the largest row tile that fits (r = 0 without LoRA).
extern "C" int repro_grouped_ffn_smem(int dtype, int d, int F, int r) {
  if (dtype == 1)
    return (int)(wg::resident_fits(d, F, r) ? wg::smem_bytes(d, F)
                                            : wg::wide_smem_bytes());
  int rt = 4;
  while (rt > 1 && smem_bytes(8 * rt, d, F, r) > 232448) rt >>= 1;
  return (int)smem_bytes(8 * rt, d, F, r);
}
