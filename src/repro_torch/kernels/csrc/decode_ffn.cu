// Decode-shaped routed FFN (one token per sequence, no dispatch plan) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel decode_ffn_kernel
// (src/repro/kernels/routed_ffn/routed_ffn.py:344, its pl.pallas_call at
// :410).
//
// Computes y[b] = sum_a gate[b,a] * ( h_a W_O[c_a] + s (h_a B_O[c_a]) C_O )
// with c_a = choice[b, a] and
//   h_a = act(x W_gate[c_a] + s (x B_gate) C_gate[c_a])
//         * (x W_I[c_a] + s (x B_I) C_I[c_a])        (ungated: act(up)).
//
// What bounds it: memory.  At one token per slot the arithmetic is 2
// flops per weight element per slot that chose the group, so the least
// time is each chosen group's weights (3 d F elements) streamed once.
// Design: group-major.  Every block of the two weight passes belongs to
// one group g and first lists, with a warp ballot over the choices, the
// (slot, choice) pairs that chose g (slot ascending, then choice; no host
// sync).  Blocks of a group no slot chose exit at once.  Each 16-byte
// weight load (8 rows in flight per thread) then feeds every pair of the
// group, up to 8 per pass, so a launch reads each touched group's weights
// once.  Every sum has a fixed order (warp shuffles, then warps, then
// column blocks, then choices a = 0..G'-1), and nothing uses atomics:
//   1. h, one block per (g, 32 hidden columns), the whole d contraction:
//      x W_I and x W_gate for the group's pairs (half the threads on each
//      matrix; the pairs' x staged in shared memory as f32 where that
//      fits, else bf16 x as stored — exact, and half the room, so d =
//      6144 fits), x B_I and x B_gate (16-byte loads of the 64 KB B rows,
//      which L2 holds after the first block; each column block forms them
//      for its pairs, which costs less than a pass of their own), the
//      LoRA term s (x B) C[g] and act -> h (B*G', F), f32 scratch;
//   2. h_a W_O[g], one block per (g, 64 output columns), all F rows; each
//      block also sums h_a B_O[g] over its share of the F rows (coalesced
//      reads of B_O rows), so that term is formed once per (slot, choice).
//      h is staged in f32: whole rows where PMAX of them fit, else chunks
//      of FCH columns (F = 16,384 and 32,768 at the MoE widths), each
//      thread's accumulators carried across the chunks, whose length is a
//      multiple of its row stride, so every sum keeps its order; the
//      block's B_O rows then take their h rows staged anew, FCH at a time;
//   3. y, one block per (slot, 128 output columns): the blocks' shares of
//      h_a B_O summed, s (h_a B_O) C_O added, and the G' choices summed in
//      order with their gates.
// One body for f32 and bf16 data (16-byte weight loads of 4 or 8
// elements).  Needs d and F to be multiples of 8 and the LoRA rank a
// multiple of 4; f32 x must fit pass 1's shared memory (d up to ~6,100:
// routed_ffn/ops.py states the limit).
#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;               // weight passes
constexpr int WARPS = THREADS / 32;
constexpr int SMALL = 128;                 // pass 3
constexpr int VEC = 8;                     // columns per thread
constexpr int PMAX = 8;                    // pairs per weight pass
constexpr int R_MAX = 64;                  // LoRA rank
constexpr int HC = 32;                     // pass 1: hidden columns/block
constexpr int OC = 64;                     // pass 2: output columns/block
constexpr int OFS = THREADS / (OC / VEC);  // pass 2: 32 f-slices
constexpr int LB = 16;                     // LoRA rows in flight
constexpr int FCH = 2048;                  // pass 2: h columns a chunk
constexpr int SMEM_MAX = 232448;           // a block's shared memory

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Scratch layout (f32); the wrapper (routed_ffn/ops.py, _decode_scratch)
// gives its size.  The regions read as 16-byte vectors come first.
struct Scratch {
  float *h, *p2, *p2h;
  __host__ __device__ Scratch(float* s, int BGA, int F, int d) {
    h = s;                                           // (BGA, F)
    p2 = h + (size_t)BGA * F;                        // (BGA, d)
    p2h = p2 + (size_t)BGA * d;                      // (d/OC, BGA, r)
  }
};

// The (slot, choice) pairs that chose group g, in order (slot ascending,
// then choice), into list; returns their number.  Warp 0 compacts the
// choices 32 at a time with a ballot.
__device__ __forceinline__ int group_pairs(const int32_t* choice, int BGA,
                                           int g, int* list, int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int i0 = 0; i0 < BGA; i0 += 32) {
      const bool hit = i0 + lane < BGA && choice[i0 + lane] == g;
      const unsigned m = __ballot_sync(FULL_MASK, hit);
      if (hit) list[n + __popc(m & ((1u << lane) - 1))] = i0 + lane;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// Eight consecutive elements held as loaded (16 bytes of bf16 or 32 of
// f32), so that a thread can have several rows in flight before it
// converts any.
template <typename T> struct Row8;
template <> struct Row8<__nv_bfloat16> {
  static constexpr int UNROLL = 8;           // rows in flight per thread
  int4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ void get(float out[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Row8<float> {
  static constexpr int UNROLL = 4;
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float out[8]) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

// vals[p][0, n) = src[ids[p] / div * ld_src + 0, n) in XS (f32, or T as
// stored), 16 bytes of src at a time (n * sizeof(T) % 16 == 0, 16-byte
// aligned rows).
template <typename XS, typename T>
__device__ __forceinline__ void stage_rows(XS* vals, int ld, const T* src,
                                           size_t ld_src, const int* ids,
                                           int div, int np, int n) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = n / E;
  for (int e = threadIdx.x; e < np * chunks; e += blockDim.x) {
    const int p = e / chunks, c = e - p * chunks;
    const T* row = src + (size_t)(ids[p] / div) * ld_src + c * E;
    XS* out = vals + (size_t)p * ld + c * E;
    if constexpr (std::is_same<XS, T>::value) {
      *reinterpret_cast<int4*>(out) = __ldg(reinterpret_cast<const int4*>(row));
    } else {
      Row8<T> v;                                // bf16 -> f32, 8 at a time
      v.load(row);
      float f8[VEC];
      v.get(f8);
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = f8[j];
    }
  }
}

// out[ids[p] * ostride + q] = sum_{k0 <= k < k1} vals[p][k - k0] lo[k r + q]
// for the np pairs: thread (q = tid % r, slice tid / r) takes rows k0 +
// slice, + THREADS / r, ... (LB loads in flight, coalesced over q), and
// the slices are summed in order.  vals: the pairs' inputs in shared
// memory, row p at p * ld.  red: PMAX * THREADS floats of shared memory.
// add: add the sums to out (a later chunk of the rows) instead of storing.
__device__ __forceinline__ void lora_down(const float* vals, int ld, int np,
                                          const float* __restrict__ lo,
                                          int r, int k0, int k1, float* red,
                                          const int* ids, float* out,
                                          size_t ostride, bool add) {
  const int tid = threadIdx.x, q = tid % r, sl = tid / r, nsl = THREADS / r;
  if (sl < nsl) {
    float acc[PMAX];
#pragma unroll
    for (int p = 0; p < PMAX; ++p) acc[p] = 0.f;
    for (int k = k0 + sl; k < k1; k += LB * nsl) {
      float v[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int kk = k + u * nsl;
        v[u] = kk < k1 ? lo[(size_t)kk * r + q] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int kk = k + u * nsl;
        if (kk >= k1) break;
#pragma unroll
        for (int p = 0; p < PMAX; ++p)
          if (p < np) acc[p] += vals[p * ld + kk - k0] * v[u];
      }
    }
#pragma unroll
    for (int p = 0; p < PMAX; ++p) red[(sl * PMAX + p) * r + q] = acc[p];
  }
  __syncthreads();
  for (int e = tid; e < np * r; e += THREADS) {
    const int p = e / r, qq = e - p * r;
    float s = 0.f;
    for (int j = 0; j < nsl; ++j) s += red[(j * PMAX + p) * r + qq];
    float* o = out + ids[p] * ostride + qq;
    *o = add ? *o + s : s;
  }
  __syncthreads();
}

// Pass 1: block (32 hidden columns cb, group g), the whole contraction:
// gated, the first half of the threads streams W_I and the second W_gate,
// each half 4 column lanes x 32 row slices (ungated: all threads on W_I,
// 64 slices); then x B_I and x B_gate of the group's pairs (the B rows
// are 64 KB each, read from L2) and h of the block's columns.
template <typename T, typename XS>
__global__ void __launch_bounds__(THREADS, 1) decode_ffn_hidden(
    const T* __restrict__ x, const int32_t* __restrict__ choice,
    const T* __restrict__ w_inner, const T* __restrict__ w_gate,
    const float* __restrict__ li_b, const float* __restrict__ li_c,
    const float* __restrict__ lg_b, const float* __restrict__ lg_c,
    float* __restrict__ scratch, int BGA, int GA, int d, int F, int r,
    float scale, int act) {
  extern __shared__ float smem[];
  const int g = blockIdx.y, cb = blockIdx.x, f0 = cb * HC;
  int* list = reinterpret_cast<int*>(smem);
  XS* xs = reinterpret_cast<XS*>(smem + ((BGA + 4) & ~3));  // (PMAX, d)
  float* red = reinterpret_cast<float*>(xs + PMAX * d);     // (WARPS, PMAX, HC)
  float* redx = red + WARPS * PMAX * HC;     // (WARPS, PMAX, 2, 16)
  float* xbs = redx + WARPS * PMAX * 32;     // (PMAX, 2, R_MAX)
  float* cst = xbs + PMAX * 2 * R_MAX;       // (2, R_MAX, HC) C rows
  __shared__ int count;
  const int np_all = group_pairs(choice, BGA, g, list, &count);
  if (np_all == 0) return;                   // no slot chose this group
  Scratch sc(scratch, BGA, F, d);
  const bool gated = w_gate != nullptr;
  const bool lora = li_b != nullptr && r > 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = gated ? THREADS / 2 : THREADS;  // threads per matrix
  const int mat = tid / half, nsl = half / (HC / VEC);
  const int ct = tid % (HC / VEC), ksl = (tid % half) / (HC / VEC);
  const int fv = f0 + ct * VEC;
  const T* w = (mat ? w_gate : w_inner) + (size_t)g * d * F + fv;
  if (lora) {                                // C rows of the block's columns
    for (int e = tid; e < 2 * r * HC; e += THREADS) {
      const int m = e / (r * HC), q = (e / HC) % r, c = e % HC;
      const float* cm = m ? lg_c : li_c;
      cst[(m * R_MAX + q) * HC + c] =
          f0 + c < F && (m == 0 || gated) ? cm[((size_t)g * r + q) * F + f0 + c]
                                          : 0.f;
    }
  }

  for (int p0 = 0; p0 < np_all; p0 += PMAX) {
    const int np = min(PMAX, np_all - p0);
    stage_rows(xs, d, x, d, list + p0, GA, np, d);
    __syncthreads();
    float acc[PMAX][VEC];
#pragma unroll
    for (int p = 0; p < PMAX; ++p)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[p][e] = 0.f;
    if (fv < F) {
      constexpr int U = Row8<T>::UNROLL;
      for (int k = ksl; k < d; k += U * nsl) {
        Row8<T> rows[U];                     // U rows' loads, then the FMAs
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + u * nsl < d) rows[u].load(w + (size_t)(k + u * nsl) * F);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = k + u * nsl;
          if (kk >= d) break;
          float w8[VEC];
          rows[u].get(w8);
#pragma unroll
          for (int p = 0; p < PMAX; ++p) {
            if (p >= np) break;
            const float xv = to_f(xs[p * d + kk]);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[p][e] += xv * w8[e];
          }
        }
      }
    }
    // the warp's 8 k-slices (lane bits 2-4); the warps are summed below
#pragma unroll
    for (int p = 0; p < PMAX; ++p) {
      if (p >= np) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          acc[p][e] += __shfl_xor_sync(FULL_MASK, acc[p][e], o);
      if (lane < HC / VEC) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[(warp * PMAX + p) * HC + ct * VEC + e] = acc[p][e];
      }
    }
    if (lora) {
      // x B_I and x B_gate, 16 ranks at a time: thread (4 ranks q4, row
      // slice tid / 4 of 64), 16-byte loads of B rows
      const int q4 = tid & 3, xsl = tid >> 2;
      for (int q0 = 0; q0 < r; q0 += 16) {
        const int q = q0 + 4 * q4;
        float ax[PMAX][2][4];
#pragma unroll
        for (int p = 0; p < PMAX; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) ax[p][0][j] = ax[p][1][j] = 0.f;
        for (int k = xsl; k < d; k += 8 * 64) {
          float4 bi[8], bg[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int kk = k + u * 64;
            const bool ok = kk < d && q < r;
            bi[u] = ok ? __ldg(reinterpret_cast<const float4*>(li_b + (size_t)kk * r + q))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
            bg[u] = ok && gated
                        ? __ldg(reinterpret_cast<const float4*>(lg_b + (size_t)kk * r + q))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int kk = k + u * 64;
            if (kk >= d) break;
#pragma unroll
            for (int p = 0; p < PMAX; ++p) {
              if (p >= np) break;
              const float xv = to_f(xs[p * d + kk]);
              ax[p][0][0] += xv * bi[u].x; ax[p][0][1] += xv * bi[u].y;
              ax[p][0][2] += xv * bi[u].z; ax[p][0][3] += xv * bi[u].w;
              ax[p][1][0] += xv * bg[u].x; ax[p][1][1] += xv * bg[u].y;
              ax[p][1][2] += xv * bg[u].z; ax[p][1][3] += xv * bg[u].w;
            }
          }
        }
        // the warp's 8 slices (lane bits 2-4), then the 8 warps in order
#pragma unroll
        for (int p = 0; p < PMAX; ++p) {
          if (p >= np) break;
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int o = 4; o < 32; o <<= 1)
                ax[p][m][j] += __shfl_xor_sync(FULL_MASK, ax[p][m][j], o);
              if (lane < 4)
                redx[((warp * PMAX + p) * 2 + m) * 16 + 4 * q4 + j] = ax[p][m][j];
            }
        }
        __syncthreads();
        for (int e = tid; e < np * 2 * 16; e += THREADS) {
          const int p = e / 32, m = (e / 16) & 1, qq = e % 16;
          float s = 0.f;
          for (int wq = 0; wq < WARPS; ++wq)
            s += redx[((wq * PMAX + p) * 2 + m) * 16 + qq];
          if (q0 + qq < r) xbs[(p * 2 + m) * R_MAX + q0 + qq] = s;
        }
        __syncthreads();
      }
    }
    __syncthreads();
    // h of the block's columns: the warps' sums in order, the LoRA term
    const int wpm = half / 32;               // warps per matrix
    for (int e = tid; e < np * HC; e += THREADS) {
      const int p = e / HC, c = e % HC;
      if (f0 + c >= F) continue;
      float u = 0.f, gg = 0.f;
      for (int wq = 0; wq < wpm; ++wq) u += red[(wq * PMAX + p) * HC + c];
      if (gated)
        for (int wq = wpm; wq < 2 * wpm; ++wq) gg += red[(wq * PMAX + p) * HC + c];
      if (lora) {
        float lu = 0.f, lgg = 0.f;
        for (int q = 0; q < r; ++q) {
          lu += xbs[(p * 2 + 0) * R_MAX + q] * cst[(0 * R_MAX + q) * HC + c];
          lgg += xbs[(p * 2 + 1) * R_MAX + q] * cst[(1 * R_MAX + q) * HC + c];
        }
        u += scale * lu;
        gg += scale * lgg;
      }
      sc.h[(size_t)list[p0 + p] * F + f0 + c] =
          gated ? activate(gg, act) * u : activate(u, act);
    }
    __syncthreads();
  }
}

// Pass 2: block (64 output columns cb, group g); h staged whole or, with
// CHUNKED, FCH columns at a time (a multiple of U * OFS for both element
// types).  The unchunked instance is the one loop over F it always was.
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, 2) decode_ffn_out_part(
    const int32_t* __restrict__ choice, const T* __restrict__ w_outer,
    const float* __restrict__ lo_b, float* __restrict__ scratch, int BGA,
    int d, int F, int r) {
  constexpr bool C = CHUNKED;
  const int FC = C ? FCH : F;
  extern __shared__ float smem[];
  const int g = blockIdx.y, cb = blockIdx.x, n0 = cb * OC;
  int* list = reinterpret_cast<int*>(smem);
  float* hs = smem + ((BGA + 4) & ~3);       // (PMAX, FC)
  float* red = hs + PMAX * FC;               // (WARPS, PMAX, OC)
  __shared__ int count;
  const int np_all = group_pairs(choice, BGA, g, list, &count);
  if (np_all == 0) return;
  Scratch sc(scratch, BGA, F, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % (OC / VEC), fsl = tid / (OC / VEC);
  const int nv = n0 + ct * VEC;
  const T* wo = w_outer + (size_t)g * F * d + nv;
  const int xl = cdiv(F, gridDim.x);          // this block's LoRA rows
  const int xf0 = min(F, cb * xl), xf1 = min(F, xf0 + xl);
  constexpr int U = Row8<T>::UNROLL;
  Row8<T> w[U];
  auto load_rows = [&](int f) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (nv < d && f + u * OFS < F) w[u].load(wo + (size_t)(f + u * OFS) * d);
  };
  load_rows(fsl);                  // in flight while h is staged

  for (int p0 = 0; p0 < np_all; p0 += PMAX) {
    const int np = min(PMAX, np_all - p0);
    float acc[PMAX][VEC];
#pragma unroll
    for (int p = 0; p < PMAX; ++p)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[p][e] = 0.f;
    const int chunks = C ? cdiv(F, FCH) : 1;
    for (int ci = 0; ci < chunks; ++ci) {
      const int f0 = C ? ci * FCH : 0, f1 = C ? min(F, f0 + FCH) : F;
      if (ci > 0) __syncthreads();           // the last chunk is consumed
      stage_rows(hs, FC, sc.h + f0, F, list + p0, 1, np, f1 - f0);
      __syncthreads();
      if (nv < d) {
        for (int f = f0 + fsl; f < f1; f += U * OFS) {
          if (p0 > 0 || f > fsl) load_rows(f);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int ff = f + u * OFS;
            if (ff >= F) break;
            float w8[VEC];
            w[u].get(w8);
#pragma unroll
            for (int p = 0; p < PMAX; ++p) {
              if (p >= np) break;
              const float hv = hs[p * FC + ff - f0];
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[p][e] += hv * w8[e];
            }
          }
        }
      }
    }
    // the warp's 4 f-slices (lane bits 3-4), then the 8 warps in order
#pragma unroll
    for (int p = 0; p < PMAX; ++p)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int o = 8; o < 32; o <<= 1)
          acc[p][e] += __shfl_xor_sync(FULL_MASK, acc[p][e], o);
    if (lane < OC / VEC) {
#pragma unroll
      for (int p = 0; p < PMAX; ++p)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[(warp * PMAX + p) * OC + ct * VEC + e] = acc[p][e];
    }
    __syncthreads();
    for (int e = tid; e < np * OC; e += THREADS) {
      const int p = e / OC, c = e % OC;
      if (n0 + c >= d) continue;
      float s = 0.f;
      for (int wq = 0; wq < WARPS; ++wq) s += red[(wq * PMAX + p) * OC + c];
      sc.p2[(size_t)list[p0 + p] * d + n0 + c] = s;
    }
    __syncthreads();
    if (lo_b == nullptr || r == 0) continue;
    // h_a B_O[g] over this block's rows [xf0, xf1): from the staged rows,
    // or (h in chunks) from those rows staged anew, FC at a time
    const float* lb = lo_b + (size_t)g * F * r;
    float* out = sc.p2h + (size_t)cb * BGA * r;
    if constexpr (!C) {
      lora_down(hs + xf0, F, np, lb, r, xf0, xf1, red, list + p0, out, r,
                false);
    } else {
      int k0 = xf0;
      do {                                // at least once: an empty range
        const int k1 = min(xf1, k0 + FC), n = k1 - k0;  // writes zeros
        for (int e = tid; e < np * n; e += THREADS) {
          const int p = e / n, i = e - p * n;
          hs[p * n + i] = sc.h[(size_t)list[p0 + p] * F + k0 + i];
        }
        __syncthreads();
        lora_down(hs, n, np, lb, r, k0, k1, red, list + p0, out, r,
                  k0 > xf0);
        k0 = k1;
      } while (k0 < xf1);
    }
  }
}

// Pass 3: block (slot b, 128 output columns).
template <typename T>
__global__ void __launch_bounds__(SMALL) decode_ffn_out(
    const float* __restrict__ gate, const float* __restrict__ lo_c,
    float* __restrict__ scratch, T* __restrict__ y, int BGA, int GA, int d,
    int F, int r, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, n0 = blockIdx.y * SMALL;
  const bool lora = lo_c != nullptr && r > 0;
  const int nx = cdiv(d, OC);                 // pass 2's column blocks
  float* hb = smem;                           // (GA, r)
  float* cs = hb + GA * r;                    // (r, SMALL): C_O's columns
  float* part = cs + r * SMALL;               // (nx, GA, r) staged
  Scratch sc(scratch, BGA, F, d);
  if (lora) {       // C_O's columns while the output pass ends
#pragma unroll 8
    for (int e = tid; e < r * SMALL; e += SMALL) {
      const int q = e / SMALL, n = n0 + e % SMALL;
      cs[e] = n < d ? lo_c[(size_t)q * d + n] : 0.f;
    }
  }
  if (lora) {       // every load in flight at once, then the fixed sums
#pragma unroll 8
    for (int e = tid; e < nx * GA * r; e += SMALL) {
      const int j = e / (GA * r), ar = e - j * GA * r;
      part[e] = sc.p2h[((size_t)j * BGA + b * GA) * r + ar];
    }
    __syncthreads();
    for (int e = tid; e < GA * r; e += SMALL) {
      float s = 0.f;
      for (int j = 0; j < nx; ++j) s += part[j * GA * r + e];
      hb[e] = s;
    }
    __syncthreads();
  }
  const int n = n0 + tid;
  if (n >= d) return;
  float o = 0.f;
  for (int a = 0; a < GA; ++a) {
    const int ba = b * GA + a;
    float v = sc.p2[(size_t)ba * d + n];
    if (lora) {
      float lo = 0.f;
      for (int q = 0; q < r; ++q) lo += hb[a * r + q] * cs[q * SMALL + tid];
      v += scale * lo;
    }
    o += gate[ba] * v;
  }
  y[(size_t)b * d + n] = from_f<T>(o);
}

template <typename T>
int launch(const void* x, const int32_t* choice, const float* gate,
           const void* wi, const void* wg, const void* wo,
           const float* const* lo, float* scratch, void* y, int B, int d,
           int G, int GA, int F, int r, float scale, int act,
           cudaStream_t st) {
  const int BGA = B * GA;
  const size_t list = sizeof(float) * ((BGA + 4) & ~3);
  const size_t rest = sizeof(float) * (WARPS * PMAX * HC + WARPS * PMAX * 32 +
                                       PMAX * 2 * R_MAX + 2 * R_MAX * HC);
  // x staged as f32 where it fits, else as stored (bf16 past d ~6,100)
  const bool x_f32 = list + sizeof(float) * (size_t)PMAX * d + rest <= SMEM_MAX;
  const size_t b1 = list + (x_f32 ? sizeof(float) : sizeof(T)) * (size_t)PMAX * d + rest;
  auto hidden = x_f32 ? decode_ffn_hidden<T, float> : decode_ffn_hidden<T, T>;
  auto part_bytes = [&](int fc) {
    return list + sizeof(float) * ((size_t)PMAX * fc + WARPS * PMAX * OC);
  };
  const bool chunked = part_bytes(F) > SMEM_MAX;
  const size_t b3 = part_bytes(chunked ? FCH : F);
  auto part = chunked ? decode_ffn_out_part<T, true>
                      : decode_ffn_out_part<T, false>;
  const size_t b4 =
      sizeof(float) * ((size_t)GA * r * (1 + cdiv(d, OC)) + r * SMALL);
  if (b1 > SMEM_MAX || b3 > SMEM_MAX || b4 > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hidden, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(part,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)b3);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_ffn_out<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)b4);
  if (err != cudaSuccess) return (int)err;
  hidden<<<dim3(cdiv(F, HC), G), THREADS, b1, st>>>(
      static_cast<const T*>(x), choice, static_cast<const T*>(wi),
      static_cast<const T*>(wg), lo[0], lo[1], lo[2], lo[3], scratch, BGA,
      GA, d, F, r, scale, act);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  part<<<dim3(cdiv(d, OC), G), THREADS, b3, st>>>(
      choice, static_cast<const T*>(wo), lo[4], scratch, BGA, d, F, r);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  decode_ffn_out<T><<<dim3(B, cdiv(d, SMALL)), SMALL, b4, st>>>(
      gate, lo[5], scratch, static_cast<T*>(y), BGA, GA, d, F, r, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weights and y; gate and the LoRA
// leaves are float32).  w_gate null = ungated; li_b null = no LoRA.  act:
// 0 relu, 1 gelu (tanh), 2 silu.  d % 8 == 0, F % 8 == 0, rank % 4 == 0;
// x, the weights and the LoRA b leaves 16-byte aligned.  scratch holds
// B G' (F + d) + ceil(d / 64) B G' r floats.
extern "C" int repro_decode_ffn(
    int dtype, const void* x, const void* choice, const void* gate,
    const void* w_inner, const void* w_gate, const void* w_outer,
    const void* li_b, const void* li_c, const void* lg_b, const void* lg_c,
    const void* lo_b, const void* lo_c, void* scratch, void* y, int B, int d,
    int G, int GA, int F, int r, float scale, int act, void* stream) {
  const int lr = li_b != nullptr ? r : 0;
  if (B < 1 || d < VEC || d % VEC || G < 1 || GA < 1 || F < VEC || F % VEC ||
      lr < 0 || lr > R_MAX || lr % 4 || act < 0 || act > 2 || B > 65535 ||
      G > 65535)
    return (int)cudaErrorInvalidValue;
  const int32_t* ch = static_cast<const int32_t*>(choice);
  const float* gt = static_cast<const float*>(gate);
  const float* lo[6] = {static_cast<const float*>(li_b),
                        static_cast<const float*>(li_c),
                        static_cast<const float*>(lg_b),
                        static_cast<const float*>(lg_c),
                        static_cast<const float*>(lo_b),
                        static_cast<const float*>(lo_c)};
  if (lr == 0)
    for (auto& p : lo) p = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch<float>(x, ch, gt, w_inner, w_gate, w_outer, lo, sp, y, B,
                         d, G, GA, F, lr, scale, act, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ch, gt, w_inner, w_gate, w_outer, lo, sp,
                                 y, B, d, G, GA, F, lr, scale, act, st);
  return (int)cudaErrorInvalidValue;
}
