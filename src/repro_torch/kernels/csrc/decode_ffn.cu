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
// What bounds it: memory.  At one token per row the arithmetic is 2 flops
// per weight element read, so the time is the chosen weight blocks
// streamed from device memory.  Design: the top-G' choice indexes the
// weight blocks directly (no capacity plan, gather or scatter), every
// thread streams 8 consecutive columns of a weight row with one 16-byte
// load, and many slices of the contraction run side by side to keep
// loads in flight.  The sum over the G' blocks is a second pass, not
// atomics, so the order of the f32 sum is fixed:
//   pass 1, one block per (b, a, 64 hidden columns): x in shared memory,
//     32 k-slices stream W_I / W_gate rows, reduce, add LoRA, apply act
//     -> h (B, G', F) f32 scratch;
//   pass 2, one block per (b, 128 output columns): h of the row in shared
//     memory, 16 f-slices stream W_O rows, reduce, add the gated LoRA term.
// Needs d and F to be multiples of 8 (16-byte rows of bf16).
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int VEC = 8;                     // columns per thread (16 bytes)
constexpr int HCOLS = 64;                  // pass 1: hidden columns/block
constexpr int KSL = THREADS / (HCOLS / VEC);   // pass 1: 32 k-slices
constexpr int OCOLS = 128;                 // pass 2: output columns/block
constexpr int FSL = THREADS / (OCOLS / VEC);   // pass 2: 16 f-slices
constexpr int R_MAX = 64;                  // LoRA rank

template <typename T>
__global__ void __launch_bounds__(THREADS) decode_ffn_hidden(
    const T* __restrict__ x, const int32_t* __restrict__ choice,
    const T* __restrict__ w_inner, const T* __restrict__ w_gate,
    const float* __restrict__ li_b, const float* __restrict__ li_c,
    const float* __restrict__ lg_b, const float* __restrict__ lg_c,
    float* __restrict__ h, int d, int GA, int F, int r, float scale,
    int act) {
  extern __shared__ float smem[];
  float* xs = smem;                         // (d)
  float* part = xs + d;                     // (2, KSL, HCOLS)
  __shared__ float xb[R_MAX], xbg[R_MAX];
  __shared__ float lpart[2][THREADS];

  const int ba = blockIdx.x;                // b * GA + a
  const int b = ba / GA;
  const int c = choice[ba];
  const int f0 = blockIdx.y * HCOLS;
  const int tid = threadIdx.x;
  const bool lora = li_b != nullptr && r > 0;
  const bool gated = w_gate != nullptr;

  for (int kk = tid; kk < d; kk += THREADS) xs[kk] = to_f(x[(size_t)b * d + kk]);
  __syncthreads();
  if (lora) {                               // x B (rank r), k split in slices
    const int rr = tid % r, sl = tid / r, nsl = THREADS / r;
    float a = 0.f, ag = 0.f;
    if (sl < nsl) {
      for (int kk = sl; kk < d; kk += nsl) {
        a += xs[kk] * li_b[(size_t)kk * r + rr];
        if (gated) ag += xs[kk] * lg_b[(size_t)kk * r + rr];
      }
    }
    lpart[0][tid] = a;
    lpart[1][tid] = ag;
    __syncthreads();
    if (tid < r) {
      float s0 = 0.f, s1 = 0.f;
      for (int s = 0; s < nsl; ++s) {
        s0 += lpart[0][s * r + tid];
        s1 += lpart[1][s * r + tid];
      }
      xb[tid] = s0;
      xbg[tid] = s1;
    }
    __syncthreads();
  }

  const int cg = tid % (HCOLS / VEC), ks = tid / (HCOLS / VEC);
  const int fv = f0 + cg * VEC;             // first of this thread's columns
  float up[VEC], gt[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) up[e] = gt[e] = 0.f;
  if (fv < F) {
    const T* wi = w_inner + (size_t)c * d * F + fv;
    const T* wg = gated ? w_gate + (size_t)c * d * F + fv : nullptr;
    for (int kk = ks; kk < d; kk += KSL) {
      float w8[VEC];
      load8(wi + (size_t)kk * F, w8);
#pragma unroll
      for (int e = 0; e < VEC; ++e) up[e] += xs[kk] * w8[e];
      if (gated) {
        load8(wg + (size_t)kk * F, w8);
#pragma unroll
        for (int e = 0; e < VEC; ++e) gt[e] += xs[kk] * w8[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    part[ks * HCOLS + cg * VEC + e] = up[e];
    part[(KSL + ks) * HCOLS + cg * VEC + e] = gt[e];
  }
  __syncthreads();
  const int f = f0 + tid;
  if (tid < HCOLS && f < F) {
    float u = 0.f, gg = 0.f;
    for (int s = 0; s < KSL; ++s) {
      u += part[s * HCOLS + tid];
      gg += part[(KSL + s) * HCOLS + tid];
    }
    if (lora) {
      float lu = 0.f, lgg = 0.f;
      for (int rr = 0; rr < r; ++rr) {
        lu += xb[rr] * li_c[((size_t)c * r + rr) * F + f];
        if (gated) lgg += xbg[rr] * lg_c[((size_t)c * r + rr) * F + f];
      }
      u += scale * lu;
      gg += scale * lgg;
    }
    h[(size_t)ba * F + f] = gated ? activate(gg, act) * u : activate(u, act);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) decode_ffn_out(
    const float* __restrict__ h, const int32_t* __restrict__ choice,
    const float* __restrict__ gate, const T* __restrict__ w_outer,
    const float* __restrict__ lo_b, const float* __restrict__ lo_c,
    T* __restrict__ y, int d, int GA, int F, int r, float scale) {
  extern __shared__ float smem[];
  float* hs = smem;                         // (GA, F)
  float* hb = hs + (size_t)GA * F;          // (GA, r)
  __shared__ float part[FSL][OCOLS];

  const int b = blockIdx.x;
  const int n0 = blockIdx.y * OCOLS;
  const int tid = threadIdx.x;
  const bool lora = lo_b != nullptr && r > 0;

  for (int e = tid; e < GA * F; e += THREADS) hs[e] = h[(size_t)b * GA * F + e];
  __syncthreads();
  if (lora) {                               // hb[a][rr] = h_a B_O[c_a]
    for (int e = tid; e < GA * r; e += THREADS) {
      const int a = e / r, rr = e - a * r;
      const int c = choice[b * GA + a];
      float s = 0.f;
      for (int f = 0; f < F; ++f)
        s += hs[a * F + f] * lo_b[((size_t)c * F + f) * r + rr];
      hb[e] = s;
    }
    __syncthreads();
  }

  const int cg = tid % (OCOLS / VEC), fs = tid / (OCOLS / VEC);
  const int nv = n0 + cg * VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  if (nv < d) {
    for (int a = 0; a < GA; ++a) {
      const int c = choice[b * GA + a];
      const T* wo = w_outer + (size_t)c * F * d + nv;
      const float gt = gate[b * GA + a];
      float s[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] = 0.f;
      for (int f = fs; f < F; f += FSL) {
        float w8[VEC];
        load8(wo + (size_t)f * d, w8);
        const float hv = hs[a * F + f];
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[e] += hv * w8[e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += gt * s[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) part[fs][cg * VEC + e] = acc[e];
  __syncthreads();
  const int n = n0 + tid;
  if (tid < OCOLS && n < d) {
    float o = 0.f;
    for (int s = 0; s < FSL; ++s) o += part[s][tid];
    if (lora) {
      for (int a = 0; a < GA; ++a) {
        float lo = 0.f;
        for (int rr = 0; rr < r; ++rr) lo += hb[a * r + rr] * lo_c[(size_t)rr * d + n];
        o += gate[b * GA + a] * scale * lo;
      }
    }
    y[(size_t)b * d + n] = from_f<T>(o);
  }
}

template <typename T>
int launch(const void* x, const int32_t* choice, const float* gate,
           const void* wi, const void* wg, const void* wo, const float* li_b,
           const float* li_c, const float* lg_b, const float* lg_c,
           const float* lo_b, const float* lo_c, float* h, void* y, int B,
           int d, int GA, int F, int r, float scale, int act,
           cudaStream_t st) {
  const size_t b1 = sizeof(float) * ((size_t)d + 2 * KSL * HCOLS);
  const size_t b2 = sizeof(float) * ((size_t)GA * F + (size_t)GA * r);
  if (b1 > 232448 || b2 > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_ffn_hidden<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      decode_ffn_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b2);
  if (err != cudaSuccess) return (int)err;
  dim3 g1(B * GA, (F + HCOLS - 1) / HCOLS);
  decode_ffn_hidden<T><<<g1, THREADS, b1, st>>>(
      static_cast<const T*>(x), choice, static_cast<const T*>(wi),
      static_cast<const T*>(wg), li_b, li_c, lg_b, lg_c, h, d, GA, F, r,
      scale, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2(B, (d + OCOLS - 1) / OCOLS);
  decode_ffn_out<T><<<g2, THREADS, b2, st>>>(
      h, choice, gate, static_cast<const T*>(wo), lo_b, lo_c,
      static_cast<T*>(y), d, GA, F, r, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weights and y; gate, LoRA leaves
// and the h scratch (B, G', F) are float32).  w_gate null = ungated; li_b
// null = no LoRA.  act: 0 relu, 1 gelu (tanh), 2 silu.  d % 8 == 0 and
// F % 8 == 0.
extern "C" int repro_decode_ffn(
    int dtype, const void* x, const void* choice, const void* gate,
    const void* w_inner, const void* w_gate, const void* w_outer,
    const void* li_b, const void* li_c, const void* lg_b, const void* lg_c,
    const void* lo_b, const void* lo_c, void* h, void* y, int B, int d,
    int GA, int F, int r, float scale, int act, void* stream) {
  const int lr = li_b != nullptr ? r : 0;
  if (B < 1 || d < VEC || d % VEC || GA < 1 || F < VEC || F % VEC ||
      lr < 0 || lr > R_MAX || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const int32_t* ch = static_cast<const int32_t*>(choice);
  const float* gt = static_cast<const float*>(gate);
  const float* f[6] = {static_cast<const float*>(li_b),
                       static_cast<const float*>(li_c),
                       static_cast<const float*>(lg_b),
                       static_cast<const float*>(lg_c),
                       static_cast<const float*>(lo_b),
                       static_cast<const float*>(lo_c)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hp = static_cast<float*>(h);
  if (dtype == 0)
    return launch<float>(x, ch, gt, w_inner, w_gate, w_outer, f[0], f[1],
                         f[2], f[3], f[4], f[5], hp, y, B, d, GA, F, lr,
                         scale, act, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ch, gt, w_inner, w_gate, w_outer, f[0],
                                 f[1], f[2], f[3], f[4], f[5], hp, y, B, d,
                                 GA, F, lr, scale, act, st);
  return (int)cudaErrorInvalidValue;
}
