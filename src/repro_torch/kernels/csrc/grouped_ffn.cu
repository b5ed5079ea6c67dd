// Grouped routed-FFN kernel with in-kernel token gather, for Hopper (sm_90a).
//
// Replaces the TPU kernel grouped_ffn_kernel
// (src/repro/kernels/routed_ffn/routed_ffn.py:187, its pl.pallas_call at
// :264).
//
// Computes, per (batch b, group g, tile of TC capacity slots c):
//   x_c = x[b, min(index[b, g, c], S - 1)]          (S marks an empty slot)
//   h   = act(x_c W_gate[g] + s (x_c B_gate) C_gate[g])
//         * (x_c W_I[g] + s (x_c B_I) C_I[g])        (ungated: act(up))
//   y[b, g, c] = h W_O[g] + s (h B_O[g]) C_O
// with every product accumulated in f32.  Empty or dropped slots produce
// finite rows that the torch combine scatter discards.
//
// What bounds it: arithmetic.  Per slot it does 2*d*F*(2 or 3) flops
// against d inputs and d outputs, while each block re-reads its group's
// weights (3*d*F elements) from L2.  Design: the gathered x tile (TC x d)
// and the hidden tile (TC x F) live in shared memory as f32, so the
// (B, G, C, d) dispatch buffer never exists in device memory and h never
// leaves the SM.  Every product is one routine: weight tiles of KT rows x
// 128 columns are staged through shared memory with coalesced loads, the
// next tile's loads in flight (in registers) while the current one is
// used, and each thread owns an (RT x 4) register tile of outputs.  These
// are CUDA-core FMA loops (exact f32, one code path for f32 and bf16
// data); moving the products onto the tensor cores (mma / wgmma) is the
// next step for speed.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;   // 32 column lanes x 8 row lanes
constexpr int COLS = 128;      // output columns per pass (4 per lane)
constexpr int KT = 32;         // k rows per staged weight tile
constexpr int LOAD = KT * COLS / THREADS;   // tile elements per thread

// acc[i][j] += sum_k A[row_i, k] * W[k, n0 + col_j] for k < K, where
// row_i = ty + 8 i (A in shared memory, f32, row stride lda) and col_j =
// tx + 32 j masked to n < N (W in global memory, row stride ldw).
// ws: KT x COLS floats of shared staging.  Called by all threads.
template <int RT, typename TW>
__device__ __forceinline__ void gemm_acc(const float* A, int lda,
                                         const TW* __restrict__ W, int ldw,
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
      pre[e] = (col_ok && k < K) ? to_f(W[(size_t)k * ldw + n0 + lc]) : 0.f;
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

template <typename T, int RT>
__global__ void __launch_bounds__(THREADS) grouped_ffn_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ index,
    const T* __restrict__ w_inner, const T* __restrict__ w_gate,
    const T* __restrict__ w_outer, const float* __restrict__ li_b,
    const float* __restrict__ li_c, const float* __restrict__ lg_b,
    const float* __restrict__ lg_c, const float* __restrict__ lo_b,
    const float* __restrict__ lo_c, T* __restrict__ y, int S, int d, int G,
    int C, int F, int r, float scale, int act) {
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
    xs[e] = to_f(x[((size_t)b * S + rows[c]) * d + kk]);
  }
  // (gemm_acc's leading barrier orders these writes before their reads)
  float acc[RT][4], acc2[RT][4];
  if (lora) {                                       // x B, rank r <= 128
    zero(acc);
    gemm_acc(xs, d, li_b, r, d, 0, r, ws, acc);
    store_smem(xb, r, 0, acc);
    if (gated) {
      zero(acc);
      gemm_acc(xs, d, lg_b, r, d, 0, r, ws, acc);
      store_smem(xbg, r, 0, acc);
    }
  }

  // h = act(gate) * up over the group's F hidden columns
  const T* wi = w_inner + (size_t)g * d * F;
  const T* wg = gated ? w_gate + (size_t)g * d * F : nullptr;
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
  if (lora) {                                       // h B_O
    zero(acc);
    gemm_acc(hs, F, lo_b + (size_t)g * F * r, r, F, 0, r, ws, acc);
    store_smem(hb, r, 0, acc);
  }

  // y = h W_O + s (h B_O) C_O in column passes over d
  const T* wo = w_outer + (size_t)g * F * d;
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
        const float o = acc[i][j] + (lora ? scale * acc2[i][j] : 0.f);
        y[(((size_t)b * G + g) * C + c0 + c) * d + n] = from_f<T>(o);
      }
    }
  }
}

size_t smem_bytes(int tc, int d, int F, int r) {
  return sizeof(float) * ((size_t)KT * COLS + (size_t)tc * d +
                          (size_t)tc * F + 3 * (size_t)tc * r) +
         sizeof(int) * tc;
}

template <typename T, int RT>
int launch(const void* x, const void* index, const void* wi, const void* wg,
           const void* wo, const float* li_b, const float* li_c,
           const float* lg_b, const float* lg_c, const float* lo_b,
           const float* lo_c, void* y, int B, int S, int d, int G, int C,
           int F, int r, float scale, int act, size_t bytes,
           cudaStream_t st) {
  auto kern = grouped_ffn_kernel<T, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + 8 * RT - 1) / (8 * RT), G, B);
  kern<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(index),
      static_cast<const T*>(wi), static_cast<const T*>(wg),
      static_cast<const T*>(wo), li_b, li_c, lg_b, lg_c, lo_b, lo_c,
      static_cast<T*>(y), S, d, G, C, F, r, scale, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rt(int rt, const void* x, const void* index, const void* wi,
              const void* wg, const void* wo, const float* li_b,
              const float* li_c, const float* lg_b, const float* lg_c,
              const float* lo_b, const float* lo_c, void* y, int B, int S,
              int d, int G, int C, int F, int r, float scale, int act,
              size_t bytes, cudaStream_t st) {
  if (rt == 4)
    return launch<T, 4>(x, index, wi, wg, wo, li_b, li_c, lg_b, lg_c, lo_b,
                        lo_c, y, B, S, d, G, C, F, r, scale, act, bytes, st);
  if (rt == 2)
    return launch<T, 2>(x, index, wi, wg, wo, li_b, li_c, lg_b, lg_c, lo_b,
                        lo_c, y, B, S, d, G, C, F, r, scale, act, bytes, st);
  return launch<T, 1>(x, index, wi, wg, wo, li_b, li_c, lg_b, lg_c, lo_b,
                      lo_c, y, B, S, d, G, C, F, r, scale, act, bytes, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weights and y; LoRA leaves are
// float32).  w_gate null = ungated; li_b null = no LoRA (then all LoRA
// pointers are ignored).  act: 0 relu, 1 gelu (tanh), 2 silu.
extern "C" int repro_grouped_ffn(
    int dtype, const void* x, const void* index, const void* w_inner,
    const void* w_gate, const void* w_outer, const void* li_b,
    const void* li_c, const void* lg_b, const void* lg_c, const void* lo_b,
    const void* lo_c, void* y, int B, int S, int d, int G, int C, int F,
    int r, float scale, int act, void* stream) {
  const int lr = li_b != nullptr ? r : 0;
  if (B < 1 || S < 1 || d < 1 || G < 1 || C < 1 || F < 1 || lr < 0 ||
      lr > COLS || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  // largest row tile whose x and h tiles fit the 227 KB a block may use
  int rt = 4;
  while (rt > 1 && smem_bytes(8 * rt, d, F, lr) > 232448) rt >>= 1;
  const size_t bytes = smem_bytes(8 * rt, d, F, lr);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const float* f[6] = {static_cast<const float*>(li_b),
                       static_cast<const float*>(li_c),
                       static_cast<const float*>(lg_b),
                       static_cast<const float*>(lg_c),
                       static_cast<const float*>(lo_b),
                       static_cast<const float*>(lo_c)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rt<float>(rt, x, index, w_inner, w_gate, w_outer, f[0],
                            f[1], f[2], f[3], f[4], f[5], y, B, S, d, G, C,
                            F, lr, scale, act, bytes, st);
  if (dtype == 1)
    return launch_rt<__nv_bfloat16>(rt, x, index, w_inner, w_gate, w_outer,
                                    f[0], f[1], f[2], f[3], f[4], f[5], y, B,
                                    S, d, G, C, F, lr, scale, act, bytes, st);
  return (int)cudaErrorInvalidValue;
}
