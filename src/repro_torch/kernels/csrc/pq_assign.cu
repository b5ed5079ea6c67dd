// Product-quantization codeword assignment for Hopper (sm_90a).
//
// Replaces the TPU kernel pq_assign_kernel
// (src/repro/kernels/pq_quantize/pq_quantize.py:38, its pl.pallas_call at
// :54).
//
// Computes, for every row x of (rows, d) and every book m of M:
//   codes[row, m] = argmin_e ( ||c_{m,e}||^2 - 2 x[m d' : (m+1) d'] . c_{m,e} )
// (||x||^2 is constant over the argmin), in f32, the first index winning
// a tie as jnp.argmin and torch.argmin do.  The (rows, M, E) distances
// never leave the SM; only the int32 codes are written.
//
// What bounds it: memory.  It reads each x element once and writes one
// int32 per (row, book); the arithmetic is 2 E d' flops per (row, book),
// about 2 E = 32 flops per input element here.
//
// Design: the whole codebook (M*E*d' floats, 8 KB at M=16, E=16, d'=8)
// and its squared norms are staged in shared memory once per block, book
// index minor so that a warp's reads are free of bank conflicts; the
// grid strides over (row, book) pairs, one pair per thread, so a warp
// reads 32 consecutive d'-chunks of x (coalesced) and writes 32
// consecutive codes.  Every sum runs in the plain version's order
// (j = 0 .. d'-1) with one rounded multiply and one rounded add per term
// (__fmul_rn / __fadd_rn: no fused multiply-add), so the kernel's codes
// equal core.pq.assign's bit for bit, near-ties included.
#include <climits>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int CB_MAX = 8192;     // M * E * d' floats staged (32 KB)
constexpr int C2_MAX = 1024;     // M * E squared norms
constexpr int DP_MAX = 32;       // d'
constexpr int MAX_BLOCKS = 132 * 8;

// Shared memory holds the codebook book-minor, cb[(e * DP + j) * M + m],
// and the squared norms as c2[e * M + m]: the lanes of a warp work on
// consecutive books, so their reads fall in consecutive banks.
template <typename T>
__global__ void __launch_bounds__(THREADS) pq_assign_kernel(
    const T* __restrict__ x, const float* __restrict__ codebooks,
    int32_t* __restrict__ codes, int pairs, int M, int E, int DP) {
  __shared__ float cb[CB_MAX];
  __shared__ float c2[C2_MAX];
  const int n_cb = M * E * DP;
  for (int i = threadIdx.x; i < n_cb; i += THREADS) {
    const int m = i / (E * DP), ej = i - m * E * DP;   // source (m, e, j)
    cb[ej * M + m] = codebooks[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * E; i += THREADS) {
    const int e = i / M, m = i - e * M;
    const float* c = cb + e * DP * M + m;
    float s = __fmul_rn(c[0], c[0]);
    for (int j = 1; j < DP; ++j) s = __fadd_rn(s, __fmul_rn(c[j * M], c[j * M]));
    c2[i] = s;
  }
  __syncthreads();
  const int d = M * DP;
  for (int p = blockIdx.x * THREADS + threadIdx.x; p < pairs;
       p += gridDim.x * THREADS) {
    const int row = p / M, m = p - row * M;
    const T* xs = x + (size_t)row * d + m * DP;
    float xv[DP_MAX];
#pragma unroll
    for (int j = 0; j < DP_MAX; ++j)
      if (j < DP) xv[j] = to_f(xs[j]);
    int best = 0;
    float best_d = INFINITY;
    for (int e = 0; e < E; ++e) {
      const float* c = cb + e * DP * M + m;
      float dot = __fmul_rn(xv[0], c[0]);
#pragma unroll
      for (int j = 1; j < DP_MAX; ++j)
        if (j < DP) dot = __fadd_rn(dot, __fmul_rn(xv[j], c[j * M]));
      const float dist = __fsub_rn(c2[e * M + m], __fmul_rn(2.f, dot));
      if (dist < best_d) {            // strict: the first index wins ties
        best_d = dist;
        best = e;
      }
    }
    codes[p] = best;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x); codebooks are float32 (M, E, d').
// x: (rows, M * d') contiguous; codes: (rows, M) int32.  Returns the
// cudaError_t of the launch.
extern "C" int repro_pq_assign(int dtype, const void* x, const void* codebooks,
                               void* codes, long long rows, int M, int E,
                               int DP, void* stream) {
  if (rows < 1 || M < 1 || E < 1 || DP < 1 || DP > DP_MAX ||
      (long long)M * E > C2_MAX || (long long)M * E * DP > CB_MAX ||
      rows * M > INT_MAX - (long long)MAX_BLOCKS * THREADS)
    return (int)cudaErrorInvalidValue;
  const int pairs = (int)(rows * M);
  const int want = (pairs + THREADS - 1) / THREADS;
  const int blocks = want < MAX_BLOCKS ? want : MAX_BLOCKS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cb = static_cast<const float*>(codebooks);
  int32_t* out = static_cast<int32_t*>(codes);
  if (dtype == 0)
    pq_assign_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), cb, out, pairs, M, E, DP);
  else if (dtype == 1)
    pq_assign_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), cb, out, pairs, M, E, DP);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
