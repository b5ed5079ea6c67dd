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
// Each distance is ||c||^2 + sum_j x_j (-2 c_j), one fused multiply-add
// per term in the order j = 0 .. d'-1 (-2 c is exact in f32).  The plain
// version rounds its products and sums in another order, so a code may
// differ from it only where two distances lie within rounding of each
// other: chip_smoke.py holds the kernel to it by a margin rule (a code may
// differ only where the two nearest distances lie within 1e-4 x the
// largest |distance| of that sub-vector).  Both bodies below use the same
// order, so they give equal codes.
//
// What bounds it: memory.  It reads each x element once and writes one
// int32 per (row, book); the arithmetic is 2 E d' flops per (row, book),
// 32 flops per input element at E = 16.
//
// Design, the main path (E = 16, d' = 8, M <= 32, x 16-byte aligned): a
// persistent grid of one wave (every SM full) walks tiles of 64 rows.
// Each block stages the codebook (times -2) and its squared norms once,
// in their natural layout, and streams its x tiles through a 2-stage
// cp.async ring in 16-byte pieces (rows padded by 16 bytes, so a warp's
// row reads fall on distinct banks).  Warp w takes every eighth book of
// the tile: all its lanes work on the same book at once, two rows a lane,
// so every codeword read is a broadcast 16-byte shared load serving 64
// rows, and the E x d' loop is unrolled.  Codes gather in a shared tile and leave
// as coalesced stores.  Any other (M, E, d') takes the general body: one
// (row, book) a lane, the book warp-uniform, loops over E and d'.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CB_MAX = 8192;     // M * E * d' floats staged (32 KB)
constexpr int C2_MAX = 1024;     // M * E squared norms
constexpr int DP_MAX = 32;       // d'
// the main-path body
constexpr int TR = 64;           // rows a tile
constexpr int RL = TR / 32;      // rows a lane
constexpr int E_FAST = 16, DP_FAST = 8, M_FAST = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// Asynchronous 16-byte copy to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ||c||^2 of one codeword, the same order in both bodies.
__device__ __forceinline__ float sq_norm(const float* c, int dp) {
  float s = c[0] * c[0];
  for (int j = 1; j < dp; ++j) s = fmaf(c[j], c[j], s);
  return s;
}

// Codebook (times -2, natural layout) and squared norms into shared memory.
__device__ __forceinline__ void stage_codebook(const float* __restrict__ cb,
                                               float* cbn, float* c2, int n_cb,
                                               int n_words, int dp) {
  for (int i = threadIdx.x; i < n_cb; i += THREADS) cbn[i] = -2.f * __ldg(cb + i);
  for (int i = threadIdx.x; i < n_words; i += THREADS)
    c2[i] = sq_norm(cb + (size_t)i * dp, dp);
}

// Eight elements of a shared x row as floats (16-byte aligned).
__device__ __forceinline__ void lds8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Shared memory of the main-path body: -2 C (M*E*d' floats), ||C||^2 (M*E),
// 2 stages of TR rows of x (row_bytes + 16 each), TR x (M + 1) codes.
__host__ __device__ inline int fast_row_stride(int M, int elem_bytes) {
  return M * DP_FAST * elem_bytes + 16;
}
__host__ __device__ inline size_t fast_smem_bytes(int M, int elem_bytes) {
  return (size_t)M * E_FAST * (DP_FAST + 1) * 4 +
         2 * (size_t)TR * fast_row_stride(M, elem_bytes) +
         (size_t)TR * (M + 1) * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) pq_assign_fast_kernel(
    const T* __restrict__ x, const float* __restrict__ codebooks,
    int32_t* __restrict__ codes, long long rows, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_bytes = M * DP_FAST * (int)sizeof(T);
  const int rs = fast_row_stride(M, sizeof(T));
  const int stage_bytes = TR * rs;
  float* cbn = reinterpret_cast<float*>(smem);
  float* c2 = cbn + M * E_FAST * DP_FAST;
  unsigned char* ring = reinterpret_cast<unsigned char*>(c2 + M * E_FAST);
  int32_t* out = reinterpret_cast<int32_t*>(ring + 2 * stage_bytes);
  const long long tiles = (rows + TR - 1) / TR;
  const int pieces = row_bytes / 16;             // 16-byte pieces a row

  auto stage = [&](long long tile, int s) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(x) + tile * TR * row_bytes;
    unsigned char* dst = ring + s * stage_bytes;
    for (int i = tid; i < TR * pieces; i += THREADS) {
      const int r = i / pieces, c = i - r * pieces;
      const bool ok = tile * TR + r < rows;
      cp16(smem_u32(dst + r * rs + c * 16),
           ok ? src + (size_t)r * row_bytes + c * 16
              : reinterpret_cast<const unsigned char*>(x),
           ok ? 16 : 0);
    }
  };
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  cp_commit();
  stage_codebook(codebooks, cbn, c2, M * E_FAST * DP_FAST, M * E_FAST,
                 DP_FAST);

  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    cp_wait_all();
    __syncthreads();              // tile landed; the other stage is free
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x, (it + 1) & 1);
    cp_commit();
    const unsigned char* xs = ring + (it & 1) * stage_bytes;
    for (int m = warp; m < M; m += WARPS) {      // warp-uniform book
      float xv[RL][DP_FAST];                     // rows lane + 32 r
#pragma unroll
      for (int r = 0; r < RL; ++r)
        lds8(reinterpret_cast<const T*>(xs + (lane + 32 * r) * rs) +
                 m * DP_FAST, xv[r]);
      const float4* cw =
          reinterpret_cast<const float4*>(cbn + m * E_FAST * DP_FAST);
      const float4* n2 = reinterpret_cast<const float4*>(c2 + m * E_FAST);
      int best[RL];
      float best_d[RL];
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        best[r] = 0;
        best_d[r] = INFINITY;
      }
#pragma unroll
      for (int e4 = 0; e4 < E_FAST / 4; ++e4) {
        const float4 nv = n2[e4];
        const float nn[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * e4 + k;
          const float4 a = cw[2 * e], b = cw[2 * e + 1];
#pragma unroll
          for (int r = 0; r < RL; ++r) {
            float dist = nn[k];
            dist = fmaf(xv[r][0], a.x, dist);
            dist = fmaf(xv[r][1], a.y, dist);
            dist = fmaf(xv[r][2], a.z, dist);
            dist = fmaf(xv[r][3], a.w, dist);
            dist = fmaf(xv[r][4], b.x, dist);
            dist = fmaf(xv[r][5], b.y, dist);
            dist = fmaf(xv[r][6], b.z, dist);
            dist = fmaf(xv[r][7], b.w, dist);
            if (dist < best_d[r]) {   // strict: the first index wins ties
              best_d[r] = dist;
              best[r] = e;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RL; ++r) out[(lane + 32 * r) * (M + 1) + m] = best[r];
    }
    __syncthreads();
    // the tile's codes are contiguous in `codes`: coalesced stores
    const long long r0 = tile * TR;
    const int n = (int)(rows - r0 < TR ? rows - r0 : TR) * M;
    int32_t* dst = codes + r0 * M;
    for (int i = tid; i < n; i += THREADS) {
      const int r = i / M;
      dst[i] = out[r * (M + 1) + (i - r * M)];
    }
  }
}

// Any (M, E, d') within the staged limits: lane = row, the book uniform in
// a warp; x read from device memory.
template <typename T>
__global__ void __launch_bounds__(THREADS) pq_assign_general_kernel(
    const T* __restrict__ x, const float* __restrict__ codebooks,
    int32_t* __restrict__ codes, long long rows, int M, int E, int DP) {
  __shared__ float cbn[CB_MAX];
  __shared__ float c2[C2_MAX];
  stage_codebook(codebooks, cbn, c2, M * E * DP, M * E, DP);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int d = M * DP;
  const long long units = (rows + 31) / 32 * M;  // (32 rows, book) units
  for (long long u = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
       u < units; u += ((long long)gridDim.x * THREADS) >> 5) {
    const int m = (int)(u % M);
    const long long row = u / M * 32 + lane;
    if (row >= rows) continue;
    const T* xs = x + row * d + m * DP;
    float xv[DP_MAX];
#pragma unroll
    for (int j = 0; j < DP_MAX; ++j)
      if (j < DP) xv[j] = to_f(xs[j]);
    int best = 0;
    float best_d = INFINITY;
    for (int e = 0; e < E; ++e) {
      const float* c = cbn + (m * E + e) * DP;
      float dist = c2[m * E + e];
#pragma unroll
      for (int j = 0; j < DP_MAX; ++j)
        if (j < DP) dist = fmaf(xv[j], c[j], dist);
      if (dist < best_d) {            // strict: the first index wins ties
        best_d = dist;
        best = e;
      }
    }
    codes[row * M + m] = best;
  }
}

// Blocks of a grid of one wave for `kernel` at `smem` bytes (every SM
// full; the occupancy is looked up once per key).
template <typename K>
int wave_blocks(K kernel, size_t smem, int& per_sm) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (!per_sm) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                  smem);
    if (per_sm < 1) per_sm = 1;
  }
  return sms * per_sm;
}

template <typename T>
int launch(const void* x, const float* cb, int32_t* out, long long rows,
           int M, int E, int DP, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (E == E_FAST && DP == DP_FAST && M <= M_FAST &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    static int per_sm[M_FAST + 1] = {};
    const size_t smem = fast_smem_bytes(M, sizeof(T));
    if (!per_sm[M]) {
      const cudaError_t err = cudaFuncSetAttribute(
          pq_assign_fast_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)fast_smem_bytes(M_FAST, sizeof(T)));
      if (err != cudaSuccess) return (int)err;
    }
    const long long tiles = (rows + TR - 1) / TR;
    const long long wave = wave_blocks(pq_assign_fast_kernel<T>, smem,
                                       per_sm[M]);
    pq_assign_fast_kernel<T><<<(int)(tiles < wave ? tiles : wave), THREADS,
                               smem, st>>>(
        xt, cb, out, rows, M);
  } else {
    static int per_sm = 0;
    const long long units = (rows + 31) / 32 * M;
    const long long want = (units * 32 + THREADS - 1) / THREADS;
    const long long wave =
        wave_blocks(pq_assign_general_kernel<T>, 0, per_sm);
    pq_assign_general_kernel<T><<<(int)(want < wave ? want : wave), THREADS,
                                  0, st>>>(
        xt, cb, out, rows, M, E, DP);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x); codebooks are float32 (M, E, d').
// x: (rows, M * d') contiguous; codes: (rows, M) int32.  Returns the
// cudaError_t of the launch.
extern "C" int repro_pq_assign(int dtype, const void* x, const void* codebooks,
                               void* codes, long long rows, int M, int E,
                               int DP, void* stream) {
  if (rows < 1 || M < 1 || E < 1 || DP < 1 || DP > DP_MAX ||
      (long long)M * E > C2_MAX || (long long)M * E * DP > CB_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cb = static_cast<const float*>(codebooks);
  int32_t* out = static_cast<int32_t*>(codes);
  if (dtype == 0) return launch<float>(x, cb, out, rows, M, E, DP, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, cb, out, rows, M, E, DP, st);
  return (int)cudaErrorInvalidValue;
}
