// Shared device helpers of the port's CUDA kernels (sm_90a).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements as floats; p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  int4 raw = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Activation codes shared with the Python wrappers: 0 relu, 1 gelu (tanh
// approximation, jax.nn.gelu's default), 2 silu.
__device__ __forceinline__ float activate(float x, int act) {
  if (act == 0) return x > 0.f ? x : 0.f;
  if (act == 1) {
    const float k = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
  }
  return x / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// PQ codes of one query row in registers (books past M hold -1, which
// no code equals), read from codes[(row) * M].
template <int M_MAX>
__device__ __forceinline__ void load_query_codes(const int32_t* row, int M,
                                                 int (&qc)[M_MAX]) {
#pragma unroll
  for (int m = 0; m < M_MAX; ++m) qc[m] = m < M ? row[m] : -1;
}

// Match count s(q, k) = #{m : code_q[m] == code_k[m]} (paper Eq. 6),
// exact integer compares over the M books of one key row.  With VEC the
// row is read as 16-byte vectors (M % 4 == 0, 16-byte aligned rows): a
// warp reading 32 rows then issues M / 4 loads instead of M.
template <int M_MAX, bool VEC>
__device__ __forceinline__ int match_count(const int32_t* key_row, int M,
                                           const int (&qc)[M_MAX]) {
  int s = 0;
  if constexpr (VEC) {
    const int4* r4 = reinterpret_cast<const int4*>(key_row);
#pragma unroll
    for (int c = 0; c < M_MAX / 4; ++c) {
      if (4 * c < M) {
        const int4 v = __ldg(r4 + c);
        s += (v.x == qc[4 * c]) + (v.y == qc[4 * c + 1]) +
             (v.z == qc[4 * c + 2]) + (v.w == qc[4 * c + 3]);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < M_MAX; ++m)
      if (m < M) s += key_row[m] == qc[m];
  }
  return s;
}

// The kv group serving query group g = b * hq + h (GQA, rep query heads
// per kv head): b * (hq / rep) + h / rep.
__device__ __forceinline__ int kv_group(int g, int hq, int rep) {
  return (g / hq) * (hq / rep) + (g % hq) / rep;
}

}  // namespace repro
