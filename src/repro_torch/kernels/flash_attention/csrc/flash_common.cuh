// Shared by the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): tile sizes, the masking constant, and the
// 4-wide f32/bf16 loads and stores that move a head's rows between device
// memory and shared f32 tiles.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(p2[0]);
  float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Copy rows [row0, row0 + 64) of one head of a (B, S, NH, HD) tensor into a
// shared f32 tile with row stride STR, multiplied by `scale`; rows >= S are
// zero.  Each thread moves 4 consecutive dims at a time.
template <int HD, int STR, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int row0,
                                          int S, int row_stride, float scale) {
  constexpr int VEC_PER_ROW = HD / 4;
  for (int idx = threadIdx.x; idx < 64 * VEC_PER_ROW; idx += NTHREADS) {
    const int r = idx / VEC_PER_ROW;
    const int d = (idx % VEC_PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) {
      val = load4(base + (size_t)(row0 + r) * row_stride + d);
      val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
    }
    store4(dst + r * STR + d, val);
  }
}

}  // namespace
