// Helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace ecg {

// The finite mask fill of the JAX code (ops/attention.py).  With -inf a
// query row whose keys are all masked would end in 0/0 = NaN.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Round to bf16 and back: the probabilities enter P.V as bf16 values.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Store 16 bytes into a shared-memory row that is only 4-byte aligned
// (rows padded by one bf16 pair to spread them over the banks).
__device__ __forceinline__ void store_words(void* dst, uint4 v) {
  uint32_t* w = reinterpret_cast<uint32_t*>(dst);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// Eight bf16 values packed in 16 bytes -> eight floats.
__device__ __forceinline__ void unpack8(uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Eight floats -> eight bf16 values packed in 16 bytes.
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

}  // namespace ecg
