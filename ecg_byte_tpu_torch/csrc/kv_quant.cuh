// The int8 KV cache's row quantizers: quant_row, one warp a row, for decode
// attention's fresh row (attention_decode.cu), and quant_row8, a group of
// lanes a row with eight values each, for the append kernel (kv_quant.cu).
// Both compute the same arithmetic, so they write the same bits.
//
// Each quantizes one (position, kv head) row of D <= 256 bf16 values:
//
//   scale = amax|x| > 0 ? amax|x| / 127 : 1          (f32)
//   q     = clip(rint(x / scale), -127, 127)          (int8)
//
// and stores the scale rounded to bf16.  x / scale is IEEE division
// (__fdiv_rn) and rint rounds half to even, as jnp.round and torch.round
// do, so the row equals the plain version's (ops/kv_quant.quant_kv_rows)
// bit for bit.
#pragma once

#include "common.cuh"

namespace ecg {

constexpr int kQuantMaxPerLane = 8;  // D <= 256

// Quantize src[0, D) into dst and, from lane 0, the bf16 scale into
// *scale_out.  With ``staged`` set, each int8 value is also written there
// as bf16 (exact).  Returns the stored scale as f32 (the bf16 value).
__device__ __forceinline__ float quant_row(const __nv_bfloat16* __restrict__ src,
                                           int8_t* __restrict__ dst,
                                           __nv_bfloat16* __restrict__ scale_out, int lane, int D,
                                           __nv_bfloat16* staged = nullptr) {
  float f[kQuantMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kQuantMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    f[i] = e < D ? __bfloat162float(src[e]) : 0.f;
    amax = fmaxf(amax, fabsf(f[i]));
  }
  amax = warp_max(amax);
  const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
#pragma unroll
  for (int i = 0; i < kQuantMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < D) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(f[i], scale)), -127.f), 127.f);
      dst[e] = static_cast<int8_t>(r);
      if (staged != nullptr) staged[e] = __float2bfloat16(r);
    }
  }
  const __nv_bfloat16 stored = __float2bfloat16(scale);
  if (lane == 0) *scale_out = stored;
  return __bfloat162float(stored);
}

// Quantize eight values of a row, ``raw`` (eight bf16 in 16 bytes), held by
// each of a group of kLanes consecutive lanes (a power of two, aligned in
// the warp; a lane past the row's end passes zeros and stores nothing):
// the group's absmax in log2(kLanes) shuffle steps, then the eight int8
// values into 8 bytes at dst, and from the group's first lane the bf16
// scale into *scale_out.  Every lane of the warp must call it.
template <int kLanes>
__device__ __forceinline__ void quant_row8(uint4 raw, bool in_row, int8_t* __restrict__ dst,
                                           __nv_bfloat16* __restrict__ scale_out, bool first) {
  float f[8];
  unpack8(raw, f);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(f[i], scale)), -127.f), 127.f);
    packed[i / 4] |= (uint32_t(int(r)) & 0xFFu) << (8 * (i % 4));
  }
  if (in_row) *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  if (first) *scale_out = __float2bfloat16(scale);
}

}  // namespace ecg
