// The int8 KV cache's row quantizer, shared by the append kernel
// (kv_quant.cu) and decode attention's fresh row (attention_decode.cu), so
// both write the same bits.
//
// One warp quantizes one (position, kv head) row of D <= 256 bf16 values:
//
//   scale = amax|x| > 0 ? amax|x| / 127 : 1          (f32)
//   q     = clip(rint(x / scale), -127, 127)          (int8)
//
// and stores the scale rounded to bf16.  Division is IEEE (__fdiv_rn) and
// rint rounds half to even, as jnp.round and torch.round do, so the row
// equals the plain version's (ops/kv_quant.quant_kv_rows) bit for bit.
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

}  // namespace ecg
