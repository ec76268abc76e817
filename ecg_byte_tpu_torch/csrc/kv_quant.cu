// Append fresh K/V rows to the int8 KV cache of one layer, quantizing them.
//
// The card's counterpart of the JAX package's _quant_kv_rows and
// _append_kv (ecg_byte_tpu/models/transformer.py), which XLA runs: no
// Pallas kernel.  k and v (B, s, KH, D) bf16, this step's rows; k_cache and
// v_cache (B, S, KH, D) int8 and k_scale, v_scale (B, S, KH) bf16, one
// layer's slice of the cache.  Rows t of k and v go to cache slot idx + t.
// Per (b, t, kv head) row, over D:
//
//   scale = amax|x| > 0 ? amax|x| / 127 : 1          (f32)
//   q     = clip(rint(x / scale), -127, 127)          (int8)
//
// and the scale is stored rounded to bf16.  Division is IEEE (__fdiv_rn)
// and rint rounds half to even, as jnp.round and torch.round do, so the
// cache equals the plain version's bit for bit.
//
// What bounds it: launches, not bytes (a decode step quantizes 2 * B * KH
// rows of D values).  One warp per row quantizes the K row and the V row,
// and one launch per layer replaces the ~12 launches of the plain version.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPerLane = 8;  // D <= 256

__device__ __forceinline__ void quant_row(const __nv_bfloat16* __restrict__ src,
                                          int8_t* __restrict__ dst,
                                          __nv_bfloat16* __restrict__ scale_out, int lane, int D) {
  float f[kMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    f[i] = e < D ? __bfloat162float(src[e]) : 0.f;
    amax = fmaxf(amax, fabsf(f[i]));
  }
  amax = ecg::warp_max(amax);
  const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < D) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(f[i], scale)), -127.f), 127.f);
      dst[e] = static_cast<int8_t>(r);
    }
  }
  if (lane == 0) *scale_out = __float2bfloat16(scale);
}

__global__ void __launch_bounds__(kWarps * 32)
kv_quant_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
                __nv_bfloat16* __restrict__ k_scale, __nv_bfloat16* __restrict__ v_scale,
                int rows, int s, int S, int KH, int D, int idx) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (b, t, h) of the fresh rows
  if (row >= rows) return;
  const int h = row % KH;
  const int t = (row / KH) % s;
  const int b = row / (KH * s);
  const size_t src = size_t(row) * D;
  const size_t slot = (size_t(b) * S + idx + t) * KH + h;
  quant_row(k + src, k_cache + slot * D, k_scale + slot, lane, D);
  quant_row(v + src, v_cache + slot * D, v_scale + slot, lane, D);
}

}  // namespace

extern "C" int ecg_kv_quant(const void* k, const void* v, void* k_cache, void* v_cache,
                            void* k_scale, void* v_scale, int B, int s, int S, int KH, int D,
                            int idx, void* stream) {
  if (B <= 0 || s <= 0 || KH <= 0 || D <= 0 || D > 32 * kMaxPerLane || idx < 0 ||
      idx + s > S) {
    return cudaErrorInvalidValue;
  }
  const int rows = B * s * KH;
  kv_quant_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<__nv_bfloat16*>(k_scale), static_cast<__nv_bfloat16*>(v_scale), rows, s, S,
      KH, D, idx);
  return cudaGetLastError();
}
