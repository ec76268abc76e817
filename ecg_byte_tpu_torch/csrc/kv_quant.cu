// Append fresh K/V rows to the int8 KV cache of one layer, quantizing them.
//
// The card's counterpart of the JAX package's _quant_kv_rows and
// _append_kv (ecg_byte_tpu/models/transformer.py), which XLA runs: no
// Pallas kernel.  k and v (B, s, KH, D) bf16, this step's rows; k_cache and
// v_cache (B, S, KH, D) int8 and k_scale, v_scale (B, S, KH) bf16, one
// layer's slice of the cache.  Rows t of k and v go to cache slot idx + t.
// Each (b, t, kv head) row is quantized by ecg::quant_row (kv_quant.cuh),
// which decode attention's fresh row shares, bit for bit.
//
// It appends a prompt's rows at prefill, one launch per layer in place of
// the ~12 of the plain version; a decode step's row is quantized and
// appended by decode attention itself (attention_decode.cu), which saves
// this launch on every token.  What bounds it: launches, not bytes.  One
// warp per row quantizes the K row and the V row.

#include "kv_quant.cuh"

namespace {

constexpr int kWarps = 8;

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
  ecg::quant_row(k + src, k_cache + slot * D, k_scale + slot, lane, D);
  ecg::quant_row(v + src, v_cache + slot * D, v_scale + slot, lane, D);
}

}  // namespace

extern "C" int ecg_kv_quant(const void* k, const void* v, void* k_cache, void* v_cache,
                            void* k_scale, void* v_scale, int B, int s, int S, int KH, int D,
                            int idx, void* stream) {
  if (B <= 0 || s <= 0 || KH <= 0 || D <= 0 || D > 32 * ecg::kQuantMaxPerLane || idx < 0 ||
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
