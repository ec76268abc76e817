// Append fresh K/V rows to the int8 KV cache of one layer, quantizing them.
//
// The card's counterpart of the JAX package's _quant_kv_rows and
// _append_kv (ecg_byte_tpu/models/transformer.py), which XLA runs: no
// Pallas kernel.  k and v (B, s, KH, D) bf16, this step's rows; k_cache and
// v_cache (B, S, KH, D) int8 and k_scale, v_scale (B, S, KH) bf16, one
// layer's slice of the cache.  Rows t of k and v go to cache slot idx + t.
// Each (b, t, kv head) row is quantized by ecg::quant_row8 (kv_quant.cuh),
// whose arithmetic decode attention's fresh row shares, bit for bit.
//
// It appends a prompt's rows at prefill, one launch per layer in place of
// the ~12 of the plain version; a decode step's row is quantized and
// appended by decode attention itself (attention_decode.cu).  What bounds
// it: bytes (a prefill's 1,152 rows move 3.6 MB), and below that the
// launch.  So it is a bandwidth kernel: a group of D / 8 lanes (rounded up
// to a power of two) takes one row of K and the same row of V, each lane
// with one 16-byte load of each, both in flight before the group's absmax
// (log2 of the group's lanes in shuffle steps); each lane stores 8 int8
// bytes of each, and the group's first lane the two scales.  A block of 256
// threads takes 256 / group rows, so a prefill's rows cover the card in
// about one wave.

#include "kv_quant.cuh"

namespace {

constexpr int kThreads = 256;

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
kv_quant_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
                __nv_bfloat16* __restrict__ k_scale, __nv_bfloat16* __restrict__ v_scale,
                int rows, int s, int S, int KH, int D, int idx) {
  const int lane = threadIdx.x % kLanes;
  const int row = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;  // (b, t, h)
  const bool live = row < rows;
  const bool in_row = live && 8 * lane < D;
  const size_t src = size_t(row) * D + 8 * lane;
  uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
  if (in_row) {
    kr = __ldg(reinterpret_cast<const uint4*>(k + src));
    vr = __ldg(reinterpret_cast<const uint4*>(v + src));
  }
  const int h = row % KH;
  const int t = (row / KH) % s;
  const int b = row / (KH * s);
  const size_t slot = (size_t(b) * S + idx + t) * KH + h;
  const bool first = live && lane == 0;
  ecg::quant_row8<kLanes>(kr, in_row, k_cache + slot * D + 8 * lane, k_scale + slot, first);
  ecg::quant_row8<kLanes>(vr, in_row, v_cache + slot * D + 8 * lane, v_scale + slot, first);
}

struct Args {
  const void *k, *v;
  void *k_cache, *v_cache, *k_scale, *v_scale;
  int rows, s, S, KH, D, idx;
};

template <int kLanes>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int per_block = kThreads / kLanes;
  kv_quant_kernel<kLanes><<<(a.rows + per_block - 1) / per_block, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.k), static_cast<const __nv_bfloat16*>(a.v),
      static_cast<int8_t*>(a.k_cache), static_cast<int8_t*>(a.v_cache),
      static_cast<__nv_bfloat16*>(a.k_scale), static_cast<__nv_bfloat16*>(a.v_scale), a.rows,
      a.s, a.S, a.KH, a.D, a.idx);
  return cudaGetLastError();
}

}  // namespace

// k, v: 16-byte aligned; k_cache, v_cache: 8-byte aligned; D a multiple of 8.
extern "C" int ecg_kv_quant(const void* k, const void* v, void* k_cache, void* v_cache,
                            void* k_scale, void* v_scale, int B, int s, int S, int KH, int D,
                            int idx, void* stream) {
  if (B <= 0 || s <= 0 || KH <= 0 || D <= 0 || D % 8 != 0 || D > 32 * ecg::kQuantMaxPerLane ||
      idx < 0 || idx + s > S || (long long)B * s * KH >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const Args a{k, v, k_cache, v_cache, k_scale, v_scale, B * s * KH, s, S, KH, D, idx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = D / 8;  // a row's lanes, rounded up to a power of two
  if (lanes <= 1) return launch<1>(a, st);
  if (lanes <= 2) return launch<2>(a, st);
  if (lanes <= 4) return launch<4>(a, st);
  if (lanes <= 8) return launch<8>(a, st);
  if (lanes <= 16) return launch<16>(a, st);
  return launch<32>(a, st);
}
