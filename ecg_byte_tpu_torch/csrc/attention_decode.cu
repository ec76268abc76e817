// Single-position decode attention over a bf16 or an int8 KV cache.
//
// Replaces the Pallas kernel _kernel of ecg_byte_tpu/ops/attention_decode.py
// for both cache types.  q and out (B, 1, H, D); k_cache and v_cache
// (B, S, KH, D), the cache's native layout; valid_mask (B, S) int32.
// Query head h = kvh * G + g reads KV head kvh.
//
//   out[b,h] = softmax_t(q_h . k_t / sqrt(D), masked by valid_mask) . v
//
// Logits and softmax in f32; the probabilities are rounded to bf16 before
// P.V, which accumulates in f32.  With the int8 cache, k_scale and v_scale
// (B, S, KH) bf16 hold each row's dequantization scale: as in the TPU
// kernel's int8_scales branch, the K scale multiplies the f32 logit after
// the 1/sqrt(D) scaling, and the V scale multiplies the normalized f32
// probability before it is rounded to bf16, so both products read the raw
// int8 rows.  The int8 rows are staged into the same bf16 shared-memory
// tiles as the bf16 cache's (int8 values are exact in bf16), with the
// tile's scales beside them; the compute is then the bf16 branch's.
//
// Design (see ops/attention_decode.py for the why): one block of 128
// threads per (kv head, batch row) streams the cache of its KV head in
// tiles of 64 positions staged through shared memory, for all G query
// heads at once, so no f32 row of S logits has to fit anywhere.  Two
// passes: the first finds each head's max m and sum l of exp(logit - m);
// the second forms the exact probabilities exp(logit - m) / l, rounds them
// to bf16 and accumulates P.V.  K is read twice (1.5x the bytes of one
// pass) so that the rounding happens on normalized probabilities, where
// the plain version and the TPU kernel round; rounding unnormalized ones,
// as an online softmax does, moved the end-to-end logits past their bound.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;  // cache positions per tile (two per lane)

struct DecodeSmem {
  size_t v, acc, q, lg, stats, ok, k, scales, bytes;
  __host__ __device__ DecodeSmem(int G, int D, bool int8) {
    v = size_t(kKeys) * D * 2;  // V tile, 16-byte aligned rows
    acc = size_t(G) * D * 4;    // f32 output accumulators
    q = size_t(G) * D * 4;      // f32 queries
    lg = size_t(G) * kKeys * 4;  // logits, then probabilities
    stats = size_t(2) * G * 4;  // max and sum of each head's row
    ok = size_t(kKeys) * 4;     // validity of the tile's positions
    k = size_t(kKeys) * (D + 2) * 2;  // K tile, rows padded by one pair
    scales = int8 ? size_t(2) * kKeys * 4 : 0;  // the tile's K and V scales
    bytes = v + acc + q + lg + stats + ok + k + scales;
  }
};

// Eight cache values at element offset off -> eight bf16 values in 16
// bytes: a 16-byte load of the bf16 cache, or an 8-byte load of the int8
// cache converted exactly.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, size_t off) {
  return *reinterpret_cast<const uint4*>(p + off);
}

__device__ __forceinline__ uint4 load8(const int8_t* p, size_t off) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p + off);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(b[i]);
  return ecg::pack8(f);
}

// Stage cache tile t0 of (b, kvh) in shared memory (K rows padded; V rows
// when Vs is given; each position's validity; with the int8 cache the
// rows' K and, with Vs, V scales) and write the masked, scaled logits
// lg[g][j] of the G query heads.  Synchronises before the staging (the
// previous tile's readers are done) and after the logits.
template <typename T>
__device__ __forceinline__ void tile_logits(const T* __restrict__ k_cache,
                                            const int* __restrict__ valid_mask,
                                            const T* __restrict__ v_cache,
                                            const __nv_bfloat16* __restrict__ k_scale,
                                            const __nv_bfloat16* __restrict__ v_scale,
                                            __nv_bfloat16* Ks, __nv_bfloat16* Vs, int* key_ok,
                                            float* ksc, float* vsc, const float* qs, float* lg,
                                            int b, int S, int KH, int kvh, int G, int D, int t0,
                                            float scale) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const int tid = threadIdx.x;
  const int chunks = D / 8;
  const int kw = D / 2 + 1;  // K row stride in bf16 pairs
  __syncthreads();
  for (int idx = tid; idx < kKeys * chunks; idx += kThreads) {
    const int j = idx / chunks, c = idx % chunks;
    const int t = t0 + j;
    const size_t off = ((size_t(b) * S + t) * KH + kvh) * D + c * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (t < S) kv = load8(k_cache, off);
    ecg::store_words(Ks + j * (D + 2) + c * 8, kv);
    if (Vs != nullptr) {
      if (t < S) vv = load8(v_cache, off);
      *reinterpret_cast<uint4*>(Vs + j * D + c * 8) = vv;
    }
  }
  if (tid < kKeys) {
    const int t = t0 + tid;
    key_ok[tid] = (t < S) ? valid_mask[size_t(b) * S + t] : 0;
    if constexpr (kInt8) {
      const size_t srow = (size_t(b) * S + t) * KH + kvh;
      ksc[tid] = (t < S) ? __bfloat162float(k_scale[srow]) : 1.f;
      if (Vs != nullptr) vsc[tid] = (t < S) ? __bfloat162float(v_scale[srow]) : 1.f;
    }
  }
  __syncthreads();
  const __nv_bfloat162* Ks2 = reinterpret_cast<const __nv_bfloat162*>(Ks);
  for (int idx = tid; idx < G * kKeys; idx += kThreads) {
    const int g = idx / kKeys, j = idx % kKeys;
    const __nv_bfloat162* kr = Ks2 + j * kw;
    const float2* qr = reinterpret_cast<const float2*>(qs + g * D);
    float dot = 0.f;
    for (int dp = 0; dp < D / 2; ++dp) {
      const float2 kf = __bfloat1622float2(kr[dp]);
      const float2 qf = qr[dp];
      dot = fmaf(qf.x, kf.x, dot);
      dot = fmaf(qf.y, kf.y, dot);
    }
    if constexpr (kInt8) {
      lg[idx] = key_ok[j] ? dot * scale * ksc[j] : ecg::kNegInf;
    } else {
      lg[idx] = key_ok[j] ? dot * scale : ecg::kNegInf;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        const int* __restrict__ valid_mask, __nv_bfloat16* __restrict__ out,
                        int S, int KH, int G, int D, float scale) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const DecodeSmem L(G, D, kInt8);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(p);
  p += L.v;
  float* acc = reinterpret_cast<float*>(p);
  p += L.acc;
  float* qs = reinterpret_cast<float*>(p);
  p += L.q;
  float* lg = reinterpret_cast<float*>(p);
  p += L.lg;
  float* m = reinterpret_cast<float*>(p);
  float* l = m + G;
  p += L.stats;
  int* key_ok = reinterpret_cast<int*>(p);
  p += L.ok;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(p);
  p += L.k;
  float* ksc = reinterpret_cast<float*>(p);  // int8 cache only
  float* vsc = ksc + kKeys;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int GD = G * D;
  const size_t head0 = (size_t(b) * KH + kvh) * GD;  // q/out offset of head kvh*G

  for (int i = tid; i < GD; i += kThreads) {
    qs[i] = __bfloat162float(q[head0 + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = ecg::kNegInf;
    l[g] = 0.f;
  }

  // Pass 1: per head the max m and the sum l of exp(logit - m) over the
  // cache, the sum rescaled whenever the max grows.
  for (int t0 = 0; t0 < S; t0 += kKeys) {
    tile_logits<T>(k_cache, valid_mask, nullptr, k_scale, v_scale, Ks, nullptr, key_ok, ksc, vsc,
                   qs, lg, b, S, KH, kvh, G, D, t0, scale);
    for (int g = warp; g < G; g += kWarps) {
      const float a = lg[g * kKeys + lane], c = lg[g * kKeys + lane + 32];
      const float m_new = fmaxf(m[g], ecg::warp_max(fmaxf(a, c)));
      const float sum = ecg::warp_sum(expf(a - m_new) + expf(c - m_new));
      if (lane == 0) {
        l[g] = l[g] * expf(m[g] - m_new) + sum;
        m[g] = m_new;
      }
    }
  }

  // Pass 2: the exact probabilities exp(logit - m) / l (times the V scale
  // with the int8 cache), rounded to bf16 as the plain version rounds them,
  // then acc[g][d] += p[g][j] * v[j][d].
  for (int t0 = 0; t0 < S; t0 += kKeys) {
    tile_logits<T>(k_cache, valid_mask, v_cache, k_scale, v_scale, Ks, Vs, key_ok, ksc, vsc, qs,
                   lg, b, S, KH, kvh, G, D, t0, scale);
    for (int idx = tid; idx < G * kKeys; idx += kThreads) {
      const int g = idx / kKeys;
      if constexpr (kInt8) {
        lg[idx] = ecg::round_bf16((expf(lg[idx] - m[g]) / l[g]) * vsc[idx % kKeys]);
      } else {
        lg[idx] = ecg::round_bf16(expf(lg[idx] - m[g]) / l[g]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < GD; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      const float* pr = lg + g * kKeys;
      float a = acc[idx];
#pragma unroll 8
      for (int j = 0; j < kKeys; ++j) a = fmaf(pr[j], __bfloat162float(Vs[j * D + d]), a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < GD; idx += kThreads) {
    out[head0 + idx] = __float2bfloat16(acc[idx]);
  }
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* valid_mask, void* out, int B, int S, int KH, int G,
           int D, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || D <= 0 || D % 8 != 0 || D > 256) {
    return cudaErrorInvalidValue;
  }
  const DecodeSmem L(G, D, std::is_same<T, int8_t>::value);
  if (L.bytes > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L.bytes));
  if (err != cudaSuccess) return err;
  const float scale = float(1.0 / sqrt(double(D)));
  decode_attention_kernel<T><<<dim3(KH, B), kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(valid_mask),
      static_cast<__nv_bfloat16*>(out), S, KH, G, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ecg_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                    const void* valid_mask, void* out, int B, int S, int KH,
                                    int G, int D, void* stream) {
  return launch<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, valid_mask, out, B, S, KH,
                               G, D, stream);
}

extern "C" int ecg_decode_attention_int8(const void* q, const void* k_cache, const void* v_cache,
                                         const void* k_scale, const void* v_scale,
                                         const void* valid_mask, void* out, int B, int S, int KH,
                                         int G, int D, void* stream) {
  return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, valid_mask, out, B, S, KH, G, D,
                        stream);
}
