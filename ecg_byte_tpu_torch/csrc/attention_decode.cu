// Single-position decode attention over a bf16 or an int8 KV cache, with
// the cache split across blocks.
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
// What bounds it on the H100: bytes (the whole cache of a layer for a few
// operations per byte).  At batch 1 one block per (kv head, batch row) is 8
// blocks on 132 SMs, so the cache's 64-position tiles are split into
// ``splits`` contiguous ranges, one block each (ops/attention_decode.py
// num_splits aims at a full wave), in three launches:
//
//   A. grid (splits, KH, B): each block stages the K tiles of its range in
//      shared memory, writes the masked, scaled f32 logits of its G query
//      heads to scratch and, per head, the range's max m_i and sum l_i of
//      exp(logit - m_i);
//   B. grid (splits, KH, B): each block combines every range's (m_i, l_i)
//      in range order into the row's (m, l) (so all blocks of a (b, kvh)
//      hold the same bits), forms the exact probabilities
//      round_bf16(exp(logit - m) / l [x v_scale]) from the stored logits,
//      and accumulates P.V over its range's V tiles into an f32 partial;
//   C. the partials are summed in range order and rounded to bf16 (with one
//      range, B writes the output itself and C does not run).
//
// The probabilities are rounded after normalisation, where the plain
// version and the TPU kernel round them; an online softmax would round
// unnormalized ones, which moved the end-to-end logits past their bound.
// K is read once (B reads the logits back, 4 G bytes a position against
// 2 D for K).  Masked positions keep the finite logit -1e30, so a range
// whose positions are all masked reports m_i = -1e30 and the combine
// weighs it by exp(-1e30 - m) = 0; a row with no valid position gets the
// uniform mean of V over its S positions, as the plain version does.  No
// float atomics: every sum has a fixed order.
//
// This token's row (the fresh-row contract of the TPU kernel).  With
// write_idx >= 0 the cache comes in stale and fresh_k, fresh_v (B, 1, KH, D)
// bf16 hold this token's rows.  The one phase-A block of each (b, kvh)
// whose range holds slot write_idx writes them into the cache: copied for
// the bf16 cache, quantized by ecg::quant_row (kv_quant.cuh, the append
// kernel's quantizer) with their bf16 scales for the int8 cache.  It
// stages its K row and K scale from shared memory in place of the stale
// slot; phase B, the next launch on the stream, reads the written V row
// and V scale.  No other block touches the slot, so no atomics and no
// extra barrier.  The result equals an append followed by the kernel, bit
// for bit, and a decode step needs no launch of its own for the append.
//
// Scratch (one f32 buffer from the wrapper): logits (B, KH, G, S), stats
// (B, KH, splits, G, 2), partials (B, KH, splits, G, D) when splits > 1.

#include <type_traits>

#include "common.cuh"
#include "kv_quant.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;  // cache positions per tile (two per lane)

struct Scratch {
  float* logits;
  float* stats;
  float* part;
  __host__ __device__ Scratch(float* work, int B, int S, int KH, int G, int D, int splits) {
    logits = work;
    stats = logits + size_t(B) * KH * G * S;
    part = splits > 1 ? stats + size_t(B) * KH * splits * G * 2 : nullptr;
  }
};

// The first tile of range ``split`` of ``splits`` over ``tiles`` tiles.
__device__ __forceinline__ int range_start(int split, int splits, int tiles) {
  return int((long long)split * tiles / splits);
}

// This token's rows and where they go (write_idx < 0: none).
template <typename T>
struct Fresh {
  const __nv_bfloat16* k;  // (B, 1, KH, D)
  const __nv_bfloat16* v;
  T* k_cache;  // the caches and scales the rows are written into
  T* v_cache;
  __nv_bfloat16* k_scale;  // int8 cache only
  __nv_bfloat16* v_scale;
  int idx;
};

struct StatsSmem {
  size_t q, lg, fresh, stats, ok, k, scales, bytes;
  __host__ __device__ StatsSmem(int G, int D, bool int8) {
    q = size_t(G) * D * 4;             // f32 queries
    lg = size_t(G) * kKeys * 4;        // the tile's logits
    fresh = size_t(D) * 2 + 16;        // this token's K row (bf16) and K scale
    stats = size_t(2) * G * 4;         // running max and sum of each head
    ok = size_t(kKeys) * 4;            // validity of the tile's positions
    k = size_t(kKeys) * (D + 2) * 2;   // K tile, rows padded by one pair
    scales = int8 ? size_t(kKeys) * 4 : 0;  // the tile's K scales
    bytes = q + lg + fresh + stats + ok + k + scales;
  }
};

struct PvSmem {
  size_t v, acc, p, stats, terms, scales, bytes;
  __host__ __device__ PvSmem(int G, int D, int splits, bool int8) {
    v = size_t(kKeys) * D * 2;         // V tile, 16-byte aligned rows
    acc = size_t(G) * D * 4;           // f32 P.V accumulators
    p = size_t(G) * kKeys * 4;         // the tile's probabilities
    stats = size_t(2) * G * 4;         // the row's m and l of each head
    terms = size_t(G) * splits * 4;    // each range's l_i exp(m_i - m)
    scales = int8 ? size_t(kKeys) * 4 : 0;  // the tile's V scales
    bytes = v + acc + p + stats + terms + scales;
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

// Phase A: the logits of the range's tiles and the range's (m_i, l_i).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_stats_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_cache,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const int* __restrict__ valid_mask, float* __restrict__ work, int S, int KH,
                    int G, int D, int splits, float scale, Fresh<T> fr) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const StatsSmem L(G, D, kInt8);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sp = smem;
  float* qs = reinterpret_cast<float*>(sp);
  sp += L.q;
  float* lg = reinterpret_cast<float*>(sp);
  sp += L.lg;
  __nv_bfloat16* fresh = reinterpret_cast<__nv_bfloat16*>(sp);  // 16-byte aligned
  float* fresh_scale = reinterpret_cast<float*>(sp + size_t(D) * 2);
  sp += L.fresh;
  float* m = reinterpret_cast<float*>(sp);
  float* l = m + G;
  sp += L.stats;
  int* key_ok = reinterpret_cast<int*>(sp);
  sp += L.ok;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(sp);
  sp += L.k;
  float* ksc = reinterpret_cast<float*>(sp);  // int8 cache only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int GD = G * D;
  const int tiles = (S + kKeys - 1) / kKeys;
  const int tile_lo = range_start(split, splits, tiles);
  const int tile_hi = range_start(split + 1, splits, tiles);
  const Scratch W(work, B, S, KH, G, D, splits);
  float* logits = W.logits + (size_t(b) * KH + kvh) * G * S;  // (G, S) of this (b, kvh)

  const size_t head0 = (size_t(b) * KH + kvh) * GD;  // q offset of head kvh*G
  for (int i = tid; i < GD; i += kThreads) qs[i] = __bfloat162float(q[head0 + i]);
  for (int g = tid; g < G; g += kThreads) {
    m[g] = ecg::kNegInf;
    l[g] = 0.f;
  }
  // the block whose range holds slot fr.idx writes this token's rows: warp
  // 0 the K row (and its copy in shared memory), warp 1 the V row
  const int fresh_tile = fr.idx >= 0 ? fr.idx / kKeys : -1;
  if (fresh_tile >= tile_lo && fresh_tile < tile_hi && warp < 2) {
    const size_t slot = (size_t(b) * S + fr.idx) * KH + kvh;
    const __nv_bfloat16* src = (warp == 0 ? fr.k : fr.v) + (size_t(b) * KH + kvh) * D;
    T* dst = (warp == 0 ? fr.k_cache : fr.v_cache) + slot * D;
    if constexpr (kInt8) {
      const float sc = ecg::quant_row(src, dst, (warp == 0 ? fr.k_scale : fr.v_scale) + slot,
                                      lane, D, warp == 0 ? fresh : nullptr);
      if (warp == 0 && lane == 0) *fresh_scale = sc;
    } else {
      for (int e = lane; e < D; e += 32) {
        const __nv_bfloat16 x = src[e];
        dst[e] = x;
        if (warp == 0) fresh[e] = x;
      }
    }
  }

  const int chunks = D / 8;
  const int kw = D / 2 + 1;  // K row stride in bf16 pairs
  const __nv_bfloat162* Ks2 = reinterpret_cast<const __nv_bfloat162*>(Ks);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int t0 = tile * kKeys;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kKeys * chunks; idx += kThreads) {
      const int j = idx / chunks, c = idx % chunks;
      const int t = t0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0);
      if (t == fr.idx) {  // only in the writing block's range
        kv = *reinterpret_cast<const uint4*>(fresh + c * 8);
      } else if (t < S) {
        kv = load8(k_cache, ((size_t(b) * S + t) * KH + kvh) * D + c * 8);
      }
      ecg::store_words(Ks + j * (D + 2) + c * 8, kv);
    }
    if (tid < kKeys) {
      const int t = t0 + tid;
      key_ok[tid] = (t < S) ? valid_mask[size_t(b) * S + t] : 0;
      if constexpr (kInt8) {
        ksc[tid] = t == fr.idx ? *fresh_scale
                   : (t < S)   ? __bfloat162float(k_scale[(size_t(b) * S + t) * KH + kvh])
                               : 1.f;
      }
    }
    __syncthreads();
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
      float s;
      if constexpr (kInt8) {
        s = key_ok[j] ? dot * scale * ksc[j] : ecg::kNegInf;
      } else {
        s = key_ok[j] ? dot * scale : ecg::kNegInf;
      }
      lg[idx] = s;
      if (t0 + j < S) logits[size_t(g) * S + t0 + j] = s;
    }
    __syncthreads();
    // per head, the max and the sum of exp(logit - max) over the range, the
    // sum rescaled whenever the max grows; positions past S add nothing
    for (int g = warp; g < G; g += kWarps) {
      const float a = (t0 + lane < S) ? lg[g * kKeys + lane] : -INFINITY;
      const float c = (t0 + lane + 32 < S) ? lg[g * kKeys + lane + 32] : -INFINITY;
      const float m_new = fmaxf(m[g], ecg::warp_max(fmaxf(a, c)));
      const float sum = ecg::warp_sum(expf(a - m_new) + expf(c - m_new));
      if (lane == 0) {
        l[g] = l[g] * expf(m[g] - m_new) + sum;
        m[g] = m_new;
      }
    }
  }
  __syncthreads();
  float* st = W.stats + ((size_t(b) * KH + kvh) * splits + split) * G * 2;
  for (int g = tid; g < G; g += kThreads) {
    st[2 * g] = m[g];
    st[2 * g + 1] = l[g];
  }
}

// Phase B: the exact probabilities of the range and their P.V.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_pv_kernel(const T* __restrict__ v_cache, const __nv_bfloat16* __restrict__ v_scale,
                 float* __restrict__ work, __nv_bfloat16* __restrict__ out, int S, int KH, int G,
                 int D, int splits) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const PvSmem L(G, D, splits, kInt8);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sp = smem;
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(sp);
  sp += L.v;
  float* acc = reinterpret_cast<float*>(sp);
  sp += L.acc;
  float* p = reinterpret_cast<float*>(sp);
  sp += L.p;
  float* m = reinterpret_cast<float*>(sp);
  float* l = m + G;
  sp += L.stats;
  float* terms = reinterpret_cast<float*>(sp);
  sp += L.terms;
  float* vsc = reinterpret_cast<float*>(sp);  // int8 cache only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int GD = G * D;
  const int tiles = (S + kKeys - 1) / kKeys;
  const int tile_lo = range_start(split, splits, tiles);
  const int tile_hi = range_start(split + 1, splits, tiles);
  const Scratch W(work, B, S, KH, G, D, splits);
  const float* logits = W.logits + (size_t(b) * KH + kvh) * G * S;

  // the row's (m, l) from every range's: a warp per head takes the max
  // and each range's term l_i exp(m_i - m), then one lane sums the terms in
  // range order, so every block of the row holds the same bits
  const float* st = W.stats + (size_t(b) * KH + kvh) * splits * G * 2;
  for (int g = warp; g < G; g += kWarps) {
    float mg = ecg::kNegInf;
    for (int i = lane; i < splits; i += 32) mg = fmaxf(mg, st[(size_t(i) * G + g) * 2]);
    mg = ecg::warp_max(mg);
    for (int i = lane; i < splits; i += 32) {
      const float* si = st + (size_t(i) * G + g) * 2;
      terms[g * splits + i] = si[1] * expf(si[0] - mg);
    }
    __syncwarp();
    if (lane == 0) {
      float lg = 0.f;
      for (int i = 0; i < splits; ++i) lg += terms[g * splits + i];
      m[g] = mg;
      l[g] = lg;
    }
  }
  for (int i = tid; i < GD; i += kThreads) acc[i] = 0.f;

  const int chunks = D / 8;
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int t0 = tile * kKeys;
    __syncthreads();  // (m, l) are set; the previous tile's readers are done
    for (int idx = tid; idx < kKeys * chunks; idx += kThreads) {
      const int j = idx / chunks, c = idx % chunks;
      const int t = t0 + j;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (t < S) vv = load8(v_cache, ((size_t(b) * S + t) * KH + kvh) * D + c * 8);
      *reinterpret_cast<uint4*>(Vs + j * D + c * 8) = vv;
    }
    if constexpr (kInt8) {
      if (tid < kKeys) {
        const int t = t0 + tid;
        vsc[tid] = (t < S) ? __bfloat162float(v_scale[(size_t(b) * S + t) * KH + kvh]) : 1.f;
      }
      __syncthreads();
    }
    // the exact probabilities exp(logit - m) / l (times the V scale with
    // the int8 cache), rounded to bf16 as the plain version rounds them
    for (int idx = tid; idx < G * kKeys; idx += kThreads) {
      const int g = idx / kKeys, j = idx % kKeys;
      const int t = t0 + j;
      float pr = 0.f;
      if (t < S) {
        const float s = logits[size_t(g) * S + t];
        if constexpr (kInt8) {
          pr = ecg::round_bf16((expf(s - m[g]) / l[g]) * vsc[j]);
        } else {
          pr = ecg::round_bf16(expf(s - m[g]) / l[g]);
        }
      }
      p[idx] = pr;
    }
    __syncthreads();
    for (int idx = tid; idx < GD; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      const float* pr = p + g * kKeys;
      float a = acc[idx];
#pragma unroll 8
      for (int j = 0; j < kKeys; ++j) a = fmaf(pr[j], __bfloat162float(Vs[j * D + d]), a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  if (splits == 1) {
    const size_t head0 = (size_t(b) * KH + kvh) * GD;
    for (int i = tid; i < GD; i += kThreads) out[head0 + i] = __float2bfloat16(acc[i]);
  } else {
    float* part = W.part + ((size_t(b) * KH + kvh) * splits + split) * GD;
    for (int i = tid; i < GD; i += kThreads) part[i] = acc[i];
  }
}

// Phase C: out = bf16(sum of the ranges' partials, in range order).
__global__ void __launch_bounds__(256)
decode_sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out, int rows,
                  int GD, int splits) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= size_t(rows) * GD) return;
  const size_t row = idx / GD, e = idx % GD;
  const float* pr = part + row * splits * GD + e;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += pr[size_t(i) * GD];
  out[idx] = __float2bfloat16(s);
}

constexpr size_t kSmemMax = 227 * 1024;

// Both kernels' dynamic shared-memory limit, raised to the whole budget
// once per process, not on every launch.
template <typename T>
cudaError_t raise_smem_limits() {
  static const cudaError_t raised = [] {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemMax));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(decode_pv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(kSmemMax));
  }();
  return raised;
}

template <typename T>
int launch(const void* q, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
           const void* valid_mask, const void* fresh_k, const void* fresh_v,
           void* out, void* work, int B, int S, int KH, int G, int D, int splits, int write_idx,
           void* stream) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const int tiles = (S + kKeys - 1) / kKeys;
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || D <= 0 || D % 8 != 0 ||
      D > 32 * ecg::kQuantMaxPerLane || splits < 1 || splits > tiles || B > 65535 ||
      KH > 65535 || write_idx < -1 || write_idx >= S ||
      (write_idx >= 0 && (fresh_k == nullptr || fresh_v == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const Fresh<T> fr{static_cast<const __nv_bfloat16*>(fresh_k),
                    static_cast<const __nv_bfloat16*>(fresh_v), static_cast<T*>(k_cache),
                    static_cast<T*>(v_cache), static_cast<__nv_bfloat16*>(k_scale),
                    static_cast<__nv_bfloat16*>(v_scale), write_idx};
  const StatsSmem LA(G, D, kInt8);
  const PvSmem LB(G, D, splits, kInt8);
  if (LA.bytes > kSmemMax || LB.bytes > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limits<T>();
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = float(1.0 / sqrt(double(D)));
  const dim3 grid(splits, KH, B);
  float* w = static_cast<float*>(work);
  auto* o = static_cast<__nv_bfloat16*>(out);
  decode_stats_kernel<T><<<grid, kThreads, LA.bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_cache),
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const int*>(valid_mask), w, S, KH,
      G, D, splits, scale, fr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_pv_kernel<T><<<grid, kThreads, LB.bytes, s>>>(
      static_cast<const T*>(v_cache), static_cast<const __nv_bfloat16*>(v_scale), w, o, S, KH, G,
      D, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int rows = B * KH;
  const size_t total = size_t(rows) * G * D;
  decode_sum_kernel<<<unsigned((total + 255) / 256), 256, 0, s>>>(
      Scratch(w, B, S, KH, G, D, splits).part, o, rows, G * D, splits);
  return cudaGetLastError();
}

}  // namespace

// fresh_k, fresh_v: this token's rows, written at slot write_idx (-1: none;
// the pointers may then be NULL).
extern "C" int ecg_decode_attention(const void* q, void* k_cache, void* v_cache,
                                    const void* valid_mask, const void* fresh_k,
                                    const void* fresh_v, void* out, void* work, int B, int S,
                                    int KH, int G, int D, int splits, int write_idx,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, valid_mask, fresh_k,
                               fresh_v, out, work, B, S, KH, G, D, splits, write_idx, stream);
}

extern "C" int ecg_decode_attention_int8(const void* q, void* k_cache, void* v_cache,
                                         void* k_scale, void* v_scale,
                                         const void* valid_mask, const void* fresh_k,
                                         const void* fresh_v, void* out, void* work, int B,
                                         int S, int KH, int G, int D, int splits, int write_idx,
                                         void* stream) {
  return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, valid_mask, fresh_k, fresh_v, out,
                        work, B, S, KH, G, D, splits, write_idx, stream);
}
