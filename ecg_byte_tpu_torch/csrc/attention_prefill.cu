// Causal grouped-query prefill attention with a left-pad key mask.
//
// Replaces the Pallas kernel _fwd_kernel of ecg_byte_tpu/ops/attention_resident.py.
// Layouts are the JAX ones: qg and out (B, S, KH, G, D), k and v
// (B, S, KH, D), all bf16; pad_mask (B, S) int32, 1 = valid key.
//
//   out[b,s,kh,g] = softmax_t(q.k_t / sqrt(D), masked) . v   over keys t
//   key t is allowed for query s iff t <= s and pad_mask[b,t] != 0
//
// Logits and softmax in f32; the probabilities are rounded to bf16 before
// P.V, which accumulates in f32.
//
// Design (see ops/attention_resident.py for the why): one block of 128
// threads per (q tile, kv head, batch row).  The tile's 64 rows are
// 64 / G query positions x the G query heads of the KV head, so one K/V
// tile in shared memory serves all of them.  Keys come in tiles of 64 up
// to the tile's causal edge, in two passes: the first finds each row's max
// m and sum l of exp(s - m); the second forms the exact probabilities
// exp(s - m) / l, rounds them to bf16 and accumulates P.V.  The second pass
// recomputes the scores (QK is half the work again) so that the rounding
// happens where the TPU kernel and the plain version round: on normalized
// probabilities.  An online softmax rounds unnormalized ones instead, and
// through 16 random layers that difference grew past the end-to-end bound.
// Thread (tr, tc) owns rows 4tr..4tr+3; in the score step it takes keys
// 8j+tc, in the P.V step output columns tc*D/8 .. (tc+1)*D/8 - 1.  The 8
// threads sharing a row group are neighbouring lanes, so row max and row
// sum reduce with three shuffles.

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kPStride = 66;   // f32 row stride of the probability tile

template <int D>
struct PrefillSmem {
  static constexpr int kQK = D + 2;  // padded bf16 row stride of Q and K
  static constexpr size_t kV = size_t(kKeys) * D * 2;
  static constexpr size_t kP = size_t(kRows) * kPStride * 4;
  static constexpr size_t kQ = size_t(kRows) * kQK * 2;
  static constexpr size_t kK = size_t(kKeys) * kQK * 2;
  static constexpr size_t bytes = kV + kP + kQ + kK + kKeys * 4;
};

// Stage key tile t0 of (b, kvh) in shared memory: K rows (padded), V rows
// when Vs is given, and each key's pad-mask bit.  Keys past S read as zeros
// and are marked invalid.  Synchronises before (the previous tile's readers
// are done) and after.
template <int D>
__device__ __forceinline__ void load_keys(const __nv_bfloat16* __restrict__ k,
                                          const __nv_bfloat16* __restrict__ v,
                                          const int* __restrict__ pad_mask,
                                          __nv_bfloat16* Ks, __nv_bfloat16* Vs, int* key_ok,
                                          int b, int S, int KH, int kvh, int t0, int tid) {
  constexpr int kChunks = D / 8;
  __syncthreads();
  for (int idx = tid; idx < kKeys * kChunks; idx += kThreads) {
    const int j = idx / kChunks, c = idx % kChunks;
    const int t = t0 + j;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    const size_t off = ((size_t(b) * S + t) * KH + kvh) * D + c * 8;
    if (t < S) kv = *reinterpret_cast<const uint4*>(k + off);
    ecg::store_words(Ks + j * (D + 2) + c * 8, kv);
    if (Vs != nullptr) {
      if (t < S) vv = *reinterpret_cast<const uint4*>(v + off);
      *reinterpret_cast<uint4*>(Vs + j * D + c * 8) = vv;
    }
  }
  if (tid < kKeys) {
    const int t = t0 + tid;
    key_ok[tid] = (t < S) ? pad_mask[size_t(b) * S + t] : 0;
  }
  __syncthreads();
}

// Masked, scaled scores of rows 4tr+i against keys t0 + 8j + tc.
template <int D>
__device__ __forceinline__ void scores(const __nv_bfloat162* Qs2, const __nv_bfloat162* Ks2,
                                       const int* key_ok, float (&sc)[4][8], const int (&qpos)[4],
                                       int t0, int tr, int tc, float scale) {
  constexpr int kQK2 = (D + 2) / 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int dp = 0; dp < D / 2; ++dp) {
    float2 qf[4], kf[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[i] = __bfloat1622float2(Qs2[(tr * 4 + i) * kQK2 + dp]);
#pragma unroll
    for (int j = 0; j < 8; ++j) kf[j] = __bfloat1622float2(Ks2[(j * 8 + tc) * kQK2 + dp]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = fmaf(qf[i].x, kf[j].x, sc[i][j]);
        sc[i][j] = fmaf(qf[i].y, kf[j].y, sc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = key_ok[j * 8 + tc] != 0 && t0 + j * 8 + tc <= qpos[i];
      sc[i][j] = ok ? sc[i][j] * scale : ecg::kNegInf;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ qg,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ pad_mask,
                         __nv_bfloat16* __restrict__ out,
                         int S, int KH, int G, float scale) {
  using Smem = PrefillSmem<D>;
  constexpr int kQK = Smem::kQK;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kDT = D / 8;      // output columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Ps = reinterpret_cast<float*>(smem + Smem::kV);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kV + Smem::kP);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kV + Smem::kP + Smem::kQ);
  int* key_ok = reinterpret_cast<int*>(smem + Smem::kV + Smem::kP + Smem::kQ + Smem::kK);
  const __nv_bfloat162* Qs2 = reinterpret_cast<const __nv_bfloat162*>(Qs);
  const __nv_bfloat162* Ks2 = reinterpret_cast<const __nv_bfloat162*>(Ks);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bq = kRows / G;  // query positions per block
  const int s0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t q_pos_stride = size_t(KH) * G * D;
  const size_t q_base = (size_t(b) * S * KH + kvh) * G * D;

  // Q tile -> shared memory (rows past the sequence end read as zeros)
  for (int idx = tid; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int s = s0 + r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S) {
      val = *reinterpret_cast<const uint4*>(qg + q_base + s * q_pos_stride + (r % G) * D + c * 8);
    }
    ecg::store_words(Qs + r * kQK + c * 8, val);
  }

  float m[4], l[4], acc[4][kDT];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ecg::kNegInf;
    l[i] = 0.f;
    qpos[i] = s0 + (tr * 4 + i) / G;
#pragma unroll
    for (int c = 0; c < kDT; ++c) acc[i][c] = 0.f;
  }

  // keys past the tile's last query position are causally masked for all rows
  const int t_end = min(S, s0 + bq);

  // Pass 1: row max m and row sum l of exp(s - m) over every key tile, the
  // sum rescaled whenever the max grows.
  for (int t0 = 0; t0 < t_end; t0 += kKeys) {
    load_keys<D>(k, v, pad_mask, Ks, nullptr, key_ok, b, S, KH, kvh, t0, tid);
    float sc[4][8];
    scores<D>(Qs2, Ks2, key_ok, sc, qpos, t0, tr, tc, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, sc[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) rs += expf(sc[i][j] - m_new);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }

  // Pass 2: the probabilities of an exact softmax, exp(s - m) / l, rounded
  // to bf16 as the plain version and the TPU kernel round them, then P.V.
  for (int t0 = 0; t0 < t_end; t0 += kKeys) {
    load_keys<D>(k, v, pad_mask, Ks, Vs, key_ok, b, S, KH, kvh, t0, tid);
    float sc[4][8];
    scores<D>(Qs2, Ks2, key_ok, sc, qpos, t0, tr, tc, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* prow = Ps + (tr * 4 + i) * kPStride;
#pragma unroll
      for (int j = 0; j < 8; ++j) prow[j * 8 + tc] = ecg::round_bf16(expf(sc[i][j] - m[i]) / l[i]);
    }
    __syncthreads();

    // acc[rows][tc*kDT ..] += P[rows][:] . V[:][tc*kDT ..]
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr * 4 + i) * kPStride + j];
      const uint4* vrow = reinterpret_cast<const uint4*>(Vs + j * D + tc * kDT);
#pragma unroll
      for (int c8 = 0; c8 < kDT / 8; ++c8) {
        float vf[8];
        ecg::unpack8(vrow[c8], vf);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][c8 * 8 + e] = fmaf(p[i], vf[e], acc[i][c8 * 8 + e]);
      }
    }
  }

  // every row saw key tile 0, so l >= 1 (a fully masked row sums exp(0) terms)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int s = s0 + r / G;
    if (s >= S) continue;
    __nv_bfloat16* orow = out + q_base + s * q_pos_stride + (r % G) * D + tc * kDT;
#pragma unroll
    for (int c8 = 0; c8 < kDT / 8; ++c8) {
      *reinterpret_cast<uint4*>(orow + c8 * 8) = ecg::pack8(&acc[i][c8 * 8]);
    }
  }
}

template <int D>
cudaError_t launch_prefill(const void* qg, const void* k, const void* v, const void* pad_mask,
                           void* out, int B, int S, int KH, int G, cudaStream_t stream) {
  const size_t smem = PrefillSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(prefill_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int bq = kRows / G;
  const dim3 grid((S + bq - 1) / bq, KH, B);
  const float scale = float(1.0 / sqrt(double(D)));
  prefill_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qg), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pad_mask),
      static_cast<__nv_bfloat16*>(out), S, KH, G, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ecg_prefill_attention(const void* qg, const void* k, const void* v,
                                     const void* pad_mask, void* out, int B, int S, int KH,
                                     int G, int D, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || kRows % G != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_prefill<64>(qg, k, v, pad_mask, out, B, S, KH, G, st);
    case 128: return launch_prefill<128>(qg, k, v, pad_mask, out, B, S, KH, G, st);
    case 256: return launch_prefill<256>(qg, k, v, pad_mask, out, B, S, KH, G, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ecg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
