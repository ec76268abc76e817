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
// sum reduce with three shuffles.  The score and softmax steps are in
// attention_tiles.cuh, shared with the backward, which recomputes the
// probabilities bit for bit.

#include "attention_tiles.cuh"

namespace {

using ecg::kKeys;
using ecg::kPStride;
using ecg::kRows;
using ecg::kThreads;

template <int D>
struct PrefillSmem {
  static constexpr size_t kV = size_t(kKeys) * D * 2;  // unpadded: read as uint4
  static constexpr size_t kP = size_t(kRows) * kPStride * 4;
  static constexpr size_t kQ = ecg::Tile<D>::kBytes;
  static constexpr size_t kK = ecg::Tile<D>::kBytes;
  static constexpr size_t bytes = kV + kP + kQ + kK + kKeys * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ qg,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ pad_mask,
                         __nv_bfloat16* __restrict__ out,
                         int S, int KH, int G, float scale) {
  using Smem = PrefillSmem<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kDT = D / 8;      // output columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Ps = reinterpret_cast<float*>(smem + Smem::kV);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kV + Smem::kP);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kV + Smem::kP + Smem::kQ);
  int* key_ok = reinterpret_cast<int*>(smem + Smem::kV + Smem::kP + Smem::kQ + Smem::kK);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bq = kRows / G;  // query positions per block
  const int s0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t q_pos_stride = size_t(KH) * G * D;
  const size_t q_base = (size_t(b) * S * KH + kvh) * G * D;

  ecg::load_query_tile<D>(qg, Qs, b, S, KH, G, kvh, s0, tid);
  int qpos[4];
  float acc[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = s0 + (tr * 4 + i) / G;
#pragma unroll
    for (int c = 0; c < kDT; ++c) acc[i][c] = 0.f;
  }

  // keys past the tile's last query position are causally masked for all rows
  const int t_end = min(S, s0 + bq);

  // Pass 1: each row's max m and sum l of exp(s - m).
  float m[4], l[4];
  ecg::softmax_stats<D>(k, pad_mask, Qs, Ks, key_ok, b, S, KH, kvh, t_end, qpos, tr, tc, tid,
                        scale, m, l);

  // Pass 2: the probabilities of an exact softmax, exp(s - m) / l, rounded
  // to bf16 as the plain version and the TPU kernel round them, then P.V.
  for (int t0 = 0; t0 < t_end; t0 += kKeys) {
    __syncthreads();
    ecg::load_key_tile<D>(k, Ks, b, S, KH, kvh, t0, tid);
    ecg::load_key_ok(pad_mask, key_ok, b, S, t0, tid);
    for (int idx = tid; idx < kKeys * kChunks; idx += kThreads) {
      const int j = idx / kChunks, c = idx % kChunks;
      const int t = t0 + j;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (t < S) vv = *reinterpret_cast<const uint4*>(v + ((size_t(b) * S + t) * KH + kvh) * D + c * 8);
      *reinterpret_cast<uint4*>(Vs + j * D + c * 8) = vv;
    }
    __syncthreads();
    float sc[4][8];
    ecg::dot_4x8<D>(Qs, Ks, tr, tc, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* prow = Ps + (tr * 4 + i) * kPStride;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + j * 8 + tc;
        const float s = ecg::masked_score(sc[i][j], key_ok[j * 8 + tc] != 0 && t <= qpos[i], scale);
        prow[j * 8 + tc] = ecg::round_bf16(ecg::probability(s, m[i], l[i]));
      }
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
