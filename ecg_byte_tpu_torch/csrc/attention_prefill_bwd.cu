// Backward of causal grouped-query prefill attention with a left-pad key mask.
//
// Replaces the Pallas kernel _bwd_kernel of ecg_byte_tpu/ops/attention_resident.py
// (reached through _resident_bwd).  Inputs are the forward's qg, k, v,
// pad_mask, its bf16 output out and the output gradient dout, in the
// forward's layouts; outputs dq (like qg), dk and dv (like k), bf16.
//
//   P     = softmax(mask(Q K^T * scale)) in f32, exactly the forward's
//   dV    = bf16(P)^T dO
//   dP    = dO V^T                                  f32
//   delta = rowsum(dO_f32 * O_f32)                  O: the saved bf16 output
//   dS    = bf16(P * (dP - delta) * scale)
//   dQ    = dS K,   dK = dS^T Q                     f32 sums, bf16 results
//
// What bounds it on the H100: operations.  At B 4, S 1024, 32 query heads
// over 8 KV heads of 64 the five causal products (the Q K^T recompute, dV,
// dP, dQ, dK) are 42.9 GFLOP against 84 MB of inputs and outputs.  This
// first version does them as f32 FMAs from shared memory, like the forward,
// not on the tensor cores (mma.sync / wgmma are later work).
//
// Design.  The TPU kernel walks the query blocks of one (batch, KV head) in
// order and carries dK and dV in VMEM scratch across them.  Hopper blocks
// run in no order, so the reduction is split as FlashAttention-2 splits it,
// into two kernels on one stream, with no atomics, so the result is
// deterministic:
//
//   1. dq_kernel, one block per (query tile, KV head, batch row) exactly as
//      the forward's: it repeats the forward's first pass (the same code,
//      attention_tiles.cuh) for each row's max m and sum l, computes delta,
//      writes m, l and delta to a scratch buffer, then walks the key tiles
//      up to the causal edge and accumulates dQ.
//   2. dkv_kernel, one block per (key tile, KV head, batch row): it walks
//      the query tiles at or after the key tile, reads m, l and delta, and
//      accumulates dK and dV for its 64 keys.
//
// Both recompute P from the scores with the forward's own m and l, so P
// rounds exactly as the forward rounded it.  In dkv_kernel a thread holds 4
// keys x 8 query rows (the forward holds 4 rows x 8 keys); each score is
// still one fmaf chain over d in the same order, so it is the forward's
// score bit for bit.  For D >= 128 the dK and dV sums of a thread do not
// fit its registers together, so dkv_kernel runs twice, once for each.
//
// A left-pad row attends to no valid key.  The forward then averages V
// over the first tiles (its m is the -1e30 fill); the backward repeats that
// P, so it is the gradient of what the forward computed.  On the training
// path these rows' dout is zero, and so are their contributions.

#include "attention_tiles.cuh"

namespace {

using ecg::kKeys;
using ecg::kPStride;
using ecg::kRows;
using ecg::kThreads;

enum : int { kDV = 1, kDK = 2 };

template <int D>
struct DqSmem {
  static constexpr size_t kT = ecg::Tile<D>::kBytes;
  static constexpr size_t kDS = size_t(kRows) * kPStride * 4;
  static constexpr size_t bytes = 4 * kT + kDS + kKeys * 4;  // Q, dO, K, V, dS, key_ok
};

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ qg, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const int* __restrict__ pad_mask,
          const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
          __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, int S, int KH, int G,
          float scale) {
  using Smem = DqSmem<D>;
  constexpr int kS = ecg::Tile<D>::kStride;
  constexpr int kDT = D / 8;  // dQ columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kT);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + 2 * Smem::kT);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + 3 * Smem::kT);
  float* DSs = reinterpret_cast<float*>(smem + 4 * Smem::kT);
  int* key_ok = reinterpret_cast<int*>(smem + 4 * Smem::kT + Smem::kDS);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bq = kRows / G;
  const int s0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t q_pos_stride = size_t(KH) * G * D;
  const size_t q_base = (size_t(b) * S * KH + kvh) * G * D;
  const size_t n_rows = size_t(gridDim.z) * KH * S * G;      // rows of the stats buffer
  const size_t row0 = (size_t(b) * KH + kvh) * S * G + size_t(s0) * G;

  ecg::load_query_tile<D>(qg, Qs, b, S, KH, G, kvh, s0, tid);
  ecg::load_query_tile<D>(dout, dOs, b, S, KH, G, kvh, s0, tid);
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = s0 + (tr * 4 + i) / G;
  const int t_end = min(S, s0 + bq);

  // the forward's first pass: m and l, bit for bit (its barriers also make
  // the Q and dO tiles visible)
  float m[4], l[4];
  ecg::softmax_stats<D>(k, pad_mask, Qs, Ks, key_ok, b, S, KH, kvh, t_end, qpos, tr, tc, tid,
                        scale, m, l);

  // delta = rowsum(dO * O) in f32, lane tc summing columns tc*kDT ..
  float delta[4];
  const __nv_bfloat162* dO2 = reinterpret_cast<const __nv_bfloat162*>(dOs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    float part = 0.f;
    if (qpos[i] < S) {
      const __nv_bfloat16* orow = out + q_base + qpos[i] * q_pos_stride + (r % G) * D + tc * kDT;
#pragma unroll
      for (int c8 = 0; c8 < kDT / 8; ++c8) {
        float of[8];
        ecg::unpack8(*reinterpret_cast<const uint4*>(orow + c8 * 8), of);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float2 g2 = __bfloat1622float2(dO2[(r * kS + tc * kDT + c8 * 8 + e) / 2]);
          part = fmaf(g2.x, of[e], part);
          part = fmaf(g2.y, of[e + 1], part);
        }
      }
    }
    delta[i] = ecg::lane8_sum(part);
    if (tc == 0 && qpos[i] < S) {
      stats[row0 + r] = m[i];
      stats[n_rows + row0 + r] = l[i];
      stats[2 * n_rows + row0 + r] = delta[i];
    }
  }

  float acc[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDT; ++c) acc[i][c] = 0.f;

  for (int t0 = 0; t0 < t_end; t0 += kKeys) {
    __syncthreads();
    ecg::load_key_tile<D>(k, Ks, b, S, KH, kvh, t0, tid);
    ecg::load_key_tile<D>(v, Vs, b, S, KH, kvh, t0, tid);
    ecg::load_key_ok(pad_mask, key_ok, b, S, t0, tid);
    __syncthreads();
    float sc[4][8], dp[4][8];
    ecg::dot_4x8<D>(Qs, Ks, tr, tc, sc);
    ecg::dot_4x8<D>(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* dsrow = DSs + (tr * 4 + i) * kPStride;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + j * 8 + tc;
        const float s = ecg::masked_score(sc[i][j], key_ok[j * 8 + tc] != 0 && t <= qpos[i], scale);
        const float p = ecg::probability(s, m[i], l[i]);
        dsrow[j * 8 + tc] = ecg::round_bf16(p * (dp[i][j] - delta[i]) * scale);
      }
    }
    __syncthreads();

    // acc[rows][tc*kDT ..] += dS[rows][:] . K[:][tc*kDT ..]
    const __nv_bfloat162* K2 = reinterpret_cast<const __nv_bfloat162*>(Ks);
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = DSs[(tr * 4 + i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kDT; c += 2) {
        const float2 kf = __bfloat1622float2(K2[(j * kS + tc * kDT + c) / 2]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] = fmaf(ds[i], kf.x, acc[i][c]);
          acc[i][c + 1] = fmaf(ds[i], kf.y, acc[i][c + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (qpos[i] >= S) continue;
    __nv_bfloat16* row = dq + q_base + qpos[i] * q_pos_stride + (r % G) * D + tc * kDT;
#pragma unroll
    for (int c8 = 0; c8 < kDT / 8; ++c8) {
      *reinterpret_cast<uint4*>(row + c8 * 8) = ecg::pack8(&acc[i][c8 * 8]);
    }
  }
}

template <int D>
struct DkvSmem {
  static constexpr size_t kT = ecg::Tile<D>::kBytes;
  static constexpr size_t kP = size_t(kKeys) * kPStride * 4;
  // K, V, Q, dO tiles; P and dS tiles (key-major); m, l, delta, key_ok
  static constexpr size_t bytes = 4 * kT + 2 * kP + 3 * kRows * 4 + kKeys * 4;
};

template <int D, int kWhich>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const __nv_bfloat16* __restrict__ qg, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const int* __restrict__ pad_mask,
           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int KH,
           int G, float scale) {
  using Smem = DkvSmem<D>;
  constexpr int kS = ecg::Tile<D>::kStride;
  constexpr int kDT = D / 8;  // dK / dV columns per thread
  constexpr bool kWantDV = (kWhich & kDV) != 0;
  constexpr bool kWantDK = (kWhich & kDK) != 0;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kT);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * Smem::kT);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + 3 * Smem::kT);
  float* Ps = reinterpret_cast<float*>(smem + 4 * Smem::kT);
  float* DSs = reinterpret_cast<float*>(smem + 4 * Smem::kT + Smem::kP);
  float* m_s = reinterpret_cast<float*>(smem + 4 * Smem::kT + 2 * Smem::kP);
  float* l_s = m_s + kRows;
  float* d_s = l_s + kRows;
  int* key_ok = reinterpret_cast<int*>(d_s + kRows);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // keys 4 tr .. 4 tr + 3
  const int tc = tid & 7;   // query rows 8 j + tc
  const int t0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int bq = kRows / G;
  const size_t n_rows = size_t(gridDim.z) * KH * S * G;
  const size_t stat_base = (size_t(b) * KH + kvh) * S * G;

  ecg::load_key_tile<D>(k, Ks, b, S, KH, kvh, t0, tid);
  if constexpr (kWantDK) ecg::load_key_tile<D>(v, Vs, b, S, KH, kvh, t0, tid);
  ecg::load_key_ok(pad_mask, key_ok, b, S, t0, tid);

  float acc_v[kWantDV ? 4 : 1][kWantDV ? kDT : 1];
  float acc_k[kWantDK ? 4 : 1][kWantDK ? kDT : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDT; ++c) {
      if constexpr (kWantDV) acc_v[i][c] = 0.f;
      if constexpr (kWantDK) acc_k[i][c] = 0.f;
    }

  const int n_qt = (S + bq - 1) / bq;
  for (int qt = t0 / bq; qt < n_qt; ++qt) {
    const int s0 = qt * bq;
    __syncthreads();
    ecg::load_query_tile<D>(qg, Qs, b, S, KH, G, kvh, s0, tid);
    ecg::load_query_tile<D>(dout, dOs, b, S, KH, G, kvh, s0, tid);
    if (tid < kRows) {
      const bool valid = s0 + tid / G < S;
      const size_t n = stat_base + size_t(s0) * G + tid;
      m_s[tid] = valid ? stats[n] : 0.f;
      l_s[tid] = valid ? stats[n_rows + n] : 1.f;
      d_s[tid] = valid ? stats[2 * n_rows + n] : 0.f;
    }
    __syncthreads();

    float sc[4][8], dp[4][8];
    ecg::dot_4x8<D>(Ks, Qs, tr, tc, sc);  // sc[key i][row j]
    if constexpr (kWantDK) ecg::dot_4x8<D>(Vs, dOs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = tr * 4 + i;
      const bool key_valid = key_ok[key] != 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = j * 8 + tc;
        const int qpos = s0 + r / G;
        const float s = ecg::masked_score(sc[i][j], key_valid && t0 + key <= qpos, scale);
        const float p = ecg::probability(s, m_s[r], l_s[r]);
        if constexpr (kWantDV) Ps[key * kPStride + r] = ecg::round_bf16(p);
        if constexpr (kWantDK) DSs[key * kPStride + r] = ecg::round_bf16(p * (dp[i][j] - d_s[r]) * scale);
      }
    }
    __syncthreads();

    // acc_v[keys][cols] += P[keys][:] . dO[:][cols];  acc_k with dS and Q
    const __nv_bfloat162* dO2 = reinterpret_cast<const __nv_bfloat162*>(dOs);
    const __nv_bfloat162* Q2 = reinterpret_cast<const __nv_bfloat162*>(Qs);
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      float pv[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kWantDV) pv[i] = Ps[(tr * 4 + i) * kPStride + r];
        if constexpr (kWantDK) ds[i] = DSs[(tr * 4 + i) * kPStride + r];
      }
#pragma unroll
      for (int c = 0; c < kDT; c += 2) {
        const int w = (r * kS + tc * kDT + c) / 2;
        if constexpr (kWantDV) {
          const float2 g2 = __bfloat1622float2(dO2[w]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pv[i], g2.x, acc_v[i][c]);
            acc_v[i][c + 1] = fmaf(pv[i], g2.y, acc_v[i][c + 1]);
          }
        }
        if constexpr (kWantDK) {
          const float2 q2 = __bfloat1622float2(Q2[w]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_k[i][c] = fmaf(ds[i], q2.x, acc_k[i][c]);
            acc_k[i][c + 1] = fmaf(ds[i], q2.y, acc_k[i][c + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tr * 4 + i;
    if (t >= S) continue;
    const size_t off = ((size_t(b) * S + t) * KH + kvh) * D + tc * kDT;
#pragma unroll
    for (int c8 = 0; c8 < kDT / 8; ++c8) {
      if constexpr (kWantDV) *reinterpret_cast<uint4*>(dv + off + c8 * 8) = ecg::pack8(&acc_v[i][c8 * 8]);
      if constexpr (kWantDK) *reinterpret_cast<uint4*>(dk + off + c8 * 8) = ecg::pack8(&acc_k[i][c8 * 8]);
    }
  }
}

template <int D, int kWhich>
cudaError_t launch_dkv(const dim3& grid, cudaStream_t st, const __nv_bfloat16* qg,
                       const __nv_bfloat16* k, const __nv_bfloat16* v, const int* mask,
                       const __nv_bfloat16* dout, const float* stats, __nv_bfloat16* dk,
                       __nv_bfloat16* dv, int S, int KH, int G, float scale) {
  const size_t smem = DkvSmem<D>::bytes;
  cudaError_t err = ecg::allow_smem(dkv_kernel<D, kWhich>, smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<D, kWhich><<<grid, kThreads, smem, st>>>(qg, k, v, mask, dout, stats, dk, dv, S,
                                                      KH, G, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* qg_, const void* k_, const void* v_, const void* mask_,
                       const void* out_, const void* dout_, void* dq_, void* dk_, void* dv_,
                       void* stats_, int B, int S, int KH, int G, cudaStream_t st) {
  const auto* qg = static_cast<const __nv_bfloat16*>(qg_);
  const auto* k = static_cast<const __nv_bfloat16*>(k_);
  const auto* v = static_cast<const __nv_bfloat16*>(v_);
  const auto* mask = static_cast<const int*>(mask_);
  const auto* out = static_cast<const __nv_bfloat16*>(out_);
  const auto* dout = static_cast<const __nv_bfloat16*>(dout_);
  auto* dq = static_cast<__nv_bfloat16*>(dq_);
  auto* dk = static_cast<__nv_bfloat16*>(dk_);
  auto* dv = static_cast<__nv_bfloat16*>(dv_);
  auto* stats = static_cast<float*>(stats_);
  const float scale = float(1.0 / sqrt(double(D)));

  cudaError_t err = ecg::allow_smem(dq_kernel<D>, DqSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  const int bq = kRows / G;
  dq_kernel<D><<<dim3((S + bq - 1) / bq, KH, B), kThreads, DqSmem<D>::bytes, st>>>(
      qg, k, v, mask, out, dout, dq, stats, S, KH, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((S + kKeys - 1) / kKeys, KH, B);
  if constexpr (D < 128) {
    return launch_dkv<D, kDV | kDK>(grid, st, qg, k, v, mask, dout, stats, dk, dv, S, KH, G, scale);
  } else {
    err = launch_dkv<D, kDV>(grid, st, qg, k, v, mask, dout, stats, dk, dv, S, KH, G, scale);
    if (err != cudaSuccess) return err;
    return launch_dkv<D, kDK>(grid, st, qg, k, v, mask, dout, stats, dk, dv, S, KH, G, scale);
  }
}

}  // namespace

// stats: f32 scratch of 3 * B * KH * S * G values (m, l, delta per row),
// written by the first kernel and read by the second.
extern "C" int ecg_prefill_attention_bwd(const void* qg, const void* k, const void* v,
                                         const void* pad_mask, const void* out,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* stats, int B, int S, int KH, int G, int D,
                                         void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || kRows % G != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_bwd<64>(qg, k, v, pad_mask, out, dout, dq, dk, dv, stats, B, S, KH, G, st);
    case 128: return launch_bwd<128>(qg, k, v, pad_mask, out, dout, dq, dk, dv, stats, B, S, KH, G, st);
    case 256: return launch_bwd<256>(qg, k, v, pad_mask, out, dout, dq, dk, dv, stats, B, S, KH, G, st);
    default: return cudaErrorInvalidValue;
  }
}
