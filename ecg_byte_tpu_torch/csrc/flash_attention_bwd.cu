// Backward of causal grouped-query flash attention with a left-pad key mask.
//
// Replaces the Pallas kernels _bwd_dq_kernel and _bwd_dkv_kernel of
// ecg_byte_tpu/ops/flash_attention.py (reached through _flash_bwd).  Inputs
// are the forward's qg, k, v, pad_mask, its bf16 output out and f32 lse
// (B, KH, G, S), and the output gradient dout, in the forward's layouts;
// outputs dq (like qg), dk and dv (like k), bf16.
//
//   p     = exp(s - lse) in f32, s the forward's masked score
//   dV    = bf16(p)^T dO
//   dP    = dO V^T                                  f32
//   delta = rowsum(dO_f32 * O_f32)                  O: the saved bf16 output
//   dS    = bf16(p * (dP - delta) * scale)
//   dQ    = dS K,   dK = dS^T Q                     f32 sums, bf16 results
//
// over the key blocks of 128 up to each row's own query block of 128, as
// the forward (flash_attention.cu) visits them.  A left-pad row has lse =
// -1e30, so p = 1 on every key of those blocks, as in the JAX kernels; its
// dout is zero on the training path.
//
// What bounds it on the H100: operations.  At B 1, S 4096, 32 query heads
// over 8 KV heads of 64, the five products (the Q K^T recompute, dV, dP, dQ,
// dK) are 172 GFLOP over the causal pairs against 17 MB of inputs and
// outputs.  This first version does them as f32 FMAs from shared memory
// (mma.sync / wgmma are later work).
//
// Design.  The TPU kernels carry dQ across the key blocks and dK, dV across
// the query blocks of a sequential grid axis.  Hopper blocks run in no
// order, so the split is FlashAttention-2's, kernels on one stream with no
// atomics, so the result is deterministic, in the tiles of
// attention_prefill_bwd.cu:
//
//   1. flash_dq_kernel, one block per (query tile, KV head, batch row): the
//      tile's lse from the forward, so no first pass for the softmax
//      statistics; delta from O and dO, written for the second kernel; then
//      dQ over the 64-key tiles up to its query block's end (not past S:
//      K is zero there, and so would be the terms).
//   2. flash_dkv_kernel, one block per (64-key tile, query head, batch
//      row): the 64-position tiles of that head from the start of the key
//      tile's 128-block on, reading lse and delta, accumulating the head's
//      dK and dV for its 64 keys, rounded to bf16 into a (B, H, S, D)
//      scratch per gradient, as the JAX kernel writes them per query head.
//   3. head_sum_kernel: dK and dV of each KV head, the f32 sum of its G
//      query heads' bf16 values, rounded (ops/flash_attention.py:339-343).
//      Rounding once after an f32 sum over the heads instead moved dK and
//      dV by 2.6e-3 of their norm, beyond the check's 1e-3.
//
// A query head's tile reuses the (position, head) tile loaders of
// attention_tiles.cuh with one head per row: qg (B, S, KH, G, D) is
// (B, S, KH * G, 1, D) with query head h = kvh * G + g.  For D >= 128 the dK
// and dV sums of a thread do not fit its registers together, so
// dkv_kernel runs twice, once for each.

#include "attention_tiles.cuh"

namespace {

using ecg::kKeys;
using ecg::kPStride;
using ecg::kRows;
using ecg::kThreads;

constexpr int kBlock = 128;  // the TPU kernels' block_q and block_k
enum : int { kDV = 1, kDK = 2 };

// row r of the query tile at position s0 -> its index in a (B, KH, G, S) row array
__device__ __forceinline__ size_t row_index(int b, int KH, int kvh, int G, int S, int s0, int r) {
  return ((size_t(b) * KH + kvh) * G + r % G) * S + s0 + r / G;
}

template <int D>
struct DqSmem {
  static constexpr size_t kT = ecg::Tile<D>::kBytes;
  static constexpr size_t kDS = size_t(kRows) * kPStride * 4;
  static constexpr size_t bytes = 4 * kT + kDS + kKeys * 4;  // Q, dO, K, V, dS, key_ok
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const __nv_bfloat16* __restrict__ qg, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const int* __restrict__ pad_mask,
                const __nv_bfloat16* __restrict__ out, const float* __restrict__ lse,
                const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                float* __restrict__ delta_out, int S, int KH, int G, float scale) {
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
  const int s0 = (gridDim.x - 1 - blockIdx.x) * bq;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t q_pos_stride = size_t(KH) * G * D;
  const size_t q_base = (size_t(b) * S * KH + kvh) * G * D;

  ecg::load_query_tile<D>(qg, Qs, b, S, KH, G, kvh, s0, tid);
  ecg::load_query_tile<D>(dout, dOs, b, S, KH, G, kvh, s0, tid);
  __syncthreads();

  // lse from the forward; delta = rowsum(dO * O) in f32, lane tc summing
  // columns tc*kDT ..
  int qpos[4];
  float lse_r[4], delta[4];
  const __nv_bfloat162* dO2 = reinterpret_cast<const __nv_bfloat162*>(dOs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    qpos[i] = s0 + r / G;
    const bool valid = qpos[i] < S;
    const size_t n = row_index(b, KH, kvh, G, S, s0, r);
    lse_r[i] = valid ? lse[n] : 0.f;
    float part = 0.f;
    if (valid) {
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
    if (tc == 0 && valid) delta_out[n] = delta[i];
  }

  float acc[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDT; ++c) acc[i][c] = 0.f;

  const int t_end = min(S, (s0 / kBlock + 1) * kBlock);
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
        const float p = expf(__fsub_rn(s, lse_r[i]));
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
  // K, V, Q, dO tiles; P and dS tiles (key-major); lse, delta, key_ok
  static constexpr size_t bytes = 4 * kT + 2 * kP + 2 * kRows * 4 + kKeys * 4;
};

template <int D, int kWhich>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const __nv_bfloat16* __restrict__ qg, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ pad_mask,
                 const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk_h,
                 __nv_bfloat16* __restrict__ dv_h, int S, int KH, int G, float scale) {
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
  float* lse_s = reinterpret_cast<float*>(smem + 4 * Smem::kT + 2 * Smem::kP);
  float* d_s = lse_s + kRows;
  int* key_ok = reinterpret_cast<int*>(d_s + kRows);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // keys 4 tr .. 4 tr + 3
  const int tc = tid & 7;   // query rows 8 j + tc
  const int t0 = blockIdx.x * kKeys;  // the first key tiles have the most query tiles
  const int hq = blockIdx.y;          // query head kvh * G + g
  const int kvh = hq / G;
  const int b = blockIdx.z;
  const int H = KH * G;
  const size_t row0 = (size_t(b) * H + hq) * S;  // this head's rows of lse, delta, dK_h, dV_h

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

  // the head's query positions from the start of the key tile's 128-block
  // on see it, 64 a tile
  for (int s0 = (t0 / kBlock) * kBlock; s0 < S; s0 += kRows) {
    __syncthreads();
    ecg::load_query_tile<D>(qg, Qs, b, S, H, 1, hq, s0, tid);
    ecg::load_query_tile<D>(dout, dOs, b, S, H, 1, hq, s0, tid);
    if (tid < kRows) {
      const bool valid = s0 + tid < S;
      lse_s[tid] = valid ? lse[row0 + s0 + tid] : 0.f;
      d_s[tid] = valid ? delta[row0 + s0 + tid] : 0.f;
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
        const float s = ecg::masked_score(sc[i][j], key_valid && t0 + key <= s0 + r, scale);
        const float p = expf(__fsub_rn(s, lse_s[r]));
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
    const size_t off = (row0 + t) * D + tc * kDT;
#pragma unroll
    for (int c8 = 0; c8 < kDT / 8; ++c8) {
      if constexpr (kWantDV) *reinterpret_cast<uint4*>(dv_h + off + c8 * 8) = ecg::pack8(&acc_v[i][c8 * 8]);
      if constexpr (kWantDK) *reinterpret_cast<uint4*>(dk_h + off + c8 * 8) = ecg::pack8(&acc_k[i][c8 * 8]);
    }
  }
}

// out[b, t, kvh, :] = bf16(sum over g of part[b, kvh * G + g, t, :]) for
// both gradients, one thread per 8 values; part (2, B, KH * G, S, D)
__global__ void head_sum_kernel(const __nv_bfloat16* __restrict__ part,
                                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                int B, int S, int KH, int G, int D) {
  const size_t chunks = size_t(B) * S * KH * (D / 8);
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 2 * chunks) return;
  const int which = idx >= chunks;
  size_t n = idx - which * chunks;  // (b, t, kvh, c8) in the output's order
  const int c8 = n % (D / 8);
  n /= D / 8;
  const int kvh = n % KH;
  n /= KH;
  const int t = n % S;
  const int b = n / S;
  const __nv_bfloat16* src = part + which * (chunks * 8 * G)
                             + ((size_t(b) * KH + kvh) * G * S + t) * D + c8 * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int g = 0; g < G; ++g) {
    float f[8];
    ecg::unpack8(*reinterpret_cast<const uint4*>(src + size_t(g) * S * D), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(acc[e], f[e]);
  }
  __nv_bfloat16* dst = (which ? dv : dk) + (((size_t(b) * S + t) * KH + kvh) * D + c8 * 8);
  *reinterpret_cast<uint4*>(dst) = ecg::pack8(acc);
}

template <int D, int kWhich>
cudaError_t launch_dkv(const dim3& grid, cudaStream_t st, const __nv_bfloat16* qg,
                       const __nv_bfloat16* k, const __nv_bfloat16* v, const int* mask,
                       const __nv_bfloat16* dout, const float* lse, const float* delta,
                       __nv_bfloat16* dk_h, __nv_bfloat16* dv_h, int S, int KH, int G,
                       float scale) {
  const size_t smem = DkvSmem<D>::bytes;
  cudaError_t err = ecg::allow_smem(flash_dkv_kernel<D, kWhich>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<D, kWhich><<<grid, kThreads, smem, st>>>(qg, k, v, mask, dout, lse, delta,
                                                            dk_h, dv_h, S, KH, G, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* qg_, const void* k_, const void* v_, const void* mask_,
                       const void* out_, const void* lse_, const void* dout_, void* dq_,
                       void* dk_, void* dv_, void* delta_, void* part_, int B, int S, int KH,
                       int G, cudaStream_t st) {
  const auto* qg = static_cast<const __nv_bfloat16*>(qg_);
  const auto* k = static_cast<const __nv_bfloat16*>(k_);
  const auto* v = static_cast<const __nv_bfloat16*>(v_);
  const auto* mask = static_cast<const int*>(mask_);
  const auto* out = static_cast<const __nv_bfloat16*>(out_);
  const auto* lse = static_cast<const float*>(lse_);
  const auto* dout = static_cast<const __nv_bfloat16*>(dout_);
  auto* dq = static_cast<__nv_bfloat16*>(dq_);
  auto* delta = static_cast<float*>(delta_);
  auto* dk_h = static_cast<__nv_bfloat16*>(part_);
  auto* dv_h = dk_h + size_t(B) * KH * G * S * D;
  const float scale = float(1.0 / sqrt(double(D)));

  cudaError_t err = ecg::allow_smem(flash_dq_kernel<D>, DqSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  const int bq = kRows / G;
  flash_dq_kernel<D><<<dim3((S + bq - 1) / bq, KH, B), kThreads, DqSmem<D>::bytes, st>>>(
      qg, k, v, mask, out, lse, dout, dq, delta, S, KH, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((S + kKeys - 1) / kKeys, KH * G, B);
  if constexpr (D < 128) {
    err = launch_dkv<D, kDV | kDK>(grid, st, qg, k, v, mask, dout, lse, delta, dk_h, dv_h, S,
                                   KH, G, scale);
  } else {
    err = launch_dkv<D, kDV>(grid, st, qg, k, v, mask, dout, lse, delta, dk_h, dv_h, S, KH, G,
                             scale);
    if (err != cudaSuccess) return err;
    err = launch_dkv<D, kDK>(grid, st, qg, k, v, mask, dout, lse, delta, dk_h, dv_h, S, KH, G,
                             scale);
  }
  if (err != cudaSuccess) return err;
  const size_t threads = 2 * size_t(B) * S * KH * (D / 8);
  head_sum_kernel<<<unsigned((threads + 255) / 256), 256, 0, st>>>(
      dk_h, static_cast<__nv_bfloat16*>(dk_), static_cast<__nv_bfloat16*>(dv_), B, S, KH, G, D);
  return cudaGetLastError();
}

}  // namespace

// delta: f32 scratch of B * KH * G * S values, written by the first kernel
// and read by the second; part: bf16 scratch of 2 * B * KH * G * S * D
// values, each query head's dK and dV, read by the third.
extern "C" int ecg_flash_attention_bwd(const void* qg, const void* k, const void* v,
                                       const void* pad_mask, const void* out, const void* lse,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* delta, void* part, int B, int S, int KH, int G,
                                       int D, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || kRows % G != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_bwd<64>(qg, k, v, pad_mask, out, lse, dout, dq, dk, dv, delta, part, B, S,
                             KH, G, st);
    case 128:
      return launch_bwd<128>(qg, k, v, pad_mask, out, lse, dout, dq, dk, dv, delta, part, B, S,
                             KH, G, st);
    case 256:
      return launch_bwd<256>(qg, k, v, pad_mask, out, lse, dout, dq, dk, dv, delta, part, B, S,
                             KH, G, st);
    default: return cudaErrorInvalidValue;
  }
}
