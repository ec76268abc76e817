// Tile helpers of the FMA attention forwards: the prefill kernel
// (attention_prefill.cu) and the flash kernel (flash_attention.cu).
//
// Every step from the Q.K dot products to p = exp(s - m) / l lives here,
// with explicit round-to-nearest intrinsics (__fmul_rn, __fsub_rn,
// __fmaf_rn), so the compiler fuses no multiply into a later add.  The
// backwards (attention_bwd_tc.cuh) do
// not share them: they sum the scores on the tensor cores, so their
// recomputed probabilities agree with each other, not with the forward's
// bit for bit.  Nothing in the function needs the bits to agree (the TPU
// kernel's bit-identical recompute came from running the forward's code),
// and the backward's check against plain bounds the difference.
//
// Layouts are the JAX ones: q-like tensors (q, out, dout) (B, S, KH, G, D),
// k and v (B, S, KH, D), bf16; pad_mask (B, S) int32, 1 = valid key.  A
// query tile holds 64 rows: 64 / G positions x the G query heads of one
// KV head, row r = position s0 + r / G, head r % G.  A key tile holds 64
// keys.  Tiles sit in shared memory with a row stride of D + 2 bf16, which
// spreads rows over the banks (16-byte rows would all start on one bank).
#pragma once

#include "common.cuh"

namespace ecg {

constexpr int kRows = 64;      // query rows per tile
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kPStride = 66;   // f32 row stride of a 64 x 64 tile in shared memory

template <int D>
struct Tile {
  static constexpr int kStride = D + 2;         // bf16 row stride in shared memory
  static constexpr int kStride2 = kStride / 2;  // the same in bf16 pairs
  static constexpr size_t kBytes = size_t(64) * kStride * 2;
};

// Keys [t0, t0 + 64) of a (B, S, KH, D) tensor, head kvh, into a padded
// shared tile; keys past S read as zeros.  No barrier.
template <int D>
__device__ __forceinline__ void load_key_tile(const __nv_bfloat16* __restrict__ src,
                                              __nv_bfloat16* dst, int b, int S, int KH,
                                              int kvh, int t0, int tid) {
  constexpr int kChunks = D / 8;
  for (int idx = tid; idx < kKeys * kChunks; idx += kThreads) {
    const int j = idx / kChunks, c = idx % kChunks;
    const int t = t0 + j;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < S) val = *reinterpret_cast<const uint4*>(src + ((size_t(b) * S + t) * KH + kvh) * D + c * 8);
    store_words(dst + j * Tile<D>::kStride + c * 8, val);
  }
}

// The query tile at position s0 of a (B, S, KH, G, D) tensor, head kvh,
// into a padded shared tile; rows past S read as zeros.  No barrier.
template <int D>
__device__ __forceinline__ void load_query_tile(const __nv_bfloat16* __restrict__ src,
                                                __nv_bfloat16* dst, int b, int S, int KH,
                                                int G, int kvh, int s0, int tid) {
  constexpr int kChunks = D / 8;
  const size_t pos_stride = size_t(KH) * G * D;
  const size_t base = (size_t(b) * S * KH + kvh) * G * D;
  for (int idx = tid; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int s = s0 + r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S) val = *reinterpret_cast<const uint4*>(src + base + s * pos_stride + (r % G) * D + c * 8);
    store_words(dst + r * Tile<D>::kStride + c * 8, val);
  }
}

// key_ok[j] = pad_mask[b, t0 + j], 0 past S.  No barrier.
__device__ __forceinline__ void load_key_ok(const int* __restrict__ pad_mask, int* key_ok, int b,
                                            int S, int t0, int tid) {
  if (tid < kKeys) {
    const int t = t0 + tid;
    key_ok[tid] = (t < S) ? pad_mask[size_t(b) * S + t] : 0;
  }
}

// Let a kernel take more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// acc[i][j] = sum_d A[4 tr + i][d] * B[8 j + tc][d] over two padded tiles,
// one fmaf per element in the order of d.
template <int D>
__device__ __forceinline__ void dot_4x8(const __nv_bfloat16* A, const __nv_bfloat16* B, int tr,
                                        int tc, float (&acc)[4][8]) {
  constexpr int kS2 = Tile<D>::kStride2;
  const __nv_bfloat162* A2 = reinterpret_cast<const __nv_bfloat162*>(A);
  const __nv_bfloat162* B2 = reinterpret_cast<const __nv_bfloat162*>(B);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int dp = 0; dp < D / 2; ++dp) {
    float2 af[4], bf[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) af[i] = __bfloat1622float2(A2[(tr * 4 + i) * kS2 + dp]);
#pragma unroll
    for (int j = 0; j < 8; ++j) bf[j] = __bfloat1622float2(B2[(j * 8 + tc) * kS2 + dp]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = __fmaf_rn(af[i].x, bf[j].x, acc[i][j]);
        acc[i][j] = __fmaf_rn(af[i].y, bf[j].y, acc[i][j]);
      }
  }
}

// The masked, scaled score of a dot product: the finite -1e30 fill where
// the key is padding or lies after the query position.
__device__ __forceinline__ float masked_score(float dot, bool ok, float scale) {
  return ok ? __fmul_rn(dot, scale) : kNegInf;
}

// The softmax probability exp(s - m) / l in f32, before any bf16 rounding.
__device__ __forceinline__ float probability(float s, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), l);
}

// Row max m and row sum l of exp(s - m) for the query tile in Qs (rows
// 4 tr + i, query positions qpos[i]) over key tiles [0, t_end), the sum
// rescaled whenever the max grows.  Stages each key tile in Ks / key_ok;
// starts every tile with a barrier, so Qs may be written just before.
template <int D>
__device__ __forceinline__ void softmax_stats(const __nv_bfloat16* __restrict__ k,
                                              const int* __restrict__ pad_mask,
                                              const __nv_bfloat16* Qs, __nv_bfloat16* Ks,
                                              int* key_ok, int b, int S, int KH, int kvh,
                                              int t_end, const int (&qpos)[4], int tr, int tc,
                                              int tid, float scale, float (&m)[4], float (&l)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int t0 = 0; t0 < t_end; t0 += kKeys) {
    __syncthreads();
    load_key_tile<D>(k, Ks, b, S, KH, kvh, t0, tid);
    load_key_ok(pad_mask, key_ok, b, S, t0, tid);
    __syncthreads();
    float sc[4][8];
    dot_4x8<D>(Qs, Ks, tr, tc, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + j * 8 + tc;
        sc[i][j] = masked_score(sc[i][j], key_ok[j * 8 + tc] != 0 && t <= qpos[i], scale);
      }
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, sc[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) rs = __fadd_rn(rs, expf(__fsub_rn(sc[i][j], m_new)));
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 2));
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 4));
      l[i] = __fmaf_rn(l[i], expf(__fsub_rn(m[i], m_new)), rs);
      m[i] = m_new;
    }
  }
}

}  // namespace ecg
