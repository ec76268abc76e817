// Weight-only int8 linear: bf16 activations times int8 weights with one
// bf16 scale per output channel.
//
// The card's counterpart of the JAX package's int8 serving product
// (ecg_byte_tpu/models/transformer.py _kernel_matmul and _unembed), which
// has no Pallas kernel: there XLA fuses q.astype(bf16) into the dot's
// operand read.  x (M, K) bf16, q (N, K) int8 (PyTorch's (out, in) layout),
// scale (N,) bf16, optional bias (N,) bf16:
//
//   y[m, n] = bf16(bf16(sum_k x[m, k] * q[n, k]) * scale[n]) (+ bias[n])
//
// in the JAX code's rounding order: the dot accumulates in f32 and rounds
// to bf16, the scale multiplies the rounded dot, and the bias comes after
// the scale (each step rounded to bf16).  The output is bf16, or f32
// holding the same bf16 values for the LM head, whose logits the model
// returns in f32.
//
// What bounds it on the H100: at decode (M = batch rows, up to
// ops/int8_linear.GEMV_MAX_M) the bytes of the weight, read once, so a warp
// owns an output row and its lanes stream the row in 16-byte loads,
// converting int8 to f32 in registers; x (a few KB) comes from L1.  A warp
// reduction and the scale/bias epilogue finish the row: one launch per
// projection and no dequantized copy of the weight.  Above GEMV_MAX_M rows
// the wrapper takes the tensor-core kernel (csrc/int8_linear_tc.cu); forced
// here at more rows, this kernel takes them 8 at a time (grid.y), on f32
// FMAs.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;  // int8 weights per 16-byte load

// Sixteen int8 values packed in 16 bytes -> sixteen floats (exact).
__device__ __forceinline__ void unpack_int8x16(uint4 raw, float* f) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kChunk; ++i) f[i] = static_cast<float>(b[i]);
}

// One warp owns output row n and input rows m0..m0+MT-1.
template <int MT, bool kF32Out>
__global__ void __launch_bounds__(kThreads)
int8_linear_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ bias, void* __restrict__ out, int M, int N,
                   int K) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * MT;
  if (n >= N) return;  // the whole warp leaves together
  const int chunks = K / kChunk;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  const uint4* row = reinterpret_cast<const uint4*>(q + size_t(n) * K);
#pragma unroll 2
  for (int c = lane; c < chunks; c += 32) {
    float w[kChunk];
    unpack_int8x16(__ldg(row + c), w);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m < M) {
        const uint4* xr = reinterpret_cast<const uint4*>(x + size_t(m0 + m) * K) + 2 * c;
        float xf[kChunk];
        ecg::unpack8(__ldg(xr), xf);
        ecg::unpack8(__ldg(xr + 1), xf + 8);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) acc[m] = fmaf(xf[e], w[e], acc[m]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float dot = ecg::warp_sum(acc[m]);
    const int r = m0 + m;
    if (lane == 0 && r < M) {
      float y = ecg::round_bf16(dot);
      y = ecg::round_bf16(y * __bfloat162float(scale[n]));
      if (bias != nullptr) y = ecg::round_bf16(y + __bfloat162float(bias[n]));
      const size_t o = size_t(r) * N + n;
      if constexpr (kF32Out) {
        static_cast<float*>(out)[o] = y;
      } else {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y);
      }
    }
  }
}

template <int MT>
int launch(const void* x, const void* q, const void* scale, const void* bias, void* out, int M,
           int N, int K, int f32_out, cudaStream_t stream) {
  const dim3 grid((N + kWarps - 1) / kWarps, (M + MT - 1) / MT);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  if (f32_out) {
    int8_linear_kernel<MT, true><<<grid, kThreads, 0, stream>>>(xb, qb, sb, bb, out, M, N, K);
  } else {
    int8_linear_kernel<MT, false><<<grid, kThreads, 0, stream>>>(xb, qb, sb, bb, out, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ecg_int8_linear(const void* x, const void* q, const void* scale, const void* bias,
                               void* out, int M, int N, int K, int f32_out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kChunk != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 4) return launch<8>(x, q, scale, bias, out, M, N, K, f32_out, s);
  if (M > 2) return launch<4>(x, q, scale, bias, out, M, N, K, f32_out, s);
  if (M > 1) return launch<2>(x, q, scale, bias, out, M, N, K, f32_out, s);
  return launch<1>(x, q, scale, bias, out, M, N, K, f32_out, s);
}
