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
// -1e30, so p = 1 on every key of those blocks, as in the JAX kernels.  dK
// and dV are summed per query head in f32 and rounded to bf16, then summed
// over the G heads of each KV head in f32 and rounded again
// (ops/flash_attention.py:338-343); rounding once after an f32 sum over the
// heads instead moved them 2.6e-3 of their norm, beyond the check's 1e-3.
//
// The kernels are the tensor-core core of attention_bwd_tc.cuh under its
// flash policy (what bounds them and the design are described there): a
// dQ kernel that takes each row's lse from the forward and writes delta,
// and a dK/dV kernel, one block per (key tile, KV head), that walks the G
// query heads in order and keeps their head sum in shared memory, so no
// per-head buffer goes through device memory and no third launch sums it.

#include "attention_bwd_tc.cuh"

// delta: f32 scratch of B * KH * G * S values, written by the first kernel
// and read by the second.
extern "C" int ecg_flash_attention_bwd(const void* qg, const void* k, const void* v,
                                       const void* pad_mask, const void* out, const void* lse,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* delta, int B, int S, int KH, int G, int D,
                                       void* stream) {
  const ecg::bwd::Args a{static_cast<const __nv_bfloat16*>(qg),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v),
                         static_cast<const int*>(pad_mask),
                         static_cast<const __nv_bfloat16*>(out),
                         static_cast<const __nv_bfloat16*>(dout),
                         static_cast<const float*>(lse),
                         static_cast<__nv_bfloat16*>(dq),
                         static_cast<__nv_bfloat16*>(dk),
                         static_cast<__nv_bfloat16*>(dv),
                         static_cast<float*>(delta),
                         B, S, KH, G,
                         float(1.0 / sqrt(double(D)))};
  return ecg::bwd::launch<true>(a, D, static_cast<cudaStream_t>(stream));
}
