// Backward of causal grouped-query prefill attention with a left-pad key mask.
//
// Replaces the Pallas kernel _bwd_kernel of ecg_byte_tpu/ops/attention_resident.py
// (reached through _resident_bwd).  Inputs are the forward's qg, k, v,
// pad_mask, its bf16 output out and the output gradient dout, in the
// forward's layouts; outputs dq (like qg), dk and dv (like k), bf16.
//
//   P     = softmax(mask(Q K^T * scale)) in f32, exact: each row's max and
//           sum over all its keys, recomputed (the forward saves none)
//   dV    = bf16(P)^T dO
//   dP    = dO V^T                                  f32
//   delta = rowsum(dO_f32 * O_f32)                  O: the saved bf16 output
//   dS    = bf16(P * (dP - delta) * scale)
//   dQ    = dS K,   dK = dS^T Q                     f32 sums, bf16 results
//
// dK and dV sum in f32 over all G query heads of a KV head and round once,
// as the TPU kernel carries them in VMEM across its query blocks.
//
// The kernels are the tensor-core core of attention_bwd_tc.cuh under its
// resident policy (what bounds them and the design are described there):
// a dQ kernel whose first pass computes each row's max m and sum l from
// tensor-core scores and writes m, l and delta to the stats scratch, and a
// dK/dV kernel over key tiles that reads them.  P is recomputed in the
// backward and is the same P in both kernels, and the forward's
// (attention_prefill.cu) bit for bit: the forward runs the same score
// product and the same first pass (row_stats) and prob.
//
// A left-pad row attends to no valid key: its m is the -1e30 fill and its
// P the mean over the keys it visits, finite.  On the training path these
// rows' dout is zero, and so are their contributions.

#include "attention_bwd_tc.cuh"

// stats: f32 scratch of 3 * B * KH * S * G values (m, l, delta per row),
// written by the first kernel and read by the second.
extern "C" int ecg_prefill_attention_bwd(const void* qg, const void* k, const void* v,
                                         const void* pad_mask, const void* out,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* stats, int B, int S, int KH, int G, int D,
                                         void* stream) {
  const ecg::bwd::Args a{static_cast<const __nv_bfloat16*>(qg),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v),
                         static_cast<const int*>(pad_mask),
                         static_cast<const __nv_bfloat16*>(out),
                         static_cast<const __nv_bfloat16*>(dout),
                         nullptr,
                         static_cast<__nv_bfloat16*>(dq),
                         static_cast<__nv_bfloat16*>(dk),
                         static_cast<__nv_bfloat16*>(dv),
                         static_cast<float*>(stats),
                         B, S, KH, G,
                         float(1.0 / sqrt(double(D)))};
  return ecg::bwd::launch<false>(a, D, static_cast<cudaStream_t>(stream));
}
