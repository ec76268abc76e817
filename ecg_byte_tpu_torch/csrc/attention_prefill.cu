// Causal grouped-query prefill attention, forward, with a left-pad key mask.
//
// Replaces the Pallas kernel _fwd_kernel of ecg_byte_tpu/ops/attention_resident.py
// (reached through _resident_impl).  Layouts are the JAX ones: qg and out
// (B, S, KH, G, D), k and v (B, S, KH, D), all bf16; pad_mask (B, S) int32,
// 1 = valid key.
//
//   out[b,s,kh,g] = softmax_t(q.k_t / sqrt(D), masked) . v   over keys t
//   key t is allowed for query s iff t <= s and pad_mask[b,t] != 0
//
// Logits and softmax in f32, an exact softmax: each row's max m and sum l
// over all its keys, then p = exp(s - m) / l (as exp(s - m) * (1 / l)),
// rounded to bf16 after normalisation as the TPU kernel and the plain
// version round it; P.V accumulates in f32.  That takes two passes over the
// keys (statistics, then the recomputed scores and P.V): an online softmax
// rounds unnormalised probabilities, and through 16 random layers that
// difference grew past the end-to-end bound.  A masked key gets the finite
// -1e30, so a left-pad row ends with the mean of V over the keys it visits,
// finite.
//
// What bounds it on the H100: operations (17.2 GFLOP over the causal pairs
// at B4 S1024, 32 query heads over 8 KV heads of 64, plus half again for the
// first pass's scores, against 42 MB).  The kernel is the tensor-core core
// of attention_fwd_tc.cuh under its resident policy: both products on
// wgmma, P fed to P.V from registers, one block per (64 query rows, KV
// head, batch row), keys in 64-key tiles to the tile's causal edge through
// a two-stage cp.async ring.  Its first pass is the backward's (row_stats
// of attention_bwd_tc.cuh), so the backward recomputes this P bit for bit.

#include "attention_fwd_tc.cuh"

extern "C" int ecg_prefill_attention(const void* qg, const void* k, const void* v,
                                     const void* pad_mask, void* out, int B, int S, int KH,
                                     int G, int D, void* stream) {
  const ecg::fwd::Args a{static_cast<const __nv_bfloat16*>(qg),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v),
                         static_cast<const int*>(pad_mask),
                         static_cast<__nv_bfloat16*>(out),
                         nullptr,
                         B, S, KH, G,
                         float(1.0 / sqrt(double(D)))};
  return ecg::fwd::launch<false>(a, D, static_cast<cudaStream_t>(stream));
}
