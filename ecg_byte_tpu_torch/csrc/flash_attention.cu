// Causal grouped-query flash attention, forward, with a left-pad key mask.
//
// Replaces the Pallas kernel _fwd_kernel of ecg_byte_tpu/ops/flash_attention.py
// (reached through _flash_fwd), which the JAX package runs for S >= 4096.
// Layouts are the JAX ones: qg and out (B, S, KH, G, D), k and v
// (B, S, KH, D), all bf16; pad_mask (B, S) int32, 1 = valid key; lse
// (B, KH, G, S) f32, one row per (batch, query head).
//
// The function (ops/flash_attention.py says why it is not the resident
// kernel's): keys in blocks of 128, and per block
//   m_new = max(m, max_block s),  p = exp(s - m_new) in f32,
//   l = l exp(m - m_new) + sum p,  acc = acc exp(m - m_new) + bf16(p) . v
// then out = bf16(acc / l), lse = m + log(l).  s is the f32 score q.k/sqrt(D),
// or the finite -1e30 where the key is padding or after the query.  Query
// rows come in blocks of 128 too, and a row visits the key blocks up to its
// own query block (the TPU kernel skips the later ones), past S included:
// keys there are masked, and a left-pad row, whose every key is masked, has
// p = exp(-1e30 + 1e30) = 1 on each of them, as in the JAX kernel.
//
// What bounds it on the H100: operations.  At B1 S4096, 32 query heads
// over 8 KV heads of 64, the two products are 68.7 GFLOP over the causal
// pairs against 42 MB of inputs and outputs.  The kernel is the
// tensor-core core of attention_fwd_tc.cuh under its flash policy: both
// products on wgmma, P fed to P.V from registers, one block per (64 query
// rows, KV head, batch row), heaviest tiles first, and a cp.async ring
// whose stage is a whole 128-key block (two 64-key K and V tiles), so both
// score products land before the max steps, exactly at the TPU kernel's
// 128-key boundary (a max that stepped every 64 keys would round p against
// another value).

#include "attention_fwd_tc.cuh"

extern "C" int ecg_flash_attention(const void* qg, const void* k, const void* v,
                                   const void* pad_mask, void* out, void* lse, int B, int S,
                                   int KH, int G, int D, void* stream) {
  const ecg::fwd::Args a{static_cast<const __nv_bfloat16*>(qg),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v),
                         static_cast<const int*>(pad_mask),
                         static_cast<__nv_bfloat16*>(out),
                         static_cast<float*>(lse),
                         B, S, KH, G,
                         float(1.0 / sqrt(double(D)))};
  return ecg::fwd::launch<true>(a, D, static_cast<cudaStream_t>(stream));
}
