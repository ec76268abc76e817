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
// finite: not the plain version's value there, nor the TPU kernel's, and
// read by nothing (attention_fwd_tc.cuh).  The logits are wgmma's bf16
// product with one chained f32 accumulator, which leans toward zero by
// about half an f32 ulp; measured on an H100, summing them to nearest moves
// a training step no closer to f32 (attention_bwd_tc.cuh).
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

namespace {

using ecg::bwd::Dot;

template <Dot kD, bool kIeee = false>
cudaError_t launch_dot(const ecg::fwd::Args& a, cudaStream_t st) {
  constexpr int bytes = ecg::fwd::Smem<64, false>::kBytes + (kIeee ? 64 * 64 * 4 : 0);
  return ecg::bwd::launch_kernel(ecg::fwd::fwd_dot_kernel<64, kD, kIeee>, bytes,
                                 ecg::fwd::blocks(a), st, a);
}

// S = Q K^T of T independent 64-row tiles, in f32, as kD sums it: q and k
// (T, 64, D) bf16, out (T, 64, 64) f32.  One block a tile.
template <int D, Dot kD>
__global__ void __launch_bounds__(ecg::bwd::kThreads, 1)
    scores_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k, float* out) {
  using namespace ecg;
  using namespace ecg::bwd;
  constexpr int kT = TileT<D>::kBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ks = Qs + kT;
  const int tid = threadIdx.x, t = blockIdx.x;
  Args a{};  // (T, 64, 1, D): tile t is "batch row" t of 64 positions
  a.B = gridDim.x;
  a.S = kTile;
  a.KH = 1;
  a.G = 1;
  load_k_tile<D>(Qs, q, a, t, 0, 0, tid);
  load_k_tile<D>(Ks, k, a, t, 0, 0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();
  float s[32];
  wgmma_fence();
  scores<D, kD>(s, Qs, Ks);
  wgmma_commit();
  wgmma_wait<0>();
  const int w = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  float* o = out + size_t(t) * kTile * kTile;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    o[(16 * w + g + 8 * ((j >> 1) & 1)) * kTile + 8 * (j >> 2) + 2 * c + (j & 1)] = s[j];
  }
}

template <Dot kD>
cudaError_t launch_scores(const void* q, const void* k, void* out, int T, cudaStream_t st) {
  constexpr int bytes = 2 * ecg::bwd::TileT<64>::kBytes + 1024;
  scores_kernel<64, kD><<<T, ecg::bwd::kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// The resident forward with its arithmetic changed, D = 64 only: a
// diagnostic for chip_smoke.py --blame, never on a model's path.
// ``variant``: the score product summed as 0 kChain, 1 kSplit, 2 kFma of
// attention_bwd_tc.cuh says; 3 kFma with every other step rounded to
// nearest too, P.V on f32 FMAs and p = expf(s - m) / l (kIeee).
extern "C" int ecg_prefill_attention_dot(const void* qg, const void* k, const void* v,
                                         const void* pad_mask, void* out, int B, int S, int KH,
                                         int G, int D, int variant, void* stream) {
  if (D != 64 || B <= 0 || S <= 0 || KH <= 0 || G <= 0 || ecg::bwd::kTile % G != 0) {
    return cudaErrorInvalidValue;
  }
  const ecg::fwd::Args a{static_cast<const __nv_bfloat16*>(qg),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v),
                         static_cast<const int*>(pad_mask),
                         static_cast<__nv_bfloat16*>(out),
                         nullptr,
                         B, S, KH, G,
                         float(1.0 / sqrt(double(D)))};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_dot<Dot::kChain>(a, st);
    case 1: return launch_dot<Dot::kSplit>(a, st);
    case 2: return launch_dot<Dot::kFma>(a, st);
    case 3: return launch_dot<Dot::kFma, true>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The score product alone: out (T, 64, 64) f32 = q . k^T of each of T tile
// pairs, q and k (T, 64, 64) bf16, summed as ``dot`` says; for reading the
// rounding of each way against an f64 dot (chip_smoke.py --blame).
extern "C" int ecg_attention_scores(const void* q, const void* k, void* out, int T, int D,
                                    int dot, void* stream) {
  if (D != 64 || T <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dot) {
    case 0: return launch_scores<Dot::kChain>(q, k, out, T, st);
    case 1: return launch_scores<Dot::kSplit>(q, k, out, T, st);
    case 2: return launch_scores<Dot::kFma>(q, k, out, T, st);
    default: return cudaErrorInvalidValue;
  }
}
