// The tensor-core core of both attention forwards: the resident one
// (attention_prefill.cu, the TPU's _fwd_kernel of
// ecg_byte_tpu/ops/attention_resident.py) and the flash one
// (flash_attention.cu, _fwd_kernel of ecg_byte_tpu/ops/flash_attention.py).
// Both compute out = bf16(softmax-like(mask(Q K^T * scale)) . V) for causal
// grouped-query attention with a left-pad key mask, and differ in the
// policy kFlash:
//
//   - resident: an exact softmax.  A first pass over the keys finds each
//     row's max m and sum l (row_stats, shared with the backward's dQ
//     kernel); the second recomputes the scores, forms p = exp(s - m) *
//     (1 / l), the normalised probability (the multiply by 1 / l is the
//     backward's prob, within an ulp of the division), rounds it to bf16
//     and accumulates P.V in f32.  Keys run to the tile's causal edge.
//   - flash: keys in blocks of 128, the TPU kernel's block_k.  Per block
//     the row max steps once, m_new = max(m, max_block s), p = exp(s -
//     m_new) enters the row sum l unrounded and P.V rounded to bf16, and l
//     and the accumulator are rescaled by exp(m - m_new).  At the end out =
//     bf16(acc / l) and lse = m + log(l).  A row visits the key blocks up to
//     the end of its own 128-row query block, keys past S included (they
//     are masked): a left-pad row, whose every key is masked, ends with p =
//     1 on each of them, finite, as in the JAX kernel.
//
// What bounds them on the H100: operations.  Over the causal pairs the two
// products are 17.2 GFLOP at B4 S1024 (32 query heads over 8 KV heads of
// 64; 16.0 with 37 left-pad positions; the resident policy's first pass
// adds half again) and 68.7 GFLOP at B1 S4096 (59.0 with 300 left-pad
// positions), against 42 MB of inputs and outputs at either shape: 400 and
// 1,600 operations a byte, past the card's 295.  So both products run on
// wgmma (m64nNk16, bf16 in, f32 accumulators):
//
//   - S = Q K^T takes both operands from shared memory: Q stays in its
//     swizzled tile, K streams through a two-stage cp.async ring;
//   - P.V takes A from registers: the score accumulator becomes, element
//     for element, the bf16 A fragment (to_fragments), so P never passes
//     through shared memory; V is read N-major from its swizzled tile, so
//     no tile is copied transposed.
//
// Design.  One warpgroup a block, one block per (64 query rows, KV head,
// batch row), heaviest tiles first so the short ones fill the tail.  Rows
// fold the G query heads of the KV head (row r: position s0 + r / G, head
// r % G, G a power of two, so shifts), so each K/V tile serves all of them.
// The flash policy's ring stage holds a whole 128-key block (two 64-key K
// tiles and two V tiles): both score products are issued before the max
// steps, so it steps exactly at the TPU kernel's boundary (a max that
// stepped every 64 keys would round p against another value).  Its D = 256
// instance has one stage (two would exceed 227 KB), as the flash backward.
// The element-wise step is what paid off in the backward: no integer
// division, m and 1 / l per row, exp2 for exp (exp_f).
//
// The tile loaders, the score product, to_fragments, the N-major P.V, the
// row store, the resident first pass and prob are the backward core's
// (attention_bwd_tc.cuh), so the resident forward's P, before its bf16
// rounding, is bit for bit the P its backward recomputes.  The score
// product stays on wgmma with one chained accumulator; that header gives
// its measured lean toward zero and why it stays.
//
// A row whose every key is masked (a left-pad row) is the mean of V over
// the keys it visits, up to its tile's causal edge.  The plain version
// spreads such a row over every key that is not both padded and after it,
// the TPU kernel over all S keys: three values where nothing reads one (a
// valid query masks every pad key).  On the card, a diagnostic forward
// with f32 FMA scores, f32 FMA P.V and p = expf(s - m) / l left a LoRA
// step as far from f32 as this kernel at positions that counted the last
// pad row's logits, and plain with this kernel's pad rows as far again:
// checks hold only predictions made at valid positions
// (chip_smoke.valid_predictions).  fwd_dot_kernel builds that diagnostic
// forward (kIeee) and the others of chip_smoke.py --blame.
#pragma once

#include "attention_bwd_tc.cuh"

namespace ecg {
namespace fwd {

using bwd::kBlock;
using bwd::kThreads;
using bwd::kTile;

// One forward call: qg and out (B, S, KH, G, D), k and v (B, S, KH, D),
// bf16; pad_mask (B, S) int32, 1 = valid key; lse (B, KH, G, S) f32, flash
// only.
struct Args {
  const __nv_bfloat16* qg;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* pad_mask;
  __nv_bfloat16* out;
  float* lse;
  int B, S, KH, G;
  float scale;
};

template <int D, bool kFlash>
struct Smem {
  static constexpr int kSub = kFlash ? kBlock / kTile : 1;  // 64-key tiles a stage: one max step
  static constexpr int kKeys = kSub * kTile;
  static constexpr int kT = bwd::TileT<D>::kBytes;
  static constexpr int kStages = (kFlash && D == 256) ? 1 : 2;
  static constexpr int kStage = 2 * kSub * kT + 1024;  // K tiles, V tiles; key_ok
  static constexpr int kBytes = kT + kStages * kStage + 1024;  // Q; the ring; alignment slack
};

// The body of one forward block, its scores summed as kD says.  kIeee, a
// diagnostic (chip_smoke.py --blame) with kD = kFma: every step rounds to
// nearest, p = expf(s - m) / l (else exp_f and 1 / l) and P.V as f32 FMAs
// on the CUDA cores from P staged in pbuf, a 64 x 64 f32 tile in shared
// memory (else wgmma, one accumulator over every key tile).
template <int D, bool kFlash, bwd::Dot kD, bool kIeee = false>
__device__ __forceinline__ void fwd_block(const Args& a, float* pbuf = nullptr) {
  using P = bwd::Policy<kFlash>;
  using L = Smem<D, kFlash>;
  constexpr int kT = L::kT, kSub = L::kSub, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = bwd::align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* ring = smem + kT;

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  const int G = a.G, gsh = __ffs(G) - 1, bq = kTile >> gsh;
  const int n_qt = (a.S + bq - 1) / bq;
  const int qt = n_qt - 1 - int(blockIdx.x / (a.B * a.KH));  // heaviest tiles first
  const int kvh = blockIdx.x % a.KH, b = (blockIdx.x / a.KH) % a.B;
  const int s0 = qt * bq;
  // the ring's steps: resident, 64-key tiles to the tile's causal edge;
  // flash, 128-key blocks to the end of the tile's own query block
  const int n_st = kFlash ? s0 / kBlock + 1 : (P::key_end(s0, bq, a.S) + kTile - 1) / kTile;

  auto load_keys = [&](int st, int t0, bool with_v) {
    unsigned char* ks = ring + st * L::kStage;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      bwd::load_k_tile<D>(ks + u * kT, a.k, a, b, kvh, t0 + u * kTile, tid);
      if (with_v) bwd::load_k_tile<D>(ks + (kSub + u) * kT, a.v, a, b, kvh, t0 + u * kTile, tid);
    }
    if (tid < L::kKeys) {
      const int t = t0 + tid;
      reinterpret_cast<int*>(ks + 2 * kSub * kT)[tid] =
          t < a.S ? a.pad_mask[size_t(b) * a.S + t] : 0;
    }
  };

  bwd::load_q_tile<D>(Qs, a.qg, a, b, kvh, s0, gsh, 0, tid);
  cp_async_commit();

  // this thread's rows 16 w + g + 8 h: their positions
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = s0 + ((16 * w + g + 8 * h) >> gsh);

  // the masked, scaled score of accumulator element j of the 64-key tile
  // at key t0 (the dQ kernel's)
  auto score = [&](float dot, const int* key_ok, int j, int t0) {
    const int h = (j >> 1) & 1, col = 8 * (j >> 2) + 2 * c + (j & 1);
    return bwd::masked_score(dot, key_ok[col] != 0 && t0 + col <= pos[h], a.scale);
  };

  // flash: the running max and sum; resident: each row's m and 1 / l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if constexpr (!kFlash) {
    bwd::row_stats<D, kD, kIeee>(Qs, ring, L::kStage, n_st,
                                 [&](int st, int t0) { load_keys(st, t0, false); }, score, m, l);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = kIeee ? l[h] : __frcp_rn(l[h]);
  }

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  load_keys(0, 0, true);
  cp_async_commit();
  for (int it = 0; it < n_st; ++it) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // step it is in; every thread is done with step it - 1
    if (kStages > 1 && it + 1 < n_st) load_keys((it + 1) & 1, (it + 1) * L::kKeys, true);
    cp_async_commit();
    const unsigned char* ks = ring + (it % kStages) * L::kStage;
    const int* key_ok = reinterpret_cast<const int*>(ks + 2 * kSub * kT);
    const int t0 = it * L::kKeys;

    float s[kSub][32];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kSub; ++u) bwd::scores<D, kD>(s[u], Qs, ks + u * kT);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[u][j] = score(s[u][j], key_ok + u * kTile, j, t0 + u * kTile);
    }

    if constexpr (kFlash) {
      // the max steps once per 128 keys; p enters the row sum unrounded
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            mx = fmaxf(mx, fmaxf(s[u][4 * i + 2 * h], s[u][4 * i + 2 * h + 1]));
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        float rs = 0.f;
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[u][4 * i + 2 * h + e];
              x = bwd::exp_f(__fsub_rn(x, m_new));
              rs = __fadd_rn(rs, x);
            }
          }
        }
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 2));
        const float corr = bwd::exp_f(__fsub_rn(m[h], m_new));
        l[h] = __fmaf_rn(l[h], corr, rs);
        m[h] = m_new;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          acc[4 * i + 2 * h] = __fmul_rn(acc[4 * i + 2 * h], corr);
          acc[4 * i + 2 * h + 1] = __fmul_rn(acc[4 * i + 2 * h + 1], corr);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int h = (j >> 1) & 1;
          s[u][j] = kIeee ? __fdiv_rn(expf(__fsub_rn(s[u][j], m[h])), l[h])
                          : P::prob(s[u][j], m[h], l[h]);
        }
      }
    }

    if constexpr (kIeee) {
      // bf16(p) through shared memory; out element (r, col) += sum over the
      // tile's keys t in order of p[r][t] v[t][col], one rounding an FMA
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = 16 * w + g + 8 * ((j >> 1) & 1), t = 8 * (j >> 2) + 2 * c + (j & 1);
        pbuf[r * kTile + t] = round_bf16(s[0][j]);
      }
      __syncthreads();
      const unsigned char* vs = ks + kSub * kT;
      for (int t = 0; t < kTile; ++t) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const __nv_bfloat16* vrow = reinterpret_cast<const __nv_bfloat16*>(
              vs + (i / 8) * bwd::TileT<D>::kAtom + swizzled(t, i % 8));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p = pbuf[(16 * w + g + 8 * h) * kTile + t];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[4 * i + 2 * h + e] =
                  __fmaf_rn(p, __bfloat162float(vrow[2 * c + e]), acc[4 * i + 2 * h + e]);
            }
          }
        }
      }
      __syncthreads();  // every thread is done with pbuf
    } else {
      uint32_t pa[kSub][4][4];
#pragma unroll
      for (int u = 0; u < kSub; ++u) bwd::to_fragments(s[u], pa[u]);  // bf16(p)
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kSub; ++u) bwd::rows_product<D>(acc, pa[u], ks + (kSub + u) * kT);  // += P V
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) keep_alive(pa[u][kk]);
      }
    }
    if (kStages == 1 && it + 1 < n_st) {
      __syncthreads();  // every thread is done with the one stage
      load_keys(0, (it + 1) * L::kKeys, true);
      cp_async_commit();
    }
  }

  const int S = a.S, KH = a.KH;
  if constexpr (kFlash) {
    // every row's first key block holds its max at p = 1, so l >= 1; the
    // guard is the JAX kernel's
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float safe_l = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i + 2 * h] = __fdiv_rn(acc[4 * i + 2 * h], safe_l);
        acc[4 * i + 2 * h + 1] = __fdiv_rn(acc[4 * i + 2 * h + 1], safe_l);
      }
      if (c == 0 && pos[h] < S) {
        const int r = 16 * w + g + 8 * h;
        a.lse[P::row(a, b, kvh, pos[h], r & (G - 1))] = __fadd_rn(m[h], logf(safe_l));
      }
    }
  }
  bwd::store_rows<D>(a.out, acc, w, g, c, [&](int r) -> long long {
    const int s = s0 + (r >> gsh);
    return s < S ? (((long long)(b) * S + s) * KH + kvh) * G * D + (r & (G - 1)) * D : -1;
  });
}

// The forward of every caller: the scores as bwd::kDot sums them.
template <int D, bool kFlash>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(const Args a) {
  fwd_block<D, kFlash, bwd::kDot>(a);
}

// The resident forward with its arithmetic changed as the template says: a
// diagnostic that chip_smoke.py --blame alone launches
// (ecg_prefill_attention_dot).  kIeee's P tile follows the ring.
template <int D, bwd::Dot kD, bool kIeee>
__global__ void __launch_bounds__(kThreads, 1) fwd_dot_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  fwd_block<D, false, kD, kIeee>(
      a, reinterpret_cast<float*>(bwd::align1024(smem_raw) + Smem<D, false>::kBytes - 1024));
}

// one block per (64 query rows, KV head, batch row)
inline unsigned blocks(const Args& a) {
  const int bq = kTile / a.G;
  return unsigned(a.B) * a.KH * ((a.S + bq - 1) / bq);
}

template <int D, bool kFlash>
cudaError_t launch_d(const Args& a, cudaStream_t st) {
  return bwd::launch_kernel(fwd_kernel<D, kFlash>, Smem<D, kFlash>::kBytes, blocks(a), st, a);
}

// One forward call on ``st``; D one of 64, 128, 256.
template <bool kFlash>
int launch(const Args& a, int D, cudaStream_t st) {
  if (a.B <= 0 || a.S <= 0 || a.KH <= 0 || a.G <= 0 || kTile % a.G != 0) {
    return cudaErrorInvalidValue;
  }
  switch (D) {
    case 64: return launch_d<64, kFlash>(a, st);
    case 128: return launch_d<128, kFlash>(a, st);
    case 256: return launch_d<256, kFlash>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fwd
}  // namespace ecg
