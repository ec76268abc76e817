// The tensor-core core of both attention backwards: the resident one
// (attention_prefill_bwd.cu, the TPU's _bwd_kernel of
// ecg_byte_tpu/ops/attention_resident.py) and the flash one
// (flash_attention_bwd.cu, _bwd_dq_kernel and _bwd_dkv_kernel of
// ecg_byte_tpu/ops/flash_attention.py).  Both compute, from the forward's
// qg, k, v, pad_mask, its bf16 output O and the output gradient dO:
//
//   P     = the forward's probabilities, recomputed in f32
//   dV    = bf16(P)^T dO
//   dP    = dO V^T                                  f32
//   delta = rowsum(dO_f32 * O_f32)
//   dS    = bf16(P * (dP - delta) * scale)
//   dQ    = dS K,   dK = dS^T Q                     f32 sums, bf16 results
//
// and differ in four things, the policy kFlash:
//
//   - P's normalisation: resident, exp(s - m) / l with each row's max m and
//     sum l over all its keys, from a first pass of the dQ kernel (the
//     forward saves no statistics); flash, exp(s - lse) with the forward's
//     lse.
//   - the keys a query row visits: resident, up to its tile's causal edge;
//     flash, up to the end of its 128-row query block, as the TPU grid does
//     (a left-pad row, lse = -1e30, has p = 1 on every key of those blocks).
//   - where dK and dV round: resident, once after the f32 sum over the G
//     query heads of a KV head; flash, per query head, then summed over the
//     heads in f32 and rounded again (flash_attention.py:338-343).
//   - the statistics the dK/dV kernel reads: m, l and delta (resident) or
//     lse and delta (flash), m, l and delta written by the dQ kernel.
//
// What bounds it on the H100: operations.  At B4 S1024 (32 query heads
// over 8 KV heads of 64) the five causal products are 42.9 GFLOP against
// 84 MB of inputs and outputs; at B1 S4096, 172 GFLOP against 84 MB.  So
// every product runs on wgmma (m64nNk16, bf16 in, f32 accumulators):
//
//   - the scores S = Q K^T and dP = dO V^T (or, in the dK/dV kernel, their
//     transposes K Q^T and V dO^T) take both operands from shared memory;
//   - dQ = dS K, dV += P^T dO and dK += dS^T Q take A from registers: the
//     f32 accumulator of a score tile is, element for element, the bf16 A
//     fragment of the next product (as FlashAttention-3 feeds P to P.V), so
//     P and dS never pass through shared memory;
//   - B of those three is the K, dO or Q tile the scores read, read
//     N-major (wgmma.cuh), so no tile is copied transposed.
//
// Design.  Hopper blocks run in no order, so the work is split as
// FlashAttention-2 splits it, into a dQ kernel over query tiles and a dK/dV
// kernel over key tiles, one warpgroup a block, on one stream with no
// atomics: a call is deterministic.
//
//   1. dq_kernel, one block per (64 query rows, KV head, batch row),
//      heaviest tiles first.  Rows fold the G query heads of the KV head:
//      row r is position s0 + r / G, head r % G, so each K/V tile serves
//      all of them.  It computes delta, and for the resident policy m and l
//      in a first pass over the key tiles (scores only), writes them for
//      the second kernel, then walks the key tiles again for dQ.
//   2. dkv_kernel, one block per (64 keys, KV head, batch row), first key
//      tiles (the most query tiles) first.  K and V stay in shared memory;
//      it walks the query tiles that see its keys.  Resident, the tiles
//      fold the G heads and dK, dV sum in f32 over all of them.  Flash, it
//      walks the G heads in order, one head's tiles after another, and at
//      the end of each head rounds its dK, dV to bf16 into an f32 head sum
//      in shared memory (each thread its own elements), rounded once at the
//      end: the JAX rounding without a per-head buffer in device memory.
//
// Key and query tiles stream through a two-stage cp.async ring, so the next
// tile lands while the current products run (one stage for flash at
// D = 256, where two stages and the head sums exceed 227 KB).  For
// D >= 128 the dK and dV accumulators do not fit one warpgroup's registers
// beside the score tiles, so the dK/dV kernel runs twice, dV then dK.
//
// Two alternatives measured no faster on an H100 and were not kept: a
// three-stage ring, and issuing a step's score products before waiting for
// the previous step's dQ (or dV, dK) products, so the tensor cores run them
// back to back (ptxas then serializes the wgmma chain, as the accumulators
// in flight meet other instructions).  What did pay was the element-wise
// work: no integer division and no f32 division per score element (the row
// statistics arrive as m and 1 / l), and exp2 for exp.
//
// The dQ and dK/dV kernels take every score from scores<D> (the dK/dV
// kernel's K Q^T is the transpose of Q K^T bit for bit: each element is the
// same sum of the same products in the same order) and share every step
// after it (prob, ds_value), so dQ, dK and dV see one recomputed P.  The
// forwards (attention_fwd_tc.cuh) run the same score product; the resident
// one also takes its m and l from row_stats and its p from prob, so the
// resident backward's recomputed P is, before the bf16 rounding, the
// forward's P bit for bit.  The flash forward's p is exp(s - m_new) against
// a running max, the backward's exp(s - lse): not the same values, as on
// the TPU.
//
// The score arithmetic: wgmma, one f32 accumulator chained over the D / 16
// k16 steps (Dot::kChain).  It does not round to nearest: measured on an
// H100 SXM (chip_smoke.py --blame, Llama-3.2-1B's q and k with its norm
// weights moved off 1, dots that cancel by at most 4x), its scores lean
// toward zero by 0.586 f32 ulp of |s| on either sign against the f64 dot,
// as cuBLAS's bf16 product with f32 output does (the truncation Fasi,
// Higham, Mikaitis and Pranesh found in earlier tensor cores); a zeroed
// accumulator a k16 step leans 0.133 ulp, f32 FMAs 0.001.  The chain stays:
// a LoRA step with the resident forward summing its scores either other way
// ends as far from f32 as with the chain (within 0.5%), and f32 FMA scores
// would cost the tensor cores' pace.  The other two ways stay for that
// diagnostic (Dot).
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace ecg {
namespace bwd {

constexpr int kTile = 64;      // rows of every tile: query rows (dQ), keys (dK/dV)
constexpr int kThreads = 128;  // one warpgroup
constexpr int kBlock = 128;    // flash: the TPU kernels' block_q and block_k
constexpr float kNoRow = 1e30f;  // the statistic of a row past S: p = 0
enum : int { kDV = 1, kDK = 2 };

// e^x as 2^(x log2 e): one multiply and the hardware's exp2, where expf
// spends several more instructions on the last ulp.  The element-wise work
// between the products sets much of a tile's pace, and the function is the
// same to well inside the check's bounds.  Every probability and every sum
// of them in the backward goes through it, so P stays one P.
__device__ __forceinline__ float exp_f(float x) { return exp2f(__fmul_rn(x, 1.4426950408889634f)); }

// A 64 x D bf16 tile in shared memory: D / 64 swizzle atoms of 64 rows x
// 128 bytes.
template <int D>
struct TileT {
  static constexpr int kAtom = kTile * 128;
  static constexpr int kBytes = D / 64 * kAtom;
};

// One backward call.  stats: resident, m, l and delta, R = B * KH * S * G
// values each; flash, delta alone, beside the forward's lse.
struct Args {
  const __nv_bfloat16* qg;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* pad_mask;
  const __nv_bfloat16* out;
  const __nv_bfloat16* dout;
  const float* lse;  // flash only
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;
  int B, S, KH, G;
  float scale;
};

template <bool kFlash>
struct Policy {
  // (b, kvh, position s, query head g) -> its index in the row statistics:
  // resident (B, KH, S, G), flash (B, KH, G, S) as the forward's lse
  template <typename A>
  static __device__ __forceinline__ size_t row(const A& a, int b, int kvh, int s, int g) {
    return kFlash ? ((size_t(b) * a.KH + kvh) * a.G + g) * a.S + s
                  : ((size_t(b) * a.KH + kvh) * a.S + s) * a.G + g;
  }
  // the end of the keys that a tile of query positions [s0, s0 + bq) visits
  static __device__ __forceinline__ int key_end(int s0, int bq, int S) {
    return min(S, kFlash ? (s0 / kBlock + 1) * kBlock : s0 + bq);
  }
  // the first query position that visits key tile t0
  static __device__ __forceinline__ int query_start(int t0) {
    return kFlash ? t0 / kBlock * kBlock : t0;
  }
  // the probability of a masked, scaled score from its row's statistics
  // (m, 1 / l) or (lse, unused), in f32: a multiply, not a division, as the
  // element-wise work and not the tensor cores sets the pace of a tile
  static __device__ __forceinline__ float prob(float s, float st0, float st1) {
    const float e = exp_f(__fsub_rn(s, st0));
    return kFlash ? e : __fmul_rn(e, st1);
  }
};

// The masked, scaled score: the finite -1e30 fill where the key is padding
// or lies after the query position.
__device__ __forceinline__ float masked_score(float dot, bool ok, float scale) {
  return ok ? __fmul_rn(dot, scale) : kNegInf;
}

// dS before its bf16 rounding: P (dP - delta) scale.
__device__ __forceinline__ float ds_value(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// A query-side tile of a (B, S, KH, G, D) tensor into a swizzled tile:
// row r is position s0 + (r >> gsh), query head g0 + r mod 2^gsh of KV head
// kvh (gsh: log2 of the heads folded into a tile, G a power of two since
// it divides 64); rows past S read as zeros.  No commit, no barrier.
template <int D, typename A>
__device__ __forceinline__ void load_q_tile(unsigned char* dst, const __nv_bfloat16* src,
                                            const A& a, int b, int kvh, int s0, int gsh,
                                            int g0, int tid) {
  constexpr int kChunks = D / 8;
  const size_t pos_stride = size_t(a.KH) * a.G * D;
  const __nv_bfloat16* base = src + (size_t(b) * a.S * a.KH + kvh) * a.G * D;
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, j = i % kChunks;
    const int s = s0 + (r >> gsh);
    const bool ok = s < a.S;
    const __nv_bfloat16* p =
        ok ? base + s * pos_stride + (g0 + (r & ((1 << gsh) - 1))) * D + j * 8 : src;
    cp_async16(dst + (j / 8) * TileT<D>::kAtom + swizzled(r, j % 8), p, ok);
  }
}

// Keys [t0, t0 + 64) of a (B, S, KH, D) tensor, head kvh, into a swizzled
// tile; keys past S read as zeros.  No commit, no barrier.
template <int D, typename A>
__device__ __forceinline__ void load_k_tile(unsigned char* dst, const __nv_bfloat16* src,
                                            const A& a, int b, int kvh, int t0, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, j = i % kChunks;
    const int t = t0 + r;
    const bool ok = t < a.S;
    const __nv_bfloat16* p = ok ? src + ((size_t(b) * a.S + t) * a.KH + kvh) * D + j * 8 : src;
    cp_async16(dst + (j / 8) * TileT<D>::kAtom + swizzled(r, j % 8), p, ok);
  }
}

// acc (64 x 64) = A . B^T over D on wgmma, one accumulator chain over the
// k16 steps: both tiles K-major, rows of A the accumulator's rows.  Issues
// the products; the caller commits and waits.  dP = dO V^T (and V dO^T).
template <int D>
__device__ __forceinline__ void tc_product(float* acc, const unsigned char* A,
                                           const unsigned char* Bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * TileT<D>::kAtom;
    wgmma_ss_n64<0>(acc, smem_desc(A + off) + 2 * (kk % 4), smem_desc(Bt + off) + 2 * (kk % 4),
                    kk > 0);
  }
}

// How the score product S = Q K^T sums over D (the header says why every
// kernel takes kChain):
//   kChain  wgmma, one f32 accumulator chained over the D / 16 k16 steps;
//   kSplit  wgmma, each k16 step into a zeroed accumulator, the partials
//           added in f32 round-to-nearest in k order;
//   kFma    f32 FMAs on the CUDA cores, round-to-nearest, d = 0 .. D - 1.
// The kernels of one call all take kDot; the others exist for
// chip_smoke.py --blame (ecg_prefill_attention_dot, ecg_attention_scores).
enum class Dot : int { kChain = 0, kSplit = 1, kFma = 2 };
constexpr Dot kDot = Dot::kChain;

// acc (64 x 64) = A . B^T over D, as kD sums it: both tiles K-major, rows of
// A the accumulator's rows, each accumulator element in wgmma's layout
// (to_fragments).  The caller fences before and commits and waits after, as
// for a wgmma product; kChain returns with the products in flight, kSplit
// and kFma with acc complete.  Element (r, t) is the same function of row r
// of A and row t of B whichever tile is A, so K Q^T is (Q K^T)^T bit for bit.
template <int D, Dot kD = kDot>
__device__ __forceinline__ void scores(float* acc, const unsigned char* A,
                                       const unsigned char* Bt) {
  if constexpr (kD == Dot::kChain) {
    tc_product<D>(acc, A, Bt);
  } else if constexpr (kD == Dot::kSplit) {
    float part[32];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * TileT<D>::kAtom;
      wgmma_fence();
      const uint64_t da = smem_desc(A + off) + 2 * (kk % 4);
      const uint64_t db = smem_desc(Bt + off) + 2 * (kk % 4);
      if (kk == 0) {
        wgmma_ss_n64<0>(acc, da, db, 0);
      } else {
        wgmma_ss_n64<0>(part, da, db, 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (kk > 0) {
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
      }
    }
  } else {
    // this thread's rows r0, r0 + 8 of A and its 16 rows 8 i + 2 c + e of B;
    // element j = 4 i + 2 h + e.  A warp's lanes read 8 rows of A and 4 of
    // B per 16-byte chunk, each in its own bank group under the swizzle.
    const int lane = threadIdx.x & 31;
    const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), c = lane & 3;
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int ch = 0; ch < D / 8; ++ch) {
      const int off = (ch / 8) * TileT<D>::kAtom, jj = ch % 8;
      float q0[8], q1[8];
      unpack8(*reinterpret_cast<const uint4*>(A + off + swizzled(r0, jj)), q0);
      unpack8(*reinterpret_cast<const uint4*>(A + off + swizzled(r0 + 8, jj)), q1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float kv[8];
          unpack8(*reinterpret_cast<const uint4*>(Bt + off + swizzled(8 * i + 2 * c + e, jj)),
                  kv);
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            acc[4 * i + e] = __fmaf_rn(q0[x], kv[x], acc[4 * i + e]);
            acc[4 * i + 2 + e] = __fmaf_rn(q1[x], kv[x], acc[4 * i + 2 + e]);
          }
        }
      }
    }
  }
}

// acc (64 x D) += A (64 x 64, bf16 fragments a[kk] for the k16 steps) . B,
// B a 64 x D tile read N-major (its rows are the contraction).
template <int D>
__device__ __forceinline__ void rows_product(float* acc, const uint32_t (&a)[4][4],
                                             const unsigned char* B) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc_mn(B + kk * 16 * 128, TileT<D>::kAtom);
    if constexpr (D == 64) {
      wgmma_rs_n64<1>(acc, a[kk], db);
    } else if constexpr (D == 128) {
      wgmma_rs_n128<1>(acc, a[kk], db);
    } else {
      wgmma_rs_n256<1>(acc, a[kk], db);
    }
  }
}

// A 64 x 64 f32 accumulator tile -> the bf16 A fragments of a product that
// contracts over its 64 columns.  Accumulator element j of a thread sits at
// row 16 w + g + 8 ((j / 2) % 2), column 8 (j / 4) + 2 c + j % 2; fragment
// register q of k16 step kk holds row g + 8 (q % 2), columns 16 kk + 8 (q /
// 2) + 2c + {0, 1}, so the two layouts agree element for element.
__device__ __forceinline__ void to_fragments(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * (2 * kk + q / 2) + 2 * (q % 2);
      a[kk][q] = pack_bf16x2(x[j], x[j + 1]);
    }
  }
}

// Store a 64 x D f32 accumulator (or D/2 values a thread in its layout) as
// bf16 rows: row r of the tile to dst + row_off(r), rows with row_off < 0
// skipped.
template <int D, typename RowOff>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float* acc, int w, int g,
                                           int c, RowOff row_off) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long off = row_off(16 * w + g + 8 * h);
    if (off < 0) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dst + off + 8 * i + 2 * c) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// The resident policy's first pass over the key tiles [0, n_kt) of the
// query tile in Qs: each row's max m and sum l of exp(s - m) over its keys,
// the sum rescaled whenever the max grows, from the scores alone.  The dQ
// kernel and the resident forward (attention_fwd_tc.cuh) both take their
// statistics from it, so the forward's P and the backward's recomputed P
// are one function summed in one order.  Key tiles stream through a
// two-stage ring at ``ring`` (stages ``stage`` bytes apart, each with its
// key_ok after two tiles): load_keys(st, t0) issues the copies of the tile
// at key t0 into stage st, score(dot, key_ok, j, t0) masks and scales
// accumulator element j.  Ends with a barrier: the ring is free again.
template <int D, Dot kD = kDot, bool kIeee = false, typename LoadKeys, typename Score>
__device__ __forceinline__ void row_stats(const unsigned char* Qs, unsigned char* ring, int stage,
                                          int n_kt, LoadKeys load_keys, Score score,
                                          float (&m)[2], float (&l)[2]) {
  constexpr int kT = TileT<D>::kBytes;
  // kIeee: expf for a diagnostic (chip_smoke.py --blame), else exp_f
  auto ex = [](float x) { return kIeee ? expf(x) : exp_f(x); };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  load_keys(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // tile it is in; every thread is done with tile it - 1
    if (it + 1 < n_kt) load_keys((it + 1) & 1, (it + 1) * kTile);
    cp_async_commit();
    const unsigned char* ks = ring + (it & 1) * stage;
    const int* key_ok = reinterpret_cast<const int*>(ks + 2 * kT);
    float s[32];
    wgmma_fence();
    scores<D, kD>(s, Qs, ks);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = score(s[j], key_ok, j, it * kTile);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        rs = __fadd_rn(rs, ex(__fsub_rn(s[4 * i + 2 * h], m_new)));
        rs = __fadd_rn(rs, ex(__fsub_rn(s[4 * i + 2 * h + 1], m_new)));
      }
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 2));
      l[h] = __fmaf_rn(l[h], ex(__fsub_rn(m[h], m_new)), rs);
      m[h] = m_new;
    }
  }
  __syncthreads();
}

template <int D>
struct DqSmem {
  static constexpr int kT = TileT<D>::kBytes;
  static constexpr int kStage = 2 * kT + 1024;  // K, V; key_ok
  // Q, dO; two stages; delta; alignment slack
  static constexpr int kBytes = 2 * kT + 2 * kStage + 256 + 1024;
};

template <int D, bool kFlash>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const Args a) {
  using P = Policy<kFlash>;
  using L = DqSmem<D>;
  constexpr int kT = L::kT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + kT;
  unsigned char* ring = smem + 2 * kT;
  float* delta_s = reinterpret_cast<float*>(ring + 2 * L::kStage);

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  const int G = a.G, gsh = __ffs(G) - 1, bq = kTile >> gsh;
  const int n_qt = (a.S + bq - 1) / bq;
  const int qt = n_qt - 1 - int(blockIdx.x / (a.B * a.KH));  // heaviest tiles first
  const int kvh = blockIdx.x % a.KH, b = (blockIdx.x / a.KH) % a.B;
  const int s0 = qt * bq;
  const int n_kt = (P::key_end(s0, bq, a.S) + kTile - 1) / kTile;
  const size_t R = size_t(a.B) * a.KH * a.S * G;

  auto load_keys = [&](int st, int t0, bool with_v) {
    unsigned char* ks = ring + st * L::kStage;
    load_k_tile<D>(ks, a.k, a, b, kvh, t0, tid);
    if (with_v) load_k_tile<D>(ks + kT, a.v, a, b, kvh, t0, tid);
    if (tid < kTile) {
      const int t = t0 + tid;
      reinterpret_cast<int*>(ks + 2 * kT)[tid] = t < a.S ? a.pad_mask[size_t(b) * a.S + t] : 0;
    }
  };

  load_q_tile<D>(Qs, a.qg, a, b, kvh, s0, gsh, 0, tid);
  load_q_tile<D>(dOs, a.dout, a, b, kvh, s0, gsh, 0, tid);
  cp_async_commit();

  // delta = rowsum(dO O) in f32 from device memory, two threads a row
  {
    const int r = tid >> 1, half = tid & 1, s = s0 + r / G;
    float part = 0.f;
    if (s < a.S) {
      const size_t off = (((size_t(b) * a.S + s) * a.KH + kvh) * G + r % G) * D + half * (D / 2);
#pragma unroll 4
      for (int j = 0; j < D / 2; j += 8) {
        float o[8], d8[8];
        unpack8(*reinterpret_cast<const uint4*>(a.out + off + j), o);
        unpack8(*reinterpret_cast<const uint4*>(a.dout + off + j), d8);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(d8[e], o[e], part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      delta_s[r] = part;
      if (s < a.S) a.stats[(kFlash ? 0 : 2 * R) + P::row(a, b, kvh, s, r % G)] = part;
    }
  }
  __syncthreads();

  // this thread's rows 16 w + g + 8 h: position, head, statistics
  int pos[2], gh[2];
  float st0[2], st1[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * w + g + 8 * h;
    pos[h] = s0 + r / G;
    gh[h] = r % G;
    delta[h] = delta_s[r];
    st0[h] = 0.f;
    st1[h] = 1.f;
    if constexpr (kFlash) {
      if (pos[h] < a.S) st0[h] = a.lse[P::row(a, b, kvh, pos[h], gh[h])];
    }
  }

  // the masked, scaled score of accumulator element j at key tile t0
  auto score = [&](float dot, const int* key_ok, int j, int t0) {
    const int h = (j >> 1) & 1, col = 8 * (j >> 2) + 2 * c + (j & 1);
    return masked_score(dot, key_ok[col] != 0 && t0 + col <= pos[h], a.scale);
  };

  if constexpr (!kFlash) {
    float m[2], l[2];
    row_stats<D>(Qs, ring, L::kStage, n_kt, [&](int st, int t0) { load_keys(st, t0, false); },
                 score, m, l);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st0[h] = m[h];
      st1[h] = __frcp_rn(l[h]);
      if (c == 0 && pos[h] < a.S) {
        const size_t n = P::row(a, b, kvh, pos[h], gh[h]);
        a.stats[n] = m[h];
        a.stats[R + n] = l[h];
      }
    }
  }

  float dq[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;

  load_keys(0, 0, true);
  cp_async_commit();
  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    if (it + 1 < n_kt) load_keys((it + 1) & 1, (it + 1) * kTile, true);
    cp_async_commit();
    const unsigned char* ks = ring + (it & 1) * L::kStage;
    const int* key_ok = reinterpret_cast<const int*>(ks + 2 * kT);
    float s[32], dp[32];
    wgmma_fence();
    scores<D>(s, Qs, ks);
    tc_product<D>(dp, dOs, ks + kT);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = (j >> 1) & 1;
      const float p = P::prob(score(s[j], key_ok, j, it * kTile), st0[h], st1[h]);
      s[j] = ds_value(p, dp[j], delta[h], a.scale);
    }
    uint32_t ds[4][4];
    to_fragments(s, ds);
    wgmma_fence();
    rows_product<D>(dq, ds, ks);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) keep_alive(ds[kk]);
  }

  const int S = a.S, KH = a.KH;
  store_rows<D>(a.dq, dq, w, g, c, [&](int r) -> long long {
    const int s = s0 + r / G;
    return s < S ? (((long long)(b) * S + s) * KH + kvh) * G * D + (r % G) * D : -1;
  });
}

template <int D, bool kFlash, int kWhich>
struct DkvSmem {
  static constexpr bool kWantDK = (kWhich & kDK) != 0;
  static constexpr int kParts = kWhich == (kDV | kDK) ? 2 : 1;
  static constexpr int kStages = (kFlash && D == 256) ? 1 : 2;
  static constexpr int kT = TileT<D>::kBytes;
  static constexpr int kStage = 2 * kT + 1024;  // Q, dO; three row statistics
  static constexpr int kSum = kFlash ? kParts * kTile * D * 4 : 0;  // f32 head sums
  static constexpr int kBytes = (kWantDK ? 2 : 1) * kT + kStages * kStage + kSum + 1024;
};

template <int D, bool kFlash, int kWhich>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(const Args a) {
  using P = Policy<kFlash>;
  using L = DkvSmem<D, kFlash, kWhich>;
  constexpr bool kWantDV = (kWhich & kDV) != 0;
  constexpr bool kWantDK = L::kWantDK;
  constexpr int kT = L::kT, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + kT;  // with dK only
  unsigned char* ring = smem + (kWantDK ? 2 : 1) * kT;
  float* sums = reinterpret_cast<float*>(ring + kStages * L::kStage);  // flash only

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  const int G = a.G, S = a.S;
  const int kt = int(blockIdx.x / (a.B * a.KH));  // first key tiles (the heaviest) first
  const int kvh = blockIdx.x % a.KH, b = (blockIdx.x / a.KH) % a.B;
  const int t0 = kt * kTile;
  const size_t R = size_t(a.B) * a.KH * S * G;

  // query tiles: resident, the G heads folded (64 / G positions a tile);
  // flash, one head at a time (64 positions), head after head
  const int gsh = kFlash ? 0 : __ffs(G) - 1, bq = kTile >> gsh;
  const int q_start = P::query_start(t0);
  const int per_head = (S - q_start + bq - 1) / bq;
  const int n_it = per_head * (kFlash ? G : 1);

  auto load_queries = [&](int st, int it) {
    unsigned char* qs = ring + st * L::kStage;
    const int g0 = kFlash ? it / per_head : 0, s0 = q_start + (it % per_head) * bq;
    load_q_tile<D>(qs, a.qg, a, b, kvh, s0, gsh, g0, tid);
    load_q_tile<D>(qs + kT, a.dout, a, b, kvh, s0, gsh, g0, tid);
    if (tid < kTile) {
      float* rs = reinterpret_cast<float*>(qs + 2 * kT);
      const int s = s0 + (tid >> gsh), gg = g0 + (tid & ((1 << gsh) - 1));
      float st0 = kNoRow, st1 = 1.f, dl = 0.f;
      if (s < S) {
        const size_t n = P::row(a, b, kvh, s, gg);
        if constexpr (kFlash) {
          st0 = a.lse[n];
          dl = a.stats[n];
        } else {
          st0 = a.stats[n];
          st1 = __frcp_rn(a.stats[R + n]);
          dl = a.stats[2 * R + n];
        }
      }
      rs[tid] = st0;
      rs[kTile + tid] = st1;
      rs[2 * kTile + tid] = dl;
    }
  };

  load_k_tile<D>(Ks, a.k, a, b, kvh, t0, tid);
  if constexpr (kWantDK) load_k_tile<D>(Vs, a.v, a, b, kvh, t0, tid);
  load_queries(0, 0);
  cp_async_commit();

  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = t0 + 16 * w + g + 8 * h;
    key_ok[h] = key[h] < S && a.pad_mask[size_t(b) * S + key[h]] != 0;
  }

  float dv[kWantDV ? D / 2 : 1], dk[kWantDK ? D / 2 : 1];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    if constexpr (kWantDV) dv[j] = 0.f;
    if constexpr (kWantDK) dk[j] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // tile it is in; every thread is done with tile it - 1
    if (kStages > 1 && it + 1 < n_it) load_queries((it + 1) % kStages, it + 1);
    cp_async_commit();
    const unsigned char* qs = ring + (it % kStages) * L::kStage;
    const float* rs = reinterpret_cast<const float*>(qs + 2 * kT);
    const int s0 = q_start + (it % per_head) * bq;

    float s[32], dp[kWantDK ? 32 : 1];
    wgmma_fence();
    scores<D>(s, Ks, qs);                           // S^T = K Q^T
    if constexpr (kWantDK) tc_product<D>(dp, Vs, qs + kT);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();

    // element j: key row 16 w + g + 8 h, query row col of the tile
    float pv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = (j >> 1) & 1, col = 8 * (j >> 2) + 2 * c + (j & 1);
      const bool ok = key_ok[h] && key[h] <= s0 + (col >> gsh);
      const float p = P::prob(masked_score(s[j], ok, a.scale), rs[col], rs[kTile + col]);
      pv[j] = p;
      if constexpr (kWantDK) s[j] = ds_value(p, dp[j], rs[2 * kTile + col], a.scale);
    }
    uint32_t pa[4][4], da[4][4];
    if constexpr (kWantDV) to_fragments(pv, pa);
    if constexpr (kWantDK) to_fragments(s, da);
    wgmma_fence();
    if constexpr (kWantDV) rows_product<D>(dv, pa, qs + kT);  // dV += P^T dO
    if constexpr (kWantDK) rows_product<D>(dk, da, qs);       // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (kWantDV) keep_alive(pa[kk]);
      if constexpr (kWantDK) keep_alive(da[kk]);
    }

    if constexpr (kFlash) {
      if ((it + 1) % per_head == 0) {  // the end of a query head: round, add, restart
        const bool first = it + 1 == per_head;
#pragma unroll
        for (int j = 0; j < D / 2; ++j) {
          float* sv = sums + j * kThreads + tid;
          float* sk = sums + (L::kParts - 1) * (D / 2) * kThreads + j * kThreads + tid;
          if constexpr (kWantDV) {
            *sv = first ? round_bf16(dv[j]) : __fadd_rn(*sv, round_bf16(dv[j]));
            dv[j] = 0.f;
          }
          if constexpr (kWantDK) {
            *sk = first ? round_bf16(dk[j]) : __fadd_rn(*sk, round_bf16(dk[j]));
            dk[j] = 0.f;
          }
        }
      }
    }
    if (kStages == 1 && it + 1 < n_it) {
      __syncthreads();  // every thread is done with the one stage
      load_queries(0, it + 1);
      cp_async_commit();
    }
  }

  if constexpr (kFlash) {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      if constexpr (kWantDV) dv[j] = sums[j * kThreads + tid];
      if constexpr (kWantDK) dk[j] = sums[(L::kParts - 1) * (D / 2) * kThreads + j * kThreads + tid];
    }
  }
  const int KH = a.KH;
  auto row_off = [&](int r) -> long long {
    const int t = t0 + r;
    return t < S ? (((long long)(b) * S + t) * KH + kvh) * D : -1;
  };
  if constexpr (kWantDV) store_rows<D>(a.dv, dv, w, g, c, row_off);
  if constexpr (kWantDK) store_rows<D>(a.dk, dk, w, g, c, row_off);
}

template <typename Kernel, typename A>
cudaError_t launch_kernel(Kernel kernel, int bytes, unsigned blocks, cudaStream_t st,
                          const A& a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D, bool kFlash>
cudaError_t launch_d(const Args& a, cudaStream_t st) {
  const unsigned bh = unsigned(a.B) * a.KH;
  const int bq = kTile / a.G;
  cudaError_t err = launch_kernel(dq_kernel<D, kFlash>, DqSmem<D>::kBytes,
                                  bh * ((a.S + bq - 1) / bq), st, a);
  if (err != cudaSuccess) return err;
  const unsigned blocks = bh * ((a.S + kTile - 1) / kTile);
  if constexpr (D < 128) {
    return launch_kernel(dkv_kernel<D, kFlash, kDV | kDK>, DkvSmem<D, kFlash, kDV | kDK>::kBytes,
                         blocks, st, a);
  } else {
    err = launch_kernel(dkv_kernel<D, kFlash, kDV>, DkvSmem<D, kFlash, kDV>::kBytes, blocks, st,
                        a);
    if (err != cudaSuccess) return err;
    return launch_kernel(dkv_kernel<D, kFlash, kDK>, DkvSmem<D, kFlash, kDK>::kBytes, blocks, st,
                         a);
  }
}

// Both kernels of one backward call on ``st``; D one of 64, 128, 256.
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

}  // namespace bwd
}  // namespace ecg
