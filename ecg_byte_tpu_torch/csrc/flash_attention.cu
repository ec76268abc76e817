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
// What bounds it on the H100: operations.  At B 1, S 4096, 32 query heads
// over 8 KV heads of 64, the two products are 68.7 GFLOP over the causal
// pairs against 8.4 MB of inputs and outputs.  This first version does them
// as f32 FMAs from shared memory, not on the tensor cores (mma.sync / wgmma
// are later work).
//
// Design.  One block of 128 threads per (query tile, KV head, batch row), as
// attention_prefill.cu: the tile's 64 rows are 64 / G query positions x the
// G query heads of the KV head, so each K/V block in shared memory serves
// all of them.  64 / G divides 128, so a tile lies in one 128-row query
// block and all its rows visit the same key blocks.  One pass: per 128-key
// block, two 64-key score tiles (the shared dot_4x8 and masked_score of
// attention_tiles.cuh) go to shared memory with each row's max; then the
// row max steps once, exactly at the TPU kernel's 128-key boundary (a max
// that stepped every 64 keys would round p against another value), p and
// its bf16 rounding are formed in place, and P.V accumulates in registers.
// Tiles are taken heaviest first (the last query tiles visit the most key
// blocks), so the short ones fill the tail.

#include "attention_tiles.cuh"

namespace {

using ecg::kKeys;
using ecg::kRows;
using ecg::kThreads;

constexpr int kBlockK = 128;            // keys per max step: the TPU kernel's block_k
constexpr int kSStride = kBlockK + 2;   // f32 row stride of the 64 x 128 score tile

template <int D>
struct FlashSmem {
  static constexpr size_t kV = size_t(kBlockK) * D * 2;  // unpadded: read as uint4
  static constexpr size_t kP = size_t(kRows) * kSStride * 4;
  static constexpr size_t kQ = ecg::Tile<D>::kBytes;
  static constexpr size_t kK = 2 * ecg::Tile<D>::kBytes;  // two 64-key tiles
  static constexpr size_t bytes = kV + kP + kQ + kK + kBlockK * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ qg, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ pad_mask,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int KH,
                 int G, float scale) {
  using Smem = FlashSmem<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kDT = D / 8;      // output columns per thread
  constexpr int kS = ecg::Tile<D>::kStride;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Ps = reinterpret_cast<float*>(smem + Smem::kV);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kV + Smem::kP);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kV + Smem::kP + Smem::kQ);
  int* key_ok = reinterpret_cast<int*>(smem + Smem::kV + Smem::kP + Smem::kQ + Smem::kK);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bq = kRows / G;  // query positions per block
  const int s0 = (gridDim.x - 1 - blockIdx.x) * bq;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t q_pos_stride = size_t(KH) * G * D;
  const size_t q_base = (size_t(b) * S * KH + kvh) * G * D;

  ecg::load_query_tile<D>(qg, Qs, b, S, KH, G, kvh, s0, tid);
  int qpos[4];
  float m[4], l[4], acc[4][kDT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = s0 + (tr * 4 + i) / G;
    m[i] = ecg::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDT; ++c) acc[i][c] = 0.f;
  }

  // the key blocks up to the tile's own query block
  const int t_end = (s0 / kBlockK + 1) * kBlockK;
  for (int t0 = 0; t0 < t_end; t0 += kBlockK) {
    __syncthreads();
    ecg::load_key_tile<D>(k, Ks, b, S, KH, kvh, t0, tid);
    ecg::load_key_tile<D>(k, Ks + kKeys * kS, b, S, KH, kvh, t0 + kKeys, tid);
    ecg::load_key_ok(pad_mask, key_ok, b, S, t0, tid);
    ecg::load_key_ok(pad_mask, key_ok + kKeys, b, S, t0 + kKeys, tid);
    for (int idx = tid; idx < kBlockK * kChunks; idx += kThreads) {
      const int j = idx / kChunks, c = idx % kChunks;
      const int t = t0 + j;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (t < S) vv = *reinterpret_cast<const uint4*>(v + ((size_t(b) * S + t) * KH + kvh) * D + c * 8);
      *reinterpret_cast<uint4*>(Vs + j * D + c * 8) = vv;
    }
    __syncthreads();

    // masked scores of the 128 keys into Ps (each thread its own 4 rows x
    // 16 keys), and each row's max over them
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i] = ecg::kNegInf;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sc[4][8];
      ecg::dot_4x8<D>(Qs, Ks + half * kKeys * kS, tr, tc, sc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = half * kKeys + j * 8 + tc;
          const float s = ecg::masked_score(sc[i][j], key_ok[key] != 0 && t0 + key <= qpos[i], scale);
          Ps[(tr * 4 + i) * kSStride + key] = s;
          mx[i] = fmaxf(mx[i], s);
        }
    }

    // the max steps once per 128 keys; p = exp(s - m_new) enters the row
    // sum unrounded and P.V rounded to bf16
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* prow = Ps + (tr * 4 + i) * kSStride;
      float x = mx[i];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
      const float m_new = fmaxf(m[i], x);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int key = (j >> 3) * kKeys + (j & 7) * 8 + tc;
        const float p = expf(__fsub_rn(prow[key], m_new));
        rs = __fadd_rn(rs, p);
        prow[key] = ecg::round_bf16(p);
      }
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 2));
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 4));
      const float corr = expf(__fsub_rn(m[i], m_new));
      l[i] = __fmaf_rn(l[i], corr, rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDT; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr);
    }
    __syncthreads();

    // acc[rows][tc*kDT ..] += P[rows][:] . V[:][tc*kDT ..]
#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr * 4 + i) * kSStride + j];
      const uint4* vrow = reinterpret_cast<const uint4*>(Vs + j * D + tc * kDT);
#pragma unroll
      for (int c8 = 0; c8 < kDT / 8; ++c8) {
        float vf[8];
        ecg::unpack8(vrow[c8], vf);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][c8 * 8 + e] = fmaf(p[i], vf[e], acc[i][c8 * 8 + e]);
      }
    }
  }

  // every row's first key block holds its max at p = 1, so l >= 1; the
  // guard is the JAX kernel's
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (qpos[i] >= S) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    float o[kDT];
#pragma unroll
    for (int c = 0; c < kDT; ++c) o[c] = __fdiv_rn(acc[i][c], safe_l);
    __nv_bfloat16* orow = out + q_base + qpos[i] * q_pos_stride + (r % G) * D + tc * kDT;
#pragma unroll
    for (int c8 = 0; c8 < kDT / 8; ++c8) {
      *reinterpret_cast<uint4*>(orow + c8 * 8) = ecg::pack8(&o[c8 * 8]);
    }
    if (tc == 0) {
      lse[((size_t(b) * KH + kvh) * G + r % G) * S + qpos[i]] = __fadd_rn(m[i], logf(safe_l));
    }
  }
}

template <int D>
cudaError_t launch_flash(const void* qg, const void* k, const void* v, const void* pad_mask,
                         void* out, void* lse, int B, int S, int KH, int G, cudaStream_t stream) {
  const size_t smem = FlashSmem<D>::bytes;
  cudaError_t err = ecg::allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int bq = kRows / G;
  const dim3 grid((S + bq - 1) / bq, KH, B);
  const float scale = float(1.0 / sqrt(double(D)));
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qg), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pad_mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, KH, G, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ecg_flash_attention(const void* qg, const void* k, const void* v,
                                   const void* pad_mask, void* out, void* lse, int B, int S,
                                   int KH, int G, int D, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || kRows % G != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_flash<64>(qg, k, v, pad_mask, out, lse, B, S, KH, G, st);
    case 128: return launch_flash<128>(qg, k, v, pad_mask, out, lse, B, S, KH, G, st);
    case 256: return launch_flash<256>(qg, k, v, pad_mask, out, lse, B, S, KH, G, st);
    default: return cudaErrorInvalidValue;
  }
}
