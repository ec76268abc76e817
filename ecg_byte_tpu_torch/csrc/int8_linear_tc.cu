// Weight-only int8 linear on the tensor cores: the prefill path of
// ops/int8_linear.py (M = batch x prompt bucket rows).
//
// The card's counterpart of the JAX package's int8 serving product
// (ecg_byte_tpu/models/transformer.py _kernel_matmul and _unembed), which
// has no Pallas kernel: there XLA fuses q.astype(bf16) into the dot's
// operand read.  x (M, K) bf16, q (N, K) int8, scale (N,) bf16, optional
// bias (N,) bf16, with the rounding order of csrc/int8_linear.cu:
//
//   y[m, n] = bf16(bf16(sum_k x[m, k] * q[n, k]) * scale[n]) (+ bias[n])
//
// each step rounded to bf16; the output is bf16, or f32 holding the same
// bf16 values.  The scale is not folded into the weights and x is not
// quantized.
//
// What bounds it on the H100: operations.  At M = 1152 a Llama-3.2-1B gate
// projection is 38.7 GFLOP against 17 MB of operands, far above the ~295
// operations per byte where the tensor cores and not the memory set the
// pace, so the dot runs on wgmma (m64nNk16, bf16 in, f32 accumulators).
// int8 values are exact in bf16, so converting the weight changes nothing:
// the f32 dot is the same sum in another order, inside the f32 summation
// bound that chip_smoke.check_int8_linear allows.
//
// Design: the kernel computes out^T = q . x^T, so that the weight is
// wgmma's A operand, which may come from registers.  A block owns BW
// weight rows (64 per warpgroup) and BT tokens.  K advances through a ring
// of shared-memory stages filled by cp.async 16-byte copies (128 a step,
// in 2 stages for the two-warpgroup tiles and 3 for 64 x 64): the x tile
// as bf16 in the 128-byte swizzle that wgmma reads as its B operand, in
// atoms of 64, and the weight tile as int8 (so only int8 bytes cross HBM),
// rows padded by 16 bytes.  Two atoms a step halve the barriers and waits
// per K against one, which measured the faster on an H100.  Each warp loads its 16 weight rows' bytes
// straight into the A-fragment layout (k 2c, 2c+1, 2c+8, 2c+9 of row g:
// two 32-bit loads and a byte permute), converts them in registers (four
// int8 become two bf16 pairs by the magic-number trick: the byte into the
// mantissa of 2^23, minus 2^23 + 128, exact) and issues the k16 product,
// so a fragment converts while the tensor cores run the previous one, and
// no converted tile goes through shared memory.  Ragged M, N and K are
// zero-filled by the copies and masked in the epilogue.  The wrapper picks
// BW x BT by the shape (ops/int8_linear.choose_tile): with the 144-token
// tile a 1,152-token prefill of an 8192-wide projection is 512 blocks, two
// even waves of two blocks an SM; the 64 x 64 one fills the card with
// Llama's narrow k/v projections.
//
// Two alternatives were slower on an H100 during development and were not
// kept: converting the weight once per block into a swizzled bf16 tile for
// an all-shared-memory wgmma (the copies, the conversion and the products
// then serialize on the block's barriers), and a warp-specialized
// producer / consumer version of that (one producer warpgroup converting
// for two consumers falls behind them).

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using ecg::cp_async16;
using ecg::cp_async_commit;
using ecg::cp_async_wait;
using ecg::fence_async_shared;
using ecg::smem_desc;
using ecg::swizzled;
using ecg::wgmma_commit;
using ecg::wgmma_fence;
using ecg::wgmma_wait;

constexpr int kBK = 64;  // K of one swizzle atom: a 128-byte row of bf16

constexpr int kA = 2;   // atoms of K a stage

// The ring has kS stages of kA atoms of K each, and the copies run kS - 1
// steps ahead of the products.
template <int BW, int BT, int kS>
struct TcSmem {
  static constexpr int kX = BT * kBK * 2;       // an x atom, bf16, swizzled
  static constexpr int kQRow = kA * kBK + 16;   // bytes per int8 weight row (padded)
  static constexpr int kQ = BW * kQRow;         // weight stage, int8
  static constexpr int kStage = (kA * kX + kQ + 1023) & ~1023;  // x atoms stay 1024-aligned
  static constexpr int kBytes = kS * kStage + 1024;             // + alignment slack
};

// Four int8 (one 32-bit word) -> two bf16 pairs, exactly: each byte
// (offset by 128) becomes the low mantissa byte of 2^23, and subtracting
// 2^23 + 128 leaves the integer as a float, whose high half is its bf16.
__device__ __forceinline__ void int8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

template <int BW, int BT, bool kF32Out, int kS>
__global__ void __launch_bounds__(BW * 2, BW == 128 ? 2 : 1)
int8_linear_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                      const __nv_bfloat16* __restrict__ scale,
                      const __nv_bfloat16* __restrict__ bias, void* __restrict__ out, int M,
                      int N, int K) {
  using L = TcSmem<BW, BT, kS>;
  constexpr int kThreads = BW * 2;  // a warpgroup per 64 weight rows
  constexpr int kBKS = kA * kBK;    // K per stage
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: x tiles start 1024-aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // the fragment's groupID and thread in group
  const int n0 = blockIdx.x * BW, m0 = blockIdx.y * BT;  // weight rows, tokens
  const int KT = (K + kBKS - 1) / kBKS;

  // K % 16 == 0, so a 16-byte chunk lies wholly inside or outside K.
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBKS;
    unsigned char* xs = smem + stage * L::kStage;
    for (int i = tid; i < BT * 8 * kA; i += kThreads) {  // 8 chunks of 8 bf16 a token an atom
      const int a = i / (BT * 8), ii = i % (BT * 8);
      const int r = ii >> 3, j = ii & 7, k = k0 + a * kBK + j * 8;
      const bool ok = m0 + r < M && k < K;
      cp_async16(xs + a * L::kX + swizzled(r, j), ok ? x + size_t(m0 + r) * K + k : x, ok);
    }
    unsigned char* qs = xs + kA * L::kX;
    for (int i = tid; i < BW * 4 * kA; i += kThreads) {  // 16 int8 chunks
      const int r = i / (4 * kA), j = i % (4 * kA), k = k0 + j * 16;
      const bool ok = n0 + r < N && k < K;
      cp_async16(qs + r * L::kQRow + j * 16, ok ? q + size_t(n0 + r) * K + k : q, ok);
    }
  };

  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;

  // this thread's fragment row g within the stage's int8 tile, and the byte
  // permute that joins k 2c, 2c+1 (first word) with k 2c+8, 2c+9 (second)
  const int r0 = wg * 64 + 16 * w + g;
  const int half = (c & 1) ? 0x7632 : 0x5410;
  const int word = (c >> 1) * 4;

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kS - 2>();
    fence_async_shared();
    __syncthreads();  // stage kt is in; every warpgroup is done with stage kt - 1
    const int pf = kt + kS - 1;
    if (pf < KT) load_stage(pf % kS, pf);
    cp_async_commit();

    const unsigned char* xs = smem + (kt % kS) * L::kStage;
    const unsigned char* qs = xs + kA * L::kX;
    uint32_t af[kBKS / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBKS / 16; ++kk) {
      const uint64_t db = smem_desc(xs + (kk / 4) * L::kX) + 2 * (kk % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const unsigned char* row = qs + (r0 + 8 * h) * L::kQRow + kk * 16 + word;
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(row);
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(row + 8);
        // {a0 a1} = k 2c, 2c+1 and {a4 a5} = k 2c+8, 2c+9 of row g (h = 0);
        // {a2 a3}, {a6 a7} of row g + 8 (h = 1)
        int8x4_to_bf16x4(__byte_perm(lo, hi, half), af[kk][h], af[kk][2 + h]);
      }
      wgmma_fence();
      if constexpr (BT == 144) {
        ecg::wgmma_rs_n144<0>(acc, af[kk], db);
      } else if constexpr (BT == 128) {
        ecg::wgmma_rs_n128<0>(acc, af[kk], db);
      } else {
        ecg::wgmma_rs_n64<0>(acc, af[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();  // this stage is rewritten from the next step on
    // the products read af asynchronously: keep it out of the register
    // allocator's hands until they are done
#pragma unroll
    for (int kk = 0; kk < kBKS / 16; ++kk) ecg::keep_alive(af[kk]);
  }

  // epilogue: acc[4i + {0,1}] at (weight row 16w + g, tokens 8i + 2c +
  // {0,1}), acc[4i + {2,3}] at weight row 16w + g + 8.  Each is rounded in
  // the JAX order (the dot, times the scale, plus the bias, each to bf16),
  // goes to shared memory as a (token, weight row) tile, and from there to
  // out (M, N) in 16-byte stores along its rows.
  using T = typename std::conditional<kF32Out, float, __nv_bfloat16>::type;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte store
  constexpr int kOS = BW + kVec;        // staged row stride, 16-byte aligned
  static_assert(BT * kOS * sizeof(T) <= kS * L::kStage, "staging tile too large");
  __syncthreads();  // every warpgroup's products are done with the stages
  T* os = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int wr = r0 + 8 * h, n = n0 + wr;
    const float sc = n < N ? __bfloat162float(scale[n]) : 0.f;
    const float bs = (bias != nullptr && n < N) ? __bfloat162float(bias[n]) : 0.f;
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float y = ecg::round_bf16(acc[4 * i + 2 * h + e]);
        y = ecg::round_bf16(y * sc);
        if (bias != nullptr) y = ecg::round_bf16(y + bs);
        T* dst = os + (8 * i + 2 * c + e) * kOS + wr;
        if constexpr (kF32Out) {
          *dst = y;
        } else {
          *dst = __float2bfloat16(y);
        }
      }
    }
  }
  __syncthreads();
  const bool vec = N % kVec == 0;  // 16-byte aligned rows of out
  for (int idx = tid; idx < BT * (BW / kVec); idx += kThreads) {
    const int t = idx / (BW / kVec), ch = idx % (BW / kVec);
    const int m = m0 + t, n = n0 + ch * kVec;
    if (m >= M || n >= N) continue;
    const T* src = os + t * kOS + ch * kVec;
    T* dst = static_cast<T*>(out) + size_t(m) * N + n;
    if (vec && n + kVec <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kVec && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

template <int BW, int BT, bool kF32Out, int kS>
int launch_f(const void* x, const void* q, const void* scale, const void* bias, void* out, int M,
             int N, int K, cudaStream_t stream) {
  constexpr int bytes = TcSmem<BW, BT, kS>::kBytes;
  auto kernel = int8_linear_tc_kernel<BW, BT, kF32Out, kS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BW - 1) / BW, (M + BT - 1) / BT);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, BW * 2, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(bias), out, M,
      N, K);
  return cudaGetLastError();
}

template <int BW, int BT, int kS>
int launch(const void* x, const void* q, const void* scale, const void* bias, void* out, int M,
           int N, int K, int f32_out, cudaStream_t stream) {
  return f32_out ? launch_f<BW, BT, true, kS>(x, q, scale, bias, out, M, N, K, stream)
                 : launch_f<BW, BT, false, kS>(x, q, scale, bias, out, M, N, K, stream);
}

}  // namespace

// tile: 0 = 128 x 144, 1 = 128 x 128, 2 = 64 x 64 (weight rows x tokens),
// the order of ops/int8_linear.TC_TILES.
extern "C" int ecg_int8_linear_tc(const void* x, const void* q, const void* scale,
                                  const void* bias, void* out, int M, int N, int K, int f32_out,
                                  int tile, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch<128, 144, 2>(x, q, scale, bias, out, M, N, K, f32_out, s);
    case 1: return launch<128, 128, 2>(x, q, scale, bias, out, M, N, K, f32_out, s);
    case 2: return launch<64, 64, 3>(x, q, scale, bias, out, M, N, K, f32_out, s);
    default: return cudaErrorInvalidValue;
  }
}
