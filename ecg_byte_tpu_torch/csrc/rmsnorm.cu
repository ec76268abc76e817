// RMSNorm forward and backward over the rows of x (n, d), for ops/rmsnorm.py.
//
// Replaces the Pallas kernels of ecg_byte_tpu/ops/rmsnorm.py: _fwd_kernel
// (reached through _rmsnorm_fwd) and _bwd_kernel (through _rmsnorm_bwd).
// Per row, in f32:
//
//   r  = rsqrt(mean(x^2) + eps)
//   y  = (x * r) * w                        stored in bf16
//   dx = r * (g w - x (r^2 mean(g w x)))    stored in bf16
//   dw = sum over the rows of g x r         stored in w's type
//
// x (with y, g and dx) is bf16; w is bf16 or f32 and is converted in
// registers, as _fwd_kernel converts it.  d is a multiple of 8.
//
// What bounds it on the H100: bytes.  A row is a few KB with a few
// operations per element, and at the decode row (1, 2048) the launch.
// Design: one block per row, its 16-byte vectors of 8 values spread over at
// most 256 threads (VPT vectors a thread, neighbouring threads on neighbouring
// vectors), the row's values held in registers from the load to the store:
// x is read once and y written once.  The row sums go through warp shuffles,
// then one shared-memory step across the block's warps, which every thread
// sums in the same order.  The backward without dw (the frozen norms of LoRA
// training) has the same shape: x and g read once, dx written once, both
// sums in one reduction.  With dw each block walks a contiguous run of rows,
// loading the next row before it reduces the current one, and keeps its f32
// dw partial in registers; rmsnorm_dw_sum_kernel then sums the blocks'
// partials in a fixed order, so two calls give the same bits.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a block's threads, at most
constexpr int kMaxVecs = 8;    // 16-byte vectors of a row per thread, at most
constexpr int kSumWarps = 8;   // warps of rmsnorm_dw_sum_kernel
constexpr int kPerVec = 8;     // bf16 values in 16 bytes

using bf16 = __nv_bfloat16;

// The 8 values of the weight at p (aligned to their size) as floats
template <typename W>
__device__ __forceinline__ void load_w(const W* __restrict__ p, float* f) {
  if constexpr (std::is_same_v<W, float>) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x;
    f[1] = a.y;
    f[2] = a.z;
    f[3] = a.w;
    f[4] = b.x;
    f[5] = b.y;
    f[6] = b.z;
    f[7] = b.w;
  } else {
    ecg::unpack8(*reinterpret_cast<const uint4*>(p), f);
  }
}

template <typename W>
__device__ __forceinline__ W from_float(float v) {
  if constexpr (std::is_same_v<W, float>) {
    return v;
  } else {
    return __float2bfloat16(v);
  }
}

// Sum each of the K values over the block: every warp's by shuffles, then
// the warps' sums through part, which every thread adds up in the same
// order.  A caller that sums again alternates between two parts, so the
// one barrier here suffices.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*part)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = ecg::warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[k][warp] = v[k];
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int i = 0; i < warps; ++i) s += part[k][i];
    v[k] = s;
  }
}

template <typename W, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const bf16* __restrict__ x, const W* __restrict__ w, bf16* __restrict__ y,
                   int d, float eps) {
  constexpr int N = kPerVec;
  __shared__ float part[1][32];
  const int nvec = d / N;
  const size_t row = size_t(blockIdx.x) * nvec;  // in vectors
  const uint4* xv = reinterpret_cast<const uint4*>(x) + row;
  uint4 raw[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    raw[i] = c < nvec ? xv[c] : make_uint4(0, 0, 0, 0);
  }
  float wf[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) load_w<W>(w + c * N, wf[i]);
  }
  float f[VPT][N];
  float ss[1] = {0.f};
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    ecg::unpack8(raw[i], f[i]);  // zeros past the row
#pragma unroll
    for (int j = 0; j < N; ++j) ss[0] += f[i][j] * f[i][j];
  }
  block_sum<1>(ss, part);
  const float r = rsqrtf(ss[0] / d + eps);
  uint4* yv = reinterpret_cast<uint4*>(y) + row;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      float o[N];
#pragma unroll
      for (int j = 0; j < N; ++j) o[j] = f[i][j] * r * wf[i][j];
      yv[c] = ecg::pack8(o);
    }
  }
}

// Rows [blockIdx.x * rows, +rows) of n.  With kDw, the block's dw partial
// goes to part row blockIdx.x; without, rows is 1, and at VPT 1 the
// registers are held to 40 a thread so that six blocks fit on an SM, not
// five (eight would need 32, which spills and measured slower).
template <typename W, int VPT, bool kDw>
__global__ void __launch_bounds__(kThreads, VPT == 1 && !kDw ? 6 : 1)
rmsnorm_bwd_kernel(const bf16* __restrict__ x, const W* __restrict__ w, const bf16* __restrict__ g,
                   bf16* __restrict__ dx, float* __restrict__ dw_part, int n, int d, int rows,
                   float eps) {
  constexpr int N = kPerVec;
  __shared__ float part[2][2][32];
  const int nvec = d / N;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(n, r0 + rows);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* dxv = reinterpret_cast<uint4*>(dx);
  uint4 xr[VPT], gr[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    const size_t at = size_t(r0) * nvec + c;
    xr[i] = c < nvec ? xv[at] : make_uint4(0, 0, 0, 0);
    gr[i] = c < nvec ? gv[at] : make_uint4(0, 0, 0, 0);
  }
  float wf[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) load_w<W>(w + c * N, wf[i]);
  }
  float acc[kDw ? VPT : 1][N] = {};
  for (int row = r0; row < r1; ++row) {
    // the next row's loads are in flight while this one is reduced
    const bool more = kDw && row + 1 < r1;
    uint4 xn[VPT], gn[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      const size_t at = size_t(row + 1) * nvec + c;
      xn[i] = more && c < nvec ? xv[at] : make_uint4(0, 0, 0, 0);
      gn[i] = more && c < nvec ? gv[at] : make_uint4(0, 0, 0, 0);
    }
    float xf[VPT][N], gf[VPT][N];
    float s[2] = {0.f, 0.f};  // sum x^2, sum g w x
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      ecg::unpack8(xr[i], xf[i]);
      ecg::unpack8(gr[i], gf[i]);
      if (c < nvec) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          s[0] += xf[i][j] * xf[i][j];
          s[1] += gf[i][j] * wf[i][j] * xf[i][j];
        }
      }
    }
    block_sum<2>(s, part[(row - r0) & 1]);
    const float r = rsqrtf(s[0] / d + eps);
    const float c2 = r * r * (s[1] / d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nvec) {
        float o[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          o[j] = r * (gf[i][j] * wf[i][j] - xf[i][j] * c2);
          if constexpr (kDw) acc[i][j] += gf[i][j] * xf[i][j] * r;
        }
        dxv[size_t(row) * nvec + c] = ecg::pack8(o);
      }
      xr[i] = xn[i];
      gr[i] = gn[i];
    }
  }
  if constexpr (kDw) {
    float4* out = reinterpret_cast<float4*>(dw_part + size_t(blockIdx.x) * d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nvec) {
#pragma unroll
        for (int j = 0; j < N / 4; ++j) {
          out[c * (N / 4) + j] =
              make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
        }
      }
    }
  }
}

// dw[c] = the sum of the parts' column c, always in one order: warp k adds
// parts k, k + kSumWarps, .., then warp 0 adds the warps' sums in order.
template <typename W>
__global__ void __launch_bounds__(32 * kSumWarps)
rmsnorm_dw_sum_kernel(const float* __restrict__ dw_part, W* __restrict__ dw, int parts, int d) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
    for (int p = warp; p < parts; p += kSumWarps) s += dw_part[size_t(p) * d + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSumWarps; ++k) t += sums[k][lane];
    dw[c] = from_float<W>(t);
  }
}

// The launch shape of a row of nvec vectors: VPT vectors a thread, the
// fewest of 1, 2, 4, 8 that keep the block at kThreads; 0 if none does.
int vecs_per_thread(int nvec) {
  for (int v = 1; v <= kMaxVecs; v *= 2) {
    if (nvec <= kThreads * v) return v;
  }
  return 0;
}

int block_threads(int nvec, int vpt) { return ((nvec + vpt - 1) / vpt + 31) / 32 * 32; }

// f(std::integral_constant<int, vpt>) for the instantiated counts
template <typename F>
void by_vpt(int vpt, F&& f) {
  switch (vpt) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default: f(std::integral_constant<int, 8>{}); break;
  }
}

bool width_ok(int d) { return d > 0 && d % kPerVec == 0 && vecs_per_thread(d / kPerVec) > 0; }

template <typename W>
cudaError_t fwd(const void* x, const void* w, void* y, int n, int d, float eps, cudaStream_t s) {
  const int vpt = vecs_per_thread(d / kPerVec);
  by_vpt(vpt, [&](auto v) {
    rmsnorm_fwd_kernel<W, decltype(v)::value><<<n, block_threads(d / kPerVec, vpt), 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const W*>(w), static_cast<bf16*>(y), d, eps);
  });
  return cudaGetLastError();
}

template <typename W>
cudaError_t bwd(const void* x, const void* w, const void* g, void* dx, float* part, void* dw,
                int n, int d, int parts, float eps, cudaStream_t s) {
  const int rows = dw == nullptr ? 1 : (n + parts - 1) / parts;  // a block's
  const int grid = (n + rows - 1) / rows;
  const int vpt = vecs_per_thread(d / kPerVec);
  const int threads = block_threads(d / kPerVec, vpt);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* gp = static_cast<const bf16*>(g);
  const W* wp = static_cast<const W*>(w);
  bf16* dxp = static_cast<bf16*>(dx);
  by_vpt(vpt, [&](auto v) {
    constexpr int V = decltype(v)::value;
    if (dw == nullptr) {
      rmsnorm_bwd_kernel<W, V, false><<<grid, threads, 0, s>>>(xp, wp, gp, dxp, nullptr, n, d,
                                                               rows, eps);
    } else {
      rmsnorm_bwd_kernel<W, V, true><<<grid, threads, 0, s>>>(xp, wp, gp, dxp, part, n, d, rows,
                                                              eps);
    }
  });
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return err;
  rmsnorm_dw_sum_kernel<W><<<(d + 31) / 32, 32 * kSumWarps, 0, s>>>(part, static_cast<W*>(dw),
                                                                     grid, d);
  return cudaGetLastError();
}

}  // namespace

// y = rmsnorm(x) * w over the n rows of x (n, d); w_f32 says whether w is
// f32 rather than bf16.
extern "C" int ecg_rmsnorm(const void* x, const void* w, void* y, int n, int d, int w_f32,
                           float eps, void* stream) {
  if (n <= 0 || !width_ok(d)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_f32 ? fwd<float>(x, w, y, n, d, eps, s) : fwd<bf16>(x, w, y, n, d, eps, s);
}

// dx (and, unless dw is NULL, dw) of rmsnorm for the output gradient g.
// With dw, dw_part holds (parts, d) f32: the rows go in contiguous runs to
// at most ``parts`` blocks, whose partials rmsnorm_dw_sum_kernel adds up.
extern "C" int ecg_rmsnorm_bwd(const void* x, const void* w, const void* g, void* dx,
                               void* dw_part, void* dw, int n, int d, int w_f32, int parts,
                               float eps, void* stream) {
  if (n <= 0 || !width_ok(d) || (dw != nullptr && parts <= 0)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  return w_f32 ? bwd<float>(x, w, g, dx, part, dw, n, d, parts, eps, s)
               : bwd<bf16>(x, w, g, dx, part, dw, n, d, parts, eps, s);
}
