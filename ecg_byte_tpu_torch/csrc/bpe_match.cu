// Longest dictionary match at every position of a batch of symbol streams.
//
// Replaces the Pallas match kernels of ecg_byte_tpu/ops/bpe_match.py
// (_match_kernel_inker, _match_kernel_bits and _match_kernel, reached
// through longest_match).  q (B, N) uint8 symbols 0..25; the trie automaton
// trans (S, 27) int32 and token (S,) int32 of ops/bpe_encode.py (state 0
// DEAD, state 1 the root, column 26 the pad symbol, always DEAD).  For each
// position p, out of match_tok and match_len (B, N) int32:
//
//   the longest token that starts at p and ends inside the record, with its
//   length; where none is longer than one symbol, q + 'a' and 1.
//
// Design (see ops/bpe_match.py for the why): one thread per position walks
// the automaton from the root, one symbol per step, and remembers the last
// state whose token is >= 0; it stops at DEAD or after max_len steps.  A
// block of 256 threads stages its tile of 256 symbols plus a halo of
// max_len in shared memory, with the pad symbol past the record's end, so
// no walk crosses it.  The walk reads the table through the read-only
// path: the hot states near the root stay in L1, the rest in L2 (a copy of
// the table in each block's shared memory measured no faster).  The bound
// is the chain of dependent table loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // positions per tile, one per thread
constexpr int kWidth = 27;     // 26 symbols and the pad symbol
constexpr uint8_t kPad = 26;
constexpr int kByteA = 97;     // 'a': a single symbol's token id is its byte

__global__ void __launch_bounds__(kThreads)
bpe_match_kernel(const uint8_t* __restrict__ q, const int* __restrict__ trans,
                 const int* __restrict__ token, int* __restrict__ match_tok,
                 int* __restrict__ match_len, int N, int tiles_per_row, int max_len) {
  extern __shared__ uint8_t sym[];
  const int b = blockIdx.x / tiles_per_row;
  const int p0 = (blockIdx.x % tiles_per_row) * kThreads;
  const uint8_t* row = q + size_t(b) * N;
  for (int k = threadIdx.x; k < kThreads + max_len; k += kThreads) {
    const int p = p0 + k;
    const uint8_t s = p < N ? row[p] : kPad;
    sym[k] = s < kPad ? s : kPad;  // anything out of range ends a walk
  }
  __syncthreads();
  const int p = p0 + threadIdx.x;
  if (p >= N) return;
  const uint8_t* w = sym + threadIdx.x;
  int state = 1, best_tok = w[0] + kByteA, best_len = 1;
  for (int j = 0; j < max_len; ++j) {
    state = __ldg(trans + state * kWidth + w[j]);
    if (state == 0) break;
    const int tok = __ldg(token + state);
    if (tok >= 0) {
      best_tok = tok;
      best_len = j + 1;
    }
  }
  match_tok[size_t(b) * N + p] = best_tok;
  match_len[size_t(b) * N + p] = best_len;
}

}  // namespace

extern "C" int ecg_bpe_match(const void* q, const void* trans, const void* token,
                             void* match_tok, void* match_len, int B, int N, int max_len,
                             void* stream) {
  if (B <= 0 || N <= 0 || max_len < 1) return cudaErrorInvalidValue;
  const int tiles_per_row = (N + kThreads - 1) / kThreads;
  if ((long long)B * tiles_per_row > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = size_t(kThreads) + max_len;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bpe_match_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  bpe_match_kernel<<<B * tiles_per_row, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const int*>(trans),
      static_cast<const int*>(token), static_cast<int*>(match_tok), static_cast<int*>(match_len),
      N, tiles_per_row, max_len);
  return cudaGetLastError();
}
