// The greedy tokenization chain of each record, with its compaction.
//
// Replaces the Pallas kernel _chain_kernel of ecg_byte_tpu/ops/bpe_match.py
// (reached through greedy_chain) and, on the card, the sort of
// ops/bpe_encode._compact.  match_len and match_tok (B, N) int32, the
// longest match at every position (csrc/bpe_match.cu).  The chain visits
// 0, f(0), f(f(0)), ... with f(i) = i + match_len[i]; out:
//
//   visited (B, N) bool: the chain's positions;
//   ids (B, N) int32: match_tok at the chain's positions, left-aligned,
//     then -1 (PAD_TOKEN); counts (B,) int32: the chain's length.
//
// Design (see ops/bpe_match.py for the why): the chain is serial within a
// record and independent across records, so one block per record.  The
// block stages a chunk of 4,096 lengths and tokens in shared memory, all
// threads together; then one thread walks the chain through the chunk,
// marking visited positions in shared memory and writing each visited
// token to ids as it goes (the walk meets them in order); then all threads
// write the chunk's visited mask out.  A jump past the chunk carries over
// to the next one.  After the last chunk all threads fill the rest of the
// ids row with -1.  The bound is the walk: one dependent shared-memory load
// per token.  A length below 1 counts as 1, so the walk always ends.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // 36 KB of shared memory per block
constexpr int kPadToken = -1;

__global__ void __launch_bounds__(kThreads)
bpe_chain_kernel(const int* __restrict__ match_len, const int* __restrict__ match_tok,
                 uint8_t* __restrict__ visited, int* __restrict__ ids, int* __restrict__ counts,
                 int N) {
  __shared__ int s_len[kChunk];
  __shared__ int s_tok[kChunk];
  __shared__ uint8_t s_vis[kChunk];
  __shared__ int s_next, s_count;  // the chain's next position, tokens so far
  const size_t row = size_t(blockIdx.x) * N;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_next = 0;
    s_count = 0;
  }
  for (int base = 0; base < N; base += kChunk) {
    const int n = N - base < kChunk ? N - base : kChunk;
    for (int k = tid; k < n; k += kThreads) {
      s_len[k] = match_len[row + base + k];
      s_tok[k] = match_tok[row + base + k];
      s_vis[k] = 0;
    }
    __syncthreads();
    if (tid == 0) {
      int i = s_next, c = s_count;
      while (i < base + n) {
        const int k = i - base;
        s_vis[k] = 1;
        ids[row + c++] = s_tok[k];
        const int step = s_len[k];
        i += step > 0 ? step : 1;
      }
      s_next = i;
      s_count = c;
    }
    __syncthreads();
    // each thread writes out the same k it staged, so the next chunk's
    // staging needs no barrier before it
    for (int k = tid; k < n; k += kThreads) visited[row + base + k] = s_vis[k];
  }
  __syncthreads();  // s_count is final (also when N == 0)
  const int count = s_count;
  for (int k = count + tid; k < N; k += kThreads) ids[row + k] = kPadToken;
  if (tid == 0) counts[blockIdx.x] = count;
}

}  // namespace

extern "C" int ecg_bpe_chain(const void* match_len, const void* match_tok, void* visited,
                             void* ids, void* counts, int B, int N, void* stream) {
  if (B <= 0 || N < 0) return cudaErrorInvalidValue;
  bpe_chain_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(match_len), static_cast<const int*>(match_tok),
      static_cast<uint8_t*>(visited), static_cast<int*>(ids), static_cast<int*>(counts), N);
  return cudaGetLastError();
}
