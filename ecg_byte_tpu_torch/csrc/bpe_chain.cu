// The greedy tokenization chain of each record, with its compaction.
//
// Replaces the Pallas kernel _chain_kernel of ecg_byte_tpu/ops/bpe_match.py
// (reached through greedy_chain) and, on the card, the sort of
// ops/bpe_encode._compact.  match_len and match_tok (B, N) int32, the
// longest match at every position (csrc/bpe_match.cu).  The chain visits
// 0, f(0), f(f(0)), ... with f(i) = i + match_len[i]; a length outside
// [1, max_len] ends it there, as in the plain version's banded recurrence
// (ops/bpe_match.greedy_chain_plain).  Out:
//
//   visited (B, N) bool: the chain's positions;
//   ids (B, N) int32: match_tok at the chain's positions, left-aligned,
//     then -1 (PAD_TOKEN); counts (B,) int32: the chain's length.
//
// What bounds it on the H100: the chain is serial, a dependent load per
// token, so one thread walking a record (the first design) took ~0.2 ms
// for a 1.5 us byte bound (NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  This
// one walks all positions in parallel.  One block per record stages a
// chunk of lengths in shared memory as uint8 (0 where the chain would end)
// and cuts it into one segment per thread:
//
//   A. each thread computes, walking its segment backwards, the exit of
//      every position: where a chain entering there leaves the segment, as
//      an offset into the next one (< max_len), or kStop.  So the segment's
//      map from entry offset [0, max_len) to exit is a table lookup;
//   B. each warp composes the maps of its 32 segments: lane j follows the
//      entry offsets j, j + 32, ... through them (32 dependent lookups);
//   C. one thread composes the warps' maps from the chunk's entry, carried
//      over from the previous chunk (0 for the first): the entry of every
//      warp, and of the next chunk;
//   D. the true entry of every segment: where B's walk from its warp's
//      entry stood before it (kept for max_len <= 32), or lane 0 of each
//      warp follows its warp's entry through its segments;
//   E. each thread walks its segment from its true entry, giving each
//      token position its rank in the segment; a block-wide exclusive scan
//      of the counts gives each segment's offset in ids.  Then the block
//      writes visited and ids position by position, so that neighbouring
//      threads read and write neighbouring addresses (a token goes to its
//      segment's offset plus its rank).
//
// The serial depth is a segment's length (A) plus 32 + warps lookups (B,
// C; D adds 32 for max_len > 32), whatever the chain's length.  Greedy
// chains usually meet again within a few tokens of any start, but rows that
// never do (every length 2: odd and even offsets stay apart) cost the
// same: the maps hold every entry.  The tokens, read only at the end, are
// prefetched into L2 once the lengths are staged.  Rows whose length is a
// multiple of 4 (every ECG record: 12 leads) move in 16-byte loads.  The
// tail of ids is filled with -1 and counts written as before.
//
// Lengths, exits and entries are staged in a byte for max_len up to 255,
// the main path's (uint8_t instances), and in 16 bits up to kWideMaxLen
// (uint16_t instances: tokens of more than 255 symbols, as flat leads
// merge into).  The 16-bit stage is twice the bytes of shared memory (128
// KB a block at kChunk), so one block fits an SM where two byte-stage
// blocks do.  Above kWideMaxLen, where B's maps would outgrow a lane's
// registers and the shared memory, one thread a record walks the chain
// (bpe_chain_walk_kernel, the first design): serial, but right at any
// max_len (a flat record of 12 x 2,500 symbols can merge into tokens of
// thousands).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32768;   // positions staged per pass: 64 KB (byte stage) of shared memory
constexpr int kMaxLen = 255;       // byte stage: exits < max_len fit beside kStop
constexpr int kWideMaxLen = 1024;  // 16-bit stage: B's lanes follow 32 entries each
constexpr int kPadToken = -1;
constexpr int kBatch = 8;   // global loads a thread keeps in flight, 4 bytes each
constexpr int kBatch4 = 4;  // the same, 16 bytes each

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The stage's value for "the chain ends here": all ones of the stage type.
template <typename T>
__host__ __device__ constexpr int stop_of() {
  return T(~T(0));
}

// A staged length: the length, or 0 where the chain would end.
__device__ __forceinline__ uint32_t staged(int l, int W) {
  return (l >= 1 && l <= W) ? uint32_t(l) : 0u;
}

// The exit of entry offset x (or the stop value) of the segment of ``len``
// positions at s0, from the exits ``ex`` of its positions.
template <typename T>
__device__ __forceinline__ int through(const T* ex, int s0, int len, int x) {
  if (x == stop_of<T>()) return stop_of<T>();
  return x < len ? ex[s0 + x] : x - len;
}

// Four staged values from four lengths, as one 4- or 8-byte word.
__device__ __forceinline__ void stage4(uint8_t* s, int q, int4 l, int W) {
  reinterpret_cast<uint32_t*>(s)[q] =
      staged(l.x, W) | staged(l.y, W) << 8 | staged(l.z, W) << 16 | staged(l.w, W) << 24;
}
__device__ __forceinline__ void stage4(uint16_t* s, int q, int4 l, int W) {
  reinterpret_cast<uint2*>(s)[q] = make_uint2(staged(l.x, W) | staged(l.y, W) << 16,
                                              staged(l.z, W) | staged(l.w, W) << 16);
}

// The ranks of positions 4q .. 4q + 3, one a byte of the word.
__device__ __forceinline__ uint32_t ranks4(const uint8_t* s, int q) {
  return reinterpret_cast<const uint32_t*>(s)[q];
}
__device__ __forceinline__ uint32_t ranks4(const uint16_t* s, int q) {
  // a rank is at most a segment's length (<= 64): it fits a byte
  const uint2 r = reinterpret_cast<const uint2*>(s)[q];
  return (r.x & 0xFF) | (r.x >> 16) << 8 | (r.y & 0xFF) << 16 | (r.y >> 16) << 24;
}

// T: the stage type (uint8_t for max_len <= kMaxLen, uint16_t above).
// kEntries: entry offsets a lane follows in B, ceil(max_len / 32) rounded
// up to a power of two (1 for the main path's max_len <= 32).
template <typename T, int kEntries>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 1 ? 2 : 1)
bpe_chain_kernel(const int* __restrict__ match_len, const int* __restrict__ match_tok,
                 uint8_t* __restrict__ visited, int* __restrict__ ids, int* __restrict__ counts,
                 int N, int W, int chunk) {
  constexpr int kStop = stop_of<T>();
  extern __shared__ __align__(16) uint8_t smem[];
  T* s_len = reinterpret_cast<T*>(smem);  // the chunk's lengths, 0 where the chain ends
  T* s_ex = s_len + chunk;  // each position's exit; from E on, its token's rank
  __shared__ T s_gmap[kWarps][32 * kEntries];  // each warp's map over its 32 segments
  // max_len <= 32: where each lane's entry stands after each of the warp's
  // segments (B's walk), so that D is one lookup
  __shared__ T s_path[kEntries == 1 ? kWarps : 1][32][32];
  __shared__ T s_entry[kThreads];        // each segment's true entry
  __shared__ T s_gentry[kWarps];         // each warp's true entry
  __shared__ int s_warp_tokens[kWarps];
  __shared__ int s_off[kThreads];  // where each segment's tokens start in ids
  __shared__ int s_count;  // tokens of the chunks before this one
  __shared__ int s_carry;  // the chain's entry offset into this chunk, or kStop

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = size_t(blockIdx.x) * N;
  if (tid == 0) {
    s_count = 0;
    s_carry = 0;
  }
  for (int base = 0; base < N; base += chunk) {
    const int n = N - base < chunk ? N - base : chunk;
    const int seg = (n + kThreads - 1) / kThreads;  // positions per segment (<= 64)
    // a chunk of a row whose length is a multiple of 4 (every ECG record,
    // 12 leads) moves 4 positions at a time in 16-byte loads
    const bool vec = n % 4 == 0 && aligned(match_len + row + base, 16) &&
                     aligned(match_tok + row + base, 16) && aligned(visited + row + base, 4);
    // staged several loads at a time, so that each thread has them in flight
    for (int q0 = tid; vec && q0 < n / 4; q0 += kBatch4 * kThreads) {
      int4 l[kBatch4];
#pragma unroll
      for (int u = 0; u < kBatch4; ++u) {
        const int q = q0 + u * kThreads;
        if (q < n / 4) l[u] = reinterpret_cast<const int4*>(match_len + row + base)[q];
      }
#pragma unroll
      for (int u = 0; u < kBatch4; ++u) {
        const int q = q0 + u * kThreads;
        if (q < n / 4) stage4(s_len, q, l[u], W);
      }
    }
    for (int k0 = tid; !vec && k0 < n; k0 += kBatch * kThreads) {
      int l[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u * kThreads;
        l[u] = k < n ? match_len[row + base + k] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n) s_len[k] = staged(l[u], W);
      }
    }
    __syncthreads();  // also: s_count, s_carry of the previous chunk are set
    if (tid == 0 && aligned(match_tok + row + base, 16) && n >= 4) {
      // the tokens are read only at the end: bring them into L2 while A-E
      // run (after the lengths, whose loads they would slow)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(match_tok + row + base),
                   "r"(n / 4 * 16)
                   : "memory");
    }
    const int s0 = min(tid * seg, n), s1 = min(s0 + seg, n);

    // A: every position's exit, from the segment's end backwards
    for (int p = s1 - 1; p >= s0; --p) {
      const int l = s_len[p];
      s_ex[p] = l == 0 ? kStop : (p + l >= s1 ? p + l - s1 : s_ex[p + l]);
    }
    __syncthreads();

    // B: the warp's map, entry offsets lane, lane + 32, ... through its segments
    int x[kEntries];
#pragma unroll
    for (int i = 0; i < kEntries; ++i) x[i] = lane + 32 * i < W ? lane + 32 * i : kStop;
    for (int t = warp * 32; t < warp * 32 + 32; ++t) {
      const int a = min(t * seg, n), len = min(a + seg, n) - a;
#pragma unroll
      for (int i = 0; i < kEntries; ++i) x[i] = through(s_ex, a, len, x[i]);
      if constexpr (kEntries == 1) s_path[warp][t - warp * 32][lane] = x[0];
    }
#pragma unroll
    for (int i = 0; i < kEntries; ++i) {
      if (lane + 32 * i < W) s_gmap[warp][lane + 32 * i] = x[i];
    }
    __syncthreads();

    // C: each warp's entry, and the next chunk's
    if (tid == 0) {
      int e = s_carry;
      for (int w = 0; w < kWarps; ++w) {
        s_gentry[w] = e;
        e = e == kStop ? kStop : s_gmap[w][e];
      }
      s_carry = e;
    }
    __syncthreads();

    // D: each segment's entry
    if constexpr (kEntries == 1) {
      const int e = s_gentry[warp];
      s_entry[tid] = lane == 0 || e == kStop ? e : s_path[warp][lane - 1][e];
    } else if (lane == 0) {
      int e = s_gentry[warp];
      for (int t = warp * 32; t < warp * 32 + 32; ++t) {
        s_entry[t] = e;
        const int a = min(t * seg, n);
        e = through(s_ex, a, min(a + seg, n) - a, e);
      }
    }
    __syncthreads();

    // E: walk the segment from its entry; s_ex (no longer read as exits)
    // takes each position's rank among the segment's tokens, 1-based, or 0
    for (int p = s0; p < s1; ++p) s_ex[p] = 0;
    const int entry = s_entry[tid];
    int c = 0;
    if (entry != kStop) {
      for (int p = s0 + entry; p < s1;) {
        s_ex[p] = ++c;
        const int l = s_len[p];
        if (l == 0) break;
        p += l;
      }
    }
    int incl = c;  // the warp's inclusive scan of the counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp_tokens[warp] = incl;
    __syncthreads();
    int off = s_count + incl - c, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_warp_tokens[w] : 0;
      total += s_warp_tokens[w];
    }
    s_off[tid] = off;
    __syncthreads();  // every thread has read s_count
    if (tid == 0) s_count += total;

    // the chunk's outputs, position by position (coalesced): visited, and
    // each token at its segment's offset plus its rank
    for (int q0 = tid; vec && q0 < n / 4; q0 += kBatch4 * kThreads) {
      uint32_t rank[kBatch4];
      int4 tk[kBatch4];
#pragma unroll
      for (int u = 0; u < kBatch4; ++u) {
        const int q = q0 + u * kThreads;
        rank[u] = q < n / 4 ? ranks4(s_ex, q) : 0u;
        if (rank[u]) tk[u] = reinterpret_cast<const int4*>(match_tok + row + base)[q];
      }
#pragma unroll
      for (int u = 0; u < kBatch4; ++u) {
        const int q = q0 + u * kThreads;
        if (q >= n / 4) continue;
        reinterpret_cast<uint32_t*>(visited + row + base)[q] =
            __vcmpne4(rank[u], 0u) & 0x01010101u;
        const int tks[4] = {tk[u].x, tk[u].y, tk[u].z, tk[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (rank[u] >> (8 * i)) & 0xFF;
          if (r) ids[row + s_off[(4 * q + i) / seg] + r - 1] = tks[i];
        }
      }
    }
    for (int k0 = tid; !vec && k0 < n; k0 += kBatch * kThreads) {
      int rank[kBatch], tk[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u * kThreads;
        rank[u] = k < n ? s_ex[k] : 0;
        if (rank[u]) tk[u] = match_tok[row + base + k];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n) visited[row + base + k] = rank[u] != 0;
        if (rank[u]) ids[row + s_off[k / seg] + rank[u] - 1] = tk[u];
      }
    }
  }
  __syncthreads();  // s_count is final (also when N == 0)
  const int count = s_count;
  for (int k = count + tid; k < N; k += kThreads) ids[row + k] = kPadToken;
  if (tid == 0) counts[blockIdx.x] = count;
}

// max_len above kWideMaxLen: thread 0 walks the record's chain; the
// block's threads clear visited first and fill the tail of ids after.
__global__ void __launch_bounds__(kThreads)
bpe_chain_walk_kernel(const int* __restrict__ match_len, const int* __restrict__ match_tok,
                      uint8_t* __restrict__ visited, int* __restrict__ ids,
                      int* __restrict__ counts, int N, int W) {
  __shared__ int s_count;
  const size_t row = size_t(blockIdx.x) * N;
  for (int k = threadIdx.x; k < N; k += kThreads) visited[row + k] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int p = 0; p < N;) {
      visited[row + p] = 1;
      ids[row + c++] = match_tok[row + p];
      const int l = match_len[row + p];
      if (l < 1 || l > W) break;
      p += l;
    }
    s_count = c;
    counts[blockIdx.x] = c;
  }
  __syncthreads();
  for (int k = s_count + threadIdx.x; k < N; k += kThreads) ids[row + k] = kPadToken;
}

template <typename T, int kEntries>
int launch(const void* match_len, const void* match_tok, void* visited, void* ids, void* counts,
           int B, int N, int W, cudaStream_t stream) {
  static const cudaError_t raised = cudaFuncSetAttribute(  // once: the largest stage
      bpe_chain_kernel<T, kEntries>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(2 * kChunk * sizeof(T)));
  if (raised != cudaSuccess) return raised;
  const int chunk = N < kChunk ? N : kChunk;
  bpe_chain_kernel<T, kEntries><<<B, kThreads, 2 * chunk * sizeof(T), stream>>>(
      static_cast<const int*>(match_len), static_cast<const int*>(match_tok),
      static_cast<uint8_t*>(visited), static_cast<int*>(ids), static_cast<int*>(counts), N, W,
      chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ecg_bpe_chain(const void* match_len, const void* match_tok, void* visited,
                             void* ids, void* counts, int B, int N, int max_len, void* stream) {
  if (B <= 0 || N < 0) return cudaErrorInvalidValue;
  const int W = max_len > 1 ? max_len : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 32) return launch<uint8_t, 1>(match_len, match_tok, visited, ids, counts, B, N, W, s);
  if (W <= 64) return launch<uint8_t, 2>(match_len, match_tok, visited, ids, counts, B, N, W, s);
  if (W <= 128) return launch<uint8_t, 4>(match_len, match_tok, visited, ids, counts, B, N, W, s);
  if (W <= kMaxLen) {
    return launch<uint8_t, 8>(match_len, match_tok, visited, ids, counts, B, N, W, s);
  }
  if (W <= 512) return launch<uint16_t, 16>(match_len, match_tok, visited, ids, counts, B, N, W, s);
  if (W <= kWideMaxLen) {
    return launch<uint16_t, 32>(match_len, match_tok, visited, ids, counts, B, N, W, s);
  }
  bpe_chain_walk_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const int*>(match_len), static_cast<const int*>(match_tok),
      static_cast<uint8_t*>(visited), static_cast<int*>(ids), static_cast<int*>(counts), N, W);
  return cudaGetLastError();
}
