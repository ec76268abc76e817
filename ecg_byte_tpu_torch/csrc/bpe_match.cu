// Longest dictionary match at every position of a batch of symbol streams.
//
// Replaces the Pallas match kernels of ecg_byte_tpu/ops/bpe_match.py
// (_match_kernel_inker, _match_kernel_bits and _match_kernel, reached
// through longest_match).  q (B, N) uint8 symbols 0..25; out of match_tok and
// match_len (B, N) int32, at each position p:
//
//   the longest token that starts at p and ends inside the record, with its
//   length; where none is longer than one symbol, q + 'a' and 1.
//
// What bounds it on the H100: the chain of dependent table lookups, and at
// large sizes its 8 bytes of output a position, whose stores share the
// load/store pipe with the lookups.  A walk of the trie from every position
// makes ~10 dependent loads a position, repeating its neighbours' walks.
// Here each thread sweeps one segment of a record right to left over the
// Aho-Corasick automaton of the reversed tokens
// (ops/bpe_encode.build_sweep_table): one dependent transition and one
// lookup of the state's (token, length) per position.  A segment's sweep
// starts at the root `warm` = max_len - 1 symbols right of its end (the
// state depends only on the last max_len symbols read, so the cut is
// exact) or at the record's end, so no sweep crosses it.
//
// The table lives in shared memory, where a lookup costs a few dozen
// cycles: a warp waits for its slowest lane, so one lane in 32 reading a
// row from L2 stalls every step.  A table whose full rows (56 bytes a
// state) pass the kernel's budget keeps full rows for its shallow states
// and compact rows (16 bytes) for the rest: a base state's full row and at
// most three exceptions (two dependent shared-memory loads), so it is
// staged whole.  A table of full rows that do not fit (or wide rows)
// stages the first `hot` and reads the rest through L1.
//
// Layout.  Each block copies the table (or its first `hot` rows) into
// shared memory once, with cp.async (every piece in flight at once, where
// a copy through registers waits out a memory latency a piece), then
// its warps take tiles of 32 consecutive segments (a lane sweeps one)
// until the grid runs out.  A lane reads its symbols from device memory 16
// at a time, the next 16 in flight while it sweeps these; past the
// record's end it reads 0xFF, which leads to the root as any symbol outside
// the alphabet does.  Each 16 outputs of every lane go through a padded
// buffer and leave as coalesced runs (four positions a lane where
// N % 4 == 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSymbols = 26;
constexpr int kByteA = 97;  // 'a': a single symbol's token id is its byte
constexpr int kChunk = 16;  // symbols per 16-byte shared-memory read
constexpr uint8_t kPast = 0xFF;  // staged past a record's end
constexpr int kOutStride = kChunk + 1;  // words per lane in the output buffer
constexpr int kMaxWarps = 16;
constexpr int kSmemMax = 227 * 1024;
constexpr int kSmemPerSm = 228 * 1024;  // and 1 KB reserved per block

template <bool kWide>
struct Rows {
  static constexpr int kWords = kWide ? 28 : 14;
};

// Where the sweep reads the table.  One tier (every state a full row): a
// state's row from shared memory if it is one of the first `hot`, else
// from device memory (through L1); with kAllHot every row is in shared
// memory and there is no other path.  Two tiers (kTwoTier, always staged
// whole): states from `full` on have compact rows, `recs`, whose next
// states are their base's full row but at up to three exceptions.
template <bool kWide, bool kAllHot, bool kTwoTier>
struct Table {
  const uint32_t* s_rows;
  const uint32_t* __restrict__ g_rows;
  const uint4* recs;
  int hot, full;

  __device__ __forceinline__ bool staged(uint32_t s) const { return kAllHot || int(s) < hot; }

  __device__ __forceinline__ uint32_t half(uint32_t s, uint32_t at) const {
    return staged(s) ? reinterpret_cast<const uint16_t*>(s_rows)[at]
                     : __ldg(reinterpret_cast<const uint16_t*>(g_rows) + at);
  }

  // The next state from s on symbol c < 26.
  __device__ __forceinline__ uint32_t next(uint32_t s, uint32_t c) const {
    if (kWide) {
      const uint32_t at = s * Rows<kWide>::kWords + c;
      return staged(s) ? s_rows[at] : __ldg(g_rows + at);
    }
    if (!kTwoTier) return half(s, s * (2 * Rows<kWide>::kWords) + c);  // uint16 units
    const bool compact = int(s) >= full;
    uint4 rec = make_uint4(0u, 0u, 0u, ~0u);  // no exceptions
    if (compact) rec = recs[s - full];
    const uint32_t base = compact ? rec.y & 0xFFFF : s;
    uint32_t t = reinterpret_cast<const uint16_t*>(s_rows)[base * (2 * Rows<kWide>::kWords) + c];
    t = c == (rec.w & 0xFF) ? rec.y >> 16 : t;
    t = c == ((rec.w >> 8) & 0xFF) ? rec.z & 0xFFFF : t;
    return c == ((rec.w >> 16) & 0xFF) ? rec.z >> 16 : t;
  }

  // One step of the sweep: the new state on symbol c (the root on a symbol
  // outside the alphabet).
  __device__ __forceinline__ uint32_t step(uint32_t s, uint32_t c) const {
    return c < kSymbols ? next(s, c) : 0u;
  }

  // The output of state s (reached on symbol c): narrow, token << 8 |
  // length in one word; wide, the token, and the length in *len.
  __device__ __forceinline__ uint32_t output(uint32_t s, uint32_t c, uint32_t* len) const {
    const uint32_t at = s * Rows<kWide>::kWords + kSymbols / (kWide ? 1 : 2);
    if (kWide) {
      if (s == 0) {
        *len = 1;
        return c + kByteA;
      }
      *len = staged(s) ? s_rows[at + 1] : __ldg(g_rows + at + 1);
      return staged(s) ? s_rows[at] : __ldg(g_rows + at);
    }
    if (s == 0) return ((c + kByteA) << 8) | 1u;
    if (kTwoTier) {
      return int(s) >= full ? reinterpret_cast<const uint32_t*>(recs)[4 * (s - full)]
                            : s_rows[at];
    }
    return staged(s) ? s_rows[at] : __ldg(g_rows + at);
  }
};

__device__ __forceinline__ uint32_t byte_of(const uint4& w, int i) {
  const uint32_t word = i < 4 ? w.x : i < 8 ? w.y : i < 12 ? w.z : w.w;
  return (word >> (8 * (i & 3))) & 0xFF;
}

struct Shape {
  int B, N, seg, log_seg, segs_per_row, total_segs;
  int warm, first;  // the warm-up rounded up to whole chunks; its farthest chunk's part
  bool aligned;  // N % 16 == 0 and q 16-byte aligned: whole 16-byte loads
};

// 16 symbols of the lane's record from position p on, 0xFF at and past its
// end (N); `live` false: all 0xFF.  One 16-byte load where they lie whole
// and aligned in the record, else byte by byte.
__device__ __forceinline__ uint4 chunk_at(const uint8_t* __restrict__ row, int p, bool live,
                                          const Shape& sh) {
  if (!live || p >= sh.N) return make_uint4(~0u, ~0u, ~0u, ~0u);
  if (sh.aligned) return __ldg(reinterpret_cast<const uint4*>(row + p));  // N % 16 == 0
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    w[e >> 2] |= uint32_t(p + e < sh.N ? __ldg(row + p + e) : kPast) << (8 * (e & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kWide, bool kAllHot, bool kTwoTier>
__global__ void __launch_bounds__(kMaxWarps * 32)
bpe_match_kernel(const uint8_t* __restrict__ q, const uint32_t* __restrict__ table,
                 int* __restrict__ match_tok, int* __restrict__ match_len, Shape sh, int hot,
                 int full, int staged_vec) {
  extern __shared__ uint4 smem[];
  for (int i = threadIdx.x; i < staged_vec; i += blockDim.x) {
    const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(smem + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
                 "l"(reinterpret_cast<const uint4*>(table) + i));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int full_vec = full * Rows<kWide>::kWords / 4;  // two tiers: full is even
  const Table<kWide, kAllHot, kTwoTier> tab{reinterpret_cast<const uint32_t*>(smem), table,
                                            smem + full_vec, hot, full};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* obuf = reinterpret_cast<uint32_t*>(smem + staged_vec) +
                   warp * (kWide ? 2 : 1) * 32 * kOutStride;
  uint32_t* lbuf = obuf + 32 * kOutStride;  // wide: the lengths
  __syncthreads();

  const int N = sh.N, L = sh.seg;
  const bool vec = (N & 3) == 0;
  const int warps = blockDim.x >> 5;
  const int tiles = (sh.total_segs + 31) / 32;
  for (int tile = blockIdx.x * warps + warp; tile < tiles; tile += gridDim.x * warps) {
    // the lane sweeps segment g, reading its record's symbols from device
    // memory a 16-symbol chunk at a time, the next chunk in flight
    const int g = tile * 32 + lane;
    const bool live = g < sh.total_segs;
    const int b = g / sh.segs_per_row;
    const int my_lo = (g - b * sh.segs_per_row) << sh.log_seg;
    const int my_base = b * N + my_lo;  // flat index of the segment's first position
    const int my_lim = live ? min(L, N - my_lo) : 0;  // its positions
    const uint8_t* row = q + size_t(b) * N;
    uint32_t s = 0;  // the root
    // warm-up: the positions right of the segment, in its record, from the
    // right; past the record's end they read as 0xFF (the state stays the
    // root)
    int x = L + sh.warm - kChunk;
    uint4 w = chunk_at(row, my_lo + x, live, sh);
    if (x >= L) {  // the farthest chunk: its lowest `first` symbols
      const uint4 cur = w;
      w = chunk_at(row, my_lo + x - kChunk, live, sh);
#pragma unroll
      for (int i = kChunk - 1; i >= 0; --i) {
        if (i < sh.first) s = tab.step(s, byte_of(cur, i));
      }
      x -= kChunk;
    }
    for (; x >= L; x -= kChunk) {
      const uint4 cur = w;
      w = chunk_at(row, my_lo + x - kChunk, live, sh);
#pragma unroll
      for (int i = kChunk - 1; i >= 0; --i) s = tab.step(s, byte_of(cur, i));
    }
    for (; x >= 0; x -= kChunk) {
      const uint4 cur = w;
      if (x > 0) w = chunk_at(row, my_lo + x - kChunk, live, sh);
      uint32_t o[kChunk], ol[kWide ? kChunk : 1];
#pragma unroll
      for (int i = kChunk - 1; i >= 0; --i) {
        const uint32_t c = byte_of(cur, i);
        s = tab.step(s, c);
        o[i] = tab.output(s, c, &ol[kWide ? i : 0]);
      }
      __syncwarp();  // the last write-out has read the buffer
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        obuf[lane * kOutStride + i] = o[i];
        if (kWide) lbuf[lane * kOutStride + i] = ol[kWide ? i : 0];
      }
      __syncwarp();
      // write-out: 4 positions a lane, 8 segments an instruction
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int sg = 8 * r + (lane >> 2), i0 = 4 * (lane & 3);
        const int base = __shfl_sync(0xffffffffu, my_base, sg) + x + i0;
        const int room = __shfl_sync(0xffffffffu, my_lim, sg) - x - i0;
        if (room <= 0) continue;
        int tk[4], ln[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t v = obuf[sg * kOutStride + i0 + e];
          tk[e] = kWide ? int(v) : int(v >> 8);
          ln[e] = kWide ? int(lbuf[sg * kOutStride + i0 + e]) : int(v & 0xFF);
        }
        if (vec && room >= 4) {
          *reinterpret_cast<int4*>(match_tok + base) = make_int4(tk[0], tk[1], tk[2], tk[3]);
          *reinterpret_cast<int4*>(match_len + base) = make_int4(ln[0], ln[1], ln[2], ln[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < room) {
              match_tok[base + e] = tk[e];
              match_len[base + e] = ln[e];
            }
          }
        }
      }
    }
  }
}

struct Launch {
  const void* q;
  const void* table;
  void* match_tok;
  void* match_len;
  Shape sh;
  int hot, full, staged_vec, warps, warp_bytes, sms;  // warp_bytes: its output buffer
};

template <bool kWide, bool kAllHot, bool kTwoTier>
int launch(const Launch& a, cudaStream_t stream) {
  auto* kernel = bpe_match_kernel<kWide, kAllHot, kTwoTier>;
  static const cudaError_t raised = cudaFuncSetAttribute(  // once: the whole budget
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (raised != cudaSuccess) return raised;
  const int smem = a.staged_vec * 16 + a.warps * a.warp_bytes;
  const int threads = a.warps * 32;
  const int per_sm = std::max(1, std::min(2048 / threads, kSmemPerSm / (smem + 1024)));
  const int tiles = (a.sh.total_segs + 31) / 32;
  const int grid = std::max(1, std::min((tiles + a.warps - 1) / a.warps, a.sms * per_sm));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(a.q), static_cast<const uint32_t*>(a.table),
      static_cast<int*>(a.match_tok), static_cast<int*>(a.match_len), a.sh, a.hot, a.full,
      a.staged_vec);
  return cudaGetLastError();
}

}  // namespace

// table: the sweep table's words (ops/bpe_encode.build_sweep_table):
// `full` full rows of 14 (narrow) or 28 (wide) words, an odd count padded
// by a zero row, then states - full compact rows of 4 words (narrow only);
// warm: the warm-up, max_len - 1 (or more); seg:
// positions a segment (16, 32 or 64); warps: a block's (1-16; with compact
// rows, at most as many as fit beside the table); max_hot: full rows
// staged in shared memory at most (-1: as many as fit; a table with
// compact rows is always staged whole); sms: the grid's SM count.
extern "C" int ecg_bpe_match(const void* q, const void* table, void* match_tok, void* match_len,
                             int B, int N, int states, int full, int wide, int warm, int seg,
                             int warps, int max_hot, int sms, void* stream) {
  int log_seg = 0;
  while ((1 << log_seg) < seg) ++log_seg;
  if (B <= 0 || N <= 0 || states < 1 || full < 1 || full > states || (wide && full != states) ||
      warm < 0 || (seg != 16 && seg != 32 && seg != 64) || warps < 1 ||
      warps > kMaxWarps || sms < 1 || (long long)B * N >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  Shape sh;
  sh.B = B;
  sh.N = N;
  sh.seg = seg;
  sh.log_seg = log_seg;
  sh.segs_per_row = (N + seg - 1) / seg;
  sh.total_segs = B * sh.segs_per_row;
  sh.warm = (warm + kChunk - 1) / kChunk * kChunk;
  sh.first = warm - (sh.warm - kChunk);
  sh.aligned = N % kChunk == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int warp_bytes = (wide ? 2 : 1) * 32 * kOutStride * 4;
  const int row_words = wide ? Rows<true>::kWords : Rows<false>::kWords;
  const int room = kSmemMax - warps * warp_bytes;  // for the table
  const int full_rows = wide ? full : full + (full & 1);  // a narrow table's zero row
  const bool two_tier = full < states;
  Launch a{q, table, match_tok, match_len, sh, full, full, 0, warps, warp_bytes, sms};
  if (two_tier) {  // staged whole, beside as many of the warps as fit
    a.staged_vec = (full_rows * row_words + 4 * (states - full)) / 4;
    a.warps = std::min(warps, (kSmemMax - a.staged_vec * 16) / warp_bytes);
    if (a.warps < 1) return cudaErrorInvalidValue;
  } else {
    int hot = std::min(full_rows, room / (4 * row_words));
    if (max_hot >= 0) hot = std::min(hot, max_hot);
    a.hot = wide ? hot : hot & ~1;  // whole 16-byte pieces
    a.staged_vec = a.hot * row_words / 4;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_tier) return launch<false, true, true>(a, s);
  if (wide) return launch<true, false, false>(a, s);  // rarely small enough to stage whole
  return a.hot >= full ? launch<false, true, false>(a, s) : launch<false, false, false>(a, s);
}
