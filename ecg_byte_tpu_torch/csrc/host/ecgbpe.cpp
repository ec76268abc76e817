// ecgbpe: native byte-pair-encoding core, the port's copy of csrc/ecgbpe.cpp.
//
// Built with the host compiler (never nvcc) by
// ecg_byte_tpu_torch/tokenizer/native.py into ecg_byte_tpu_torch/build/.
// Re-implements the semantics of the reference Rust extension
// (ECG-Byte's rust_bpe/src/lib.rs) with a different, faster
// algorithm and a C ABI consumed from Python via ctypes:
//
//  * Training (`ecgbpe_train`): classic byte-level BPE merge learning over a
//    single corpus string.  The reference rescans the whole corpus for pair
//    counts on every merge (O(merges * corpus), lib.rs:85-117).  Here we keep
//    a doubly-linked token list plus incrementally-maintained pair counts and
//    lazily-validated position lists, giving O(corpus + total merge sites).
//    Merge records store the *fully expanded base-byte sequence* per new
//    token, exactly like the reference (lib.rs:106-110), and new ids are
//    256 + merge_index (lib.rs:97).
//    Tie-breaking: the reference argmax over a HashMap is nondeterministic
//    (lib.rs:92-94); we define a total order: highest count, then smallest
//    (left, right) pair lexicographically.  Documented determinism > replay
//    of an unspecified order.
//
//  * Encoding (`ecgbpe_encode`): greedy longest-match over a byte trie built
//    from all 256 single bytes plus every merge sequence — the same
//    algorithm as the reference encoder (lib.rs:149-193), NOT iterative
//    pair-merge replay.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libecgbpe.so ecgbpe.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;
using std::uint32_t;
using std::uint64_t;
using std::uint8_t;

inline uint64_t pack_pair(uint32_t a, uint32_t b) {
  return (static_cast<uint64_t>(a) << 32) | b;
}

struct TrainResult {
  std::vector<uint32_t> ids;           // encoded corpus after all merges
  std::vector<std::vector<uint32_t>> merge_seqs;  // base-byte sequence per merge
  std::vector<uint32_t> merge_ids;     // new id per merge (256 + i)
};

// Incremental BPE trainer over a doubly linked list of tokens.
TrainResult bpe_train(const uint8_t* corpus, int64_t n, int32_t num_merges,
                      int32_t verbose) {
  TrainResult out;
  if (n <= 0) return out;

  std::vector<uint32_t> sym(corpus, corpus + n);
  // prev/next links; -1 terminates. int32 limits corpus to 2^31-1 tokens.
  std::vector<int32_t> nxt(n), prv(n);
  for (int64_t i = 0; i < n; ++i) {
    nxt[i] = (i + 1 < n) ? static_cast<int32_t>(i + 1) : -1;
    prv[i] = static_cast<int32_t>(i - 1);
  }
  constexpr uint32_t DEAD = 0xFFFFFFFFu;

  std::unordered_map<uint64_t, int64_t> counts;
  std::unordered_map<uint64_t, std::vector<int32_t>> positions;
  counts.reserve(1 << 16);
  positions.reserve(1 << 16);
  for (int64_t i = 0; i + 1 < n; ++i) {
    uint64_t key = pack_pair(sym[i], sym[i + 1]);
    ++counts[key];
    positions[key].push_back(static_cast<int32_t>(i));
  }

  // Base-byte expansion per token id, memoized. ids < 256 expand to [id].
  std::vector<std::vector<uint32_t>> expansions;
  expansions.reserve(num_merges);
  auto expand = [&](uint32_t id, std::vector<uint32_t>& dst) {
    if (id < 256) {
      dst.push_back(id);
    } else {
      const auto& seq = expansions[id - 256];
      dst.insert(dst.end(), seq.begin(), seq.end());
    }
  };

  // Lazy max-heap over (count, key) for merge selection: a full scan of
  // the counts map per merge is O(merges * distinct_pairs) — measured
  // 60% of training time at small corpora (50 ECGs: 23.0 s scan-argmax
  // vs 8.7 s heap, bench.py::bench_tokenizer_train round 5).  Entries are
  // pushed whenever a pair's count INCREASES (so some entry >= the true
  // count always exists); decrements leave stale entries that selection
  // pops and refreshes.  Order: highest count, ties -> smallest packed
  // (a, b) — same total order as the scan and the rescan trainer.
  struct Ent {
    int64_t count;
    uint64_t key;
  };
  struct Cmp {
    bool operator()(const Ent& x, const Ent& y) const {
      if (x.count != y.count) return x.count < y.count;
      return x.key > y.key;
    }
  };
  std::priority_queue<Ent, std::vector<Ent>, Cmp> heap;
  for (const auto& kv : counts) heap.push({kv.second, kv.first});
  std::unordered_set<uint64_t> touched;  // pairs born/incremented per merge
  touched.reserve(1 << 10);

  std::vector<int32_t> occ;  // scratch: occurrence list of the best pair
  for (int32_t m = 0; m < num_merges; ++m) {
    // Select best pair: pop stale entries, refresh to current counts.
    uint64_t best_key = 0;
    int64_t best_count = 0;
    while (!heap.empty()) {
      Ent top = heap.top();
      auto it = counts.find(top.key);
      const int64_t cur = (it == counts.end()) ? 0 : it->second;
      if (cur == top.count && cur > 0) {
        best_key = top.key;
        best_count = cur;
        heap.pop();
        break;
      }
      heap.pop();
      if (cur > 0) heap.push({cur, top.key});
    }
    if (best_count <= 0) break;

    const uint32_t a = static_cast<uint32_t>(best_key >> 32);
    const uint32_t b = static_cast<uint32_t>(best_key & 0xFFFFFFFFu);
    const uint32_t new_id = 256 + static_cast<uint32_t>(m);

    // Snapshot, sort, and lazily validate the occurrence list so merges apply
    // left-to-right and never overlap — matching the reference's sequential
    // in-place merge (lib.rs:11-26).
    {
      auto it = positions.find(best_key);
      occ.clear();
      if (it != positions.end()) {
        occ.swap(it->second);
        positions.erase(it);
      }
    }
    std::sort(occ.begin(), occ.end());

    for (size_t oi = 0; oi < occ.size(); ++oi) {
      const int32_t p = occ[oi];
      if (oi > 0 && occ[oi - 1] == p) continue;  // dedupe
      if (sym[p] != a) continue;                 // stale
      const int32_t q = nxt[p];
      if (q < 0 || sym[q] != b) continue;        // stale / overlap-consumed
      const int32_t left = prv[p];
      const int32_t right = nxt[q];

      // Retire pairs that die with this merge site.
      if (left >= 0) --counts[pack_pair(sym[left], a)];
      if (right >= 0) --counts[pack_pair(b, sym[right])];

      // Apply: p becomes new_id, q is removed from the list.
      sym[p] = new_id;
      sym[q] = DEAD;
      nxt[p] = right;
      if (right >= 0) prv[right] = p;

      // Register pairs born at this merge site.
      if (left >= 0) {
        uint64_t k = pack_pair(sym[left], new_id);
        ++counts[k];
        positions[k].push_back(left);
        touched.insert(k);
      }
      if (right >= 0) {
        uint64_t k = pack_pair(new_id, sym[right]);
        ++counts[k];
        positions[k].push_back(p);
        touched.insert(k);
      }
    }
    // The merged pair can never re-form (both members are pre-existing ids
    // and merges only create adjacencies involving new ids).
    counts.erase(best_key);
    // Publish final counts of the pairs this merge incremented, so the
    // heap always holds an entry >= every pair's true count.
    for (uint64_t k : touched) {
      auto it = counts.find(k);
      if (it != counts.end() && it->second > 0) heap.push({it->second, k});
    }
    touched.clear();

    std::vector<uint32_t> seq;
    expand(a, seq);
    expand(b, seq);
    expansions.push_back(std::move(seq));
    out.merge_seqs.push_back(expansions.back());
    out.merge_ids.push_back(new_id);

    if (verbose && ((m + 1) % 100 == 0 || m + 1 == num_merges)) {
      std::fprintf(stderr, "[ecgbpe] merge %d/%d pair=(%u,%u) count=%lld\n",
                   m + 1, num_merges, a, b,
                   static_cast<long long>(best_count));
    }
  }

  // Compact the surviving linked list into the encoded corpus.
  out.ids.reserve(n);
  for (int64_t i = 0; i >= 0 && i < n;) {
    out.ids.push_back(sym[i]);
    int32_t nx = nxt[i];
    if (nx < 0) break;
    i = nx;
  }
  return out;
}

// Reference-algorithm trainer: full corpus rescan per merge, mirroring
// rust_bpe/src/lib.rs:85-117 (get_stats over the whole ids vector, argmax,
// in-place merge pass).  Single-threaded — the reference parallelizes
// get_stats with rayon (lib.rs:28-48), a <= num_threads constant factor on
// the SAME O(merges * corpus) asymptotics.  Kept for the head-to-head
// merge-learning benchmark (bench.py::bench_tokenizer_train) and as an
// algorithm-identity oracle: with the identical deterministic tie-break
// (highest count, then smallest packed pair) it must produce exactly the
// merges bpe_train produces (tests/test_bpe.py).
TrainResult bpe_train_rescan(const uint8_t* corpus, int64_t n,
                             int32_t num_merges, int32_t verbose) {
  TrainResult out;
  if (n <= 0) return out;

  std::vector<uint32_t> ids(corpus, corpus + n);
  std::vector<uint32_t> next;
  next.reserve(n);

  std::vector<std::vector<uint32_t>> expansions;
  expansions.reserve(num_merges);
  auto expand = [&](uint32_t id, std::vector<uint32_t>& dst) {
    if (id < 256) {
      dst.push_back(id);
    } else {
      const auto& seq = expansions[id - 256];
      dst.insert(dst.end(), seq.begin(), seq.end());
    }
  };

  std::unordered_map<uint64_t, int64_t> counts;
  counts.reserve(1 << 16);
  for (int32_t m = 0; m < num_merges; ++m) {
    // get_stats: full rescan (lib.rs:28-48, called at lib.rs:86).
    counts.clear();
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      ++counts[pack_pair(ids[i], ids[i + 1])];
    }
    uint64_t best_key = 0;
    int64_t best_count = 0;
    for (const auto& kv : counts) {
      if (kv.second > best_count ||
          (kv.second == best_count && best_count > 0 && kv.first < best_key)) {
        best_key = kv.first;
        best_count = kv.second;
      }
    }
    if (best_count <= 0) break;
    const uint32_t a = static_cast<uint32_t>(best_key >> 32);
    const uint32_t b = static_cast<uint32_t>(best_key & 0xFFFFFFFFu);
    const uint32_t new_id = 256 + static_cast<uint32_t>(m);

    // merge: left-to-right non-overlapping replace (lib.rs:11-26).
    next.clear();
    for (size_t i = 0; i < ids.size();) {
      if (i + 1 < ids.size() && ids[i] == a && ids[i + 1] == b) {
        next.push_back(new_id);
        i += 2;
      } else {
        next.push_back(ids[i]);
        i += 1;
      }
    }
    ids.swap(next);

    std::vector<uint32_t> seq;
    expand(a, seq);
    expand(b, seq);
    expansions.push_back(std::move(seq));
    out.merge_seqs.push_back(expansions.back());
    out.merge_ids.push_back(new_id);

    if (verbose && ((m + 1) % 100 == 0 || m + 1 == num_merges)) {
      std::fprintf(stderr,
                   "[ecgbpe-rescan] merge %d/%d pair=(%u,%u) count=%lld\n",
                   m + 1, num_merges, a, b,
                   static_cast<long long>(best_count));
    }
  }
  out.ids = std::move(ids);
  return out;
}

// ---------------------------------------------------------------------------
// Greedy longest-match trie encoder (reference lib.rs:127-193 semantics).

struct Trie {
  // Flat node pool; children stored in a hash map per node keyed by byte.
  struct Node {
    std::unordered_map<uint8_t, int32_t> children;
    int32_t token_id = -1;
  };
  std::vector<Node> nodes;

  Trie() { nodes.emplace_back(); }

  void insert(const uint32_t* seq, int64_t len, uint32_t token_id) {
    int32_t cur = 0;
    for (int64_t i = 0; i < len; ++i) {
      uint8_t byte = static_cast<uint8_t>(seq[i]);
      auto it = nodes[cur].children.find(byte);
      if (it == nodes[cur].children.end()) {
        int32_t idx = static_cast<int32_t>(nodes.size());
        nodes[cur].children.emplace(byte, idx);
        nodes.emplace_back();
        cur = idx;
      } else {
        cur = it->second;
      }
    }
    nodes[cur].token_id = static_cast<int32_t>(token_id);
  }
};

struct Encoder {
  Trie trie;
  int32_t max_token_len = 1;
};

}  // namespace

extern "C" {

struct EcgBpeTrainHandle {
  TrainResult result;
};

void* ecgbpe_train(const uint8_t* corpus, int64_t n, int32_t num_merges,
                   int32_t verbose) {
  auto* h = new EcgBpeTrainHandle();
  h->result = bpe_train(corpus, n, num_merges, verbose);
  return h;
}

// Reference-algorithm (rescan-per-merge) trainer; same handle ABI.
void* ecgbpe_train_rescan(const uint8_t* corpus, int64_t n,
                          int32_t num_merges, int32_t verbose) {
  auto* h = new EcgBpeTrainHandle();
  h->result = bpe_train_rescan(corpus, n, num_merges, verbose);
  return h;
}

int32_t ecgbpe_train_num_merges(void* hv) {
  return static_cast<int32_t>(
      static_cast<EcgBpeTrainHandle*>(hv)->result.merge_ids.size());
}

int64_t ecgbpe_train_ids_len(void* hv) {
  return static_cast<int64_t>(
      static_cast<EcgBpeTrainHandle*>(hv)->result.ids.size());
}

void ecgbpe_train_get_ids(void* hv, uint32_t* out) {
  const auto& ids = static_cast<EcgBpeTrainHandle*>(hv)->result.ids;
  std::memcpy(out, ids.data(), ids.size() * sizeof(uint32_t));
}

int64_t ecgbpe_train_seq_total(void* hv) {
  int64_t total = 0;
  for (const auto& s :
       static_cast<EcgBpeTrainHandle*>(hv)->result.merge_seqs)
    total += static_cast<int64_t>(s.size());
  return total;
}

// flat: [seq_total] concatenated base-byte sequences.
// offsets: [num_merges + 1] prefix offsets into flat.
// new_ids: [num_merges].
void ecgbpe_train_get_merges(void* hv, uint32_t* flat, int64_t* offsets,
                             uint32_t* new_ids) {
  const auto& r = static_cast<EcgBpeTrainHandle*>(hv)->result;
  int64_t off = 0;
  for (size_t i = 0; i < r.merge_seqs.size(); ++i) {
    offsets[i] = off;
    const auto& s = r.merge_seqs[i];
    std::memcpy(flat + off, s.data(), s.size() * sizeof(uint32_t));
    off += static_cast<int64_t>(s.size());
    new_ids[i] = r.merge_ids[i];
  }
  offsets[r.merge_seqs.size()] = off;
}

void ecgbpe_train_free(void* hv) { delete static_cast<EcgBpeTrainHandle*>(hv); }

void* ecgbpe_encoder_new(const uint32_t* flat, const int64_t* offsets,
                         const uint32_t* ids, int32_t num_tokens) {
  auto* e = new Encoder();
  // All 256 single bytes are always encodable (lib.rs:155-157).
  for (uint32_t b = 0; b < 256; ++b) {
    e->trie.insert(&b, 1, b);
  }
  for (int32_t i = 0; i < num_tokens; ++i) {
    int64_t len = offsets[i + 1] - offsets[i];
    e->trie.insert(flat + offsets[i], len, ids[i]);
    if (len > e->max_token_len) e->max_token_len = static_cast<int32_t>(len);
  }
  return e;
}

int32_t ecgbpe_encoder_max_token_len(void* ev) {
  return static_cast<Encoder*>(ev)->max_token_len;
}

int64_t ecgbpe_encode(void* ev, const uint8_t* text, int64_t n,
                      uint32_t* out) {
  const Trie& trie = static_cast<Encoder*>(ev)->trie;
  int64_t n_out = 0;
  int64_t i = 0;
  while (i < n) {
    int32_t node = 0;
    int64_t match_len = 0;
    int32_t match_id = -1;
    for (int64_t j = i; j < n; ++j) {
      auto it = trie.nodes[node].children.find(text[j]);
      if (it == trie.nodes[node].children.end()) break;
      node = it->second;
      if (trie.nodes[node].token_id >= 0) {
        match_len = j - i + 1;
        match_id = trie.nodes[node].token_id;
      }
    }
    if (match_id >= 0) {
      out[n_out++] = static_cast<uint32_t>(match_id);
      i += match_len;
    } else {
      out[n_out++] = text[i];
      i += 1;
    }
  }
  return n_out;
}

void ecgbpe_encoder_free(void* ev) { delete static_cast<Encoder*>(ev); }

}  // extern "C"
