"""Greedy longest-match BPE encoding on the device: the port of
``ecg_byte_tpu/ops/bpe_encode.py``.

The host encoder walks a byte trie record by record (``tokenizer/native.py``).
On the device the same greedy longest-match tokenization splits into three
stages batched over records:

1. **Longest match per position** -- walk the dictionary's trie from every
   position at once: the longest token that starts there and ends inside
   the record, or the position's own symbol byte.
2. **Greedy chain** -- the tokenization visits ``0, f(0), f(f(0)), ...``
   with ``f(i) = i + match_len[i]``.
3. **Compaction** -- the visited positions' tokens, left-aligned, padded
   with ``PAD_TOKEN``, and their count.

Stages 1 and 2 are the two kernels of ``ops/bpe_match.py`` (the chain
kernel also compacts); on a CPU tensor they run their plain versions and
:func:`_compact`.  The matcher table, :func:`build_automaton`, carries two
automata of the same dictionary: the dense trie that the plain version
walks forward from every position, and the Aho-Corasick automaton of the
reversed tokens that the match kernel sweeps right to left, one transition
per position (:func:`build_sweep_table`).  Neither has a token-id limit;
on the card tokens take up to 255 symbols (the chain kernel's byte-wide
lengths), where the TPU package's Pallas tables take 16 symbols and ids
below 8192, so every vocabulary of that size takes the same path.  Streams
are token-exact with the host trie, including its overwrite rule for
duplicate expanded sequences (the later merge id wins).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ecg_byte_tpu_torch.ops.quantize import _BYTE_A, NUM_SYMBOLS, normalize_quantize

PAD_SYMBOL = NUM_SYMBOLS  # 26: the symbol past a record's end; leads to DEAD
PAD_TOKEN = -1  # padding value in encoded outputs


# the sweep table (see build_sweep_table): full rows of 26 uint16 next
# states in 13 words and one word (token << 8 | length), or of 26 int32
# next states, the token and the length; compact rows of 4 words
SWEEP_NARROW_WORDS = 14
SWEEP_WIDE_WORDS = 28
SWEEP_COMPACT_WORDS = 4
SWEEP_EXCEPTIONS = 3  # a compact row's next states that differ from its base row's
NARROW_MAX_STATES = 1 << 16  # uint16 state ids
NARROW_MAX_TOKEN = 1 << 23  # the packed word stays a non-negative int32
NARROW_MAX_LEN = 255  # the packed length is a byte
# the table's share of the match kernel's shared memory (227 KB) beside
# the output buffers of a block of 16 warps (2,176 bytes each)
SWEEP_SMEM_BUDGET = 192 * 1024


class SweepTable(NamedTuple):
    """The Aho-Corasick automaton of the reversed tokens, as the match
    kernel reads it (:func:`build_sweep_table`).

    Attributes:
      words: int32 (n,): ``full`` full rows, then ``states - full`` compact
        rows.
      states: the automaton's states; state 0 is the root.
      full: the states with a full row, the first ones.
      wide: full rows of int32 next states (28 words), else uint16 (14).
    """

    words: torch.Tensor
    states: int
    full: int
    wide: bool


class Automaton(NamedTuple):
    """Dense longest-match automata over the ECG symbol alphabet.

    Attributes:
      trans: int32 (num_states, 27); ``trans[s, sym]`` is the next state.
        State 0 is the absorbing DEAD state, state 1 the root; column 26
        (``PAD_SYMBOL``) always leads to DEAD.
      token: int32 (num_states,); the token id of a terminal state, else -1.
      max_len: the longest token, in symbols (the walk's depth).
      sweep: the reversed tokens' automaton that the match kernel sweeps
        (:class:`SweepTable`); None where the table was assembled by hand
        from ``trans`` and ``token`` alone.
    """

    trans: torch.Tensor
    token: torch.Tensor
    max_len: int
    sweep: Optional[SweepTable] = None


def _alphabet_tokens(merges: Sequence[Tuple[Sequence[int], int]]):
    """The dictionary as ``(symbols, id)`` in insertion order: the 26 single
    symbols with their byte as id (the host trie's single-byte fallback),
    then every merge whose bytes are all a..z; only those occur in quantized
    ECG strings, so a token holding another byte is unreachable and
    skipped.  A later entry of the same symbols overwrites an earlier one."""
    tokens = [([s], s + _BYTE_A) for s in range(NUM_SYMBOLS)]
    for seq, token_id in merges:
        symbols = [int(b) - _BYTE_A for b in seq]
        if all(0 <= s < NUM_SYMBOLS for s in symbols):
            tokens.append((symbols, int(token_id)))
    return tokens


def _reversed_automaton(tokens):
    """The Aho-Corasick automaton of the reversed tokens, states numbered
    breadth first: (next states (R, 26), suffix links (R,), each state's
    token and length (R,), int64; the root's are 0)."""
    children, token, depth = [{}], [-1], [0]
    for symbols, token_id in tokens:
        node = 0
        for s in reversed(symbols):
            nxt = children[node].get(s)
            if nxt is None:
                nxt = len(children)
                children.append({})
                token.append(-1)
                depth.append(depth[node] + 1)
                children[node][s] = nxt
            node = nxt
        token[node] = token_id  # the later entry wins
    order = [0]
    for u in order:  # breadth first; the list grows while it is read
        order.extend(children[u][c] for c in sorted(children[u]))
    n = len(order)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    delta = np.zeros((n, NUM_SYMBOLS), np.int64)
    fail = np.zeros(n, np.int64)
    out_tok = np.zeros(n, np.int64)
    out_len = np.zeros(n, np.int64)
    for u, old in enumerate(order):  # a state's suffix link precedes it
        row = delta[fail[u]].copy() if u else np.zeros(NUM_SYMBOLS, np.int64)
        for c, child in children[old].items():
            v = rank[child]
            fail[v] = delta[fail[u], c] if u else 0
            row[c] = v
        delta[u] = row
        if u:
            if token[old] >= 0:
                out_tok[u], out_len[u] = token[old], depth[old]
            else:
                out_tok[u], out_len[u] = out_tok[fail[u]], out_len[fail[u]]
    return delta, fail, out_tok, out_len


def _two_tier(delta, fail, budget):
    """Which states keep a full row when the full rows do not fit ``budget``
    bytes: the breadth-first ones that do, the others compact, each beside
    its base (the first state along its suffix links with a full row), from
    whose row its next states differ at most at ``SWEEP_EXCEPTIONS``
    symbols; a state that differs at more keeps a full row too.  Returns
    (is_full (R,) bool, base (R,)), or None where no such split fits."""
    n = len(delta)
    full_bytes, compact_bytes = 4 * SWEEP_NARROW_WORDS, 4 * SWEEP_COMPACT_WORDS
    k = (budget - n * compact_bytes) // (full_bytes - compact_bytes)
    while k > NUM_SYMBOLS:
        is_full = np.arange(n) < k
        while True:  # a state that joins the full rows only shortens others' exceptions
            base = np.arange(n)
            for s in range(1, n):  # breadth first: a suffix link's base is known
                if not is_full[s]:
                    base[s] = base[fail[s]]
            many = (delta != delta[base]).sum(axis=1) > SWEEP_EXCEPTIONS
            if not many.any():
                break
            is_full |= many
        if is_full.sum() * full_bytes + (~is_full).sum() * compact_bytes <= budget:
            return is_full, base
        k -= 64
    return None


def build_sweep_table(tokens, budget: int = SWEEP_SMEM_BUDGET) -> SweepTable:
    """The Aho-Corasick automaton of the reversed tokens, as the match
    kernel reads it (words on the CPU; :func:`build_automaton` moves them).

    Read a record right to left from its end: after ``q[N-1], ..., q[p]``
    the state is the longest suffix of what was read that is a prefix of a
    reversed token, and the longest reversed token that is a suffix of it
    is the longest token starting at ``p`` (and ending inside the record).
    That token and its length are a constant of the state, found here with
    the suffix (failure) links, so the kernel spends one transition and one
    lookup per position.  The state depends only on the last ``max_len``
    symbols read, so a sweep may start that far right of where its outputs
    begin.  State 0 is the root, where a sweep starts and where any symbol
    outside the alphabet leads; every other state has a token, since every
    single symbol is one.  States are numbered breadth first (the shallow
    ones, which the sweep visits most, first) among the full rows and among
    the compact ones.

    Narrow rows (up to 65,536 states, ids below 2^23, tokens up to 255
    symbols): a full row holds the 26 next states as uint16 in words 0-12
    (state ``2w`` in the low half of word ``w``) and ``token << 8 |
    length`` in word 13; an odd count of full rows gets a zero row, so the
    compact rows start 16-byte aligned.  Where full rows for every state
    would pass ``budget`` bytes (the kernel's shared memory), the deeper
    states get compact rows of 4 words: ``token << 8 | length``; the base
    state and exception 0's next state (low, high half); exceptions 1 and
    2's next states; the three exceptions' symbols, a byte each (0xFF:
    none).  Their next states are the base's full row but at the
    exceptions.  Wide rows (otherwise): 26 int32 next states, the token
    and the length, every state full.
    """
    delta, fail, out_tok, out_len = _reversed_automaton(tokens)
    n = len(delta)
    packed = (out_tok << 8) | out_len
    if n > NARROW_MAX_STATES or out_tok.max() >= NARROW_MAX_TOKEN or \
            out_len.max() > NARROW_MAX_LEN:
        table = np.zeros((n, SWEEP_WIDE_WORDS), np.int32)
        table[:, :NUM_SYMBOLS] = delta
        table[:, NUM_SYMBOLS] = out_tok
        table[:, NUM_SYMBOLS + 1] = out_len
        return SweepTable(torch.from_numpy(table.reshape(-1)), n, n, True)
    split = _two_tier(delta, fail, budget) if n * 4 * SWEEP_NARROW_WORDS > budget else None
    if split is None:
        is_full, base = np.ones(n, bool), np.arange(n)
    else:
        is_full, base = split
        if is_full.sum() % 2:  # an even count of full rows: one more
            is_full[np.flatnonzero(~is_full)[0]] = True
            base[is_full] = np.flatnonzero(is_full)
    order = np.concatenate([np.flatnonzero(is_full), np.flatnonzero(~is_full)])
    new = np.empty(n, np.int64)
    new[order] = np.arange(n)
    full = int(is_full.sum())
    d = new[delta[order]].astype(np.uint32)  # in the new numbering, row by new state
    rows = full + full % 2  # a zero row keeps the compact rows 16-byte aligned
    words = np.zeros((rows, SWEEP_NARROW_WORDS), np.uint32)
    words[:full, :NUM_SYMBOLS // 2] = d[:full, 0::2] | (d[:full, 1::2] << 16)
    words[:full, NUM_SYMBOLS // 2] = packed[order[:full]]
    compact = np.zeros((n - full, SWEEP_COMPACT_WORDS), np.uint32)
    for i, old in enumerate(order[full:]):
        b = base[old]
        exc = np.flatnonzero(delta[old] != delta[b])
        sym = np.full(SWEEP_EXCEPTIONS, 0xFF, np.uint32)
        nxt = np.zeros(SWEEP_EXCEPTIONS, np.uint32)
        sym[:len(exc)] = exc
        nxt[:len(exc)] = new[delta[old, exc]]
        compact[i] = [packed[old], new[b] | (nxt[0] << 16), nxt[1] | (nxt[2] << 16),
                      sym[0] | (sym[1] << 8) | (sym[2] << 16) | (0xFF << 24)]
    flat = np.concatenate([words.reshape(-1), compact.reshape(-1)]).view(np.int32)
    return SweepTable(torch.from_numpy(flat), n, full, False)


def build_automaton(merges: Sequence[Tuple[Sequence[int], int]], device: torch.device,
                    sweep_budget: int = SWEEP_SMEM_BUDGET) -> Automaton:
    """Compile reference-format merges into the dense trie automaton and
    the sweep table on ``device`` (see :func:`_alphabet_tokens` for which
    merges take part; ``sweep_budget``: :func:`build_sweep_table`'s)."""
    dead, root = 0, 1
    trans_rows = [np.zeros(NUM_SYMBOLS + 1, np.int32), np.zeros(NUM_SYMBOLS + 1, np.int32)]
    token_list = [-1, -1]

    def insert(symbols, token_id: int) -> None:
        node = root
        for s in symbols:
            child = int(trans_rows[node][s])
            if child == dead:
                trans_rows.append(np.zeros(NUM_SYMBOLS + 1, np.int32))
                token_list.append(-1)
                child = len(trans_rows) - 1
                trans_rows[node][s] = child
            node = child
        token_list[node] = token_id

    tokens = _alphabet_tokens(merges)
    for symbols, token_id in tokens:
        insert(symbols, token_id)
    table = build_sweep_table(tokens, sweep_budget)
    trans = np.stack(trans_rows)
    trans[:, PAD_SYMBOL] = dead
    return Automaton(
        trans=torch.from_numpy(trans).to(device),
        token=torch.from_numpy(np.asarray(token_list, np.int32)).to(device),
        max_len=max(len(symbols) for symbols, _ in tokens),
        sweep=table._replace(words=table.words.to(device)),
    )


def build_best_matcher(merges: Sequence[Tuple[Sequence[int], int]],
                       device: torch.device) -> Automaton:
    """The matcher table for ``device``: the automaton, for every
    vocabulary (the TPU package picks among three table formats here)."""
    return build_automaton(merges, device)


def _compact(match_tok: torch.Tensor, visited: torch.Tensor):
    """Left-align the visited positions' tokens: ``(ids, counts)``, ids
    int32 (B, N) padded with ``PAD_TOKEN`` and counts int32 (B,).

    The pair sort of the TPU package (``_compact_sort_kv``): survivors keep
    their position as key, the others sort behind them; the keys are
    distinct, so the order is fixed.  No id limit.
    """
    b, n = match_tok.shape
    pos = torch.arange(n, device=match_tok.device)
    key = torch.where(visited, pos, pos + n)
    order = torch.sort(key, dim=1).indices
    counts = visited.sum(dim=1, dtype=torch.int32)
    ids = torch.gather(match_tok.to(torch.int32), 1, order)
    ids = torch.where(pos[None] < counts[:, None], ids, PAD_TOKEN)
    return ids.to(torch.int32), counts


def encode(q, table: Automaton):
    """Encode symbol stream(s) into BPE token ids.

    Args:
      q: uint8 (N,) or (B, N) symbols 0..25, on the table's device.
      table: the :class:`Automaton` of the merges.

    Returns:
      ``(ids, counts)``: ids int32 shaped like ``q``, padded with
      ``PAD_TOKEN``; counts int32, the valid tokens of each stream.
    """
    from ecg_byte_tpu_torch.ops import bpe_match

    q = torch.as_tensor(q)
    squeeze = q.dim() == 1
    if squeeze:
        q = q[None]
    q = q.to(torch.uint8).contiguous()
    match_tok, match_len = bpe_match.longest_match(q, table)
    _, ids, counts = bpe_match.greedy_chain(match_len, match_tok, table.max_len)
    if squeeze:
        return ids[0], counts[0]
    return ids, counts


def quantize_and_encode(signal, p1, p99, table: Automaton):
    """Float ECG -> BPE token ids, on the signal's device.

    ``signal``: float (B, 12, L) or (12, L).  The leads are flattened
    row-major into one symbol stream per record, as the host path
    concatenates the lead strings.
    """
    signal = torch.as_tensor(signal)
    batched = signal.dim() == 3
    _, q = normalize_quantize(signal, p1, p99)
    q = q.reshape((q.shape[0], -1) if batched else (-1,))
    return encode(q, table)
