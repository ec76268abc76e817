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
:func:`_compact`.  The one matcher table is the dense trie automaton of
:func:`build_automaton`: it has no token-id limit and, on the card, takes
tokens of up to 255 symbols (the chain kernel's byte-wide lengths), where
the TPU package's Pallas tables take 16 symbols and ids below 8192, so
every vocabulary of that size takes the same path.  Streams are token-exact with the host
trie, including its overwrite rule for duplicate expanded sequences (the
later merge id wins).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ecg_byte_tpu_torch.ops.quantize import _BYTE_A, NUM_SYMBOLS, normalize_quantize

PAD_SYMBOL = NUM_SYMBOLS  # 26: the symbol past a record's end; leads to DEAD
PAD_TOKEN = -1  # padding value in encoded outputs


class Automaton(NamedTuple):
    """Dense longest-match automaton over the ECG symbol alphabet.

    Attributes:
      trans: int32 (num_states, 27); ``trans[s, sym]`` is the next state.
        State 0 is the absorbing DEAD state, state 1 the root; column 26
        (``PAD_SYMBOL``) always leads to DEAD.
      token: int32 (num_states,); the token id of a terminal state, else -1.
      max_len: the longest token, in symbols (the walk's depth).
    """

    trans: torch.Tensor
    token: torch.Tensor
    max_len: int


def build_automaton(merges: Sequence[Tuple[Sequence[int], int]],
                    device: torch.device) -> Automaton:
    """Compile reference-format merges into the dense trie automaton on
    ``device``.

    Merge sequences are base byte values; only a..z occur in quantized ECG
    strings, so a token holding another byte is unreachable and skipped.
    All 26 single symbols are terminal with their byte value as token id,
    the single-byte fallback of the host trie.
    """
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

    for s in range(NUM_SYMBOLS):
        insert([s], s + _BYTE_A)
    max_len = 1
    for seq, token_id in merges:
        symbols = [int(b) - _BYTE_A for b in seq]
        if any(s < 0 or s >= NUM_SYMBOLS for s in symbols):
            continue  # token holds a non-alphabet byte: unreachable
        insert(symbols, int(token_id))
        max_len = max(max_len, len(symbols))

    trans = np.stack(trans_rows)
    trans[:, PAD_SYMBOL] = dead
    return Automaton(
        trans=torch.from_numpy(trans).to(device),
        token=torch.from_numpy(np.asarray(token_list, np.int32)).to(device),
        max_len=max_len,
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
