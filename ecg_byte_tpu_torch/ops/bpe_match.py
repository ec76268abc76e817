"""The device BPE encoder's two kernels and their wrappers: longest match
(``csrc/bpe_match.cu``) and the greedy chain with compaction
(``csrc/bpe_chain.cu``), each beside its plain PyTorch version.

``longest_match`` replaces the Pallas match kernels of
``ecg_byte_tpu/ops/bpe_match.py`` (``_match_kernel_inker``,
``_match_kernel_bits`` and ``_match_kernel``, reached through
``longest_match``).  Those fed the TPU's matrix unit: matching was an int8
product of symbol windows against a table of token columns, and a packed
(length, id) max.  That caps tokens at 16 symbols and ids below 8192.  On
the H100 the work is a chain of dependent table loads: a walk of the trie
from every position takes ~10 a position, repeating its neighbours'.  The
kernel sweeps each record right to left over the Aho-Corasick automaton of
the reversed tokens (``bpe_encode.build_sweep_table``): one transition and
one lookup per position, from a table in shared memory.  A record is cut
into segments of :func:`choose_sweep`'s length, one a thread, each sweep
starting ``max_len - 1`` symbols right of its segment or at the record's
end, which makes the cut exact.  No length or id limit: a table past
65,536 states, ids from 2^23 or tokens past 255 symbols take the wide
(int32) rows.

``greedy_chain`` replaces ``_chain_kernel`` (reached through
``greedy_chain``), which carried a 16-row window of the banded recurrence
across a sequential grid, and on the card ``bpe_encode._compact``'s sort.
The chain is serial within a record: one thread walking it took ~0.2 ms
for a 1.5 us byte bound (NVIDIA H100 80GB HBM3 at 700 W, ``PERF.md``).  So
one block per record stages the lengths as bytes and cuts them into one
segment per thread; each thread tabulates where a chain entering its
segment at each offset leaves it (one backward pass), the warps and then
one thread compose those maps into every segment's true entry (a few
dozen dependent lookups, whatever the chain's length, also on rows whose
chains never meet again), each thread walks its segment once more to rank
its tokens, and after a block-wide prefix sum of the counts the block
writes the outputs position by position.  Lengths are staged in a byte up
to ``max_len`` :data:`CHAIN_MAX_LEN`, the main path's, and in 16 bits up to
:data:`CHAIN_WIDE_MAX_LEN` (the kernel's second instance: tokens of more
than 255 symbols, which flat leads merge into).  Above that, where the
kernel's per-lane maps would not fit, one thread a record walks the chain
(its third instance); the JAX package encodes such vocabularies with its
XLA matcher (``ecg_byte_tpu/ops/bpe_encode.py:536-547``).  The choice is
made in the kernel's entry from ``max_len``.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel
or raises.  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from ecg_byte_tpu_torch.ops import _cuda
from ecg_byte_tpu_torch.ops.bpe_encode import PAD_SYMBOL, Automaton, _compact
from ecg_byte_tpu_torch.ops.quantize import _BYTE_A

CHAIN_MAX_LEN = 255  # up to this the chain kernel stages lengths and exits in a byte
CHAIN_WIDE_MAX_LEN = 1024  # up to this in 16 bits; above, one thread a record walks it


def longest_match_plain(q: torch.Tensor, table: Automaton):
    """(B, N) symbols -> ``(match_tok, match_len)``, int32 (B, N): the
    longest token starting at each position and ending inside its record,
    else the position's own symbol byte and length 1.  The gather walk of
    ``bpe_encode._longest_match``, over the batch."""
    b, n = q.shape
    dev = q.device
    width = table.trans.shape[1]
    trans = table.trans.reshape(-1).long()
    token = table.token.long()
    qp = torch.cat([q.long(), torch.full((b, table.max_len), PAD_SYMBOL, dtype=torch.long,
                                         device=dev)], dim=1)
    states = torch.ones((b, n), dtype=torch.long, device=dev)  # the root
    match_tok = q.long() + _BYTE_A
    match_len = torch.ones((b, n), dtype=torch.long, device=dev)
    for j in range(table.max_len):
        states = trans[states * width + qp[:, j:j + n]]
        tok = token[states]
        hit = tok >= 0
        match_tok = torch.where(hit, tok, match_tok)
        match_len = torch.where(hit, j + 1, match_len)
    return match_tok.to(torch.int32), match_len.to(torch.int32)


def greedy_chain_plain(match_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, N) match lengths in [1, max_len] -> (B, N) bool, the positions
    0, f(0), f(f(0)), ... of each record.  The banded recurrence of
    ``bpe_encode._greedy_chain_scan``: ``visited[i] = OR_d visited[i-d] &
    (match_len[i-d] == d)`` over the last ``max_len`` positions, one step
    per position."""
    b, n = match_len.shape
    w = max(int(max_len), 1)
    dev = match_len.device
    # slot w + i holds position i; the w slots before position 0 stay empty
    visited = torch.zeros((b, n + w), dtype=torch.bool, device=dev)
    lens = torch.zeros((b, n + w), dtype=match_len.dtype, device=dev)
    lens[:, w:] = match_len
    dist = torch.arange(w, 0, -1, device=dev, dtype=match_len.dtype)
    if n:
        visited[:, w] = True
    for i in range(1, n):
        visited[:, w + i] = (visited[:, i:i + w] & (lens[:, i:i + w] == dist)).any(dim=1)
    return visited[:, w:]


# (segment length, warps a block) by the positions of a call, the best of
# every length and warp count at the shapes the port launches
# (tools/bpe_match_shapes.py, PERF.md): (16, 8) up to the token cache's
# (64, 6000) and (12, 30000), whose few threads need short segments to
# fill the card; (32, 16) at its (64, 30000); (64, 16) at (256, 30000),
# where longer segments save warm-up and more warps hide the loads
SWEEP_CHOICES = ((1 << 20, (16, 8)), (1 << 22, (32, 16)))
SWEEP_LARGE = (64, 16)


def choose_sweep(b: int, n: int):
    """The match kernel's ``(segment length, warps a block)`` for a (b, n)
    call."""
    for limit, choice in SWEEP_CHOICES:
        if b * n < limit:
            return choice
    return SWEEP_LARGE


def sweep_choices():
    """Every ``(segment length, warps a block)`` :func:`choose_sweep`
    returns."""
    return [choice for _, choice in SWEEP_CHOICES] + [SWEEP_LARGE]


def _check_match(q, table):
    if q.dim() != 2 or q.dtype != torch.uint8:
        raise ValueError(f"q must be a uint8 (B, N) tensor, got {q.dtype} {tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if not q.is_cuda:
        raise ValueError("q must lie on a CUDA device")
    sweep = table.sweep
    if sweep is None:
        raise ValueError("the table has no sweep table: build it with bpe_encode.build_automaton")
    words = sweep.words
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError(f"the sweep table's words must be int32 (n,), got {words.dtype} "
                         f"{tuple(words.shape)}")
    if words.get_device() != q.get_device():
        raise ValueError("the sweep table must lie on q's CUDA device")
    if not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError("the sweep table must be contiguous and 16-byte aligned")


def longest_match(q: torch.Tensor, table: Automaton):
    """``longest_match_plain``'s contract; a CUDA tensor launches
    ``csrc/bpe_match.cu`` over ``table.sweep`` at :func:`choose_sweep`'s
    segment length and warps."""
    if q.device.type == "cpu":
        return longest_match_plain(q, table)
    return sweep_match(q, table, *choose_sweep(*q.shape))


def sweep_match(q: torch.Tensor, table: Automaton, seg: int, warps: int, max_hot: int = -1):
    """Launch the match kernel on a CUDA ``q``: segments of ``seg``
    positions (16, 32 or 64), ``warps`` a block, at most ``max_hot`` table
    rows in shared memory (-1: as many as fit; a table with compact rows is
    staged whole).  Counts in ``longest_match.launches``."""
    _check_match(q, table)
    b, n = q.shape
    match_tok = torch.empty((b, n), dtype=torch.int32, device=q.device)
    match_len = torch.empty((b, n), dtype=torch.int32, device=q.device)
    if q.numel() == 0:
        return match_tok, match_len
    sweep = table.sweep
    lib = _cuda.library()
    err = lib.ecg_bpe_match(
        q.data_ptr(), sweep.words.data_ptr(), match_tok.data_ptr(), match_len.data_ptr(), b, n,
        sweep.states, sweep.full, int(sweep.wide), table.max_len - 1, seg, warps, max_hot,
        _cuda.sm_count(q.get_device()), _cuda.stream(q),
    )
    _cuda.check(err, "BPE longest match")
    longest_match.launches += 1
    return match_tok, match_len


longest_match.launches = 0


def _check_chain(match_len, match_tok, max_len):
    if max_len < 0:
        raise ValueError(f"max_len {max_len} is negative")
    if match_len.dim() != 2 or match_tok.shape != match_len.shape:
        raise ValueError("match_len and match_tok must be (B, N) of one shape")
    for name, t in (("match_len", match_len), ("match_tok", match_tok)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_cuda or t.device != match_len.device:
            raise ValueError(f"{name} must lie on match_len's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def greedy_chain(match_len: torch.Tensor, match_tok: torch.Tensor, max_len: int):
    """The greedy chain and its compaction: ``(visited, ids, counts)``,
    visited bool (B, N), ids int32 (B, N) left-aligned and padded with
    ``PAD_TOKEN``, counts int32 (B,).  A length outside [1, max_len] ends
    the chain there.  A CPU tensor takes ``greedy_chain_plain`` and
    ``bpe_encode._compact``; a CUDA tensor launches ``csrc/bpe_chain.cu``
    (its byte stage up to :data:`CHAIN_MAX_LEN`, its 16-bit stage up to
    :data:`CHAIN_WIDE_MAX_LEN` and its one-thread walk past it)."""
    if match_len.device.type == "cpu":
        visited = greedy_chain_plain(match_len, max_len)
        return (visited, *_compact(match_tok, visited))
    max_len = int(max_len)
    _check_chain(match_len, match_tok, max_len)
    b, n = match_len.shape
    dev = match_len.device
    visited = torch.empty((b, n), dtype=torch.bool, device=dev)
    ids = torch.empty((b, n), dtype=torch.int32, device=dev)
    counts = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return visited, ids, counts
    lib = _cuda.library()
    stream = _cuda.stream(match_len)
    err = lib.ecg_bpe_chain(match_len.data_ptr(), match_tok.data_ptr(), visited.data_ptr(),
                            ids.data_ptr(), counts.data_ptr(), b, n, max_len, stream)
    _cuda.check(err, "BPE greedy chain")
    greedy_chain.launches += 1
    return visited, ids, counts


greedy_chain.launches = 0
