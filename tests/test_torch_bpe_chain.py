"""The segment-parallel greedy chain of ``csrc/bpe_chain.cu`` on the CPU.

The kernel runs only on the card.  Here a Python model of its arithmetic
(segments, their exit tables, the warps' composed maps, the true entries,
the walk that ranks each segment's tokens, the prefix sum of their counts
and the outputs written position by position, chunk by chunk) is held
exactly to the plain version (``bpe_match.greedy_chain_plain`` and
``bpe_encode._compact``) on the adversarial rows ``chip_smoke.py`` gives the
kernel, at small sizes and with few threads and small chunks so that every
case of the kernel's control flow is reached; and the plain version to the
JAX package's Pallas chain kernel (interpret mode) and banded scan on the
same rows.  Token ids are integers: every comparison is exact."""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.ops import bpe_encode as jbe
from ecg_byte_tpu.ops import bpe_match as jbm
from ecg_byte_tpu_torch.ops import bpe_encode, bpe_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("chip_smoke", chip_smoke)
_spec.loader.exec_module(chip_smoke)

def stop_value(max_len):
    """The kernel's "the chain ends here" of its stage: a byte's all-ones up
    to ``CHAIN_MAX_LEN``, 16 bits' above."""
    return 0xFF if max_len <= bpe_match.CHAIN_MAX_LEN else 0xFFFF


def segment_chain(match_len, match_tok, max_len, threads=512, chunk=32768):
    """(visited, ids, counts) as ``csrc/bpe_chain.cu`` computes them, with
    ``threads`` threads (a multiple of 32) and chunks of ``chunk``
    positions."""
    ml, mt = match_len.numpy(), match_tok.numpy()
    b, n_all = ml.shape
    w = max(int(max_len), 1)
    assert w <= bpe_match.CHAIN_WIDE_MAX_LEN, "past the segment kernel's widest stage"
    STOP = stop_value(w)
    warps = threads // 32
    visited = np.zeros((b, n_all), bool)
    ids = np.full((b, n_all), bpe_encode.PAD_TOKEN, np.int32)
    counts = np.zeros(b, np.int32)
    for r in range(b):
        count, carry = 0, 0
        for base in range(0, n_all, chunk):
            n = min(chunk, n_all - base)
            seg = -(-n // threads)
            lens = [int(x) if 1 <= x <= w else 0 for x in ml[r, base:base + n]]
            bounds = [(min(t * seg, n), min(t * seg + seg, n)) for t in range(threads)]
            ex = [0] * n
            for s0, s1 in bounds:  # A
                for p in range(s1 - 1, s0 - 1, -1):
                    lp = lens[p]
                    ex[p] = STOP if lp == 0 else (p + lp - s1 if p + lp >= s1 else ex[p + lp])
                    assert ex[p] == STOP or ex[p] < w

            def through(t, x):
                s0, s1 = bounds[t]
                if x == STOP:
                    return STOP
                return ex[s0 + x] if x < s1 - s0 else x - (s1 - s0)

            gmap = []  # B
            for wp in range(warps):
                xs = list(range(w))
                for t in range(wp * 32, wp * 32 + 32):
                    xs = [through(t, x) for x in xs]
                gmap.append(xs)
            gentry, e = [], carry  # C
            for wp in range(warps):
                gentry.append(e)
                e = STOP if e == STOP else gmap[wp][e]
            carry = e
            entry = []  # D
            for wp in range(warps):
                e = gentry[wp]
                for t in range(wp * 32, wp * 32 + 32):
                    entry.append(e)
                    e = through(t, e)
            rank, tokens = [0] * n, []  # E: each position's rank in its segment
            for t, (s0, s1) in enumerate(bounds):
                c, p = 0, s0 + entry[t]
                while entry[t] != STOP and p < s1:
                    c += 1
                    rank[p] = c
                    if lens[p] == 0:
                        break
                    p += lens[p]
                tokens.append(c)
            off = count + np.cumsum([0] + tokens)  # the exclusive scan
            count = int(off[-1])
            for k in range(n):  # the outputs, position by position
                visited[r, base + k] = rank[k] != 0
                if rank[k]:
                    assert rank[k] <= seg < 256
                    ids[r, off[k // seg] + rank[k] - 1] = mt[r, base + k]
        counts[r] = count
    return torch.from_numpy(visited), torch.from_numpy(ids), torch.from_numpy(counts)


def _plain(match_len, match_tok, max_len):
    visited = bpe_match.greedy_chain_plain(match_len, max_len)
    return (visited, *bpe_encode._compact(match_tok, visited))


MAX_LEN = 7
# chip_smoke's rows at a small size: chunks of 96 positions, 64 threads (two
# warps), rows of 150 and 400 positions, so that every row spans several
# chunks and the long one many
ROWS = chip_smoke.chain_rows(torch.Generator().manual_seed(0), MAX_LEN, torch.device("cpu"),
                             n=150, long_n=400, threads=64)


@pytest.mark.parametrize("label,match_len,match_tok", ROWS, ids=[r[0] for r in ROWS])
def test_segment_model_equals_plain(label, match_len, match_tok):
    want = _plain(match_len, match_tok, MAX_LEN)
    for threads, chunk in ((64, 96), (32, 1000)):
        got = segment_chain(match_len, match_tok, MAX_LEN, threads=threads, chunk=chunk)
        for g, w, what in zip(got, want, ("visited", "ids", "counts")):
            assert torch.equal(g, w), f"{label}, {threads} threads, chunk {chunk}: {what}"


def test_segment_model_at_the_kernel_widths_and_a_real_record():
    """512 threads, one chunk: a row of 6,000 ECG-like lengths, the 12 x 500
    record of the main path, and its tail past the last full segment."""
    rng = np.random.default_rng(5)
    ln = torch.from_numpy(rng.integers(1, 33, (2, 6000)).astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, 1000, (2, 6000)).astype(np.int32))
    for g, w in zip(segment_chain(ln, tok, 32), _plain(ln, tok, 32)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("label,match_len,match_tok", ROWS[:5], ids=[r[0] for r in ROWS[:5]])
def test_plain_chain_matches_jax_on_the_adversarial_rows(label, match_len, match_tok):
    """The plain chain against the banded scan of the JAX package, lengths
    <= 0 and > max_len included (each ends the chain there), and against
    its Pallas chain kernel (interpret mode) where every length is at most
    max_len."""
    visited = bpe_match.greedy_chain_plain(match_len, MAX_LEN)
    jl = jnp.asarray(match_len.numpy())
    np.testing.assert_array_equal(visited.numpy(),
                                  np.asarray(jbe._greedy_chain_scan(jl, MAX_LEN)))
    if match_len.max() <= MAX_LEN:  # the Pallas kernel's window is 16, not max_len
        pallas = jbm.greedy_chain(jl, tile_rows=64, interpret=True)
        np.testing.assert_array_equal(visited.numpy(), np.asarray(pallas))


def walk_chain(match_len, match_tok, max_len):
    """(visited, ids, counts) as ``csrc/bpe_chain.cu``'s one-thread walk
    computes them (max_len past ``CHAIN_WIDE_MAX_LEN``)."""
    ml, mt = match_len.numpy(), match_tok.numpy()
    b, n = ml.shape
    w = max(int(max_len), 1)
    visited = np.zeros((b, n), bool)
    ids = np.full((b, n), bpe_encode.PAD_TOKEN, np.int32)
    counts = np.zeros(b, np.int32)
    for r in range(b):
        c, p = 0, 0
        while p < n:
            visited[r, p] = True
            ids[r, c] = mt[r, p]
            c += 1
            if not 1 <= ml[r, p] <= w:
                break
            p += int(ml[r, p])
        counts[r] = c
    return torch.from_numpy(visited), torch.from_numpy(ids), torch.from_numpy(counts)


WIDE_ROWS = [(w, row) for w in (300, bpe_match.CHAIN_WIDE_MAX_LEN)
             for row in chip_smoke.chain_rows(torch.Generator().manual_seed(1), w,
                                              torch.device("cpu"), n=1200, long_n=1300,
                                              threads=64)[:5]]


@pytest.mark.parametrize("max_len,row", WIDE_ROWS,
                         ids=[f"{w}-{r[0]}" for w, r in WIDE_ROWS])
def test_chain_route_at_max_len_past_a_byte(max_len, row):
    """max_len 300 and CHAIN_WIDE_MAX_LEN: the 16-bit stage (exits and
    entries up to 0xFFFF) in the segment model equals the plain chain; past
    it, the one-thread walk does.  The wrapper takes such a max_len (a meta
    tensor stands in for the card's: the check passes max_len and stops at
    the device)."""
    label, ln, tok = row
    want = _plain(ln, tok, max_len)
    for threads, chunk in ((64, 700), (32, 5000)):
        got = segment_chain(ln, tok, max_len, threads=threads, chunk=chunk)
        for g, w, what in zip(got, want, ("visited", "ids", "counts")):
            assert torch.equal(g, w), f"{label}, {threads} threads: {what}"
    longer = max_len + bpe_match.CHAIN_WIDE_MAX_LEN
    for g, w in zip(walk_chain(ln, tok, longer), _plain(ln, tok, longer)):
        assert torch.equal(g, w), f"{label}: the walk at max_len {longer}"
    meta = torch.ones(2, 10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        bpe_match.greedy_chain(meta, meta, max_len)


def test_flat_lead_vocabulary_encodes_as_the_host_trie():
    """A vocabulary whose flat-lead tokens reach a^300 (chip_smoke's
    flat_lead_merges) over records with flat runs past 300 symbols: the
    device encoder's plain path equals the C++ trie exactly, and so do the
    kernel's 16-bit stage (segment model) on its match lengths."""
    from ecg_byte_tpu_torch.tokenizer import native

    rng = np.random.default_rng(7)
    corpus = bytes(rng.integers(97, 123, 4000).astype(np.uint8))
    _, merges = native.train(corpus, 40)
    merges = chip_smoke.flat_lead_merges(merges)
    table = bpe_encode.build_automaton(merges, torch.device("cpu"))
    assert table.max_len == chip_smoke.FLAT_MAX_LEN > bpe_match.CHAIN_MAX_LEN
    q = chip_smoke.flat_lead_records(torch.Generator().manual_seed(2), 3, 2400)
    ids, counts = bpe_encode.encode(q, table)
    want = [native.NativeEncoder(merges).encode((row.numpy() + 97).tobytes()).tolist()
            for row in q]
    assert max(len(w) for w in want) < q.shape[1]
    chip_smoke.check_streams(ids, counts, want, "flat leads")
    match_tok, match_len = bpe_match.longest_match_plain(q, table)
    assert int(match_len.max()) == chip_smoke.FLAT_MAX_LEN
    _, mids, mcounts = segment_chain(match_len, match_tok, table.max_len, threads=64, chunk=1000)
    chip_smoke.check_streams(mids, mcounts, want, "flat leads, 16-bit stage")
