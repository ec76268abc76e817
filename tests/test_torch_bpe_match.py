"""The sweep match kernel of ``csrc/bpe_match.cu`` on the CPU.

The kernel runs only on the card.  Here its table (the Aho-Corasick
automaton of the reversed tokens, ``bpe_encode.build_sweep_table``) is held
to its definition state by state, and a Python model of the kernel's
arithmetic (segments of 16, 32 or 64 positions, one a thread; a warm-up of
``max_len - 1`` symbols, read right to left; 0xFF past the record's end and
any symbol outside the alphabet leading to the root) is held to the plain version
(``bpe_match.longest_match_plain``) and to the JAX package's match kernel in
interpret mode, on the toy and trained vocabularies, cut at every offset,
on the adversarial rows ``chip_smoke.py`` gives the kernel, and on random
vocabularies.  Token ids and lengths are integers: every comparison is
exact."""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ecg_byte_tpu.ops import bpe_match as jbm
from ecg_byte_tpu_torch.ops import bpe_encode, bpe_match
from ecg_byte_tpu_torch.tokenizer import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("chip_smoke", chip_smoke)
_spec.loader.exec_module(chip_smoke)

CPU = torch.device("cpu")
A = ord("a")
PAST = 0xFF  # read past a record's end


def decode(sweep):
    """A sweep table's (next states (R, 26), tokens (R,), lengths (R,)),
    compact rows expanded from their base's full row and exceptions."""
    w = sweep.words.numpy()
    n, full = sweep.states, sweep.full
    if sweep.wide:
        w = w.reshape(n, bpe_encode.SWEEP_WIDE_WORDS).astype(np.int64)
        return w[:, :26], w[:, 26], w[:, 27]
    u = w.view(np.uint32).astype(np.int64)
    rows = full + full % 2
    f = u[:rows * bpe_encode.SWEEP_NARROW_WORDS].reshape(rows, -1)[:full]
    c = u[rows * bpe_encode.SWEEP_NARROW_WORDS:].reshape(n - full, bpe_encode.SWEEP_COMPACT_WORDS)
    nxt = np.empty((n, 26), np.int64)
    nxt[:full, 0::2] = f[:, :13] & 0xFFFF
    nxt[:full, 1::2] = f[:, :13] >> 16
    packed = np.concatenate([f[:, 13], c[:, 0]])
    for i, (_, b_t0, t1_t2, syms) in enumerate(c):
        s = full + i
        assert (b_t0 & 0xFFFF) < full  # the base has a full row
        nxt[s] = nxt[b_t0 & 0xFFFF]
        for k, t in enumerate((b_t0 >> 16, t1_t2 & 0xFFFF, t1_t2 >> 16)):
            sym = (syms >> (8 * k)) & 0xFF
            if sym != 0xFF:
                nxt[s, sym] = t
        assert syms >> 24 == 0xFF
    return nxt, packed >> 8, packed & 0xFF


def sweep_model(q, table, seg, warm=None):
    """(match_tok, match_len) as ``csrc/bpe_match.cu`` computes them with
    segments of ``seg`` positions and a warm-up of ``warm`` symbols
    (default: the wrapper's, ``max_len - 1``), all segments at once."""
    nxt, otok, olen = decode(table.sweep)
    if warm is None:
        warm = table.max_len - 1
    q = np.asarray(q).astype(np.int64)
    b, n = q.shape
    spr = -(-n // seg)
    lo = np.broadcast_to(np.arange(spr) * seg, (b, spr))
    rows = np.broadcast_to(np.arange(b)[:, None], (b, spr))
    s = np.zeros((b, spr), np.int64)  # the root
    tok = np.full((b, n), -7, np.int64)
    ln = np.full((b, n), -7, np.int64)
    for t in range(seg + warm):
        p = lo + seg + warm - 1 - t  # right to left
        c = np.where(p < n, q[rows, np.minimum(p, n - 1)], PAST)
        s = np.where(c < 26, nxt[s, np.minimum(c, 25)], 0)
        if t >= warm:
            ok = p < n
            tok[rows[ok], p[ok]] = np.where(s == 0, c + A, otok[s])[ok]
            ln[rows[ok], p[ok]] = np.where(s == 0, 1, olen[s])[ok]
    return tok, ln


def brute_force(q, merges):
    """The longest dictionary token at each position, by definition: the 26
    single symbols, then every merge of a..z bytes, a later entry of the
    same symbols replacing an earlier one."""
    tokens = {(s,): s + A for s in range(26)}
    for seq, tid in merges:
        if all(A <= c < A + 26 for c in seq):
            tokens[tuple(c - A for c in seq)] = tid
    longest = max(map(len, tokens))
    q = np.asarray(q)
    tok, ln = np.zeros(q.shape, np.int64), np.zeros(q.shape, np.int64)
    for r, row in enumerate(q.tolist()):
        for p in range(len(row)):
            for k in range(min(longest, len(row) - p), 0, -1):
                if tuple(row[p:p + k]) in tokens:
                    tok[r, p], ln[r, p] = tokens[tuple(row[p:p + k])], k
                    break
    return tok, ln


def _plain(q, table):
    tok, ln = bpe_match.longest_match_plain(torch.as_tensor(q, dtype=torch.uint8), table)
    return tok.numpy(), ln.numpy()


def _same(got, want, what):
    for name, g, w in zip(("match_tok", "match_len"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def toy():
    """tests/test_torch_bpe.py's toy vocabulary: 80 merges of a random
    walk, three 240-symbol streams."""
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.integers(-2, 3, size=4000))
    _, merges = native.train(bytes((np.abs(walk) % 26).astype(np.uint8) + A), 80)
    q = (np.abs(np.cumsum(rng.integers(-2, 3, size=(3, 240)), axis=1)) % 26).astype(np.uint8)
    return merges, q


@pytest.fixture(scope="module")
def trained():
    """200 merges of an ECG-like walk (tests/test_torch_bpe.py's), and four
    600-symbol records of the same walk, one all 'a'."""
    rng = np.random.default_rng(0)
    steps = rng.integers(-1, 2, size=20000).cumsum()
    _, merges = native.train(bytes(np.clip(steps % 26, 0, 25).astype(np.uint8) + A), 200)
    q = (np.abs(np.cumsum(rng.integers(-1, 2, size=(4, 600)), axis=1)) % 26).astype(np.uint8)
    q[3] = 0
    return merges, q


@pytest.mark.parametrize("budget", [bpe_encode.SWEEP_SMEM_BUDGET, 6000],
                         ids=["full-rows", "two-tiers"])
def test_sweep_table_is_the_reversed_automaton(toy, budget):
    """Every state of the toy table, from its string (the path from the
    root): each transition leads to the longest suffix of the string plus
    the symbol that is a prefix of a reversed token, and the state's output
    is the longest reversed token that is a suffix of its string.  With a
    budget below the full rows' bytes, the deeper states take compact rows
    (a base and at most three exceptions) and the table fits the budget."""
    merges, _ = toy
    table = bpe_encode.build_sweep_table(bpe_encode._alphabet_tokens(merges), budget)
    assert not table.wide and table.words.dtype == torch.int32
    if budget == 6000:
        assert 26 < table.full < table.states and table.full % 2 == 0
        assert table.words.numel() * 4 <= budget
    else:
        assert table.full == table.states
    assert table.words.numel() * 4 % 16 == 0  # copies in 16-byte pieces
    nxt, otok, olen = decode(table)
    tokens = {}
    for seq, tid in [((A + s,), A + s) for s in range(26)] + list(merges):
        tokens[tuple(reversed([c - A for c in seq]))] = tid  # reversed, later wins
    prefixes = {t[:k] for t in tokens for k in range(len(t) + 1)}
    string = {0: ()}
    frontier = [0]
    for s in frontier:  # breadth first over the trie's edges
        for c in range(26):
            if (*string[s], c) in prefixes and int(nxt[s, c]) not in string:
                string[int(nxt[s, c])] = (*string[s], c)
                frontier.append(int(nxt[s, c]))
    assert len(string) == len(prefixes) == table.states
    for part in (range(table.full), range(table.full, table.states)):  # breadth first in each
        depths = [len(string[s]) for s in part]
        assert depths == sorted(depths)
    for s, text in string.items():
        for c in range(26):
            t = (*text, c)
            want = next(t[i:] for i in range(len(t) + 1) if t[i:] in prefixes)
            assert string[int(nxt[s, c])] == want
        if s:
            best = next(text[i:] for i in range(len(text)) if text[i:] in tokens)
            assert (otok[s], olen[s]) == (tokens[best], len(best))


@pytest.mark.parametrize("budget", [bpe_encode.SWEEP_SMEM_BUDGET, 6000],
                         ids=["full-rows", "two-tiers"])
@pytest.mark.parametrize("seg", [16, 32, 64])
def test_sweep_model_equals_jax_and_plain(toy, trained, seg, budget):
    """The model at each segment length against the JAX package's match
    kernel (interpret mode) and the plain walk, on both vocabularies, with
    full rows and with compact ones."""
    for merges, q in (toy, trained):
        table = bpe_encode.build_automaton(merges, CPU, sweep_budget=budget)
        got = sweep_model(q, table, seg)
        _same(got, _plain(q, table), f"plain, segment {seg}")
        if max(len(s) for s, _ in merges) <= 16:
            want = jbm.longest_match(jnp.asarray(q), jbm.build_pallas_matcher(merges),
                                     tile_n=128, interpret=True)
            _same(got, want, f"JAX, segment {seg}")


def test_sweep_is_exact_at_every_cut(trained):
    """One position a segment: every offset of the record is a cut, each
    sweep starting ``max_len - 1`` symbols to its right (rounded up to the
    kernel's chunk, or not) or at the record's end.  One symbol less of
    warm-up is not enough: that is the bound's tightness."""
    merges, q = trained
    table = bpe_encode.build_automaton(merges, CPU)
    want = _plain(q, table)
    w = table.max_len - 1
    for warm in (w, w + 9):  # and more than needed
        _same(sweep_model(q, table, 1, warm), want, f"cut everywhere, warm-up {warm}")
    longest = max((s for s, _ in merges), key=len)
    qt = q.copy()
    qt[0, 100:100 + len(longest)] = np.asarray(longest) - A
    short = sweep_model(qt, table, 1, w - 1)
    assert not np.array_equal(short[1], _plain(qt, table)[1])


ROWS = chip_smoke.match_rows(np.random.default_rng(11), [((A, A + 1), 256)])  # the labels


@pytest.mark.parametrize("index", range(len(ROWS)), ids=[r[0] for r in ROWS])
def test_sweep_model_on_the_chip_smoke_rows(index, trained):
    """chip_smoke's adversarial rows, with the trained vocabulary where they
    take the main path's: the model at every segment length equals the
    plain walk; the plain walk equals the definition where it is cheap."""
    label, q, vocab, budget = chip_smoke.match_rows(np.random.default_rng(11), trained[0])[index]
    table = bpe_encode.build_automaton(vocab, CPU, sweep_budget=budget)
    want = _plain(q, table)
    for seg in (16, 32, 64):
        _same(sweep_model(q, table, seg), want, f"{label}, segment {seg}")
    if q.size * table.max_len <= 200_000:
        _same(want, brute_force(q, vocab), f"{label}: plain vs definition")
    wide = "65,536" in label
    assert table.sweep.wide == wide
    if wide:
        assert table.sweep.states > bpe_encode.NARROW_MAX_STATES
    assert (table.sweep.full < table.sweep.states) == ("compact" in label)


_symbols = st.lists(st.integers(0, 25), min_size=1, max_size=12)
SPLITS = []  # whether each table of test_random_vocabularies had compact rows


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(
    tokens=st.lists(st.tuples(_symbols, st.booleans()), min_size=1, max_size=25),
    long_token=st.lists(st.integers(0, 2), min_size=100, max_size=255),
    records=st.lists(st.lists(st.integers(0, 2), min_size=1, max_size=40), min_size=1,
                     max_size=3),
    cut=st.integers(1, 64),
)
def test_random_vocabularies(tokens, long_token, records, cut):
    """Random vocabularies over a few symbols, so that tokens overlap:
    duplicate sequences (the later id wins), a token of up to 255 symbols,
    tokens holding a non-alphabet byte (skipped), records shorter than the
    longest token, padded to one width with records cut short.  The model
    at every segment length, the plain walk and the definition agree."""
    merges = [(tuple(A + c for c in syms) + ((ord("A"),) if odd else ()), 256 + i)
              for i, (syms, odd) in enumerate(tokens)]
    merges += [(tuple(A + c for c in long_token), 9000),
               (tuple(A + c for c in tokens[0][0]), 70000)]
    width = max(map(len, records))
    q = np.array([r + [0] * (width - len(r)) for r in records], np.uint8)
    q = q[:, :max(1, min(width, cut))]
    want = brute_force(q, merges)
    for budget in (bpe_encode.SWEEP_SMEM_BUDGET, 6 * 1024):
        table = bpe_encode.build_automaton(merges, CPU, sweep_budget=budget)
        SPLITS.append(table.sweep.full < table.sweep.states)
        _same(_plain(q, table), want, "plain vs definition")
        for seg in (16, 32, 64):
            _same(sweep_model(q, table, seg), want, f"segment {seg}, budget {budget}")


def test_choose_sweep():
    """Every choice is one the kernel takes (a segment of 16, 32 or 64, at
    most 16 warps a block) and one of ``sweep_choices``, which chip_smoke
    checks on its adversarial rows; the token cache's shapes and
    chip_smoke's (256, 30000) get the best reading of
    tools/bpe_match_shapes.py."""
    choices = bpe_match.sweep_choices()
    for n in (1, 6000, 1 << 20, 1 << 21, 1 << 22, 7_680_000):
        seg, warps = bpe_match.choose_sweep(1, n)
        assert seg in (16, 32, 64) and 1 <= warps <= 16
        assert (seg, warps) in choices
    best = {(64, 6000): (16, 8), (12, 30000): (16, 8), (64, 30000): (32, 16),
            (256, 30000): (64, 16)}
    for (b, n), choice in best.items():
        assert bpe_match.choose_sweep(b, n) == choice


@pytest.mark.parametrize("fault", ["dtype", "non-contiguous", "device"])
def test_wrapper_refuses(fault, toy):
    """A tensor off the CPU goes to the kernel's checks, never to the plain
    version (a meta tensor stands in for the card's): a q of another dtype,
    a non-contiguous q and a q that is not on a CUDA device are refused."""
    merges, q = toy
    table = bpe_encode.build_automaton(merges, CPU)
    meta = torch.from_numpy(q).to("meta")
    bad, match = {"dtype": (meta.to(torch.int32), "uint8"),
                  "non-contiguous": (meta.t(), "contiguous"),
                  "device": (meta, "CUDA device")}[fault]
    before = bpe_match.longest_match.launches
    with pytest.raises(ValueError, match=match):
        bpe_match.longest_match(bad, table)
    assert bpe_match.longest_match.launches == before


def test_random_vocabularies_reach_both_layouts():
    """The property above built tables with compact rows and without."""
    if not SPLITS:
        test_random_vocabularies()
    assert any(SPLITS) and not all(SPLITS)
