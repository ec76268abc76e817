"""The port's device BPE encoder (``ops/bpe_encode.py``, ``ops/bpe_match.py``)
against the JAX package's, on the CPU: the plain versions of the two kernels
and the compaction, token for token, against the Pallas kernels in interpret
mode, the XLA matchers and the C++ trie; vocabularies the Pallas path
refuses; the quantizer helpers and the tokenizer CLI.  Every result is an
integer and must be exact."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.cli import train_tokenizer as jax_train_tokenizer
from ecg_byte_tpu.ops import bpe_encode as jbe
from ecg_byte_tpu.ops import bpe_match as jbm
from ecg_byte_tpu.ops import quantize as jq
from ecg_byte_tpu_torch.cli import make_synthetic, train_tokenizer
from ecg_byte_tpu_torch.ops import bpe_encode, bpe_match, quantize
from ecg_byte_tpu_torch.tokenizer import native

CPU = torch.device("cpu")
A = ord("a")


def _trie(merges, q):
    """The host C++ trie's stream of each row of ``q``."""
    enc = native.NativeEncoder(merges)
    return [enc.encode(bytes(np.asarray(row, np.uint8) + A)).tolist()
            for row in np.atleast_2d(q)]


def _streams(ids, counts):
    """Valid tokens of each row; the rest of the row must be PAD_TOKEN."""
    ids, counts = np.atleast_2d(np.asarray(ids)), np.atleast_1d(np.asarray(counts))
    for row, c in zip(ids, counts):
        assert (row[int(c):] == bpe_encode.PAD_TOKEN).all()
    return [row[: int(c)].tolist() for row, c in zip(ids, counts)]


@pytest.fixture(scope="module")
def toy():
    """The fixture of tests/test_bpe_match.py: 80 merges of a random walk,
    three 240-symbol streams."""
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.integers(-2, 3, size=4000))
    corpus = bytes((np.abs(walk) % 26).astype(np.uint8) + A)
    _, merges = native.train(corpus, 80)
    q = (np.abs(np.cumsum(rng.integers(-2, 3, size=(3, 240)), axis=1)) % 26).astype(np.uint8)
    return merges, q, bpe_encode.build_automaton(merges, CPU)


@pytest.fixture(scope="module")
def trained():
    """The fixture of tests/test_bpe_tpu.py: 200 merges of an ECG-like walk."""
    rng = np.random.default_rng(0)
    steps = rng.integers(-1, 2, size=20000).cumsum()
    corpus = bytes(np.clip(steps % 26, 0, 25).astype(np.uint8) + A)
    _, merges = native.train(corpus, 200)
    return merges


def test_build_automaton_identical_to_jax(toy, trained):
    for merges in (toy[0], trained):
        got, want = bpe_encode.build_automaton(merges, CPU), jbe.build_automaton(merges)
        np.testing.assert_array_equal(got.trans.numpy(), np.asarray(want.trans))
        np.testing.assert_array_equal(got.token.numpy(), np.asarray(want.token))
        assert got.trans.dtype == got.token.dtype == torch.int32
        assert got.max_len == want.max_len
        assert bpe_encode.build_best_matcher(merges, CPU).max_len == want.max_len


def test_longest_match_plain_matches_jax(toy):
    merges, q, table = toy
    tok, ln = bpe_match.longest_match_plain(torch.from_numpy(q), table)
    assert tok.dtype == ln.dtype == torch.int32
    pm = jbm.build_pallas_matcher(merges)
    ptok, pln = jbm.longest_match(jnp.asarray(q), pm, tile_n=128, interpret=True)
    ctok, cln = jbe._longest_match_conv(jnp.asarray(q.astype(np.int32)), jbe.build_matcher(merges))
    for want_tok, want_len in ((ptok, pln), (ctok, cln)):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(want_len))


def test_greedy_chain_plain_matches_jax(toy):
    merges, q, table = toy
    _, ln = bpe_match.longest_match_plain(torch.from_numpy(q), table)
    visited = bpe_match.greedy_chain_plain(ln, table.max_len)
    assert visited.dtype == torch.bool and visited.shape == ln.shape
    pallas = jbm.greedy_chain(jnp.asarray(ln.numpy()), tile_rows=64, interpret=True)
    scan = jbe._greedy_chain_scan(jnp.asarray(ln.numpy()), table.max_len)
    np.testing.assert_array_equal(visited.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(visited.numpy(), np.asarray(scan))


@pytest.mark.parametrize("b,n,high", [(4, 3000, 8191), (3, 257, 8191), (2, 500, 70000)],
                         ids=["4x3000", "3x257", "ids-above-8191"])
def test_compact_matches_jax(b, n, high):
    """The cases of tests/test_bpe_tpu.py::test_compact_variants_identical,
    and ids past the packed sort's 13 bits against the pair sort."""
    rng = np.random.default_rng(0)
    tok = rng.integers(97, high, (b, n)).astype(np.int32)
    vis = rng.random((b, n)) < 0.3
    vis[0, :5] = [True, False, True, True, False]
    ids, counts = bpe_encode._compact(torch.from_numpy(tok), torch.from_numpy(vis))
    assert ids.dtype == counts.dtype == torch.int32
    jax_compact = jbe._compact if high <= 8192 else jbe._compact_sort_kv
    want_ids, want_counts = jax_compact(jnp.asarray(tok), jnp.asarray(vis))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert _streams(ids, counts) == [tok[i][vis[i]].tolist() for i in range(b)]


@pytest.mark.parametrize("rows", [2, 1], ids=["2d", "1d"])
def test_encode_matches_pallas_and_trie(toy, rows):
    merges, q, table = toy
    x = q if rows == 2 else q[0]
    ids, counts = bpe_encode.encode(torch.from_numpy(x), table)
    assert ids.shape == x.shape and ids.dtype == torch.int32
    want_ids, want_counts = jbm.encode(x, jbm.build_pallas_matcher(merges), tile_n=128,
                                       interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert _streams(ids, counts) == _trie(merges, x)


def test_quantize_and_encode_matches_jax(trained):
    merges = trained
    rng = np.random.default_rng(5)
    signal = rng.normal(size=(3, 12, 500)).astype(np.float32)
    p1, p99 = float(np.percentile(signal, 1)), float(np.percentile(signal, 99))
    ids, counts = bpe_encode.quantize_and_encode(
        torch.from_numpy(signal), p1, p99, bpe_encode.build_automaton(merges, CPU))
    assert ids.shape == (3, 6000)
    want_ids, want_counts = jbe.quantize_and_encode(signal, p1, p99, jbe.build_automaton(merges))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    _, q = quantize.normalize_quantize(torch.from_numpy(signal), p1, p99)
    assert _streams(ids, counts) == _trie(merges, q.reshape(3, -1).numpy())
    one, n_one = bpe_encode.quantize_and_encode(
        torch.from_numpy(signal[1]), p1, p99, bpe_encode.build_automaton(merges, CPU))
    assert _streams(one, n_one) == _streams(ids[1], counts[1])


def _long_token(n):
    return tuple(A + (i * 7) % 26 for i in range(n))


_VOCABS = {
    # the Pallas tables refuse both of these (tests/test_bpe_match.py:65-75, :100-101)
    "token-of-40-symbols": [((A, A + 1), 256), (_long_token(17), 257), (_long_token(40), 258)],
    "ids-of-8192-and-up": [((A, A), 8192), ((A + 1, A + 2, A + 1), 70000), ((A, A, A), 9000)],
    # tests/test_bpe_match.py::test_boundary_vocabulary_exact
    "boundary": [(tuple(A + (i % 26) for i in range(16)), 300), ((A, A), 8191),
                 ((A + 1, A + 2, A + 1), 270)],
    # tests/test_bpe_tpu.py::test_conv_matcher_duplicate_sequences_last_wins
    "duplicates-last-wins": [([97, 98], 256), ([97, 98, 99], 257), ([97, 98, 99], 258)],
}


@pytest.mark.parametrize("name", list(_VOCABS))
def test_vocabularies_pallas_refuses(name):
    """Every vocabulary takes the automaton: streams equal JAX's automaton
    encode and the C++ trie's, with the long tokens and large ids planted,
    and an all-'a' run (tests/test_bpe_tpu.py:49-56)."""
    merges = _VOCABS[name]
    if name in ("token-of-40-symbols", "ids-of-8192-and-up"):
        with pytest.raises(ValueError):
            jbm.build_pallas_matcher(merges, max_width=16)
    rng = np.random.default_rng(7)
    q = rng.integers(0, 3, size=(4, 200)).astype(np.uint8)
    for r, (seq, _) in enumerate(merges[:3]):
        q[r, 10:10 + len(seq)] = np.asarray(seq) - A
        q[r, -len(seq):] = np.asarray(seq) - A  # a token that ends at the record's end
    q[3] = 0
    table = bpe_encode.build_automaton(merges, CPU)
    ids, counts = bpe_encode.encode(torch.from_numpy(q), table)
    want_ids, want_counts = jbe.encode(q, jbe.build_automaton(merges))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    got = _streams(ids, counts)
    assert got == _trie(merges, q)
    if name == "duplicates-last-wins":
        assert bpe_encode.encode(torch.tensor([0, 1, 2], dtype=torch.uint8), table)[0][:1].tolist() == [258]


def test_all_a_run(trained):
    table = bpe_encode.build_automaton(trained, CPU)
    q = np.zeros(777, np.uint8)
    ids, count = bpe_encode.encode(torch.from_numpy(q), table)
    assert _streams(ids, count) == _trie(trained, q)


def test_wrappers_take_plain_versions_on_cpu(toy):
    merges, q, table = toy
    qt = torch.from_numpy(q)
    before = (bpe_match.longest_match.launches, bpe_match.greedy_chain.launches)
    tok, ln = bpe_match.longest_match(qt, table)
    ptok, pln = bpe_match.longest_match_plain(qt, table)
    assert torch.equal(tok, ptok) and torch.equal(ln, pln)
    visited, ids, counts = bpe_match.greedy_chain(ln, tok, table.max_len)
    assert torch.equal(visited, bpe_match.greedy_chain_plain(ln, table.max_len))
    want_ids, want_counts = bpe_encode._compact(tok, visited)
    assert torch.equal(ids, want_ids) and torch.equal(counts, want_counts)
    assert (bpe_match.longest_match.launches, bpe_match.greedy_chain.launches) == before


def test_wrappers_never_fall_back_off_the_cpu(toy):
    """A tensor that is not on the CPU goes to the kernel's checks, never to
    the plain version: a meta tensor is refused."""
    _, q, table = toy
    meta = torch.device("meta")
    mtable = bpe_encode.Automaton(table.trans.to(meta), table.token.to(meta), table.max_len)
    with pytest.raises(ValueError, match="CUDA device"):
        bpe_match.longest_match(torch.from_numpy(q).to(meta), mtable)
    ln = torch.ones(3, 240, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        bpe_match.greedy_chain(ln, ln, table.max_len)


def test_quantize_helpers_identical_to_jax():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 26, size=(12, 50)).astype(np.uint8)
    got = quantize.reverse_normalize(torch.from_numpy(q), -1.25, 2.5)
    # XLA folds (hi - lo) / 25 into one constant and fuses the multiply-add,
    # where the port rounds q / 25, the product and the sum: within one f32
    # ulp of the product's size, hi - lo = 4.5 (an ulp of 4 is 4.8e-7)
    want = np.asarray(jq.reverse_normalize(q, -1.25, 2.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=float(np.spacing(np.float32(4))))
    text = quantize.quantized_to_string(q)
    np.testing.assert_array_equal(quantize.string_to_quantized(text, q.shape),
                                  jq.string_to_quantized(text, q.shape))
    np.testing.assert_array_equal(quantize.quantized_to_bytes(q), jq.quantized_to_bytes(q))
    b = jq.quantized_to_bytes(q)
    np.testing.assert_array_equal(quantize.bytes_to_quantized(b), jq.bytes_to_quantized(b))


def test_train_tokenizer_cli_identical_to_jax(tmp_path, monkeypatch, capsys):
    """The same flags give the same pickle and the same report as the JAX
    CLI, and the round trip is exact."""
    monkeypatch.chdir(tmp_path)
    make_synthetic.main(["--n_train", "6", "--n_val", "1", "--n_test", "1", "--seg_len", "80"])
    common = ["--train", "--num_merges", "60", "--sampled_files", "data/sampled_ecg_files_6.txt",
              "--percentiles", "data/ptb_500_dataset_stats.npy",
              "--check_file", "data/ptb_500/ecg/train/ecg_0_0.npy"]
    capsys.readouterr()
    path = train_tokenizer.main(common + ["--out_dir", "port"])
    port_out = capsys.readouterr().out
    # the JAX CLI's main takes the namespace of its own (identical) flags
    jax_train_tokenizer.main(train_tokenizer.get_args(common + ["--out_dir", "jax"]))
    jax_out = capsys.readouterr().out
    assert path == "port/tokenizer_60.pkl"
    with open(path, "rb") as f, open("jax/tokenizer_60.pkl", "rb") as g:
        assert pickle.load(f) == pickle.load(g)
    assert "Round-trip exact: True" in port_out

    def report(out):
        return [ln.replace("port/", "").replace("jax/", "") for ln in out.splitlines()
                if not ln.startswith("Byte pair encoding executed")]

    assert report(port_out) == report(jax_out)
