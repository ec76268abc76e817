"""The port's SentencePiece reader and segmenter against the JAX package's.

The twins of ``tests/test_sp_model.py``: the same ``.spm`` files (written
by either package's ``write_spm``, which must give the same bytes) go
through both packages' ``SentencePieceModel`` and ``MarianSpTokenizer``;
pieces, scores, ids, masks and decoded texts must be equal, with and
without the precompiled charsmap normaliser.  Host code on strings: every
comparison is exact (scores are the file's float32 values).
"""

import json

import numpy as np
import pytest

from ecg_byte_tpu.tokenizer import sp_model as jsp
from ecg_byte_tpu_torch.tokenizer import sp_model as tsp

UNIGRAM = [("<unk>", 0.0), ("▁the", -1.5), ("▁", -2.0), ("t", -3.0), ("h", -3.25), ("e", -3.5)]
BPE = [("<unk>", 0.0), ("a", -3.0), ("b", -3.0), ("c", -3.0), ("ab", -1.0), ("bc", -0.5),
       ("▁", -2.0)]
RULES = {"ﬁ": "fi", "ℌ": "H", "：": ":", " ": " ", "ab": "X", "abc": "Y"}
TEXTS = ["the", "te", "ta", "  the   the ", "abc", "efﬁzient ℌerz： gut", "müde 💙", ""]


def _both(tmp_path, name, pieces, **kw):
    """Write the model with each package; the files must be equal."""
    jp, tp = tmp_path / f"j_{name}.spm", tmp_path / f"t_{name}.spm"
    jsp.write_spm(str(jp), pieces, **kw)
    tsp.write_spm(str(tp), pieces, **kw)
    assert jp.read_bytes() == tp.read_bytes()
    return jsp.SentencePieceModel(str(jp)), tsp.SentencePieceModel(str(tp))


@pytest.mark.parametrize("name,pieces,kw", [
    ("unigram", UNIGRAM, {}),
    ("bpe", BPE, {"model_type": 2}),
    ("charsmap", UNIGRAM + [("▁fix", -0.5), ("f", -2.0), ("i", -2.0), ("x", -2.0)],
     {"charsmap_rules": RULES}),
])
def test_model_and_segmentation_match_jax(tmp_path, name, pieces, kw):
    jm, tm = _both(tmp_path, name, pieces, **kw)
    assert tm.pieces == jm.pieces == [p for p, _ in pieces]
    np.testing.assert_array_equal(tm.scores, jm.scores)
    assert (tm.types, tm.model_type, tm.unk_piece, tm.add_dummy_prefix) == \
        (jm.types, jm.model_type, jm.unk_piece, jm.add_dummy_prefix)
    assert (tm.charsmap is None) == (jm.charsmap is None) == ("charsmap_rules" not in kw)
    for text in TEXTS + ["ﬁx", "ﬁ the"]:
        assert tm.normalize(text) == jm.normalize(text), text
        assert tm.encode_pieces(text) == jm.encode_pieces(text), text


def test_segmentation_cases_of_the_jax_tests(tmp_path):
    """The hand-computed optima of tests/test_sp_model.py, on the port."""
    _, um = _both(tmp_path, "u", UNIGRAM)
    assert um.encode_pieces("the") == ["▁the"]
    assert um.encode_pieces("te") == ["▁", "t", "e"]
    assert um.encode_pieces("ta") == ["▁", "t", "a"]
    assert um.encode_pieces("  the   the ") == ["▁the", "▁the"]
    _, bm = _both(tmp_path, "b", BPE, model_type=2)
    assert bm.encode_pieces("abc") == ["▁", "a", "bc"]


def test_charsmap_blob_and_normaliser_match_jax():
    blob = tsp.DartsCharsMap.build(RULES)
    assert blob == jsp.DartsCharsMap.build(RULES)
    cm, jcm = tsp.DartsCharsMap(blob), jsp.DartsCharsMap(blob)
    for text in ("efﬁzient", "ℌerz： gut", "abc ab a", "müde 💙"):
        assert cm.normalize(text) == jcm.normalize(text)
    assert cm.normalize("abc ab a") == "Y X a"
    for bad in (b"\x01", b"\xff\xff\xff\xff123"):
        with pytest.raises(ValueError):
            tsp.DartsCharsMap(bad)


def test_marian_tokenizer_matches_jax(tmp_path):
    pieces = [("<unk>", 0.0), ("▁der", -1.0), ("▁herz", -1.0), ("▁", -2.0)]
    pieces += [(c, -3.0) for c in "derhz"]
    tsp.write_spm(str(tmp_path / "source.spm"), pieces, charsmap_rules={"ﬁ": "fi"})
    vocab = {"<pad>": 10, "</s>": 0, "<unk>": 1, "▁der": 2, "▁herz": 3,
             "▁": 4, "d": 5, "e": 6, "r": 7, "h": 8, "z": 9}
    json.dump(vocab, open(tmp_path / "vocab.json", "w"))
    tok, jtok = tsp.MarianSpTokenizer(str(tmp_path)), jsp.MarianSpTokenizer(str(tmp_path))
    texts = ["der herz", "der", "herz der herz xq", "ﬁ der"]
    for kw in ({}, {"max_length": 3}, {"max_length": 3, "truncation": False}):
        enc, jenc = tok(texts, **kw), jtok(texts, **kw)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(enc[key], jenc[key])
            assert enc[key].dtype == jenc[key].dtype
    ids = tok(texts)["input_ids"]
    assert tok.batch_decode(ids) == jtok.batch_decode(ids)
    assert tok.batch_decode(ids, skip_special_tokens=False) == \
        jtok.batch_decode(ids, skip_special_tokens=False)
    assert tok.batch_decode(tok(["der herz", "der"])["input_ids"]) == ["der herz", "der"]
    assert tok.encode("der", max_length=1) == jtok.encode("der", max_length=1) == [0]
