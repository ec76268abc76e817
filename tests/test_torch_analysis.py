"""The port's tokenizer analysis against the JAX package's, and its two CLIs.

The cases of ``tests/test_preprocess.py::test_analysis_token_tools`` on the
same files and merges: ``quantize_file``, ``analyze_token_distribution``
and ``track_encoding`` of both packages must be equal (host code on
integers and strings: exact).  Then ``cli.token_distribution`` and
``cli.track_bpe_encoding`` run in-process and return the same numbers,
with their plots where matplotlib is installed and without them where it
is not.
"""

import numpy as np
import pytest

from ecg_byte_tpu.tokenizer import analysis as janalysis
from ecg_byte_tpu.tokenizer import native as jnative
from ecg_byte_tpu_torch.cli import token_distribution, track_bpe_encoding
from ecg_byte_tpu_torch.tokenizer import analysis
from ecg_byte_tpu_torch.tokenizer.bpe import save_vocab_and_merges, build_vocab
from ecg_byte_tpu_torch.utils import viz_utils


@pytest.fixture()
def files(tmp_path):
    rng = np.random.default_rng(3)
    sigs = []
    for i in range(4):
        s = (np.cumsum(rng.normal(size=(12, 60)), -1) * 0.05).astype(np.float32)
        s[i % 12] = 0.0  # a flat lead in each record
        np.save(tmp_path / f"ecg_{i}_0.npy", s)
        sigs.append(s)
    stats = np.stack(sigs)
    percentiles = {"percentile_1": float(np.percentile(stats, 1)),
                   "percentile_99": float(np.percentile(stats, 99))}
    paths = [str(tmp_path / f"ecg_{i}_0.npy") for i in range(4)]
    corpus = "".join(analysis.quantize_file(p, percentiles) for p in paths)
    _, merges = jnative.train(corpus.encode(), 50)
    return tmp_path, paths, percentiles, merges


def test_analysis_matches_jax(files):
    _, paths, percentiles, merges = files
    for p in paths:
        assert analysis.quantize_file(p, percentiles) == janalysis.quantize_file(p, percentiles)
    counts, lengths = analysis.analyze_token_distribution(paths, merges, percentiles)
    jcounts, jlengths = janalysis.analyze_token_distribution(paths, merges, percentiles)
    assert counts == jcounts and lengths == jlengths
    assert len(lengths) == 4 and sum(counts.values()) == sum(lengths)
    text = analysis.quantize_file(paths[0], percentiles)
    ids, segmap = analysis.track_encoding(text, merges)
    assert (ids, segmap) == janalysis.track_encoding(text, merges)
    assert len(ids) == len(segmap)
    assert segmap[0][0] == 0 and segmap[-1][1] == len(text)
    for (_, e1), (s2, _) in zip(segmap, segmap[1:]):
        assert e1 == s2


@pytest.mark.parametrize("matplotlib", [True, False], ids=["plots", "no-matplotlib"])
def test_both_clis_run(files, monkeypatch, matplotlib):
    root, paths, percentiles, merges = files
    if not matplotlib:  # as on the machine with the card
        monkeypatch.setattr(viz_utils, "_pyplot", lambda: None)
    save_vocab_and_merges(build_vocab(merges), merges, str(root / "tok.pkl"))
    np.save(root / "stats.npy", percentiles)
    out = root / "pngs"
    counts, lengths = token_distribution.main([
        "--tokenizer", str(root / "tok.pkl"), "--ecg_glob", str(root / "ecg_*_0.npy"),
        "--percentiles", str(root / "stats.npy"), "--num_workers", "2", "--limit", "3",
        "--out_dir", str(out)])
    assert (counts, lengths) == analysis.analyze_token_distribution(paths[:3], merges,
                                                                    percentiles)
    ids, segmap = track_bpe_encoding.main([
        "--tokenizer", str(root / "tok.pkl"), "--ecg_file", paths[0],
        "--percentiles", str(root / "stats.npy"), "--leads", "0", "5", "--out_dir", str(out)])
    assert (ids, segmap) == analysis.track_encoding(
        analysis.quantize_file(paths[0], percentiles), merges)
    drawn = sorted(p.name for p in out.glob("*.png")) if out.exists() else []
    if matplotlib:
        assert drawn == ["bpe_segments_lead0.png", "bpe_segments_lead5.png",
                         "token_length_distribution.png", "token_rank_frequency.png"]
    else:
        assert drawn == []
