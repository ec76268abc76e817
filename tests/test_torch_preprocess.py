"""The port's ingestion (``ecg_byte_tpu_torch/data/wfdb_io.py``,
``data/preprocess.py``, ``cli/preprocess_ecg.py``) against the JAX
package's on the CPU: the WFDB reader on formats 16, 212, 80 and 32; the
MIMIC tree and its stats written by both from the same raw records (5,000
samples, as ``load_instance_signal`` requires), bad records included; the
PTB-XL labels of all six tasks against pandas and scikit-learn; the PTB-XL
tree; and one subprocess run of each preprocess CLI on the same tiny tree.
The raw trees are written by ``chip_smoke``'s writers, which phase 15
runs on the card at full size."""

import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from ecg_byte_tpu.data import preprocess as jpre
from ecg_byte_tpu.data import wfdb_io as jwfdb
from ecg_byte_tpu_torch.data import preprocess as pre
from ecg_byte_tpu_torch.data import wfdb_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
sys.modules["chip_smoke"] = chip_smoke  # its dataclasses look their module up
_spec.loader.exec_module(chip_smoke)

# |d| / max|ref| of the written arrays and of the stats: float32 products
# of operators that agree to ~1e-7 (measured 1.2e-6 on the arrays, 3.2e-7
# on the stats)
ARRAY_TOL = 1e-5
BAD = {1: "inf", 4: "fs250", 6: "short", 8: "missing"}
N_MIMIC = 10


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tree(root):
    """{relative path: array or parsed JSON} of a written tree."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npy"):
                out[rel] = np.load(path)
            elif name.endswith(".json"):
                with open(path) as f:
                    out[rel] = json.load(f)
    return out


def _assert_trees_match(got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want)
    assert got, "nothing was written"
    worst = 0.0
    for rel, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[rel].shape == w.shape and got[rel].dtype == w.dtype, rel
            worst = max(worst, _rel(got[rel], w))
        else:
            assert got[rel] == w, rel
    assert worst <= ARRAY_TOL, worst
    return len(got)


# ---------------------------------------------------------------- WFDB


def _write_record(tmp_path, name, fmt, adc, fs, spec):
    n, n_sig = adc.shape
    with open(tmp_path / f"{name}.hea", "w") as f:
        f.write(f"{name} {n_sig} {fs} {n}\n")
        for i in range(n_sig):
            f.write(f"{name}.dat {fmt} {spec} 12 0 0 0 0 s{i}\n")
    if fmt == "16":
        adc.astype("<i2").tofile(tmp_path / f"{name}.dat")
    elif fmt == "32":
        adc.astype("<i4").tofile(tmp_path / f"{name}.dat")
    elif fmt == "80":
        (adc + 128).astype(np.uint8).tofile(tmp_path / f"{name}.dat")
    else:  # 212: 12-bit pairs in 3 bytes
        flat = adc.reshape(-1) & 0xFFF
        raw = bytearray()
        for s0, s1 in zip(flat[0::2], flat[1::2]):
            raw += bytes([s0 & 0xFF, ((s1 >> 8) << 4) | (s0 >> 8), s1 & 0xFF])
        (tmp_path / f"{name}.dat").write_bytes(bytes(raw))


@pytest.mark.parametrize("fmt,lo,hi,spec", [
    ("16", -2000, 2000, "200(10)/mV"), ("212", -2048, 2048, "200/mV"),
    ("80", -128, 128, "100/mV"), ("32", -(2**20), 2**20, "1000(5)/uV")])
def test_wfdb_reader_equals_jax(tmp_path, fmt, lo, hi, spec):
    rng = np.random.default_rng(int(fmt))
    adc = rng.integers(lo, hi, size=(40, 3)).astype(np.int32)
    _write_record(tmp_path, "r", fmt, adc, 360, spec)
    sig, fields = wfdb_io.rdsamp(str(tmp_path / "r"))
    jsig, jfields = jwfdb.rdsamp(str(tmp_path / "r"))
    np.testing.assert_array_equal(sig, jsig)
    assert fields == jfields and sig.shape == (40, 3)


def test_wfdb_reader_refuses_what_jax_refuses(tmp_path):
    for name, fmt in (("r24", "24"), ("rx", "16x2")):
        (tmp_path / f"{name}.hea").write_text(f"{name} 1 500 4\n{name}.dat {fmt} 200/mV 16 0 0 0 0 s\n")
        (tmp_path / f"{name}.dat").write_bytes(b"\x00" * 16)
        for reader in (wfdb_io, jwfdb):
            with pytest.raises(NotImplementedError):
                reader.rdsamp(str(tmp_path / name))


# ---------------------------------------------------------------- MIMIC


@pytest.fixture(scope="module")
def mimic(tmp_path_factory):
    """Raw MIMIC-shaped records (4 bad) and a data root for each side, both
    reading the same ``mimic/`` directory."""
    raw = tmp_path_factory.mktemp("raw")
    chip_smoke.write_raw_mimic(str(raw), N_MIMIC, BAD, seed=3)
    with open(raw / "mimic" / "conversations.json") as f:
        instances = json.load(f)
    roots = {}
    for side in ("jax", "torch"):
        roots[side] = tmp_path_factory.mktemp(side)
        os.symlink(raw / "mimic", roots[side] / "mimic")
    return instances, roots, raw


def test_mimic_tree_and_stats_match_jax(mimic, capsys):
    """compute_global_stats and process_and_save_split on the same records:
    the same skip count (4) and the same file names and texts; arrays and
    stats within ARRAY_TOL."""
    instances, roots, _ = mimic
    jargs = jpre.PreprocessArgs(data="mimic", seg_len=500, data_root=str(roots["jax"]),
                                batch_size=4)
    targs = pre.PreprocessArgs(data="mimic", seg_len=500, data_root=str(roots["torch"]),
                               batch_size=4, device="cpu")
    jstats = jpre.compute_global_stats(instances, jargs, sample_size=20000)
    stats = pre.compute_global_stats(instances, targs, sample_size=20000)
    assert stats["skipped_instances"] == jstats["skipped_instances"] == len(BAD)
    for k in ("global_min", "global_max", "percentile_1", "percentile_99"):
        assert abs(stats[k] - jstats[k]) <= ARRAY_TOL * abs(jstats["global_max"]), k
    capsys.readouterr()
    jpre.process_and_save_split(instances, "train", jargs)
    jlog = capsys.readouterr().out
    pre.process_and_save_split(instances, "train", targs)
    log = capsys.readouterr().out
    assert jlog.splitlines()[-1] == log.splitlines()[-1] == "Total instances skipped in train split: 4"
    skipped = [[x.replace(str(roots[side]), "<root>") for x in out.splitlines() if "Skipping" in x]
               for side, out in (("torch", log), ("jax", jlog))]
    assert skipped[0] == skipped[1] and len(skipped[0]) == len(BAD)
    n = _assert_trees_match(roots["torch"] / "mimic_500", roots["jax"] / "mimic_500")
    assert n == 2 * (N_MIMIC - len(BAD)) * 5


def test_default_device_is_the_card():
    """PreprocessArgs without a device means the CUDA card; with none here
    the batch raises rather than run on the CPU."""
    x = np.zeros((1, 5000, 12), np.float32)
    assert pre.preprocess_signal_batch(x, pre.PreprocessArgs(device="cpu")).shape == (1, 1, 12, 2500)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pre.preprocess_signal_batch(x, pre.PreprocessArgs())


def test_setup_ecg_qa_matches_jax(tmp_path):
    items = [{"question_type": t, "question": f"q{i}", "answer": ["yes"]}
             for i, t in enumerate(["single-verify", "comparison", "single-query",
                                    "single-choose", "all-query"])]
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"t{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(items[i:], f)
    assert pre.setup_ecg_qa(paths) == jpre.setup_ecg_qa(paths)
    assert len(pre.setup_ecg_qa(paths)) == 5


# ---------------------------------------------------------------- PTB-XL


def _scp_csv(tmp_path):
    """scp_statements.csv of tests/test_preprocess.py's fixture (NaN flags,
    a diagnostic code without a subclass) and chip_smoke's statements."""
    path = tmp_path / "scp_statements.csv"
    chip_smoke.write_raw_ptb(str(tmp_path), n=0)
    agg = pd.read_csv(path, index_col=0)
    extra = pd.DataFrame(
        {"description": ["x", "y"], "diagnostic": [np.nan, 1.0], "form": [1.0, np.nan],
         "rhythm": [np.nan, np.nan], "diagnostic_class": [np.nan, "CD"],
         "diagnostic_subclass": [np.nan, "NA"]}, index=["ABQRS2", "CLBBB"])
    pd.concat([agg, extra]).to_csv(path)
    codes = [chip_smoke.ptb_codes(i) for i in range(40)]
    codes += [{"XYZ": 50.0}, {"CLBBB": 100.0, "ABQRS2": 0.0}, {"ABQRS2": 0.0}]
    return path, codes


@pytest.mark.parametrize("task", ["all", "diagnostic", "subdiagnostic", "superdiagnostic", "form",
                                  "rhythm"])
def test_ptb_labels_match_pandas_and_sklearn(tmp_path, task):
    """Every task's label lists from the csv-module table equal the JAX
    package's from pandas; select_labeled's rows, multi-hot matrix and
    classes equal sklearn's, at min_samples 0 and 1."""
    path, codes = _scp_csv(tmp_path)
    got = pre.compute_label_aggregations(codes, pre.ScpTable.read(str(path)), task)
    want = jpre.compute_label_aggregations(codes, pd.read_csv(path, index_col=0), task)
    assert got == want
    for min_samples in (0, 1):
        keep, kept, y, mlb = pre.select_labeled(got, task, min_samples, str(tmp_path / "t"))
        jkeep, jkept, jy, jmlb = jpre.select_labeled(want, task, min_samples, str(tmp_path / "j"))
        np.testing.assert_array_equal(keep, jkeep)
        assert kept == jkept and list(mlb.classes_) == list(jmlb.classes_)
        np.testing.assert_array_equal(y, jy)
        assert y.dtype == jy.dtype
        with open(tmp_path / "t" / "mlb.pkl", "rb") as f:
            assert list(pickle.load(f).classes_) == list(jmlb.classes_)
    with pytest.raises(ValueError):
        pre.compute_label_aggregations(codes, pre.ScpTable.read(str(path)), "bogus")


def test_preprocess_ptb_matches_jax(tmp_path):
    """The whole PTB-XL path on 12 records (folds 1-10, one record without a
    diagnostic statement in four, an empty report): the same tree, the
    same binarizer classes and a raw500.npy within ARRAY_TOL; a second run
    reads that cache and writes the same tree."""
    src = tmp_path / "src"
    chip_smoke.write_raw_ptb(str(src), n=12)
    for side in ("jax", "torch"):
        shutil.copytree(src, tmp_path / side / "ptb")
    jargs = jpre.PreprocessArgs(data="ptb", seg_len=500, data_root=str(tmp_path / "jax"),
                                batch_size=12)
    targs = pre.PreprocessArgs(data="ptb", seg_len=500, data_root=str(tmp_path / "torch"),
                               batch_size=12, device="cpu")
    jpre.preprocess_ptb(str(tmp_path / "jax" / "ptb"), jargs)
    pre.preprocess_ptb(str(tmp_path / "torch" / "ptb"), targs)
    n = _assert_trees_match(tmp_path / "torch" / "ptb_500", tmp_path / "jax" / "ptb_500")
    kept = chip_smoke.expected_ptb(12)[0]
    assert n == 2 * 5 * sum(len(v) for v in kept.values())
    for split, records in kept.items():
        assert len(os.listdir(tmp_path / "torch" / "ptb_500" / "ecg" / split)) == 5 * len(records)
    assert _tree(tmp_path / "torch" / "ptb_500")["text/val/text_0_0.json"] == "nan"  # record 7
    for side in ("jax", "torch"):
        with open(tmp_path / side / "ptb_500" / "mlb.pkl", "rb") as f:
            assert list(pickle.load(f).classes_) == chip_smoke.expected_ptb(12)[1]
    cache = np.load(tmp_path / "torch" / "ptb" / "raw500.npy", allow_pickle=True)
    jcache = np.load(tmp_path / "jax" / "ptb" / "raw500.npy", allow_pickle=True)
    assert cache.shape == jcache.shape == (12, 2500, 12) and cache.dtype == jcache.dtype
    assert _rel(cache, jcache) <= ARRAY_TOL
    shutil.rmtree(tmp_path / "torch" / "ptb_500")
    pre.preprocess_ptb(str(tmp_path / "torch" / "ptb"), targs)  # from raw500.npy
    _assert_trees_match(tmp_path / "torch" / "ptb_500", tmp_path / "jax" / "ptb_500")


def test_translate_reports_passes_through_or_refuses(tmp_path, monkeypatch):
    """Without a checkpoint the reports pass through, as in the JAX package;
    a directory that holds no model is refused by both packages, not passed
    through quietly; with a Marian directory (``chip_smoke``'s random one,
    tiny) both translate it to the same texts, named directly or by
    ``$ECG_BYTE_TRANSLATION_MODEL``."""
    monkeypatch.delenv(pre.TRANSLATION_ENV, raising=False)
    texts = ["sinusrhythmus", ""]
    assert list(pre.translate_reports(texts)) == list(jpre.translate_reports(texts))
    assert list(pre.translate_reports(texts, str(tmp_path / "missing"))) == texts
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        pre.translate_reports(texts, str(tmp_path / "empty"), device="cpu")
    with pytest.raises(FileNotFoundError):
        jpre.translate_reports(texts, str(tmp_path / "empty"))
    model = str(tmp_path / "marian")
    reports = chip_smoke.german_reports(3)
    chip_smoke.write_random_marian(model, reports, dict(
        vocab_size=200, d_model=16, encoder_layers=1, decoder_layers=1, num_heads=2, ffn_dim=32,
        max_position_embeddings=160, pad_token_id=199, decoder_start_token_id=199))
    texts = reports + [""]
    want = list(jpre.translate_reports(texts, model))
    assert list(pre.translate_reports(texts, model, device="cpu")) == want
    assert want[-1] == "" and all(want[:3])
    monkeypatch.setenv(pre.TRANSLATION_ENV, model)
    assert list(pre.translate_reports(texts, device="cpu")) == want


# ---------------------------------------------------------------- the CLI


def test_preprocess_cli_matches_jax(mimic):
    """``python -m ...cli.preprocess_ecg --data mimic`` of both packages on
    the same 10 records, at once in two processes: the same splits (7/1/2,
    scikit-learn's against the port's own), skip counts and tree; stats and
    arrays within ARRAY_TOL."""
    _, roots, raw = mimic
    base = ["--data", "mimic", "--instances_json", str(raw / "mimic" / "conversations.json"),
            "--seg_len", "2500", "--batch_size", "4"]
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    procs = {}
    for side, pkg, extra in (("jax", "ecg_byte_tpu", []),
                             ("torch", "ecg_byte_tpu_torch", ["--device", "cpu"])):
        procs[side] = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli.preprocess_ecg", *base, "--data_root",
             str(roots[side]), *extra], cwd=str(roots[side]), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for side, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stdout + stderr
        out[side] = stdout
    for line in ("train 7 val 1 test 2",):
        assert line in out["jax"] and line in out["torch"]
    skips = [x for x in out["jax"].splitlines() if x.startswith("Total instances skipped in")]
    assert skips == [x for x in out["torch"].splitlines()
                     if x.startswith("Total instances skipped in")] and len(skips) == 3
    _assert_trees_match(roots["torch"] / "mimic_2500", roots["jax"] / "mimic_2500")
    stats = np.load(roots["torch"] / "mimic_dataset_stats.npy", allow_pickle=True).item()
    jstats = np.load(roots["jax"] / "mimic_dataset_stats.npy", allow_pickle=True).item()
    assert sorted(stats) == sorted(jstats)
    assert stats["skipped_instances"] == jstats["skipped_instances"]
    for k in ("global_min", "global_max", "percentile_1", "percentile_99"):
        assert abs(stats[k] - jstats[k]) <= ARRAY_TOL * abs(jstats["global_max"]), k
