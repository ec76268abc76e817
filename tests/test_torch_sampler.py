"""The port's morphology sampler and its scikit-learn replacements
(``ecg_byte_tpu_torch/data/sampler.py``, ``utils/sk.py``,
``cli/sample_ecg.py``) against the JAX package's sampler and scikit-learn
on the CPU.  The split and the binarizer are exact; PCA, scaling and
silhouette agree to float64 rounding; KMeans draws its seeds from a torch
generator, so it is held to the same partition up to a permutation (and
the same chosen k) on separable blobs; DBSCAN to the same labels where no
border point is shared."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN as SkDBSCAN
from sklearn.cluster import KMeans as SkKMeans
from sklearn.decomposition import PCA as SkPCA
from sklearn.metrics import silhouette_score as sk_silhouette
from sklearn.model_selection import train_test_split as sk_split
from sklearn.preprocessing import MultiLabelBinarizer as SkMLB
from sklearn.preprocessing import StandardScaler as SkScaler

from ecg_byte_tpu.data import sampler as jsampler
from ecg_byte_tpu_torch.data import sampler
from ecg_byte_tpu_torch.utils import sk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blobs(n_per, k, d, spread=1.0, seed=0, scale=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * scale
    x = np.concatenate([c + spread * rng.normal(size=(n_per, d)) for c in centers])
    return x, np.repeat(np.arange(k), n_per)


def _same_partition(a, b):
    """Labels ``a`` and ``b`` name the same groups, up to a permutation."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(a)) == len(set(b))


@pytest.mark.parametrize("test_size", [0.3, 0.6])
def test_train_test_split_is_sklearns(test_size):
    """Every n from 2 to 299: the same train and test lists, or the same
    refusal of an empty side."""
    for n in range(2, 300):
        items = [f"r{i}" for i in range(n)]
        try:
            want = sk_split(items, test_size=test_size, random_state=42)
        except ValueError:
            with pytest.raises(ValueError):
                sk.train_test_split(items, test_size, 42)
            continue
        assert list(sk.train_test_split(items, test_size, 42)) == list(want), n


def test_multilabel_binarizer_is_sklearns():
    rows = [["NORM", "MI"], ["STTC"], ["MI"], ["CD", "HYP", "NORM"]]
    for y in (rows, [[3, 1], [2]]):
        got, want = sk.MultiLabelBinarizer(), SkMLB()
        np.testing.assert_array_equal(got.fit_transform(y), want.fit_transform(y))
        assert list(got.classes_) == list(want.classes_)
        assert got.classes_.dtype == want.classes_.dtype
        assert got.fit_transform(y).dtype == want.fit_transform(y).dtype
    empty = sk.MultiLabelBinarizer().fit([[]])
    assert list(empty.classes_) == list(SkMLB().fit([[]]).classes_) == []


@pytest.mark.parametrize("shape", [(60, 20), (15, 40), (400, 12)],
                         ids=["n>d", "n<d", "n>=10d"])
def test_pca_and_scaler_match_sklearn(shape):
    """PCA(0.95) keeps sklearn's number of components with sklearn's signs
    (within 1e-9 of max|ref|; measured 5.9e-15) and StandardScaler matches
    (within 1e-12; measured 2.2e-15), a constant column included."""
    rng = np.random.default_rng(shape[0])
    x = rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1])) + rng.normal(size=shape[1])
    x[:, 3] = 2.5
    t = torch.from_numpy(x)
    want = SkPCA(n_components=0.95).fit_transform(x)
    got = sk.PCA(0.95).fit_transform(t).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    want = SkScaler().fit_transform(x)
    got = sk.StandardScaler().fit_transform(t).numpy()
    assert np.abs(got - want).max() <= 1e-12


@pytest.mark.parametrize("k", [2, 3, 5])
def test_kmeans_matches_sklearn_on_blobs(k):
    """k separable blobs: the same partition up to a permutation and the
    same inertia within 1e-9 relative (measured 1.9e-16)."""
    x, truth = _blobs(25, k, 6, seed=k)
    got = sk.KMeans(k, random_state=42, n_init=10).fit(torch.from_numpy(x))
    want = SkKMeans(k, random_state=42, n_init=10).fit(x)
    assert _same_partition(got.labels_, want.labels_) and _same_partition(got.labels_, truth)
    assert abs(got.inertia_ - want.inertia_) <= 1e-9 * want.inertia_
    assert got.labels_.dtype == np.int64


def test_kmeans_relocates_an_empty_cluster_as_sklearn(monkeypatch):
    """From the same seeds, one of them far from every point: the empty
    cluster takes the point farthest from its center, as in sklearn's
    ``_relocate_empty_clusters_dense``, and Lloyd's iterations then give
    sklearn's labels and inertia (within 1e-9 relative)."""
    x, _ = _blobs(10, 3, 2, seed=4)
    init = np.stack([x[0], x[15], np.full(2, 1e3)])
    want = SkKMeans(3, init=init, n_init=1).fit(x)
    km = sk.KMeans(3, n_init=1)
    monkeypatch.setattr(km, "_seed", lambda x_, gen: torch.from_numpy(init)[None].clone())
    got = km.fit(torch.from_numpy(x))
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert abs(got.inertia_ - want.inertia_) <= 1e-9 * want.inertia_


@pytest.mark.parametrize("labels", ["truth", "split", "singleton"])
def test_silhouette_matches_sklearn(labels):
    """Against sklearn within 1e-12 (measured 1.1e-16); a sample alone in its
    cluster scores 0, as there."""
    x, truth = _blobs(10, 3, 4, seed=1)
    lab = {"truth": truth, "split": np.arange(30) % 4,
           "singleton": np.where(np.arange(30) == 7, 9, truth)}[labels]
    got = sk.silhouette_score(torch.from_numpy(x), lab)
    assert abs(got - sk_silhouette(x, lab)) <= 1e-12
    with pytest.raises(ValueError):
        sk.silhouette_score(torch.from_numpy(x), np.zeros(30, np.int64))


def test_dbscan_matches_sklearn_without_shared_border_points():
    """Three tight blobs, a chain and scattered noise: the same labels as
    sklearn (clusters numbered by their first core point, noise -1)."""
    rng = np.random.default_rng(5)
    x, _ = _blobs(20, 3, 3, spread=0.1, seed=5)
    chain = np.stack([np.linspace(30, 32.4, 13), np.zeros(13), np.zeros(13)], 1)
    noise = rng.uniform(-60, 60, size=(8, 3))
    x = np.concatenate([noise[:4], x, chain, noise[4:]])
    want = SkDBSCAN(eps=0.5, min_samples=5).fit_predict(x)
    got = sk.DBSCAN(eps=0.5, min_samples=5).fit_predict(torch.from_numpy(x))
    np.testing.assert_array_equal(got, want)
    assert set(want.tolist()) >= {-1, 0, 1, 2, 3}


def test_find_optimal_clusters_chooses_sklearns_k(capsys):
    """On 4 separable blobs, the port's KMeans and silhouette give the JAX
    package's elbow (2), best silhouette (4) and choice (their minimum)."""
    x, _ = _blobs(12, 4, 5, seed=9)
    x = SkScaler().fit_transform(x)
    want = jsampler.find_optimal_clusters(x, 8)
    jlog = capsys.readouterr().out
    assert sampler.find_optimal_clusters(torch.from_numpy(x), 8) == want == 2
    assert capsys.readouterr().out == jlog == (
        "Elbow method suggests 2 clusters; highest silhouette at 4; chosen 2\n")


@pytest.fixture(scope="module")
def ecg_dir(tmp_path_factory):
    """18 segments of (12, 500) in three separable morphologies."""
    root = tmp_path_factory.mktemp("segments")
    rng = np.random.default_rng(2)
    for i in range(18):
        kind = i % 3
        base = np.sin(np.linspace(0, 20 + 30 * kind, 500)) * (1 + kind)
        sig = base[None] + 0.05 * rng.normal(size=(12, 500))
        np.save(root / f"ecg_{i}_0.npy", sig.astype(np.float32))
    return root


def test_features_and_clusters_match_jax(ecg_dir):
    """Per-file features equal the JAX package's exactly (the same numpy and
    scipy, the port's own db4); the clusters are the same partition with
    the same count; the stratified draw, the same code under the same
    seeded ``random``, is the same list."""
    for i in range(18):
        x = np.load(ecg_dir / f"ecg_{i}_0.npy")
        np.testing.assert_array_equal(sampler.extract_features(x), jsampler.extract_features(x))
    got_paths, got, n = sampler.analyze_morphologies(str(ecg_dir), max_clusters=6, device="cpu")
    want_paths, want, jn = jsampler.analyze_morphologies(str(ecg_dir), max_clusters=6)
    assert got_paths == want_paths and n == jn == 3 and _same_partition(got, want)
    for n_samples in (6, 11, 100):
        random.seed(n_samples)
        a = sampler.stratified_sampling(got_paths, want, n_samples)
        random.seed(n_samples)
        assert a == jsampler.stratified_sampling(want_paths, want, n_samples)


def test_clustering_runs_on_the_card_unless_the_cpu_is_named(ecg_dir):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sampler.analyze_morphologies(str(ecg_dir), max_clusters=3)


def test_sample_cli_matches_jax(ecg_dir, tmp_path):
    """``python -m ...cli.sample_ecg`` of both packages at once on the same
    segments, every file drawn: the same list file name, the same paths,
    the same cluster count."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    procs = {}
    for side, pkg, extra in (("jax", "ecg_byte_tpu", []),
                             ("torch", "ecg_byte_tpu_torch", ["--device", "cpu"])):
        procs[side] = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli.sample_ecg", "--ecg_dir", str(ecg_dir),
             "--max_clusters", "6", "--num_samples", "1000", "--data_root",
             str(tmp_path / side), *extra], cwd=str(tmp_path), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = {}
    for side, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stdout + stderr
        assert "18 files in 3 clusters" in stdout, stdout
        with open(tmp_path / side / "sampled_ecg_files_18.txt") as f:
            lines[side] = f.read().split("\n")
    assert sorted(lines["torch"]) == sorted(lines["jax"]) == sorted(
        str(ecg_dir / f"ecg_{i}_0.npy") for i in range(18))
