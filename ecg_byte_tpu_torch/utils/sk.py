"""The few scikit-learn pieces the preprocessing uses, for a machine without
scikit-learn (the card's has none).

- :func:`train_test_split` is exact: the same split as
  ``sklearn.model_selection.train_test_split(items, test_size=...,
  random_state=...)`` for a float ``test_size``.
- :class:`MultiLabelBinarizer` has sklearn's sorted ``classes_`` and
  multi-hot rows; it is what ``select_labeled`` pickles as ``mlb.pkl``.
- :class:`StandardScaler`, :class:`PCA`, :class:`KMeans`,
  :func:`silhouette_score` and :class:`DBSCAN` take float64 tensors and run
  on the tensors' device.  KMeans draws its k-means++ seeds from a
  ``torch.Generator``, not numpy's ``RandomState``, so its labels equal
  sklearn's only up to a permutation, and only where the data leave one
  good partition.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch


def train_test_split(items: Sequence, test_size: float, random_state: int):
    """``(train, test)`` lists: ``n_test = ceil(test_size * n)``, and
    ``RandomState(random_state).permutation(n)`` gives the test part first
    and the train part after it, as sklearn's ``ShuffleSplit`` does."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} of {n} items leaves an empty train or test set")
    perm = np.random.RandomState(random_state).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


class MultiLabelBinarizer:
    """Label sets -> multi-hot int64 rows over the sorted ``classes_``."""

    def fit(self, y):
        classes = sorted(set(itertools.chain.from_iterable(y)))
        dtype = int if all(isinstance(c, int) for c in classes) else object
        self.classes_ = np.empty(len(classes), dtype=dtype)
        self.classes_[:] = classes
        return self

    def transform(self, y) -> np.ndarray:
        column = {c: i for i, c in enumerate(self.classes_)}
        out = np.zeros((len(y), len(column)), dtype=np.int64)
        for r, labels in enumerate(y):
            out[r, [column[c] for c in set(labels) if c in column]] = 1
        return out

    def fit_transform(self, y) -> np.ndarray:
        return self.fit(y).transform(y)


class StandardScaler:
    """Zero mean, unit (population) variance per column; a column sklearn
    calls constant keeps scale 1."""

    def fit_transform(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        mean = x.mean(0)
        var = x.var(0, correction=0)
        eps = torch.finfo(torch.float64).eps
        constant = var <= n * eps * var + (n * mean * eps) ** 2
        scale = torch.where(constant, 1.0, var.sqrt())
        return (x - mean) / scale


class PCA:
    """``PCA(n_components=f)`` for a fraction ``f``: the fewest components
    whose explained variance reaches ``f``, from the SVD of the centred
    data, signs as sklearn's ``svd_flip`` (the largest |entry| of each
    component positive)."""

    def __init__(self, n_components: float = 0.95):
        self.n_components = n_components

    def fit_transform(self, x: torch.Tensor) -> torch.Tensor:
        xc = x - x.mean(0)
        _, s, vt = torch.linalg.svd(xc, full_matrices=False)
        rows = torch.arange(vt.shape[0], device=vt.device)
        vt = vt * torch.sign(vt[rows, vt.abs().argmax(1)])[:, None]
        ev = s**2 / (x.shape[0] - 1)
        cum = torch.cumsum(ev / ev.sum(), 0)
        k = int(torch.searchsorted(cum, torch.tensor([self.n_components], dtype=cum.dtype,
                                                      device=cum.device), right=True)) + 1
        self.n_components_ = min(k, vt.shape[0])
        self.components_ = vt[: self.n_components_]
        return xc @ self.components_.T


def _sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between the rows of ``a`` (..., m, d) and
    ``b`` (..., k, d), clamped at 0."""
    d = (a * a).sum(-1)[..., :, None] - 2 * a @ b.transpose(-1, -2) + (b * b).sum(-1)[..., None, :]
    return d.clamp_min_(0)


def pairwise_distances(x: torch.Tensor) -> torch.Tensor:
    """(n, n) Euclidean distances between the rows of ``x``, 0 on the
    diagonal."""
    d = _sq_distances(x, x).sqrt_()
    return d.fill_diagonal_(0)


class KMeans:
    """Lloyd's k-means with sklearn's defaults (greedy k-means++ seeding
    with 2 + ln k trials a center, 300 iterations, tol 1e-4 of the mean
    column variance, empty clusters moved to the farthest points), the
    ``n_init`` runs batched; the run of least inertia wins."""

    max_iter = 300
    tol = 1e-4  # of the mean column variance

    def __init__(self, n_clusters: int, random_state: int = 42, n_init: int = 10):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.n_init = n_init

    def _seed(self, x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """k-means++ centers, (n_init, k, d)."""
        I, k, (n, d) = self.n_init, self.n_clusters, x.shape
        trials = 2 + int(np.log(k))
        rows = torch.arange(I, device=x.device)
        first = torch.randint(n, (I,), generator=gen, device=x.device)
        centers = torch.empty(I, k, d, dtype=x.dtype, device=x.device)
        centers[:, 0] = x[first]
        closest = _sq_distances(x[first][:, None], x)[:, 0]  # (I, n)
        pot = closest.sum(1)
        for c in range(1, k):
            rand = torch.rand(I, trials, generator=gen, device=x.device, dtype=x.dtype) * pot[:, None]
            cand = torch.searchsorted(torch.cumsum(closest, 1), rand).clamp_(max=n - 1)  # (I, T)
            dist = torch.minimum(closest[:, None], _sq_distances(x[cand], x))  # (I, T, n)
            cand_pot = dist.sum(2)
            best = cand_pot.argmin(1)
            pot = cand_pot[rows, best]
            closest = dist[rows, best]
            centers[:, c] = x[cand[rows, best]]
        return centers

    def _assign(self, x, centers):
        return _sq_distances(x, centers).argmin(-1)  # (I, n)

    def fit(self, x: torch.Tensor) -> "KMeans":
        I, k, (n, d) = self.n_init, self.n_clusters, x.shape
        gen = torch.Generator(device=x.device).manual_seed(self.random_state)
        tol = x.var(0, correction=0).mean() * self.tol
        centers = self._seed(x, gen)
        labels_old = torch.full((I, n), -1, dtype=torch.long, device=x.device)
        active = torch.ones(I, dtype=torch.bool, device=x.device)
        xs = x.expand(I, n, d)
        for _ in range(self.max_iter):
            labels = self._assign(x, centers)
            sums = torch.zeros(I, k, d, dtype=x.dtype, device=x.device)
            sums.scatter_add_(1, labels[..., None].expand(I, n, d), xs)
            counts = torch.zeros(I, k, dtype=x.dtype, device=x.device)
            counts.scatter_add_(1, labels, torch.ones_like(labels, dtype=x.dtype))
            if bool((counts == 0).any()):
                self._relocate_empty(x, centers, labels, sums, counts)
            new = sums / counts[..., None]
            shift = ((new - centers) ** 2).sum((1, 2))
            converged = (labels == labels_old).all(1) | (shift <= tol)
            centers = torch.where(active[:, None, None], new, centers)
            labels_old = labels
            active &= ~converged
            if not bool(active.any()):
                break
        labels = self._assign(x, centers)
        inertia = ((x - centers[torch.arange(I, device=x.device)[:, None], labels]) ** 2).sum((1, 2))
        best = int(inertia.argmin())
        self.cluster_centers_ = centers[best]
        self.labels_ = labels[best].cpu().numpy()
        self.inertia_ = float(inertia[best])
        return self

    @staticmethod
    def _relocate_empty(x, centers, labels, sums, counts):
        """sklearn's ``_relocate_empty_clusters_dense``: each empty cluster
        takes one of the points farthest from their centers, which leaves
        its old cluster's sum (its label stays this iteration)."""
        for i in torch.nonzero((counts == 0).any(1)).flatten().tolist():
            empty = torch.nonzero(counts[i] == 0).flatten().tolist()
            far = ((x - centers[i][labels[i]]) ** 2).sum(1).argsort(descending=True)
            for cluster, p in zip(empty, far[: len(empty)].tolist()):
                old = int(labels[i, p])
                sums[i, old] -= x[p]
                sums[i, cluster] = x[p]
                counts[i, cluster] = 1
                counts[i, old] -= 1

    def fit_predict(self, x: torch.Tensor) -> np.ndarray:
        return self.fit(x).labels_


def silhouette_score(x: torch.Tensor, labels) -> float:
    """Mean silhouette over every sample, from the full pairwise distance
    matrix on ``x``'s device; a sample alone in its cluster scores 0."""
    labels = torch.as_tensor(np.asarray(labels), device=x.device)
    uniq, inv = torch.unique(labels, return_inverse=True)
    n, L = x.shape[0], len(uniq)
    if not 2 <= L <= n - 1:
        raise ValueError(f"{L} labels for {n} samples: silhouette needs 2 to n - 1")
    onehot = torch.nn.functional.one_hot(inv, L).to(x.dtype)
    sums = pairwise_distances(x) @ onehot  # (n, L): distance sum to each cluster
    counts = onehot.sum(0)
    own = counts[inv]
    a = sums.gather(1, inv[:, None])[:, 0] / (own - 1)
    b = (sums / counts).scatter(1, inv[:, None], float("inf")).min(1).values
    s = torch.nan_to_num((b - a) / torch.maximum(a, b))
    return float(s.mean())


class DBSCAN:
    """sklearn's DBSCAN on the full distance matrix: neighbours within
    ``eps`` (inclusive), core points with at least ``min_samples`` of them
    (themselves included), clusters numbered by their lowest core index,
    a border point in the lowest-numbered cluster that reaches it, noise
    -1."""

    def __init__(self, eps: float = 0.5, min_samples: int = 5):
        self.eps = eps
        self.min_samples = min_samples

    def fit_predict(self, x: torch.Tensor) -> np.ndarray:
        n = x.shape[0]
        adj = pairwise_distances(x) <= self.eps
        core = adj.sum(1) >= self.min_samples
        idx = torch.arange(n, device=x.device)
        sentinel = torch.full_like(idx, n)
        comp = torch.where(core, idx, sentinel)
        core_adj = adj & core[None, :] & core[:, None]
        while True:  # each core point takes the least index of its component
            spread = torch.where(core_adj, comp[None, :], sentinel[None, :]).min(1).values
            new = torch.minimum(comp, spread)
            if torch.equal(new, comp):
                break
            comp = new
        roots = torch.unique(comp[core])  # sorted: cluster j has the j-th least root
        cluster = torch.full((n + 1,), n, dtype=torch.long, device=x.device)
        cluster[roots] = torch.arange(len(roots), device=x.device)
        core_label = torch.where(core, cluster[comp], sentinel)
        reach = torch.where(adj & core[None, :], core_label[None, :], sentinel[None, :]).min(1).values
        labels = torch.where(core, core_label, reach)
        return torch.where(labels == n, -1, labels).cpu().numpy().astype(np.int64)

