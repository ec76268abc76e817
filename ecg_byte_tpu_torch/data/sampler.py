"""Morphology-stratified ECG sampling for the tokenizer corpus
(``ecg_byte_tpu/data/sampler.py``).

Counterpart of preprocess_utils.py:259-462 (the sample_ecg.py path):
per-lead statistical, spectral and morphological features on the host
(numpy and scipy, the wavelet features from the port's own db4), then PCA
to 95% of the variance, KMeans with elbow and silhouette model selection
(DBSCAN as the fallback) and the stratified draw.  The clustering runs in
float64 on a device with the port's own routines (``utils/sk.py``; no
scikit-learn): on the card by default, on the CPU when asked.
"""

from __future__ import annotations

import os
import random
from typing import List, Sequence, Tuple

import numpy as np
import torch
from scipy import signal as sps

from ecg_byte_tpu_torch.device import resolve_device


def _wavedec_host(x: np.ndarray, dec_lo: np.ndarray, dec_hi: np.ndarray,
                  level: int) -> List[np.ndarray]:
    """Symmetric-extension DWT cascade -> [cA_n, cD_n, ..., cD_1]."""
    flen = len(dec_lo)
    a = np.asarray(x, np.float64)
    details: List[np.ndarray] = []
    for _ in range(level):
        n = len(a)
        pad = flen - 1
        idx = np.arange(-pad, n + pad)
        idx = np.mod(idx, 2 * n)
        idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
        ext = a[idx]
        lo = np.convolve(ext, dec_lo[::-1], "valid")[1::2]
        hi = np.convolve(ext, dec_hi[::-1], "valid")[1::2]
        m = (n + flen - 1) // 2
        details.append(hi[:m])
        a = lo[:m]
    return [a] + details[::-1]


def find_qrs_duration(ecg: np.ndarray, peak: int, sampling_rate: float) -> float:
    """Simplified QRS width around a peak (preprocess_utils.py:327-333)."""
    window = int(0.1 * sampling_rate)
    start = max(0, peak - window)
    end = min(len(ecg), peak + window)
    qrs = ecg[start:end]
    return float(np.sum(np.abs(qrs) > 0.1 * np.max(qrs)) / sampling_rate)


def find_t_wave_amplitude(ecg: np.ndarray, peaks: np.ndarray) -> float:
    if len(peaks) < 2:
        return 0.0
    region = ecg[peaks[-2] : peaks[-1]]
    return float(np.max(region) - np.min(region))


def find_st_deviation(ecg: np.ndarray, peaks: np.ndarray,
                      sampling_rate: float) -> float:
    if len(peaks) < 2:
        return 0.0
    st_point = peaks[-1] + int(0.08 * sampling_rate)
    if st_point < len(ecg):
        return float(ecg[st_point] - ecg[peaks[-1]])
    return 0.0


def extract_features(ecg: np.ndarray, sampling_rate: float = 250) -> np.ndarray:
    """Per-lead feature vector (preprocess_utils.py:259-324)."""
    from ecg_byte_tpu_torch.ops.wavelet import daubechies

    db4 = daubechies(4)
    dec_lo = np.asarray(db4.dec_lo, np.float64)
    dec_hi = np.asarray(db4.dec_hi, np.float64)

    features: List[float] = []
    for lead in range(ecg.shape[0]):
        x = np.asarray(ecg[lead], np.float64)
        features.extend([
            np.mean(x), np.std(x), np.max(x), np.min(x), np.median(x),
            np.percentile(x, 25), np.percentile(x, 75),
        ])

        freqs, psd = sps.welch(x, fs=sampling_rate, nperseg=min(1024, len(x)))
        total_power = float(np.sum(psd))
        features.extend([total_power, float(np.max(psd)),
                         float(freqs[np.argmax(psd)])])
        features.append(
            float(np.sum(freqs * psd) / total_power) if total_power > 0 else 0.0
        )

        peaks, _ = sps.find_peaks(
            x, height=0.5 * np.max(x), distance=max(int(0.2 * sampling_rate), 1)
        )
        if len(peaks) > 1:
            rr = np.diff(peaks) / sampling_rate
            features.append(60.0 / float(np.mean(rr)))  # heart rate
            features.append(float(np.std(rr)))  # HRV
            features.append(
                float(np.mean([find_qrs_duration(x, p, sampling_rate)
                               for p in peaks]))
            )
        else:
            features.extend([0.0, 0.0, 0.0])

        features.append(find_t_wave_amplitude(x, peaks))
        features.append(find_st_deviation(x, peaks, sampling_rate))

        coeffs = _wavedec_host(x, dec_lo, dec_hi, level=5)
        features.extend(float(np.mean(np.abs(c))) for c in coeffs)

        features.append(float(np.mean(np.abs(np.diff(x)))))
        features.append(float(np.sqrt(np.mean(np.square(np.diff(x))))))

    return np.nan_to_num(np.asarray(features, np.float64))


def find_elbow_point(inertias: Sequence[float]) -> int:
    diffs = np.diff(inertias)
    return int(np.argmin(diffs)) + 2  # k range starts at 2


def find_optimal_clusters(data: torch.Tensor, max_clusters: int) -> int:
    """Elbow + silhouette; the conservative minimum of the two
    (preprocess_utils.py:396-439).  ``data``: float64 on the device that
    clusters."""
    from ecg_byte_tpu_torch.utils.sk import KMeans, silhouette_score

    n = data.shape[0]
    upper = min(max_clusters, n - 1)
    if upper < 2:
        return 1
    inertias, sils = [], []
    for k in range(2, upper + 1):
        km = KMeans(n_clusters=k, random_state=42, n_init=10).fit(data)
        inertias.append(km.inertia_)
        sils.append(silhouette_score(data, km.labels_))
    if len(inertias) == 1:
        return 2
    elbow = find_elbow_point(inertias)
    best_sil = int(np.argmax(sils)) + 2
    optimal = min(elbow, best_sil)
    print(f"Elbow method suggests {elbow} clusters; "
          f"highest silhouette at {best_sil}; chosen {optimal}")
    return optimal


def analyze_morphologies(directory: str, max_clusters: int = 100, subset_size: int = 10000,
                         device=None) -> Tuple[List[str], np.ndarray, int]:
    """Cluster ECG files by morphology features
    (preprocess_utils.py:349-394): the features on the host, PCA to 95% of
    the variance, scaling, the model-selected KMeans and the DBSCAN
    fallback on ``device`` (default the CUDA card; the CPU only when
    named).  Returns (paths, cluster labels, n_clusters)."""
    from ecg_byte_tpu_torch.utils.sk import DBSCAN, PCA, KMeans, StandardScaler

    dev = resolve_device(device)
    file_paths: List[str] = []
    feats: List[np.ndarray] = []
    for filename in sorted(os.listdir(directory)):
        if not filename.endswith(".npy"):
            continue
        path = os.path.join(directory, filename)
        file_paths.append(path)
        feats.append(extract_features(np.load(path)))
        if len(file_paths) > subset_size:
            break
    all_features = torch.from_numpy(np.asarray(feats, np.float64)).to(dev)

    reduced = PCA(n_components=0.95).fit_transform(all_features)  # retain 95% of variance
    scaled = StandardScaler().fit_transform(reduced)

    n_clusters = find_optimal_clusters(scaled, max_clusters)
    if n_clusters < 2:
        return file_paths, np.zeros(len(file_paths), np.int64), 1
    clusters = KMeans(n_clusters=n_clusters, random_state=42, n_init=10).fit_predict(scaled)
    if len(np.unique(clusters)) < 3:
        print("KMeans produced too few clusters. Trying DBSCAN...")
        db = DBSCAN(eps=0.5, min_samples=5).fit_predict(scaled)
        if len(np.unique(db)) >= len(np.unique(clusters)):
            clusters = db
    return file_paths, clusters, len(np.unique(clusters))


def stratified_sampling(
    file_paths: Sequence[str], clusters: np.ndarray, n_samples: int = 100000
) -> List[str]:
    """Equal draw per cluster, top-up from the remainder
    (preprocess_utils.py:447-462)."""
    unique_clusters = np.unique(clusters)
    per_cluster = n_samples // len(unique_clusters)
    sampled: List[str] = []
    for cluster in unique_clusters:
        members = [file_paths[i] for i in range(len(file_paths))
                   if clusters[i] == cluster]
        sampled.extend(random.sample(members, min(per_cluster, len(members))))
    remaining = n_samples - len(sampled)
    if remaining > 0:
        rest = list(set(file_paths) - set(sampled))
        sampled.extend(random.sample(rest, min(remaining, len(rest))))
    return sampled
