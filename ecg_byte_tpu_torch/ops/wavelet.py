"""Daubechies wavelet transforms as batched convolutions
(``ecg_byte_tpu/ops/wavelet.py``).

The reference denoises each lead with pywt ``wavedec``/``waverec`` (db6,
level 4, symmetric padding) and a soft threshold set by the coarsest
detail band.  Here the transform is ``F.conv1d`` over every lead of a
batch at once, and for a fixed record length it folds into two matrices
(:func:`wavelet_operators`), so the pipeline's denoise is matmul ->
threshold -> matmul (:func:`wavelet_denoise_fused`).

The filters come from spectral factorization of the binomial polynomial
(numpy, float64), with pywt's conventions:

  - ``dec_lo = rev(h)``, ``dec_hi = rev(qmf(h))``, ``rec_lo = h``,
    ``rec_hi = qmf(h)`` with ``qmf(h)[k] = (-1)^k h[L-1-k]``;
  - signal extension is half-sample symmetric;
  - a DWT band has ``floor((n + L - 1) / 2)`` values and keeps the odd
    phase of the full convolution.
"""

from __future__ import annotations

import functools
from math import comb
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class WaveletFilters(NamedTuple):
    dec_lo: np.ndarray
    dec_hi: np.ndarray
    rec_lo: np.ndarray
    rec_hi: np.ndarray

    @property
    def dec_len(self) -> int:
        return len(self.dec_lo)


@functools.lru_cache(maxsize=None)
def daubechies(p: int) -> WaveletFilters:
    """The db``p`` filter bank (length 2p) by spectral factorization."""
    if p == 1:
        h = np.array([1.0, 1.0]) / np.sqrt(2.0)
    else:
        # P(y) = sum_{k=0}^{p-1} C(p-1+k, k) y^k (highest degree first)
        P = np.array([comb(p - 1 + k, k) for k in range(p - 1, -1, -1)], float)
        z_roots = []
        for y in np.roots(P):
            # y = (2 - z - 1/z) / 4  =>  z^2 + (4y - 2) z + 1 = 0
            r = np.roots(np.array([1.0, 4.0 * y - 2.0, 1.0]))
            z_roots.append(r[np.argmin(np.abs(r))])  # the root inside the unit circle
        poly = np.array([1.0 + 0.0j])
        for _ in range(p):
            poly = np.convolve(poly, [1.0, 1.0])  # (1 + z)^p
        for z in z_roots:
            poly = np.convolve(poly, [1.0, -z])
        h = np.real(poly)
        h *= np.sqrt(2.0) / h.sum()

    L = len(h)
    qmf = np.array([(-1) ** k * h[L - 1 - k] for k in range(L)])
    return WaveletFilters(dec_lo=h[::-1].copy(), dec_hi=qmf[::-1].copy(), rec_lo=h, rec_hi=qmf)


def _symmetric_extend(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Half-sample symmetric extension on the last axis (pywt 'symmetric')."""
    if pad == 0:
        return x
    n = x.shape[-1]
    if pad <= n:
        return torch.cat([x[..., :pad].flip(-1), x, x[..., n - pad:].flip(-1)], -1)
    idx = np.mod(np.arange(-pad, n + pad), 2 * n)
    idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
    return x[..., torch.from_numpy(idx).to(x.device)]


def _conv1d(x: torch.Tensor, kernels: np.ndarray, stride: int) -> torch.Tensor:
    """Valid-mode correlation along the last axis with a stack of kernels.

    x: (..., n); kernels: (num_filters, L) -> (..., num_filters, out).
    """
    w = torch.as_tensor(np.ascontiguousarray(kernels), dtype=x.dtype, device=x.device)[:, None, :]
    out = F.conv1d(x.reshape(-1, 1, x.shape[-1]), w, stride=stride)
    return out.reshape(x.shape[:-1] + out.shape[1:])


def dwt(x: torch.Tensor, filters: WaveletFilters) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level DWT -> (approx, detail), pywt 'symmetric' mode."""
    L = filters.dec_len
    out_len = (x.shape[-1] + L - 1) // 2
    ext = _symmetric_extend(x, L - 1)
    # convolution is correlation with the flipped filter; pywt keeps the
    # odd phase of the full convolution: stride 2 from ext[1:]
    kernels = np.stack([filters.dec_lo[::-1], filters.dec_hi[::-1]])
    dec = _conv1d(ext[..., 1:], kernels, stride=2)[..., :out_len]
    return dec[..., 0, :], dec[..., 1, :]


def idwt(ca: torch.Tensor, cd: torch.Tensor, filters: WaveletFilters,
         out_len: int) -> torch.Tensor:
    """Single-level inverse DWT (pywt semantics), cut to ``out_len``."""
    L = filters.dec_len

    def up(c):  # zero-interleave
        return torch.stack([c, torch.zeros_like(c)], -1).reshape(c.shape[:-1] + (2 * c.shape[-1],))

    pad = (L - 1, L - 1)
    ua, ud = F.pad(up(ca), pad), F.pad(up(cd), pad)
    rec = (_conv1d(ua, filters.rec_lo[None, ::-1], 1)[..., 0, :]
           + _conv1d(ud, filters.rec_hi[None, ::-1], 1)[..., 0, :])
    return rec[..., L - 2: L - 2 + out_len]


def wavedec(x: torch.Tensor, filters: WaveletFilters, level: int) -> List[torch.Tensor]:
    """Multilevel DWT; returns ``[cA_level, cD_level, ..., cD_1]`` like pywt."""
    coeffs = []
    a = x
    for _ in range(level):
        a, d = dwt(a, filters)
        coeffs.append(d)
    coeffs.append(a)
    return coeffs[::-1]


def dec_lengths(n: int, dec_len: int, level: int) -> List[int]:
    """Approximation lengths per level during decomposition, innermost
    first: ``lengths[i]`` is the target length when :func:`waverec` applies
    detail ``coeffs[i + 1]``."""
    lengths = [n]
    m = n
    for _ in range(level - 1):
        m = (m + dec_len - 1) // 2
        lengths.append(m)
    return lengths[::-1]


def waverec(coeffs: Sequence[torch.Tensor], filters: WaveletFilters,
            lengths: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`wavedec` given per-level target lengths."""
    a = coeffs[0]
    for i, d in enumerate(coeffs[1:]):
        a = idwt(a, d, filters, lengths[i])
    return a


def soft_threshold(c: torch.Tensor, threshold) -> torch.Tensor:
    """pywt.threshold(..., mode='soft'): sign(x) * max(|x| - t, 0)."""
    return torch.sign(c) * torch.clamp_min(c.abs() - threshold, 0.0)


def median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, keeping it: the mean of the two middle
    values for an even length, as ``jnp.median`` and ``np.median`` take it
    (``torch.median`` returns the lower one)."""
    s = x.sort(-1).values
    m = x.shape[-1] // 2
    if x.shape[-1] % 2:
        return s[..., m: m + 1]
    # jnp.median's linear interpolation at weight 0.5, term for term
    return s[..., m - 1: m] * 0.5 + s[..., m: m + 1] * 0.5


def _threshold(details: torch.Tensor, cd_level: torch.Tensor, epsilon: float) -> torch.Tensor:
    """The reference's masking soft threshold of every detail band, set by
    ``median(|cD_level|) / 0.6745`` (0 where that median is 0)."""
    median_abs = median(cd_level.abs())
    threshold = torch.where(median_abs == 0, 0.0, median_abs / 0.6745)
    th = soft_threshold(details, threshold)
    keep = torch.isfinite(th) & (details.abs() > epsilon)
    return torch.where(keep, th, 0.0)


@functools.lru_cache(maxsize=2)
def _wavelet_matrices(n: int, level: int, p: int) -> np.ndarray:
    from ecg_byte_tpu_torch.ops.dsp import _disk_cached

    filters = daubechies(p)

    def build():
        # push identities through the conv path in float64 on the host
        with torch.no_grad():
            coeffs = wavedec(torch.eye(n, dtype=torch.float64), filters, level)
            seg = [c.shape[-1] for c in coeffs]
            w_dec = torch.cat(coeffs, -1).T  # (total, n)
            parts = torch.split(torch.eye(sum(seg), dtype=torch.float64), seg, -1)
            w_rec = waverec(list(parts), filters, dec_lengths(n, filters.dec_len, level))
        # (total + total, n): w_dec rows, then w_rec^T rows (total, n)
        return torch.cat([w_dec, w_rec]).to(torch.float32).numpy()

    return _disk_cached("wavelet", (n, level, p), build)


def _segment_lengths(n: int, level: int, dec_len: int) -> Tuple[int, ...]:
    """``[cA_L, cD_L, ..., cD_1]`` band lengths, a function of (n, level, p)."""
    lens = []
    m = n
    for _ in range(level):
        m = (m + dec_len - 1) // 2
        lens.append(m)
    return tuple([lens[-1]] + lens[::-1])


def wavelet_operators(n: int, level: int = 4, p: int = 6, device="cpu"):
    """The fixed-length DWT as matrices: ``coeffs = x @ w_dec^T`` and
    ``rec = coeffs @ w_rec^T``, with only the data-dependent threshold
    between them.

    Built by pushing identity matrices through the conv path in float64 on
    the host, cast to float32 once, disk-cached beside the DSP operators;
    the device copy is cached per device.  Returns ``(w_dec (total, n),
    w_rec (n, total), seg_lens)``.
    """
    from ecg_byte_tpu_torch.ops.dsp import on_device

    seg = _segment_lengths(n, level, daubechies(p).dec_len)
    total = sum(seg)
    w_dec = on_device("wavelet_dec", (n, level, p), lambda: _wavelet_matrices(n, level, p)[:total],
                      device)
    w_rec = on_device("wavelet_rec", (n, level, p),
                      lambda: np.ascontiguousarray(_wavelet_matrices(n, level, p)[total:].T), device)
    return w_dec, w_rec, seg


def wavelet_denoise_fused(x: torch.Tensor, level: int = 4, p: int = 6,
                          epsilon: float = 1e-10) -> torch.Tensor:
    """Operator form of :func:`wavelet_denoise`: matmul -> threshold ->
    matmul, on ``x``'s device, the products in full float32."""
    from ecg_byte_tpu_torch.ops.dsp import apply_operator, full_f32_matmul

    w_dec, w_rec, seg = wavelet_operators(x.shape[-1], level, p, x.device)
    with full_f32_matmul():
        c = apply_operator(x, w_dec)  # (..., total)
        ca_len = seg[0]
        details = _threshold(c[..., ca_len:], c[..., ca_len: ca_len + seg[1]], epsilon)
        rec = apply_operator(torch.cat([c[..., :ca_len], details], -1), w_rec)
    return torch.nan_to_num(rec, nan=0.0, posinf=0.0, neginf=0.0)


def wavelet_denoise(x: torch.Tensor, level: int = 4, p: int = 6,
                    epsilon: float = 1e-10) -> torch.Tensor:
    """The reference's ``wavelet_denoise`` on (..., n) tensors: db6 level-4
    decomposition; threshold median(|cD_level|) / 0.6745 (0 if the median
    is 0); soft threshold on every detail band with the reference's
    finite/epsilon masking; the approximation band unchanged."""
    filters = daubechies(p)
    coeffs = wavedec(x, filters, level)
    ca, details = coeffs[0], coeffs[1:]  # [cD_level, ..., cD_1]
    lens = [d.shape[-1] for d in details]
    kept = torch.split(_threshold(torch.cat(details, -1), details[0], epsilon), lens, -1)
    rec = waverec([ca, *kept], filters, dec_lengths(x.shape[-1], filters.dec_len, level))
    return torch.nan_to_num(rec, nan=0.0, posinf=0.0, neginf=0.0)
