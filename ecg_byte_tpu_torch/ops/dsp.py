"""The ECG DSP chain as linear operators and batched tensor ops
(``ecg_byte_tpu/ops/dsp.py``).

Reference chain (preprocess_utils.py:64-98,115-162): per record, scipy
``filtfilt`` with two notch biquads (50/60 Hz, Q=30), a Butterworth
band-pass (0.5-100 Hz, order 4) and a 0.05 Hz high-pass, then db6 wavelet
denoising, then cubic-spline resampling 500 -> 250 Hz.

For a fixed record length every filtering stage is linear in the samples,
``filtfilt`` (odd padding, ``lfilter_zi`` edges) and cubic interpolation
alike, so each is built once on the host by pushing an identity through
scipy itself in float64, and applied on the device as one product over a
whole batch:

    c = x @ (W_dec F)^T      # filtfilt chain, then wavelet analysis
    c = threshold(c)         # the only nonlinear stage (median threshold)
    y = c @ (R W_rec)^T      # wavelet synthesis, then cubic resample

The two products are plain large matrix products (``torch.matmul``), as
the JAX package leaves them to XLA; they run in full float32 whatever the
process's TF32 setting (:func:`full_f32_matmul`): TF32 rounds to ~1e-3, past
the 2e-4 and 2e-5 bounds against scipy.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import os
import tempfile
from typing import Sequence, Tuple

import numpy as np
import torch

from ecg_byte_tpu_torch.device import resolve_device
from ecg_byte_tpu_torch.ops.wavelet import _threshold

CACHE_ENV = "ECG_BYTE_TORCH_OP_CACHE"


def _disk_cached(name: str, key: tuple, build):
    """Memoize an operator matrix on disk, under ``$ECG_BYTE_TORCH_OP_CACHE``
    or ``<tmp>/ecg_byte_tpu_torch_op_cache``: scipy pushes a full identity
    through filtfilt/interp1d to build it (seconds at n = 5000), while the
    matrix is a pure function of the key."""
    cache_dir = os.environ.get(CACHE_ENV, os.path.join(tempfile.gettempdir(),
                                                       "ecg_byte_tpu_torch_op_cache"))
    digest = hashlib.sha1(repr((name,) + key).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"{name}_{digest}.npy")
    if os.path.exists(path):
        try:
            return np.load(path)
        except (OSError, ValueError):
            pass  # a torn or foreign file: build it again
    op = build()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        # np.save appends .npy to a name without it: the temp name has it
        tmp = f"{path}.tmp{os.getpid()}.npy"
        with open(tmp, "wb") as f:
            np.save(f, op)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is best-effort
    return op


_ON_DEVICE: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
_ON_DEVICE_MAX = 8


def on_device(name: str, key: tuple, build, device) -> torch.Tensor:
    """The operator ``name(key)`` as a float32 tensor on ``device``, from
    ``build()`` (a host array) on the first request for that device, then
    kept: this cache, keyed by name, key and device, holds the last
    ``_ON_DEVICE_MAX`` operators."""
    k = (name, key, torch.device(device))
    op = _ON_DEVICE.get(k)
    if op is None:
        op = torch.from_numpy(np.ascontiguousarray(build())).to(k[2])
        _ON_DEVICE[k] = op
        while len(_ON_DEVICE) > _ON_DEVICE_MAX:
            _ON_DEVICE.popitem(last=False)
    _ON_DEVICE.move_to_end(k)
    return op


@contextlib.contextmanager
def full_f32_matmul(backend: str = "matmul"):
    """Run float32 matrix products (``backend="matmul"``) or cuDNN
    convolutions (``"conv"``) in full float32 inside the block, whatever the
    process set, and restore its setting after.  The process's own API is
    kept: the legacy ``allow_tf32``, unless reading it raises because the
    newer ``fp32_precision`` was set (torch refuses a mix of the two)."""
    legacy, newer = {
        "matmul": (torch.backends.cuda.matmul, torch.backends.cuda.matmul),
        "conv": (torch.backends.cudnn, torch.backends.cudnn.conv),
    }[backend]
    try:
        owner, attr, value, saved = legacy, "allow_tf32", False, legacy.allow_tf32
    except RuntimeError:
        owner, attr, value, saved = newer, "fp32_precision", "ieee", newer.fp32_precision
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


@functools.lru_cache(maxsize=8)
def filtfilt_matrix(n: int, fs: float = 500.0, notch_freqs: Tuple[float, ...] = (50.0, 60.0),
                    highcut: float = 100.0, lowcut: float = 0.5, baseline_cutoff: float = 0.05,
                    order: int = 4) -> np.ndarray:
    """[n, n] float32 host matrix equal to the reference's
    ``advanced_ecg_filter`` (preprocess_utils.py:64-86 parameters): scipy's
    own filtfilt chain over an identity in float64, so padding and initial
    state are exactly scipy's."""
    def build():
        from scipy import signal as sps

        T = np.eye(n, dtype=np.float64)
        for f0 in notch_freqs:
            b, a = sps.iirnotch(f0, 30.0, fs)
            T = sps.filtfilt(b, a, T, axis=0)
        nyq = 0.5 * fs
        b, a = sps.butter(order, [lowcut / nyq, highcut / nyq], btype="band")
        T = sps.filtfilt(b, a, T, axis=0)
        b, a = sps.butter(order, baseline_cutoff / nyq, btype="high")
        T = sps.filtfilt(b, a, T, axis=0)
        return np.ascontiguousarray(T, dtype=np.float32)

    key = (n, fs, notch_freqs, highcut, lowcut, baseline_cutoff, order)
    return _disk_cached("filtfilt", key, build)


@functools.lru_cache(maxsize=8)
def resample_matrix(n: int, orig_fs: float, target_fs: float) -> np.ndarray:
    """[m, n] float32 host matrix of the reference's ``nsample_ecg``
    (preprocess_utils.py:88-98: scipy ``interp1d(kind='cubic')`` on matched
    endpoint-inclusive grids)."""
    def build():
        from scipy import interpolate

        duration = n / orig_fs
        t_orig = np.linspace(0, duration, n, endpoint=True)
        m = int(n * target_fs / orig_fs)
        t_target = np.linspace(0, duration, m, endpoint=True)
        f = interpolate.interp1d(t_orig, np.eye(n, dtype=np.float64), kind="cubic", axis=0,
                                 bounds_error=False, fill_value="extrapolate")
        return np.ascontiguousarray(f(t_target), dtype=np.float32)

    return _disk_cached("resample", (n, orig_fs, target_fs), build)


def filtfilt_operator(n: int, fs: float = 500.0, notch_freqs: Tuple[float, ...] = (50.0, 60.0),
                      highcut: float = 100.0, lowcut: float = 0.5,
                      baseline_cutoff: float = 0.05, order: int = 4,
                      device="cpu") -> torch.Tensor:
    """:func:`filtfilt_matrix` as a float32 tensor on ``device``."""
    key = (n, fs, tuple(notch_freqs), highcut, lowcut, baseline_cutoff, order)
    return on_device("filtfilt", key, lambda: filtfilt_matrix(*key), device)


def resample_operator(n: int, orig_fs: float, target_fs: float, device="cpu") -> torch.Tensor:
    """:func:`resample_matrix` as a float32 tensor on ``device``."""
    key = (n, orig_fs, target_fs)
    return on_device("resample", key, lambda: resample_matrix(*key), device)


def apply_operator(x: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """Apply an [m, n] operator along the last (time) axis: one product
    over every row of the batch."""
    return (x.reshape(-1, x.shape[-1]) @ op.T).reshape(x.shape[:-1] + (op.shape[0],))


def advanced_ecg_filter(x: torch.Tensor, fs: float = 500.0,
                        notch_freqs: Sequence[float] = (50.0, 60.0),
                        highcut: float = 100.0) -> torch.Tensor:
    """The reference filter chain on (..., time) tensors, on ``x``'s device."""
    op = filtfilt_operator(x.shape[-1], fs, tuple(notch_freqs), highcut, device=x.device)
    with full_f32_matmul():
        return apply_operator(x, op)


def nsample_ecg(x: torch.Tensor, orig_fs: float, target_fs: float) -> torch.Tensor:
    """Cubic resample along the last (time) axis, on ``x``'s device."""
    op = resample_operator(x.shape[-1], orig_fs, target_fs, device=x.device)
    with full_f32_matmul():
        return apply_operator(x, op)


def check_nan_inf(x: torch.Tensor) -> torch.Tensor:
    """NaN/inf scrub (preprocess_utils.py:27-34): replace with zeros."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


# MIMIC lead reorder (preprocess_utils.py:36-41): aVR/aVF/aVL -> aVL/aVR/aVF.
_MIMIC_REORDER = (0, 1, 2, 5, 3, 4, 6, 7, 8, 9, 10, 11)


def reorder_leads(x: torch.Tensor, lead_axis: int = -2) -> torch.Tensor:
    """Reorder MIMIC lead channels to the desired aVL/aVR/aVF order."""
    return torch.index_select(x, lead_axis, torch.tensor(_MIMIC_REORDER, device=x.device))


def segment_ecg(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """(..., leads, time) -> (..., num_segments, leads, seg_len): consecutive
    non-overlapping windows; the tail shorter than seg_len is dropped
    (preprocess_utils.py:100-113)."""
    num_segments = x.shape[-1] // seg_len
    parts = x[..., : num_segments * seg_len].reshape(x.shape[:-1] + (num_segments, seg_len))
    return parts.movedim(-2, -3)


@functools.lru_cache(maxsize=2)
def preprocess_operators(n: int, fs: float, target_fs: float, level: int = 4, p: int = 6,
                         device="cpu"):
    """The pipeline's linear stages folded into two float32 operators on
    ``device``: ``dec = W_dec F`` (filtfilt chain, then wavelet analysis,
    (total, n)) and ``rec = R W_rec`` (wavelet synthesis, then cubic
    resample, (m, total)), multiplied in float64 from the stage matrices
    (on ``device``: on the card a double-precision product takes
    milliseconds where the host takes seconds) and rounded once.
    Returns ``(dec, rec, seg_lens)``; kept per (shape, device)."""
    from ecg_byte_tpu_torch.ops.wavelet import _segment_lengths, _wavelet_matrices, daubechies

    device = torch.device(device)

    def f64(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float64)

    seg = _segment_lengths(n, level, daubechies(p).dec_len)
    total = sum(seg)
    wavelet = _wavelet_matrices(n, level, p)  # w_dec rows, then w_rec^T rows
    dec = (f64(wavelet[:total]) @ f64(filtfilt_matrix(n, fs))).float()
    w_rec = f64(wavelet[total:]).T
    rec = (f64(resample_matrix(n, fs, target_fs)) @ w_rec if target_fs != fs else w_rec).float()
    return dec, rec, seg


def preprocess_records(signals, fs: float = 500.0, target_fs: float = 250.0,
                       do_reorder: bool = False, device=None) -> torch.Tensor:
    """The per-record preprocess of ``process_instance``
    (preprocess_utils.py:115-162) minus segmentation, for a whole batch:
    filter -> wavelet denoise -> resample.

    Args:
      signals: float [..., leads, time] (time-last), a tensor or an array.
      device: where to run; default a tensor's own device, and for an
        array the CUDA card (``device.resolve_device``: the CPU only when
        named).
    Returns:
      float32 [..., leads, time * target_fs / fs] on that device.
    """
    if device is not None or not isinstance(signals, torch.Tensor):
        device = resolve_device(device)
    else:
        device = signals.device
    x = check_nan_inf(torch.as_tensor(signals, dtype=torch.float32, device=device))
    if do_reorder:
        x = reorder_leads(x)
    dec_op, rec_op, seg = preprocess_operators(x.shape[-1], fs, target_fs, device=x.device)
    with full_f32_matmul():
        c = apply_operator(x, dec_op)
        ca_len = seg[0]
        details = _threshold(c[..., ca_len:], c[..., ca_len: ca_len + seg[1]], 1e-10)
        y = apply_operator(torch.cat([c[..., :ca_len], details], -1), rec_op)
    return check_nan_inf(y)
