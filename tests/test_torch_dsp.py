"""The port's DSP chain (``ecg_byte_tpu_torch/ops/dsp.py``, ``ops/wavelet.py``)
against the JAX package's and against float64 scipy, on the CPU, at the
sizes of ``tests/test_dsp.py`` (1,000 samples).  Inputs are made with
numpy and handed to both.  Tolerances are stated with the worst case
measured on this CPU beside them."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import interpolate
from scipy import signal as sps

from ecg_byte_tpu.ops import dsp as jdsp
from ecg_byte_tpu.ops import wavelet as jw
from ecg_byte_tpu_torch.ops import dsp, wavelet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def ecg():
    """(2, 12, 1000) float32: 1.2 Hz sine, 50 Hz hum, noise, a random walk."""
    rng = np.random.default_rng(0)
    t = np.arange(1000) / 500.0
    base = np.sin(2 * np.pi * 1.2 * t) + 0.3 * np.sin(2 * np.pi * 50 * t)
    x = base[None, None, :] + 0.1 * rng.normal(size=(2, 12, 1000))
    return (x + 0.05 * rng.normal(size=x.shape).cumsum(-1)).astype(np.float32)


def test_daubechies_filters_equal_jax():
    for p in range(1, 11):
        for a, b in zip(wavelet.daubechies(p), jw.daubechies(p)):
            np.testing.assert_array_equal(a, b)


def test_conv_path_matches_jax(ecg):
    """dwt, idwt, wavedec and waverec on the same input, within 1e-6 of
    max|ref| (measured: wavedec equal, waverec 3.5e-7): both run float32
    correlations of the same filters."""
    f = wavelet.daubechies(6)
    x = torch.from_numpy(ecg)
    ca, cd = wavelet.dwt(x, f)
    jca, jcd = jw.dwt(ecg, jw.daubechies(6))
    assert _rel(ca, jca) <= 1e-6 and _rel(cd, jcd) <= 1e-6
    coeffs = wavelet.wavedec(x, f, 4)
    jcoeffs = jw.wavedec(ecg, jw.daubechies(6), 4)
    assert [c.shape[-1] for c in coeffs] == [c.shape[-1] for c in jcoeffs]
    for c, j in zip(coeffs, jcoeffs):
        assert _rel(c, j) <= 1e-6
    lengths = wavelet.dec_lengths(1000, f.dec_len, 4)
    assert lengths == jw.dec_lengths(1000, 12, 4)
    rec = wavelet.waverec(coeffs, f, lengths)
    assert _rel(rec, jw.waverec(jcoeffs, jw.daubechies(6), lengths)) <= 1e-6
    assert _rel(rec, ecg) <= 1e-5  # perfect reconstruction (tests/test_dsp.py: 1e-5)
    # a pad longer than the signal takes the index path of the extension
    short = torch.arange(5, dtype=torch.float32)[None]
    np.testing.assert_array_equal(wavelet._symmetric_extend(short, 11).numpy(),
                                  np.asarray(jw._symmetric_extend(jnp.asarray(short.numpy()), 11)))


def test_operators_match_jax():
    """The scipy-built filter and resample matrices equal the JAX package's
    bit for bit (the same scipy calls, rounded to float32 once); the
    wavelet matrices, built in float64 here and in float32 there, within
    3e-7 (measured 1.8e-7); the folded pipeline operators within 1e-6 of
    their largest entry (measured 9.9e-8)."""
    np.testing.assert_array_equal(dsp.filtfilt_operator(1000).numpy(),
                                  np.asarray(jdsp.filtfilt_operator(1000)))
    np.testing.assert_array_equal(dsp.resample_operator(1000, 500.0, 250.0).numpy(),
                                  np.asarray(jdsp.resample_operator(1000, 500.0, 250.0)))
    w_dec, w_rec, seg = wavelet.wavelet_operators(1000)
    jw_dec, jw_rec, jseg = jw.wavelet_operators(1000)
    assert seg == jseg == (72, 72, 134, 258, 505)
    assert np.abs(w_dec.numpy() - np.asarray(jw_dec)).max() <= 3e-7
    assert np.abs(w_rec.numpy() - np.asarray(jw_rec)).max() <= 3e-7
    dec, rec, seg = dsp.preprocess_operators(1000, 500.0, 250.0)
    jdec, jrec, _ = jdsp.preprocess_operators(1000, 500.0, 250.0)
    assert _rel(dec, jdec) <= 1e-6 and _rel(rec, jrec) <= 1e-6


@pytest.mark.parametrize("do_reorder", [False, True], ids=["ptb", "mimic-reorder"])
def test_preprocess_records_matches_jax(ecg, do_reorder):
    """The whole chain, NaN and inf inputs included, within 1e-5 of
    max|ref| (measured 1.7e-6): float32 products of nearly equal
    operators; the band that sets the threshold (cD4) has 72 values, an
    even length."""
    x = ecg.copy()
    x[0, 0, 10] = np.nan
    x[1, 3, 500] = np.inf
    got = dsp.preprocess_records(x, do_reorder=do_reorder, device="cpu")
    want = jdsp.preprocess_records(x, fs=500.0, target_fs=250.0, do_reorder=do_reorder)
    assert got.shape == (2, 12, 500) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("n", [321, 322, 72, 79, 1, 2])
def test_median_is_jnp_median_on_odd_and_even_lengths(n):
    """The threshold's median is jnp.median's (and numpy's) exactly: for an
    even length the mean of the two middle values, where torch.median
    returns the lower one."""
    rng = np.random.default_rng(n)
    x = np.abs(rng.normal(size=(3, n))).astype(np.float32)
    got = wavelet.median(torch.from_numpy(x)).numpy()[:, 0]
    np.testing.assert_array_equal(got, np.asarray(jnp.median(x, axis=-1)))
    np.testing.assert_array_equal(got, np.median(x, axis=-1))
    if n % 2 == 0:
        ramp = torch.arange(n, dtype=torch.float32)
        assert float(wavelet.median(ramp)[0]) == (n - 1) / 2 != float(torch.median(ramp))


@pytest.mark.parametrize("n", [1000, 1100], ids=["cD4-even-72", "cD4-odd-79"])
def test_wavelet_denoise_matches_jax(n):
    """The operator form of the denoise against the JAX package's on a
    random walk, with the threshold's band of even and odd length, within
    1e-5 of max|ref| (measured 7.2e-7); the conv path at the even length
    within 1e-5 (measured 2.4e-7; the JAX conv path compiles for seconds
    at each length); a zero signal stays zero."""
    seg = wavelet._segment_lengths(n, 4, 12)
    assert seg[1] % 2 == (0 if n == 1000 else 1)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, n)).astype(np.float32).cumsum(-1)
    t = torch.from_numpy(x)
    if n == 1000:
        assert _rel(wavelet.wavelet_denoise(t), jw.wavelet_denoise(x)) <= 1e-5
    assert _rel(wavelet.wavelet_denoise_fused(t), jw.wavelet_denoise_fused(x)) <= 1e-5
    z = torch.zeros(1, n)
    assert (wavelet.wavelet_denoise_fused(z) == 0).all() and (wavelet.wavelet_denoise(z) == 0).all()


def test_filter_and_resample_match_scipy(ecg):
    """tests/test_dsp.py's oracles: the filter chain within 2e-4 of
    max|ref| (measured 1.9e-6), the cubic resample within 2e-5 (measured
    3.0e-7), against float64 scipy."""
    x = ecg.astype(np.float64)
    want = x
    for f0 in (50, 60):
        b, a = sps.iirnotch(f0, 30.0, 500)
        want = sps.filtfilt(b, a, want, axis=-1)
    b, a = sps.butter(4, [0.5 / 250, 100.0 / 250], btype="band")
    want = sps.filtfilt(b, a, want, axis=-1)
    b, a = sps.butter(4, 0.05 / 250, btype="high")
    want = sps.filtfilt(b, a, want, axis=-1)
    assert _rel(dsp.advanced_ecg_filter(torch.from_numpy(ecg)), want) < 2e-4
    t = np.linspace(0, 2.0, 1000, endpoint=True)
    f = interpolate.interp1d(t, x, kind="cubic", axis=-1, bounds_error=False,
                             fill_value="extrapolate")
    want = f(np.linspace(0, 2.0, 500, endpoint=True))
    got = dsp.nsample_ecg(torch.from_numpy(ecg), 500.0, 250.0)
    assert got.shape == want.shape and _rel(got, want) < 2e-5


def test_segment_and_reorder_match_jax():
    x = np.arange(2 * 12 * 10, dtype=np.float32).reshape(2, 12, 10)
    np.testing.assert_array_equal(dsp.segment_ecg(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jdsp.segment_ecg(x, 4)))
    np.testing.assert_array_equal(dsp.reorder_leads(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdsp.reorder_leads(x)))
    y = np.array([[np.nan, np.inf, -np.inf, 1.5]], np.float32)
    np.testing.assert_array_equal(dsp.check_nan_inf(torch.from_numpy(y)).numpy(),
                                  np.asarray(jdsp.check_nan_inf(y)))


def test_operator_cache_is_the_ports_own(tmp_path, monkeypatch):
    """The disk cache lies under the port's own directory, by default
    ``<tmp>/ecg_byte_tpu_torch_op_cache`` (never a file the JAX package
    built), or ``$ECG_BYTE_TORCH_OP_CACHE``; the device copy is kept per
    device."""
    import tempfile

    monkeypatch.delenv(dsp.CACHE_ENV, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    dsp._disk_cached("probe", (1,), lambda: np.zeros(3, np.float32))
    assert os.listdir(tmp_path) == ["ecg_byte_tpu_torch_op_cache"]
    monkeypatch.setenv(dsp.CACHE_ENV, str(tmp_path / "own"))
    op = dsp.resample_matrix(96, 500.0, 125.0)
    assert [f.split("_")[0] for f in os.listdir(tmp_path / "own")] == ["resample"]
    a = dsp.resample_operator(96, 500.0, 125.0, device="cpu")
    assert a is dsp.resample_operator(96, 500.0, 125.0, device=torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(), op)


_FLAGS = r"""
import sys, torch
from ecg_byte_tpu_torch.ops import dsp
m = torch.backends.cuda.matmul
if sys.argv[1] == "legacy":
    m.allow_tf32 = True
    with dsp.full_f32_matmul():
        assert m.allow_tf32 is False
    assert m.allow_tf32 is True
else:
    m.fp32_precision = "tf32"
    with dsp.full_f32_matmul():
        assert m.fp32_precision == "ieee"
    assert m.fp32_precision == "tf32"
print("ok")
"""


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_full_f32_matmul_sets_and_restores_the_tf32_flags(api):
    """Inside the block float32 products run in full float32 whichever API
    the process used to allow TF32; after it the process's setting is back
    (a fresh process for each API: torch refuses a process that mixes
    them)."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _FLAGS, api], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_array_input_runs_on_the_card_unless_the_cpu_is_named():
    x = np.zeros((1, 12, 300), np.float32)
    assert dsp.preprocess_records(x, device="cpu").device.type == "cpu"
    assert dsp.preprocess_records(torch.from_numpy(x)).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dsp.preprocess_records(x)
