"""WFDB record reader (header + signal, formats 16/212/80/32): the port's
copy of ``ecg_byte_tpu/data/wfdb_io.py``, numpy only.

Replaces the reference's ``wfdb.rdsamp`` (preprocess_utils.py:127,506,513)
for the formats PhysioNet's ECG exports use: MIMIC-IV-ECG and PTB-XL
``*_hr`` records are format 16; legacy PhysioBank records are 212/80/32.

Returns ``(signal, fields)`` with the wfdb-python contract: ``signal`` is
float64 ``(sig_len, n_sig)`` in physical units ``(adc - baseline) / gain``,
``fields`` carries ``fs``, ``sig_len``, ``n_sig``, ``sig_name``, ``units``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np

_DEFAULT_GAIN = 200.0


class _SignalSpec:
    __slots__ = (
        "file_name", "fmt", "gain", "baseline", "adc_zero", "sig_name", "units"
    )

    def __init__(self, file_name, fmt, gain, baseline, adc_zero, sig_name, units):
        self.file_name = file_name
        self.fmt = fmt
        self.gain = gain
        self.baseline = baseline
        self.adc_zero = adc_zero
        self.sig_name = sig_name
        self.units = units


def _parse_gain_spec(spec: str) -> Tuple[float, float, str]:
    """'gain(baseline)/units' with every part optional (WFDB header(5))."""
    units = "mV"
    if "/" in spec:
        spec, units = spec.split("/", 1)
    baseline = None
    m = re.match(r"^([-+0-9.eE]*)(?:\(([-+0-9]+)\))?$", spec)
    gain_s, baseline_s = (m.group(1), m.group(2)) if m else ("", None)
    gain = float(gain_s) if gain_s else 0.0
    if gain == 0.0:
        gain = _DEFAULT_GAIN
    if baseline_s is not None:
        baseline = float(baseline_s)
    return gain, baseline, units


def read_header(header_path: str):
    """Parse a .hea file -> (record_name, n_sig, fs, sig_len, [specs])."""
    with open(header_path) as f:
        lines = [
            ln.strip()
            for ln in f
            if ln.strip() and not ln.startswith("#")
        ]
    rec = lines[0].split()
    record_name = rec[0].split("/")[0]
    n_sig = int(rec[1])
    fs = float(rec[2]) if len(rec) > 2 else 250.0
    sig_len = int(rec[3]) if len(rec) > 3 else 0

    specs: List[_SignalSpec] = []
    for ln in lines[1 : 1 + n_sig]:
        parts = ln.split()
        file_name = parts[0]
        fmt = parts[1] if len(parts) > 1 else "16"
        if any(c in fmt for c in "x:+"):
            # samples-per-frame / skew / byte-offset modifiers change the
            # .dat interleaving; decoding as spf=1 would silently misread
            # multi-frequency records (WFDB header(5) format field).
            raise NotImplementedError(
                f"WFDB format modifier in {fmt!r} (samples-per-frame/skew/"
                "offset) is not supported"
            )
        gain, baseline, units = _parse_gain_spec(parts[2]) if len(parts) > 2 else (
            _DEFAULT_GAIN, None, "mV"
        )
        adc_zero = float(parts[4]) if len(parts) > 4 else 0.0
        if baseline is None:
            baseline = adc_zero
        sig_name = parts[8] if len(parts) > 8 else f"sig{len(specs)}"
        specs.append(
            _SignalSpec(file_name, fmt, gain, baseline, adc_zero, sig_name, units)
        )
    return record_name, n_sig, fs, sig_len, specs


def _decode_fmt16(raw: bytes, n_sig: int) -> np.ndarray:
    a = np.frombuffer(raw, dtype="<i2")
    return a[: (a.size // n_sig) * n_sig].reshape(-1, n_sig).astype(np.int32)


def _decode_fmt32(raw: bytes, n_sig: int) -> np.ndarray:
    a = np.frombuffer(raw, dtype="<i4")
    return a[: (a.size // n_sig) * n_sig].reshape(-1, n_sig).astype(np.int32)


def _decode_fmt80(raw: bytes, n_sig: int) -> np.ndarray:
    a = np.frombuffer(raw, dtype=np.uint8).astype(np.int32) - 128
    return a[: (a.size // n_sig) * n_sig].reshape(-1, n_sig)


def _decode_fmt212(raw: bytes, n_sig: int) -> np.ndarray:
    """12-bit packed pairs: 3 bytes hold samples s0, s1 (WFDB signal(5))."""
    b = np.frombuffer(raw, dtype=np.uint8)
    b = b[: (b.size // 3) * 3].reshape(-1, 3).astype(np.int32)
    s0 = ((b[:, 1] & 0x0F) << 8) | b[:, 0]
    s1 = ((b[:, 1] & 0xF0) << 4) | b[:, 2]
    flat = np.empty(2 * b.shape[0], np.int32)
    flat[0::2] = s0
    flat[1::2] = s1
    flat = np.where(flat >= 2048, flat - 4096, flat)  # sign-extend 12 bits
    return flat[: (flat.size // n_sig) * n_sig].reshape(-1, n_sig)


_DECODERS = {
    "16": _decode_fmt16,
    "32": _decode_fmt32,
    "80": _decode_fmt80,
    "212": _decode_fmt212,
}


def rdsamp(record_path: str) -> Tuple[np.ndarray, Dict]:
    """Read a WFDB record (path without extension) like ``wfdb.rdsamp``."""
    _name, n_sig, fs, sig_len, specs = read_header(record_path + ".hea")
    base_dir = os.path.dirname(record_path)

    fmts = {s.fmt for s in specs}
    files = {s.file_name for s in specs}
    if len(files) != 1:
        raise NotImplementedError(
            f"multi-file records unsupported (files: {sorted(files)})"
        )
    if len(fmts) != 1:
        raise NotImplementedError(f"mixed-format records unsupported: {sorted(fmts)}")
    fmt = fmts.pop()
    if fmt not in _DECODERS:
        raise NotImplementedError(
            f"WFDB format {fmt!r} not supported (have {sorted(_DECODERS)})"
        )

    dat_path = os.path.join(base_dir, specs[0].file_name)
    with open(dat_path, "rb") as f:
        raw = f.read()
    adc = _DECODERS[fmt](raw, n_sig)
    if sig_len:
        adc = adc[:sig_len]

    gains = np.array([s.gain for s in specs], np.float64)
    baselines = np.array([s.baseline for s in specs], np.float64)
    signal = (adc.astype(np.float64) - baselines[None, :]) / gains[None, :]

    fields = {
        "fs": int(fs) if float(fs).is_integer() else fs,
        "sig_len": adc.shape[0],
        "n_sig": n_sig,
        "sig_name": [s.sig_name for s in specs],
        "units": [s.units for s in specs],
    }
    return signal, fields
