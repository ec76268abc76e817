"""Percentile min-max symbol quantizer (``ecg_byte_tpu/ops/quantize.py``).

``normalize_quantize`` and ``reverse_normalize`` work on torch tensors on
any device, in float32 as the JAX versions do; the string and byte helpers
render symbols on the host for the C++ BPE core and the tokenizer CLI.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHABET = "abcdefghijklmnopqrstuvwxyz"
NUM_SYMBOLS = len(ALPHABET)  # 26
_BYTE_A = ord("a")


def normalize_quantize(signal: torch.Tensor, p1: float, p99: float):
    """Quantize a signal into 26 symbol bins with the corpus 1st/99th
    percentiles.

    Returns ``(clipped_normalized, quantized)``: the float32 signal mapped
    into [0, 1], and uint8 symbol bins in [0, 25].  The bins are the same
    on every device: the divisor lives on the signal's device, because
    PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal,
    which moves values that lie on a bin edge to the next bin.
    """
    signal = torch.as_tensor(signal, dtype=torch.float32)
    lo = torch.tensor(p1, dtype=torch.float32, device=signal.device) - 0.5
    hi = torch.tensor(p99, dtype=torch.float32, device=signal.device) + 0.5
    normalized = (signal - lo) / (hi - lo + 1e-6)
    clipped = torch.clamp(normalized, 0.0, 1.0)
    quantized = torch.clamp(
        torch.floor(clipped * NUM_SYMBOLS), max=NUM_SYMBOLS - 1
    ).to(torch.uint8)
    return clipped, quantized


def reverse_normalize(quantized, p1: float, p99: float) -> torch.Tensor:
    """Symbol bins back into the percentile range: ``bin / 25`` (not
    ``/ 26``), as the reference's ``reverse_normalize_all``."""
    quantized = torch.as_tensor(quantized)
    dev = quantized.device
    lo = torch.tensor(p1, dtype=torch.float32, device=dev) - 0.5
    hi = torch.tensor(p99, dtype=torch.float32, device=dev) + 0.5
    clipped = quantized.to(torch.float32) / torch.tensor(NUM_SYMBOLS - 1.0, device=dev)
    return clipped * (hi - lo) + lo


def quantized_to_string(quantized) -> str:
    """Render uint8 symbol bins (0..25) as the a-z string, row-major, so a
    ``(12, L)`` ECG becomes 12 concatenated lead strings."""
    if isinstance(quantized, torch.Tensor):
        quantized = quantized.cpu().numpy()
    q = np.asarray(quantized, dtype=np.uint8).reshape(-1)
    return (q + _BYTE_A).tobytes().decode("ascii")


def string_to_quantized(text: str, shape=None) -> np.ndarray:
    """Inverse of :func:`quantized_to_string` (host-side)."""
    q = np.frombuffer(text.encode("ascii"), dtype=np.uint8) - _BYTE_A
    if shape is not None:
        q = q.reshape(shape)
    return q


def quantized_to_bytes(quantized) -> np.ndarray:
    """uint8 symbol bins 0..25 -> raw byte values 97..122 ('a'..'z')."""
    return np.asarray(quantized, dtype=np.uint8) + _BYTE_A


def bytes_to_quantized(b) -> np.ndarray:
    """Raw byte values 97..122 -> uint8 symbol bins 0..25."""
    return np.asarray(b, dtype=np.uint8) - _BYTE_A
