"""Percentile min-max symbol quantizer (``ecg_byte_tpu/ops/quantize.py``).

``normalize_quantize`` works on torch tensors on any device, in float32 as
the JAX version does; ``quantized_to_string`` renders the symbols on the
host for the C++ BPE encoder.
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
    into [0, 1], and uint8 symbol bins in [0, 25].
    """
    signal = torch.as_tensor(signal, dtype=torch.float32)
    lo = torch.tensor(p1, dtype=torch.float32) - 0.5
    hi = torch.tensor(p99, dtype=torch.float32) + 0.5
    normalized = (signal - lo) / (hi - lo + 1e-6)
    clipped = torch.clamp(normalized, 0.0, 1.0)
    quantized = torch.clamp(
        torch.floor(clipped * NUM_SYMBOLS), max=NUM_SYMBOLS - 1
    ).to(torch.uint8)
    return clipped, quantized


def quantized_to_string(quantized) -> str:
    """Render uint8 symbol bins (0..25) as the a-z string, row-major, so a
    ``(12, L)`` ECG becomes 12 concatenated lead strings."""
    if isinstance(quantized, torch.Tensor):
        quantized = quantized.cpu().numpy()
    q = np.asarray(quantized, dtype=np.uint8).reshape(-1)
    return (q + _BYTE_A).tobytes().decode("ascii")
