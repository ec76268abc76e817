"""Pillow's bicubic resize of an 8-bit image, in numpy, without Pillow.

The two-stage datasets turn an ECG into an 8-bit image and resize it with
``PIL.Image.resize(..., BICUBIC)``; the card's machine has no Pillow.  This
is Pillow's own algorithm (``libImaging/Resample.c``), so the result is
equal to Pillow's byte for byte:

- two separable passes, horizontal first, each rounded into a uint8 image;
- per output pixel, the cubic kernel (a = -0.5) at taps around its centre,
  the support widened by the scale when downscaling, the weights
  normalized to sum 1 in float64;
- the weights as fixed-point integers of 22 fractional bits
  (``int(w * 2**22 +- 0.5)``), the sum of pixel x weight in integers from
  half of one, shifted back and clipped to [0, 255].

Every output pixel depends only on its own taps, so ``out_cols`` computes
a window of the output columns alone (a center crop of a very wide resize
needs no other column).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0  # the bicubic filter's


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def coefficients(in_size: int, out_size: int):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the box
    [0, in_size): (xmin (out,), xmax (out,), fixed-point weights (out,
    ksize) int64 with zeros past each pixel's xmax taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # the C loop's order of additions
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << PRECISION_BITS)).astype(np.int64)
    return xmin, xmax, fixed


def _pass(img: np.ndarray, xmin, fixed) -> np.ndarray:
    """One pass along the last axis of a uint8 (rows, in) image."""
    idx = np.minimum(xmin[:, None] + np.arange(fixed.shape[1])[None, :], img.shape[-1] - 1)
    acc = (img[:, idx].astype(np.int64) * fixed[None]).sum(-1) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, width: int, height: int,
                   out_cols: Optional[slice] = None) -> np.ndarray:
    """A uint8 (H, W) image resized to (height, width) as Pillow's BICUBIC
    resize does; ``out_cols`` keeps only that window of output columns."""
    h, w = img.shape
    cols = range(width)[out_cols or slice(None)]
    out = img
    if width != w:  # horizontal pass first, into uint8
        xmin, _, fixed = coefficients(w, width)
        out = _pass(img, xmin[cols.start:cols.stop], fixed[cols.start:cols.stop])
    elif out_cols is not None:
        out = img[:, cols.start:cols.stop]
    if height != h:
        ymin, _, fixed = coefficients(h, height)
        out = _pass(np.ascontiguousarray(out.T), ymin, fixed).T
    return np.ascontiguousarray(out)
