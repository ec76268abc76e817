"""Weight-only int8 linear: the wrapper of the CUDA kernel in
``csrc/int8_linear.cu``, beside its plain PyTorch version.

The JAX package's int8 serving trees (``models/quantized.py``) multiply
``(x @ q.astype(bf16)) * scale`` and rely on XLA fusing the int8-to-bf16
conversion into the dot's operand read, so only int8 bytes cross HBM
(``ecg_byte_tpu/models/transformer.py`` ``_kernel_matmul`` and
``_unembed``).  It has no Pallas kernel.  Eager PyTorch has no such fusion:
``F.linear(x, q.to(bf16))`` writes a bf16 copy of the weight on every call
and moves more bytes than the bf16 model.  The kernel reads each int8
weight once, in 16-byte loads, and converts it in registers; scale and
bias are its epilogue, one launch per projection.

What bounds it on the H100: at decode (M = batch <= 16) the weight bytes,
half the bf16 model's; at prefill (M = B*S) the FLOPs, which this first
kernel runs on f32 FMAs rather than the tensor cores.

Rounding follows the JAX code: the dot accumulates in f32 and rounds to
the activation dtype, the per-output-channel scale multiplies the rounded
dot, and the bias is added after the scale.  The LM head takes
``out_dtype=torch.float32`` and returns those values in f32.

A CPU tensor takes :func:`int8_linear_plain`; a CUDA tensor launches the
kernel or raises.  ``int8_linear.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.ops import _cuda

CHUNK = 16  # the kernel reads K in 16-byte chunks of int8


def int8_linear_plain(x, q, scale, bias=None, out_dtype: Optional[torch.dtype] = None):
    """``F.linear(x, q.to(x.dtype)) * scale (+ bias)``, the plain version:
    it materializes the dequantized weight."""
    y = F.linear(x, q.to(x.dtype)) * scale
    if bias is not None:
        y = y + bias
    return y if out_dtype is None else y.to(out_dtype)


def _check(x, q, scale, bias):
    k = x.shape[-1]
    if q.dim() != 2 or q.shape[1] != k or q.dtype != torch.int8:
        raise ValueError(f"q must be int8 (N, {k}), got {q.dtype} {tuple(q.shape)}")
    n = q.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if k % CHUNK:
        raise ValueError(f"in-features {k} must be a multiple of {CHUNK}")
    named = [("x", x), ("q", q), ("scale", scale)] + ([("bias", bias)] if bias is not None else [])
    for name, t in named[2:]:
        if t.shape != (n,) or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 ({n},), got {t.dtype} {tuple(t.shape)}")
    for name, t in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:2]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def int8_linear(x, q, scale, bias=None, out_dtype: Optional[torch.dtype] = None):
    """``x`` (..., K) times the int8 weight ``q`` (N, K) with the bf16
    per-output-channel ``scale`` (N,) and optional ``bias`` (N,); returns
    (..., N) in x's dtype, or in ``out_dtype`` (the head's float32)."""
    if x.device.type == "cpu":
        return int8_linear_plain(x, q, scale, bias, out_dtype)
    x = x.contiguous()
    _check(x, q, scale, bias)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    k, n = x.shape[-1], q.shape[0]
    out = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    lib = _cuda.library()
    stream = _cuda.stream(x)
    err = lib.ecg_int8_linear(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        x.numel() // k, n, k, int(out_dtype == torch.float32), stream,
    )
    _cuda.check(err, "int8 linear")
    int8_linear.launches += 1
    return out


int8_linear.launches = 0
