"""Weight-only int8 linear: the wrapper of the CUDA kernels in
``csrc/int8_linear.cu`` and ``csrc/int8_linear_tc.cu``, beside their plain
PyTorch version.

The JAX package's int8 serving trees (``models/quantized.py``) multiply
``(x @ q.astype(bf16)) * scale`` and rely on XLA fusing the int8-to-bf16
conversion into the dot's operand read, so only int8 bytes cross HBM
(``ecg_byte_tpu/models/transformer.py`` ``_kernel_matmul`` and
``_unembed``).  It has no Pallas kernel.  Eager PyTorch has no such fusion:
``F.linear(x, q.to(bf16))`` writes a bf16 copy of the weight on every call
and moves more bytes than the bf16 model.  The kernels read each int8
weight from HBM once and convert it in registers; scale and bias are their
epilogue, one launch per projection.

What bounds it on the H100: at decode (M = batch rows, up to GEMV_MAX_M)
the weight bytes, half the bf16 model's, so ``csrc/int8_linear.cu`` gives
each output row a warp that streams it once (the GEMV kernel); at prefill
(M = B*S) the operations, so ``csrc/int8_linear_tc.cu`` runs the dot on the
tensor cores (wgmma, the int8 weight converted exactly to bf16 in
registers as the products' A operand) in tiles of weight rows x tokens.
:func:`choose_path` picks the kernel by M and :func:`choose_tile` the tile
by the shape; both run here on the CPU too, and a caller may force the
kernel (``path=``).  GEMV_MAX_M is where the two kernels cross on an H100
(PERF.md).

Rounding follows the JAX code: the dot accumulates in f32 and rounds to
the activation dtype, the per-output-channel scale multiplies the rounded
dot, and the bias is added after the scale.  The LM head takes
``out_dtype=torch.float32`` and returns those values in f32.

A CPU tensor takes :func:`int8_linear_plain`; a CUDA tensor launches a
kernel or raises.  ``int8_linear.launches`` counts the GEMV kernel's
launches, ``int8_linear.tc_launches`` the tensor-core kernel's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.ops import _cuda

CHUNK = 16  # the kernels read K in 16-byte chunks of int8
GEMV_MAX_M = 5  # M up to this takes the GEMV kernel, above it the tensor cores
# the tensor-core kernel's output tiles (weight rows, tokens), the order of
# its C entry point's ``tile`` argument: two warpgroups, then one
TC_TILES = ((128, 144), (128, 128), (64, 64))


def choose_path(m: int) -> str:
    """``"gemv"`` for M <= GEMV_MAX_M (decode: the weight bytes bound it),
    else ``"tc"`` (prefill: the tensor cores)."""
    return "gemv" if m <= GEMV_MAX_M else "tc"


def choose_tile(m: int, n: int, sm_count: int) -> int:
    """The index in TC_TILES of the tile for an (m, n) output: the
    two-warpgroup tile with the least work on the busiest SM (blocks per
    SM, rounded up, times the tile's area; the smaller tile on a tie), or,
    when that leaves more than half the ``sm_count`` SMs idle, the
    one-warpgroup 64 x 64 tile."""

    def blocks(i):
        bw, bt = TC_TILES[i]
        return -(-n // bw) * -(-m // bt)

    i = min((0, 1), key=lambda i: (-(-blocks(i) // sm_count) * TC_TILES[i][0]
                                   * TC_TILES[i][1], TC_TILES[i][1]))
    return i if 2 * blocks(i) >= sm_count else 2


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


def int8_linear(x, q, scale, bias=None, out_dtype: Optional[torch.dtype] = None,
                path: Optional[str] = None):
    """``x`` (..., K) times the int8 weight ``q`` (N, K) with the bf16
    per-output-channel ``scale`` (N,) and optional ``bias`` (N,); returns
    (..., N) in x's dtype, or in ``out_dtype`` (the head's float32).
    ``path`` (``"gemv"`` or ``"tc"``) overrides :func:`choose_path`."""
    if x.device.type == "cpu":
        return int8_linear_plain(x, q, scale, bias, out_dtype)
    x = x.contiguous()
    _check(x, q, scale, bias)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    k, n = x.shape[-1], q.shape[0]
    m = x.numel() // k
    path = path or choose_path(m)
    out = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    lib = _cuda.library()
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            m, n, k, int(out_dtype == torch.float32))
    if path == "gemv":
        _cuda.check(lib.ecg_int8_linear(*args, _cuda.stream(x)), "int8 linear")
        int8_linear.launches += 1
    elif path == "tc":
        tile = choose_tile(m, n, _cuda.sm_count(x.device.index))
        _cuda.check(lib.ecg_int8_linear_tc(*args, tile, _cuda.stream(x)), "int8 linear (tc)")
        int8_linear.tc_launches += 1
    else:
        raise ValueError(f"path must be 'gemv' or 'tc', got {path!r}")
    return out


int8_linear.launches = 0
int8_linear.tc_launches = 0
