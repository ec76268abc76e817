"""RMSNorm forward: a Triton kernel and its plain PyTorch version.

Replaces the Pallas forward kernel ``_fwd_kernel`` of
``ecg_byte_tpu/ops/rmsnorm.py`` (reached through ``_rmsnorm_fwd``).  The
JAX package gates that kernel behind an opt-in tuned for the TPU; the port
uses this one on every RMSNorm of its path (twice per layer, once before
the unembedding).

    y = (x_f32 * rsqrt(mean(x_f32^2) + eps) * w_f32).to(x.dtype)

What bounds it on the H100: bytes.  One row is read once and written once
(2 x 4 KB at d = 2048 in bf16) around a reduction and a few multiplies per
element, far below the card's ratio of operations to bytes.  The kernel
therefore keeps the whole row in registers, one program per row: one
read of x, the f32 statistics and products in registers, one write of y.
With a (1, 2048) decode row the launch, not the bytes, is the cost.

Gemma's ``1 + w`` stays with the caller, as in ``transformer._norm``; the
backward kernel comes with training.
"""

from __future__ import annotations

import functools
import os

import torch

from ecg_byte_tpu_torch.ops import _cuda


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The reference math of ``transformer._norm`` for RMSNorm archs."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _kernel():
    # Triton's compile cache goes beside the CUDA build, inside the package
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_cuda.BUILD_DIR, "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_fwd(x_ptr, w_ptr, y_ptr, d, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inb = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=inb, other=0.0).to(tl.float32)
        r = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / d + eps)
        w = tl.load(w_ptr + cols, mask=inb, other=0.0)
        y = x * r * w
        tl.store(y_ptr + row * d + cols, y.to(y_ptr.dtype.element_ty), mask=inb)

    return triton, rmsnorm_fwd


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., D) with f32 weight ``w``.

    A CPU tensor takes :func:`rmsnorm_plain`; a CUDA tensor launches the
    Triton kernel or raises.
    """
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"rmsnorm: unsupported dtype {x.dtype}")
    if w.dtype != torch.float32 or w.shape != (d,) or w.device != x.device:
        raise ValueError("rmsnorm: w must be a float32 (D,) tensor on x's device")
    if not w.is_contiguous():
        raise ValueError("rmsnorm: w must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError("rmsnorm: the kernel is forward only")
    triton, kernel = _kernel()
    y = torch.empty_like(x)
    rows = x.numel() // d
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, w, y, d, eps, BLOCK=block,
                        num_warps=min(max(block // 256, 1), 16))
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
