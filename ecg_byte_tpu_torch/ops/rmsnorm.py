"""RMSNorm forward and backward: the CUDA kernels of ``csrc/rmsnorm.cu``,
their plain PyTorch versions, and :class:`RMSNorm`, the autograd function
that joins them.

Replaces the Pallas kernels of ``ecg_byte_tpu/ops/rmsnorm.py``: the forward
``_fwd_kernel`` (reached through ``_rmsnorm_fwd``) and the backward
``_bwd_kernel`` (reached through ``_rmsnorm_bwd``).  The JAX package gates
them behind an opt-in tuned for the TPU; the port uses them on every
RMSNorm of its path (twice per layer, once before the unembedding).

    y  = (x_f32 * r * w_f32).to(x.dtype),   r = rsqrt(mean(x_f32^2) + eps)
    dx = r * (g*w - x * r^2 * mean(g*w*x))  per row, in x's dtype
    dw = sum over rows of g * x * r         summed in f32, in w's dtype

On the card x is bf16, as every kernel of the port takes it, and w bf16
or f32: the kernels convert w in registers, so a model's stored bf16 norm
weight goes in as it is.  The width D must be a multiple of 8 (16-byte
vectors) up to ``MAX_WIDTH``.

What bounds it on the H100: bytes, and for the (1, 2048) decode row the
launch.  One block per row holds the row in registers between its one
read and its one write; the backward without dw (the frozen norms of LoRA
training) is the same shape.  With dw, blocks walk contiguous runs of rows
and a second kernel, launched by the same C call, sums their f32 partials
in a fixed order.  The wrappers launch through ``ctypes`` on ``_cuda.stream``, the
raw-stream path of every kernel of the port: eager decode is bound by the
host's launches.

Gemma's ``1 + w`` stays with the caller, as in ``transformer._norm``; its
gradient flows through that sum by autograd.
"""

from __future__ import annotations

import torch

from ecg_byte_tpu_torch.ops import _cuda

# a row is at most 2,048 vectors of 8 values: 256 threads of 8 vectors
# each (csrc/rmsnorm.cu)
MAX_WIDTH = 2048 * 8
# blocks per SM of the backward with dw, each with its partial row of dw
DW_BLOCKS_PER_SM = 4


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The reference math of ``transformer._norm`` for RMSNorm archs, in f32
    (f64 for f64 inputs)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(ct)).to(x.dtype)


def rmsnorm_bwd_plain(x, w, g, eps: float, need_dw: bool = True):
    """The backward kernel's math in plain PyTorch: returns (dx, dw or None)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, gf = x.to(ct), g.to(ct)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    gw = gf * w.to(ct)
    dot = (gw * xf).mean(-1, keepdim=True)
    dx = (r * (gw - xf * (r * r * dot))).to(x.dtype)
    if not need_dw:
        return dx, None
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx, dw.to(w.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    """Raise on what the kernels do not take, the device last, so that a
    test can reach the other checks on a ``meta`` tensor."""
    if x.dtype != torch.bfloat16 or w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: x must be bfloat16 and w bfloat16 or float32, got "
                         f"{x.dtype}, {w.dtype}")
    d = x.shape[-1]
    if d % 8 or d > MAX_WIDTH:
        raise ValueError(f"{what}: width {d} is not a multiple of 8 up to {MAX_WIDTH}")
    if x.numel() == 0:
        raise ValueError(f"{what}: x has no rows")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"{what}: x and w must be contiguous")
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"{what}: w must be a (D,) tensor on x's device")
    if not x.is_cuda:
        raise ValueError(f"{what}: unsupported device {x.device}")
    if (x.data_ptr() | w.data_ptr()) % 16:
        raise ValueError(f"{what}: x and w must be 16-byte aligned")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., D) with the weight ``w``
    (D,), forward only (differentiable callers go through
    :class:`RMSNorm`).

    A CPU tensor takes :func:`rmsnorm_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    if x.is_cpu:
        return rmsnorm_plain(x, w, eps)
    _check(x, w, "rmsnorm")
    d = x.shape[-1]
    y = torch.empty_like(x)
    err = _cuda.library().ecg_rmsnorm(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // d, d, w.dtype == torch.float32,
        eps, _cuda.stream(x))
    _cuda.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float,
                need_dw: bool = True):
    """Gradients (dx, dw) of :func:`rmsnorm` for the output gradient ``g``;
    dw, in w's dtype, is None unless ``need_dw``.

    A CPU tensor takes :func:`rmsnorm_bwd_plain`; a CUDA tensor launches the
    kernels or raises.
    """
    if x.is_cpu:
        return rmsnorm_bwd_plain(x, w, g, eps, need_dw)
    _check(x, w, "rmsnorm_bwd")
    if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous() or g.data_ptr() % 16):
        raise ValueError("rmsnorm_bwd: g must be a contiguous, 16-byte aligned tensor like x")
    d = x.shape[-1]
    n = x.numel() // d
    dx = torch.empty_like(x)
    part = dw = None
    parts = 0
    if need_dw:  # one f32 partial row of dw per block
        parts = min(n, DW_BLOCKS_PER_SM * _cuda.sm_count(x.device.index))
        part = torch.empty((parts, d), dtype=torch.float32, device=x.device)
        dw = torch.empty_like(w)
    err = _cuda.library().ecg_rmsnorm_bwd(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
        None if part is None else part.data_ptr(), None if dw is None else dw.data_ptr(), n, d,
        w.dtype == torch.float32, parts, eps, _cuda.stream(x))
    _cuda.check(err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0


class RMSNorm(torch.autograd.Function):
    """Differentiable RMSNorm (``rmsnorm`` with its ``jax.custom_vjp``):
    saves x and w, recomputes the row statistics in the backward.  The
    wrappers are looked up when called, so a test can swap in their plain
    versions."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g.contiguous(), ctx.eps, ctx.needs_input_grad[1])
        return dx, dw, None
