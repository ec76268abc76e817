"""RMSNorm forward and backward: Triton kernels, their plain PyTorch
versions, and :class:`RMSNorm`, the autograd function that joins them.

Replaces the Pallas kernels of ``ecg_byte_tpu/ops/rmsnorm.py``: the forward
``_fwd_kernel`` (reached through ``_rmsnorm_fwd``) and the backward
``_bwd_kernel`` (reached through ``_rmsnorm_bwd``).  The JAX package gates
them behind an opt-in tuned for the TPU; the port uses them on every
RMSNorm of its path (twice per layer, once before the unembedding).

    y  = (x_f32 * r * w_f32).to(x.dtype),   r = rsqrt(mean(x_f32^2) + eps)
    dx = r * (g*w - x * r^2 * mean(g*w*x))  per row, in x's dtype
    dw = sum over rows of g * x * r         f32

What bounds it on the H100: bytes.  One row is read once and written once
(2 x 4 KB at d = 2048 in bf16) around a reduction and a few multiplies per
element, far below the card's ratio of operations to bytes.  The kernel
therefore keeps the whole row in registers, one program per row: one
read of x, the f32 statistics and products in registers, one write of y.
With a (1, 2048) decode row the launch, not the bytes, is the cost.

The backward is bound by bytes too: it reads x and g and writes dx, one
pass, with two row reductions (r and mean(g*w*x)) in f32 registers.  One
program takes a block of rows and keeps its f32 partial sum of dw in
registers; a second small kernel sums the partials, as the TPU kernel sums
dw in its own body over its sequential grid.  Where the weight is frozen
(LoRA training) dw is not computed at all.

Gemma's ``1 + w`` stays with the caller, as in ``transformer._norm``; its
gradient flows through that sum by autograd.
"""

from __future__ import annotations

import functools
import os

import torch

from ecg_byte_tpu_torch.ops import _cuda


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


@functools.lru_cache(maxsize=1)
def _kernels():
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

    @triton.jit
    def rmsnorm_bwd(x_ptr, w_ptr, g_ptr, dx_ptr, dw_part_ptr, n_rows, d, eps, rows_per_prog,
                    BLOCK: tl.constexpr, HAS_DW: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inb = cols < d
        w = tl.load(w_ptr + cols, mask=inb, other=0.0)
        dw = tl.zeros([BLOCK], dtype=tl.float32)
        for i in range(rows_per_prog):
            row = pid * rows_per_prog + i
            ok = inb & (row < n_rows)
            x = tl.load(x_ptr + row * d + cols, mask=ok, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + row * d + cols, mask=ok, other=0.0).to(tl.float32)
            r = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / d + eps)
            gw = g * w
            dot = tl.sum(gw * x, axis=0) / d
            dx = r * (gw - x * (r * r * dot))
            tl.store(dx_ptr + row * d + cols, dx.to(dx_ptr.dtype.element_ty), mask=ok)
            if HAS_DW:
                dw += g * x * r
        if HAS_DW:
            tl.store(dw_part_ptr + pid * d + cols, dw, mask=inb)

    @triton.jit
    def sum_partials(part_ptr, out_ptr, n_parts, d, BLOCK: tl.constexpr):
        cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        inb = cols < d
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for i in range(n_parts):
            acc += tl.load(part_ptr + i * d + cols, mask=inb, other=0.0)
        tl.store(out_ptr + cols, acc, mask=inb)

    return triton, rmsnorm_fwd, rmsnorm_bwd, sum_partials


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    d = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    if w.dtype != torch.float32 or w.shape != (d,) or w.device != x.device:
        raise ValueError(f"{what}: w must be a float32 (D,) tensor on x's device")
    if not w.is_contiguous():
        raise ValueError(f"{what}: w must be contiguous")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., D) with f32 weight ``w``,
    forward only (differentiable callers go through :class:`RMSNorm`).

    A CPU tensor takes :func:`rmsnorm_plain`; a CUDA tensor launches the
    Triton kernel or raises.
    """
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    _check(x, w, "rmsnorm")
    triton, kernel, _, _ = _kernels()
    d = x.shape[-1]
    y = torch.empty_like(x)
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(x.numel() // d,)](x, w, y, d, eps, BLOCK=block,
                                  num_warps=min(max(block // 256, 1), 16))
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float,
                need_dw: bool = True):
    """Gradients (dx, dw) of :func:`rmsnorm` for the output gradient ``g``;
    dw is None unless ``need_dw``.

    A CPU tensor takes :func:`rmsnorm_bwd_plain`; a CUDA tensor launches the
    Triton kernels or raises.
    """
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, w, g, eps, need_dw)
    _check(x, w, "rmsnorm_bwd")
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError("rmsnorm_bwd: g must be a contiguous tensor like x")
    triton, _, kernel, sum_partials = _kernels()
    d = x.shape[-1]
    n = x.numel() // d
    block = triton.next_power_of_2(d)
    # about two programs per SM, each walking its rows; each program's dw
    # partial is one f32 row of the partials
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows_per_prog = max(1, -(-n // (2 * sms)))
    progs = -(-n // rows_per_prog)
    dx = torch.empty_like(x)
    part = torch.empty((progs, d) if need_dw else (1,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        kernel[(progs,)](x, w, g, dx, part, n, d, eps, rows_per_prog, BLOCK=block,
                         HAS_DW=need_dw, num_warps=min(max(block // 256, 1), 16))
        dw = None
        if need_dw:
            dw = torch.empty(d, dtype=torch.float32, device=x.device)
            sum_partials[(triton.cdiv(d, 256),)](part, dw, progs, d, BLOCK=256, num_warps=2)
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
