"""1-D ResNet over 12-lead ECG signals (the MERL backbone).

The port of ``ecg_byte_tpu/models/resnet1d.py``: BasicBlock / Bottleneck
residual blocks on Conv1d + BatchNorm1d, a stem conv (kernel 7, stride 2),
four stages at 64/128/256/512 channels, ResNet18/34/50/101/152 depths.
Parameters and the BatchNorm running statistics are two plain dicts of
tensors with the JAX package's names and layouts (conv weights
``(out, in, k)``, BN ``{"scale", "bias"}`` and state ``{"mean", "var"}``),
so ``models/convert.resnet_from_jax`` only copies values.

The BatchNorm is written out, not ``F.batch_norm``: the JAX package
updates the running variance with the biased batch variance, torch's
BatchNorm with the unbiased one.  The f32 convolutions run with TF32 off
(cuDNN turns it on by default), in the forward and in both products of
the backward (:func:`conv_f32`), so they compute the JAX package's f32
function and its gradients.  ``ECG_BYTE_RESNET_BF16=1`` (or
``compute_dtype=torch.bfloat16``) casts both conv operands to bf16 and the
output back to f32, as the JAX package does.

Under ``--dis`` (``rows``: a rank's rows of the global batch) training
BatchNorm takes its mean and biased variance over the global batch, as
the JAX package's GSPMD step does: two passes, each an all-reduce of the
per-channel sums with a gradient, so the running state and the gradients
are one process's on the global batch.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.ops.dsp import full_f32_matmul
from ecg_byte_tpu_torch.parallel import distributed
from ecg_byte_tpu_torch.parallel.distributed import Rows

Params = Dict[str, Any]

BN_MOMENTUM = 0.1
BN_EPS = 1e-5

_DEPTHS = {
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
    "resnet152": ([3, 8, 36, 3], True),
}


class _ConvF32(torch.autograd.Function):
    """A convolution whose forward and both backward products run with
    cuDNN's TF32 off.  The flag is read when a kernel launches, and
    autograd runs the backward after the forward's block has restored the
    process's setting, so the backward sets it again."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        ctx.save_for_backward(x, kernel)
        ctx.conv = (stride, padding)
        conv = F.conv1d if x.dim() == 3 else F.conv2d
        with full_f32_matmul("conv"):
            return conv(x, kernel, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        stride, padding = ctx.conv
        one_d = x.dim() == 3
        grad_input = torch.nn.grad.conv1d_input if one_d else torch.nn.grad.conv2d_input
        grad_weight = torch.nn.grad.conv1d_weight if one_d else torch.nn.grad.conv2d_weight
        dx = dk = None
        with full_f32_matmul("conv"):
            if ctx.needs_input_grad[0]:
                dx = grad_input(x.shape, kernel, g, stride=stride, padding=padding)
            if ctx.needs_input_grad[1]:
                dk = grad_weight(x, kernel.shape, g, stride=stride, padding=padding)
        return dx, dk, None, None


def conv_f32(x, kernel, stride=1, padding=0):
    """F.conv1d ((B, C, L) input) or F.conv2d ((B, C, H, W)) in full f32,
    forward and backward."""
    return _ConvF32.apply(x, kernel, stride, padding)


def conv1d(x, kernel, stride=1, padding=0, compute_dtype=None):
    """1-D conv over (B, C, L).  With ``compute_dtype=torch.bfloat16`` both
    operands are cast to bf16 and the result back to x's dtype; otherwise
    the conv runs in x's dtype with TF32 off (:func:`conv_f32`)."""
    if compute_dtype is not None:
        y = F.conv1d(x.to(compute_dtype), kernel.to(compute_dtype), stride=stride,
                     padding=padding)
        return y.to(x.dtype)
    return conv_f32(x, kernel, stride, padding)


def _batch_stats(x, rows: Optional[Rows]):
    """The mean and biased variance over (B, L) of the global batch whose
    ``rows`` ``x`` holds (None: ``x`` itself): two passes, each an
    all-reduce of the per-channel sums."""
    rows = rows if rows is not None else Rows.whole(x.shape[0])
    n = rows.total * x.shape[2]
    mean = distributed.all_reduce_sum(x.sum(dim=(0, 2))) / n
    sq = (x - mean[None, :, None]).square().sum(dim=(0, 2))
    return mean, distributed.all_reduce_sum(sq) / n


def batchnorm(x, p, s, train: bool, rows: Optional[Rows] = None):
    """BatchNorm1d over (B, C, L); returns (y, new_state).  In training the
    batch mean and biased variance normalize and update the state (detached:
    the state takes no gradient); with ``rows``, the global batch's."""
    if train:
        mean, var = _batch_stats(x, rows)
        new_s = {
            "mean": (1 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * mean.detach(),
            "var": (1 - BN_MOMENTUM) * s["var"] + BN_MOMENTUM * var.detach(),
        }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + BN_EPS)
    y = (x - mean[None, :, None]) * (inv * p["scale"])[None, :, None]
    return y + p["bias"][None, :, None], new_s


def _conv_init(gen, k, c_in, c_out, device):
    std = math.sqrt(2.0 / (k * c_in))
    return torch.randn(c_out, c_in, k, generator=gen, device=device) * std


def _bn_init(c, device):
    return ({"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)})


def _init_block(gen, c_in, c_out, stride, bottleneck, device):
    if bottleneck:
        p = {"conv1": _conv_init(gen, 1, c_in, c_out, device),
             "conv2": _conv_init(gen, 3, c_out, c_out, device),
             "conv3": _conv_init(gen, 1, c_out, 4 * c_out, device)}
        chans = {"bn1": c_out, "bn2": c_out, "bn3": 4 * c_out}
        out_ch = 4 * c_out
    else:
        p = {"conv1": _conv_init(gen, 3, c_in, c_out, device),
             "conv2": _conv_init(gen, 3, c_out, c_out, device)}
        chans = {"bn1": c_out, "bn2": c_out}
        out_ch = c_out
    s = {}
    for name, c in chans.items():
        p[name], s[name] = _bn_init(c, device)
    if stride != 1 or c_in != out_ch:
        p["shortcut_conv"] = _conv_init(gen, 1, c_in, out_ch, device)
        p["shortcut_bn"], s["shortcut_bn"] = _bn_init(out_ch, device)
    return p, s, out_ch


def init_resnet(generator: torch.Generator, variant: str = "resnet101", in_channels: int = 12,
                device=None):
    """(params, state, meta) on ``device`` (default the generator's); output
    channels 512 * expansion (``meta["out_channels"]``)."""
    device = generator.device if device is None else device
    depths, bottleneck = _DEPTHS[variant]
    params: Params = {"stem_conv": _conv_init(generator, 7, in_channels, 64, device)}
    state: Params = {}
    params["stem_bn"], state["stem_bn"] = _bn_init(64, device)
    meta = {"variant": variant, "strides": [], "bottleneck": bottleneck}
    c_in = 64
    for stage, (n_blocks, c_out, stride0) in enumerate(
            zip(depths, [64, 128, 256, 512], [1, 2, 2, 2])):
        for b in range(n_blocks):
            stride = stride0 if b == 0 else 1
            name = f"s{stage}b{b}"
            params[name], state[name], c_in = _init_block(generator, c_in, c_out, stride,
                                                          bottleneck, device)
            meta["strides"].append((name, stride))
    meta["out_channels"] = c_in
    return params, state, meta


def _block_forward(x, p, s, stride, bottleneck, train, cd, rows):
    new_s = {}

    def bn(out, name):
        out, new_s[name] = batchnorm(out, p[name], s[name], train, rows)
        return out

    if bottleneck:
        out = F.relu(bn(conv1d(x, p["conv1"], compute_dtype=cd), "bn1"))
        out = F.relu(bn(conv1d(out, p["conv2"], stride=stride, padding=1, compute_dtype=cd),
                        "bn2"))
        out = bn(conv1d(out, p["conv3"], compute_dtype=cd), "bn3")
    else:
        out = F.relu(bn(conv1d(x, p["conv1"], stride=stride, padding=1, compute_dtype=cd),
                        "bn1"))
        out = bn(conv1d(out, p["conv2"], padding=1, compute_dtype=cd), "bn2")
    if "shortcut_conv" in p:
        sc = bn(conv1d(x, p["shortcut_conv"], stride=stride, compute_dtype=cd), "shortcut_bn")
    else:
        sc = x
    return F.relu(out + sc), new_s


def resnet_forward(params, state, meta, x, train: bool = False,
                   compute_dtype: Optional[torch.dtype] = None, rows: Optional[Rows] = None):
    """x: (B, 12, L) f32 -> features (B, C_out, L'); returns (y, new_state).
    ``compute_dtype=torch.bfloat16`` casts every conv's operands to bf16;
    ``ECG_BYTE_RESNET_BF16=1`` turns it on when the caller leaves it None.
    ``rows``: the rows of a global batch ``x`` holds (``--dis``), whose
    statistics training BatchNorm takes."""
    if compute_dtype is None and os.environ.get("ECG_BYTE_RESNET_BF16") == "1":
        compute_dtype = torch.bfloat16
    new_state = {}
    out = conv1d(x, params["stem_conv"], stride=2, padding=3, compute_dtype=compute_dtype)
    out, new_state["stem_bn"] = batchnorm(out, params["stem_bn"], state["stem_bn"], train, rows)
    out = F.relu(out)
    for name, stride in meta["strides"]:
        out, new_state[name] = _block_forward(out, params[name], state[name], stride,
                                              meta["bottleneck"], train, compute_dtype, rows)
    return out, new_state
