"""Noam LR schedule and the optimizer chain of ``ecg_byte_tpu/train/scheduler.py``.

The JAX chain is clip(global norm 1.0) -> L2 weight decay added to the
gradient -> Adam moments (beta 0.9, 0.99, eps 1e-8) -> Noam LR.  Here:
:func:`clip_by_global_norm_` on the gradients, then ``torch.optim.Adam``
with ``weight_decay`` (which adds the decay to the clipped gradient before
the moments, as ``add_decayed_weights`` ahead of ``scale_by_adam`` does) at
base lr 1.0 under ``LambdaLR(noam_schedule)``.

The clip is optax's, not ``torch.nn.utils.clip_grad_norm_``: that one
divides by ``norm + 1e-6`` and scales every gradient even below the limit;
optax leaves gradients below the limit as they are and otherwise computes
``g / norm * max_norm``.  The norm is taken in f32 on the device and the
choice made there with ``torch.where``, so the step needs no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch


def noam_schedule(d_model: int, warmup_steps: int) -> Callable[[int], float]:
    """lr(step) for a 0-based step count (the reference counts from 1):
    d_model^-0.5 * min(s^-0.5, warmup^-1.5 * s) with s = step + 1."""
    init_lr = float(d_model) ** -0.5
    warmup = float(warmup_steps)

    def schedule(step: int) -> float:
        s = step + 1.0
        return init_lr * min(s**-0.5, warmup**-1.5 * s)

    return schedule


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to global norm ``max_norm`` if it is above;
    returns the norm (a device scalar)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])
    )
    below = norm < max_norm
    div = torch.where(below, 1.0, norm)
    mul = torch.where(below, 1.0, torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    return norm


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """The optimizer's hyperparameters; :meth:`build` makes the torch
    optimizer and LR scheduler for a list of trainable tensors."""

    d_model: int
    warmup_steps: int
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    weight_decay: float = 1e-2
    clip_norm: float = 1.0

    def build(self, params: Sequence[torch.Tensor]):
        opt = torch.optim.Adam(
            list(params), lr=1.0, betas=(self.beta1, self.beta2), eps=self.eps,
            weight_decay=self.weight_decay,
        )
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, noam_schedule(self.d_model, self.warmup_steps)
        )
        return opt, sched


def make_optimizer(d_model: int, warmup_steps: int, *, beta1: float = 0.9,
                   beta2: float = 0.99, eps: float = 1e-8, weight_decay: float = 1e-2,
                   clip_norm: float = 1.0) -> OptimizerSpec:
    """clip(1.0) -> L2 weight decay -> Adam -> Noam LR, with the JAX defaults."""
    return OptimizerSpec(d_model, warmup_steps, beta1, beta2, eps, weight_decay, clip_norm)
