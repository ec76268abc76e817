"""Train and eval steps: the port of ``ecg_byte_tpu/train/step.py``.

One step is the reference's forward, backward, clip and Noam-scheduled Adam
update: gradients over the trainable tree (LoRA adapters under ``peft``,
every parameter otherwise), the loss returned as a device tensor with no
host sync.  Under ``peft`` the base tensors have ``requires_grad=False``,
so autograd never forms their gradients.  There is no sharding here:
``--dis`` (DDP) is ``ROADMAP.md`` queue 1, item 12.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.config import TransformerConfig
from ecg_byte_tpu_torch.train.scheduler import OptimizerSpec, clip_by_global_norm_

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    """Everything a step mutates.  ``base`` holds the frozen parameters
    when only LoRA trains; otherwise ``trainable`` is the full tree and
    ``base`` is None.  ``in_step`` is True while a step is updating the
    tensors in place, so a crash save can tell a half-updated state."""

    trainable: Params
    base: Optional[Params]
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0
    in_step: bool = False

    def full_params(self) -> Params:
        return self.base if self.base is not None else self.trainable

    def lora(self) -> Optional[Params]:
        return self.trainable if self.base is not None else None


def create_train_state(config: TransformerConfig, optimizer: OptimizerSpec,
                       generator: torch.Generator, *, peft: bool = True,
                       params: Optional[Params] = None,
                       lora: Optional[Params] = None) -> TrainState:
    """Initialize parameters and adapters (unless given) and the optimizer.

    ``peft=True`` trains LoRA adapters only (the reference's LoRA mode):
    the adapters are drawn from ``generator`` on its device and the base
    is frozen.
    """
    device = generator.device
    if params is None:
        params = T.init_params(config, generator, device)
    if peft:
        if lora is None:
            lora = lora_lib.init_lora(config, generator, device)
        trainable, base = lora, params
        for t in lora_lib.leaves(base):
            t.requires_grad_(False)
    else:
        trainable, base = params, None
    for t in lora_lib.leaves(trainable):
        t.requires_grad_(True)
    opt, sched = optimizer.build(lora_lib.leaves(trainable))
    return TrainState(trainable=trainable, base=base, optimizer=opt, scheduler=sched)


def _batch_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    def t(x, dtype):
        x = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return x.to(device=device, dtype=dtype, non_blocking=True)

    out = {"input_ids": t(batch["input_ids"], torch.long), "labels": t(batch["labels"], torch.long)}
    if batch.get("attn_mask") is not None:
        out["attn_mask"] = t(batch["attn_mask"], torch.int32)
    if batch.get("position_ids") is not None:
        out["position_ids"] = t(batch["position_ids"], torch.long)
    return out


def _loss_from_batch(config, params, lora, batch, dropout_generator, remat="none"):
    hidden = T.forward(
        params, config, batch["input_ids"], batch.get("attn_mask"), batch.get("position_ids"),
        lora=lora, dropout_generator=dropout_generator, return_hidden=True, remat=remat,
    )
    return T.lm_loss_from_hidden(params, config, hidden, batch["labels"])


def _device(state: TrainState):
    return lora_lib.leaves(state.trainable)[0].device


def make_train_step(config: TransformerConfig, optimizer: OptimizerSpec, *,
                    remat: str = "none") -> Callable:
    """Build ``(state, batch, generator) -> (state, loss)``.

    ``batch`` holds ``input_ids``, ``attn_mask``, ``labels`` and
    ``position_ids`` (numpy or tensors).  ``generator`` is the CPU
    ``torch.Generator`` LoRA dropout draws its per-layer seeds from (None:
    no dropout).  ``remat`` is ``"none"`` or ``"full"``
    (``transformer.forward``); the JAX policies ``"slim"`` and ``"dots"``
    name XLA primitives to save, which have no PyTorch counterpart over
    kernels called through ctypes, so they run as ``"none"``.
    """
    if remat in ("slim", "dots"):
        print(f"remat {remat!r} is a save policy over XLA primitives; it runs as 'none' here")
        remat = "none"

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator]):
        batch = _batch_tensors(batch, _device(state))
        params, lora = (state.base, state.trainable) if state.base is not None else (
            state.trainable, None)
        state.in_step = True
        state.optimizer.zero_grad(set_to_none=True)
        loss = _loss_from_batch(config, params, lora, batch, generator, remat)
        loss.backward()
        grads = [t.grad for t in lora_lib.leaves(state.trainable) if t.grad is not None]
        clip_by_global_norm_(grads, optimizer.clip_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        state.in_step = False
        return state, loss.detach()

    return train_step


def make_eval_step(config: TransformerConfig) -> Callable:
    """``(state, batch) -> loss``: no dropout, no gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict):
        batch = _batch_tensors(batch, _device(state))
        return _loss_from_batch(config, state.full_params(), state.lora(), batch, None)

    return eval_step
