"""Train and eval steps: the port of ``ecg_byte_tpu/train/step.py``.

One step is the reference's forward, backward, clip and Noam-scheduled Adam
update: gradients over the trainable tree (LoRA adapters under ``peft``,
every parameter otherwise), the loss returned as a device tensor with no
host sync.  Under ``peft`` the base tensors have ``requires_grad=False``,
so autograd never forms their gradients.

Under ``--dis`` a step takes a rank's rows of the global batch
(``rows``) and the global count of labelled tokens (``n_valid``): the
loss is the rank's sum over that count, the gradients are summed over the
ranks before the clip by global norm (optax's chain clips the global
gradient), and the loss returned is the global mean.  So every rank takes
the step one process takes on the global batch.

Under ``--tp`` and ``--fsdp`` (``parallel/mesh.py``) the state is this
rank's shards (:func:`shard_train_state`, the JAX ``shard_state``): the
model code's collectives make every rank of a tp group compute the loss
and the whole gradient of what it holds whole, so no gradient is summed
over tp; the gradients sum over the data group only (an fsdp shard's over
the dp group, its gather's backward having reduce-scattered it over the
fsdp group); the clip's norm sums each shard's squares over the ranks
that hold the other blocks, and Adam and Noam step on the shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.config import TransformerConfig
from ecg_byte_tpu_torch.parallel import distributed, mesh, sharding
from ecg_byte_tpu_torch.parallel.distributed import Rows
from ecg_byte_tpu_torch.train.checkpoint import host_copy
from ecg_byte_tpu_torch.train.scheduler import OptimizerSpec, clip_by_global_norm_
from ecg_byte_tpu_torch.utils.profiling import span

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    """Everything a step mutates.  ``base`` holds the frozen parameters
    when only LoRA trains; otherwise ``trainable`` is the full tree and
    ``base`` is None.  ``in_step`` is True while a step is updating the
    tensors in place, so a crash save can tell a half-updated state.
    ``whole_base``: under ``--tp`` / ``--fsdp`` LoRA training, rank 0's
    host copy of the frozen base, whole, which its checkpoints write
    without gathering it again (``train/checkpoint.py``)."""

    trainable: Params
    base: Optional[Params]
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0
    in_step: bool = False
    whole_base: Optional[Params] = None

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


def shard_train_state(state: TrainState, optimizer: OptimizerSpec) -> TrainState:
    """This rank's shards of a fresh one-process state (every rank drew the
    same one), by the JAX specs (``parallel/sharding.py``), with the
    optimizer built anew on them; the state itself where T = F = 1."""
    if not mesh.grid().sharded:
        return state
    whole_base = None
    if state.base is not None:
        if distributed.is_primary():
            whole_base = host_copy(state.base)
        base = sharding.shard_tree(state.base, sharding.param_splits(state.base))
        trainable = sharding.shard_tree(state.trainable, sharding.lora_splits(state.trainable))
    else:
        base, trainable = None, sharding.shard_tree(state.trainable,
                                                    sharding.param_splits(state.trainable))
    for t in lora_lib.leaves(base):
        t.requires_grad_(False)
    for t in lora_lib.leaves(trainable):
        t.requires_grad_(True)
    opt, sched = optimizer.build(lora_lib.leaves(trainable))
    return TrainState(trainable=trainable, base=base, optimizer=opt, scheduler=sched,
                      step=state.step, whole_base=whole_base)


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


def _no_rows(batch: Dict[str, torch.Tensor], rows: Optional[Rows]):
    """A row that no loss counts (labels -100), for a rank without rows of
    the global batch under ``--fsdp``: its forward and backward take part
    in the fsdp group's gathers and add exact zeros."""
    s = batch["input_ids"].shape[1]
    dev = batch["input_ids"].device
    out = {"input_ids": torch.zeros((1, s), dtype=torch.long, device=dev),
           "attn_mask": torch.ones((1, s), dtype=torch.int32, device=dev),
           "labels": torch.full((1, s), -100, dtype=torch.long, device=dev),
           "position_ids": torch.arange(s, device=dev)[None]}
    return out, Rows(rows.total, (0,)) if rows is not None else None


def _loss_from_batch(config, params, lora, batch, dropout_generator, remat="none", rows=None,
                     n_valid=None):
    if batch["input_ids"].shape[0] == 0:  # a rank without rows of the global batch
        if mesh.fsdp_size() == 1:
            T.dropout_seeds(config, len(params["layers"]), lora, dropout_generator)
            return None
        batch, rows = _no_rows(batch, rows)
    hidden = T.forward(
        params, config, batch["input_ids"], batch.get("attn_mask"), batch.get("position_ids"),
        lora=lora, dropout_generator=dropout_generator, return_hidden=True, remat=remat,
        rows=rows,
    )
    return T.lm_loss_from_hidden(params, config, hidden, batch["labels"], count=n_valid)


def _device(state: TrainState):
    return lora_lib.leaves(state.trainable)[0].device


def gradients(trainable: Sequence[torch.Tensor], loss_fn: Callable[[], Optional[torch.Tensor]]
              ) -> torch.Tensor:
    """The forward and backward of a step: each of ``trainable``'s
    ``.grad`` becomes the gradient of ``loss_fn()``, this rank's share of
    the global batch's loss (None: a rank without rows), summed over the
    ranks before any clip.  Returns the loss summed over the ranks (the
    global mean), detached."""
    for t in trainable:
        t.grad = None
    with span("ecg.train.forward"):
        loss = loss_fn()
    if loss is None:
        loss = torch.zeros((), device=trainable[0].device)
    else:
        with span("ecg.train.backward"):
            loss.backward()
        loss = loss.detach()
    groups = [sharding.grad_group(t) for t in trainable] if mesh.grid().sharded else None
    with span("ecg.train.reduce"):
        (loss,) = distributed.reduce_gradients_(trainable, loss, groups=groups)
    return loss


def apply_step(trainable: Sequence[torch.Tensor], loss_fn: Callable[[], Optional[torch.Tensor]],
               optimizer: torch.optim.Optimizer, scheduler, clip_norm: float) -> torch.Tensor:
    """One step of the reference's chain on ``trainable``: :func:`gradients`,
    the clip by global norm (after the sum over the ranks, as optax clips
    the global gradient), the optimizer and the schedule.  Returns the
    loss (the global mean), detached."""
    loss = gradients(trainable, loss_fn)
    with span("ecg.train.update"):
        held = [t for t in trainable if t.grad is not None]
        clip_by_global_norm_([t.grad for t in held], clip_norm,
                             [sharding.norm_groups(t) for t in held])
        optimizer.step()
        scheduler.step()
    return loss


def make_train_step(config: TransformerConfig, optimizer: OptimizerSpec, *,
                    remat: str = "none") -> Callable:
    """Build ``(state, batch, generator, rows=None, n_valid=None) -> (state,
    loss)``.

    ``batch`` holds ``input_ids``, ``attn_mask``, ``labels`` and
    ``position_ids`` (numpy or tensors).  ``generator`` is the CPU
    ``torch.Generator`` LoRA dropout draws its per-layer seeds from (None:
    no dropout).  ``rows`` and ``n_valid``: the rows of the global batch
    ``batch`` holds and the global batch's labelled tokens (``--dis``;
    None: ``batch`` is the whole batch).  ``remat`` is ``"none"`` or
    ``"full"`` (``transformer.forward``); the JAX policies ``"slim"`` and
    ``"dots"`` name XLA primitives to save, which have no PyTorch
    counterpart over kernels called through ctypes, so they run as
    ``"none"``.
    """
    if remat in ("slim", "dots"):
        print(f"remat {remat!r} is a save policy over XLA primitives; it runs as 'none' here")
        remat = "none"

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator],
                   rows: Optional[Rows] = None, n_valid: Optional[int] = None):
        with span("ecg.train.step"):
            state.in_step = True
            loss = apply_step(lora_lib.leaves(state.trainable),
                              _step_loss(config, state, batch, generator, remat, rows, n_valid),
                              state.optimizer, state.scheduler, optimizer.clip_norm)
        state.step += 1
        state.in_step = False
        return state, loss

    return train_step


def _step_loss(config, state: TrainState, batch: Dict, generator, remat, rows, n_valid):
    with span("ecg.train.batch"):
        batch = _batch_tensors(batch, _device(state))
    params, lora = (state.base, state.trainable) if state.base is not None else (
        state.trainable, None)
    return lambda: _loss_from_batch(config, params, lora, batch, generator, remat, rows, n_valid)


def compute_gradients(config: TransformerConfig, state: TrainState, batch: Dict,
                      generator: Optional[torch.Generator], *, remat: str = "none",
                      rows: Optional[Rows] = None, n_valid: Optional[int] = None
                      ) -> torch.Tensor:
    """The forward and backward of a train step (:func:`gradients`) without
    its update; returns the loss (the global mean), detached."""
    return gradients(lora_lib.leaves(state.trainable),
                     _step_loss(config, state, batch, generator, remat, rows, n_valid))


def make_eval_step(config: TransformerConfig) -> Callable:
    """``(state, batch, rows=None, n_valid=None) -> loss``: no dropout, no
    gradients.  Under ``--dis`` the loss is this rank's share of the global
    mean (its sum over ``n_valid``): the caller sums it over the ranks."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict, rows: Optional[Rows] = None,
                  n_valid: Optional[int] = None):
        batch = _batch_tensors(batch, _device(state))
        loss = _loss_from_batch(config, state.full_params(), state.lora(), batch, None,
                                n_valid=n_valid)
        return torch.zeros((), device=_device(state)) if loss is None else loss

    return eval_step
