"""Checkpoints with the reference's file roles: the port of
``ecg_byte_tpu/train/checkpoint.py``.

Roles: ``best_model`` (saved when the validation loss improves),
``crash_model`` (on an exception, SIGTERM or normal exit) and
``best_train_model_{epoch}_{step}`` (every 50k steps), each a ``torch.save``
file ``{directory}/{role}.pt`` holding

    {"state": payload, "epoch": int, "mutable_only": bool}

where the payload carries the train state: ``trainable``, ``base`` (the
frozen parameters under LoRA training, else None), the optimizer's and the
LR scheduler's state dicts and ``step``.  A ``mutable_only`` payload leaves
the frozen base out (a LoRA crash save is {trainable, optimizer, scheduler,
step}, a few hundred MB at full width); :func:`load_checkpoint` grafts the
base back from its template.  Serving reads the same format through :func:`load_weights`, which needs no
optimizer.  The two-stage CLIs save a plain tree of tensors in the same
file format (:func:`save_tree`, :func:`load_tree`).

Loading copies the saved values into the template's own tensors, so the
optimizer keeps pointing at the tensors it updates.

Under ``--dis`` rank 0 alone writes, and the other ranks wait for it at a
barrier (reference main.py:311-316); ``wait=False`` leaves the barrier out,
for a save on the way out of a failed run, whose peers may be gone.

Under ``--tp`` and ``--fsdp`` the state is this rank's shards
(``parallel/sharding.py``): every rank takes part in gathering the whole
tree, Adam's moments included, and rank 0 writes the tree one process
writes, so ``cli.main --inference`` serves it and any grid resumes it;
loading takes this rank's shards of the whole tree, by the target's
splits.  A LoRA run's frozen base is not gathered: rank 0 writes its host
copy (``TrainState.whole_base``).  A failed run cannot gather (its peers may be gone): its crash
save is the last epoch boundary's host snapshot, which every rank gathered.
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ecg_byte_tpu_torch.models.lora import leaves
from ecg_byte_tpu_torch.parallel import distributed, mesh, sharding

# the largest host snapshot taken; only a full fine-tune's state exceeds it
SNAPSHOT_LIMIT_BYTES = 2 << 30
# the roles this process wrote, in order (under --dis only rank 0's fill)
written = []


def checkpoint_path(directory: str, role: str) -> str:
    return os.path.join(directory, f"{role}.pt")


def _whole_optimizer(state) -> Dict[str, Any]:
    """The optimizer's state dict, each moment (Adam's, shaped like its
    param) gathered whole by its param's split."""
    sd = state.optimizer.state_dict()
    params = leaves(state.trainable)
    return {**sd, "state": {
        i: {k: sharding.gather(sharding.mark(v, params[i]))
            if isinstance(v, torch.Tensor) and v.dim() else v for k, v in s.items()}
        for i, s in sd["state"].items()}}


def _payload(state, mutable_only: bool) -> Dict[str, Any]:
    """The train state as one process holds it: under --tp or --fsdp
    gathered from the shards, every rank taking part."""
    out = {
        "trainable": sharding.gather_tree(state.trainable),
        "optimizer": _whole_optimizer(state),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
    }
    if not mutable_only:
        # under --tp / --fsdp rank 0 holds the frozen base whole on the host
        out["base"] = (state.whole_base if state.base is not None and mesh.grid().sharded
                       else sharding.gather_tree(state.base))
    return out


def host_copy(tree):
    """A copy of a tree of tensors in host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class HostSnapshot(NamedTuple):
    """Host copy of a state's mutable part (the crash-save fallback)."""

    payload: Dict[str, Any]
    mutable_only: bool
    nbytes: int


def snapshot_state(state) -> Optional[HostSnapshot]:
    """Copy the mutable part of ``state`` to host memory: {trainable,
    optimizer, scheduler, step} under LoRA training, everything otherwise.
    None when that exceeds ``SNAPSHOT_LIMIT_BYTES``, and on every rank but
    rank 0 (under --tp or --fsdp after taking part in the gather)."""
    mutable_only = state.base is not None
    if not mesh.grid().sharded and not distributed.is_primary():
        return None
    payload = _payload(state, mutable_only)
    if not distributed.is_primary():
        return None
    nbytes = sum(t.numel() * t.element_size() for t in leaves(payload))
    if nbytes > SNAPSHOT_LIMIT_BYTES:
        return None
    return HostSnapshot(host_copy(payload), mutable_only, nbytes)


def _save(directory: str, role: str, payload, epoch: int, mutable_only: bool,
          wait: bool = True) -> str:
    path = checkpoint_path(directory, role)
    if distributed.is_primary():
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"state": payload, "epoch": int(epoch), "mutable_only": bool(mutable_only)},
                   tmp)
        os.replace(tmp, path)  # never leave a half-written checkpoint
        written.append(role)
    if wait:
        distributed.barrier()
    return path


def save_checkpoint(directory: str, role: str, state, *, epoch: int = 0,
                    mutable_only: bool = False, wait: bool = True) -> str:
    """Save the train state as ``{directory}/{role}.pt``; ``mutable_only``
    leaves the frozen base out.  Returns the path."""
    return _save(directory, role, _payload(state, mutable_only), epoch, mutable_only, wait)


def state_is_alive(state) -> bool:
    """False while a step is updating the tensors in place: after an
    exception there, the live state is half-updated."""
    return not state.in_step


def save_crash_checkpoint(directory: str, state, fallback: Optional[HostSnapshot], *,
                          epoch: int = 0, fallback_epoch: int = 0, wait: bool = True) -> str:
    """The crash save: the live state when it is whole, else ``fallback``,
    the host snapshot of the last epoch boundary.  Under LoRA training both
    carry only the mutable part.  Returns ``"live"``, ``"snapshot"`` or
    ``"none"`` (nothing savable)."""
    # a failed run's peers may be gone: shards cannot be gathered
    if state_is_alive(state) and (wait or not mesh.grid().sharded):
        save_checkpoint(directory, "crash_model", state, epoch=epoch,
                        mutable_only=state.base is not None, wait=wait)
        return "live"
    if fallback is not None:
        _save(directory, "crash_model", fallback.payload, fallback_epoch, fallback.mutable_only,
              wait)
        return "snapshot"
    return "none"


def _copy_into(dst, src, where: str) -> None:
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"checkpoint {where}: names differ from the model's")
        for k in dst:
            _copy_into(dst[k], src[k], f"{where}.{k}")
    elif isinstance(dst, list):
        if not isinstance(src, list) or len(src) != len(dst):
            raise ValueError(f"checkpoint {where}: layer count differs from the model's")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{where}[{i}]")
    else:
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"checkpoint {where}: {tuple(src.shape)} {src.dtype}, model has "
                f"{tuple(dst.shape)} {dst.dtype}"
            )
        with torch.no_grad():
            dst.copy_(src)


def _local(src, dst):
    """``src`` (a whole tree) as the shards ``dst`` holds: each tensor's
    block by its target's split (``src`` itself where ``dst`` is whole)."""
    if isinstance(dst, dict) and isinstance(src, dict):
        return {k: _local(src[k], dst[k]) if k in dst else src[k] for k in src}
    if isinstance(dst, list) and isinstance(src, list):
        return [_local(s, d) for s, d in zip(src, dst)] + src[len(dst):]
    if isinstance(dst, torch.Tensor) and isinstance(src, torch.Tensor):
        split, shape = sharding.split_of(dst)
        if shape is not None and tuple(src.shape) == shape:
            return sharding.shard(src, split)
    return src


def _read(directory: str, role: str, device, peft: bool) -> Dict[str, Any]:
    """``{directory}/{role}.pt`` on ``device``, refused unless it was saved
    in the same mode (LoRA or full fine-tune) as ``peft`` says."""
    ckpt = torch.load(checkpoint_path(directory, role), map_location=device, weights_only=True)
    # only a LoRA state is ever saved without its base
    saved_peft = ckpt["mutable_only"] or ckpt["state"]["base"] is not None
    if saved_peft != peft:
        raise ValueError(f"checkpoint {role}: LoRA / full fine-tune mode differs from the model's")
    return ckpt


def load_checkpoint(directory: str, role: str, target):
    """Load ``{directory}/{role}.pt`` into ``target`` (a TrainState of the
    same model and mode) and return ``(target, epoch)``.  A mutable-only
    checkpoint keeps ``target``'s base."""
    device = leaves(target.trainable)[0].device
    ckpt = _read(directory, role, device, peft=target.base is not None)
    state = ckpt["state"]
    _copy_into(target.trainable, _local(state["trainable"], target.trainable),
               f"{role}.trainable")
    if not ckpt["mutable_only"] and target.base is not None:
        _copy_into(target.base, _local(state["base"], target.base), f"{role}.base")
        if target.whole_base is not None:
            target.whole_base = host_copy(state["base"])
    optimizer = state["optimizer"]
    if mesh.grid().sharded:
        params = leaves(target.trainable)
        optimizer = {**optimizer, "state": {
            i: {k: sharding.shard(v, sharding.split_of(params[i])[0])
                if isinstance(v, torch.Tensor) and v.dim() else v for k, v in s.items()}
            for i, s in optimizer["state"].items()}}
    target.optimizer.load_state_dict(optimizer)
    target.scheduler.load_state_dict(state["scheduler"])
    target.step = int(state["step"])
    target.in_step = False
    return target, int(ckpt["epoch"])


def load_weights(directory: str, role: str, params, *, peft: bool) -> Tuple[Any, Optional[Any]]:
    """The weights of ``{directory}/{role}.pt`` for serving: ``(params,
    lora)``.  The saved full parameters, or a LoRA checkpoint's base, are
    copied into ``params`` (the model as built); a mutable-only LoRA
    checkpoint keeps ``params`` as built.  ``lora`` is the saved adapter
    tree under ``peft``, else None."""
    device = leaves(params)[0].device
    ckpt = _read(directory, role, device, peft)
    state = ckpt["state"]
    if not peft:
        _copy_into(params, state["trainable"], f"{role}.trainable")
        return params, None
    if not ckpt["mutable_only"]:
        _copy_into(params, state["base"], f"{role}.base")
    return params, state["trainable"]


def save_tree(directory: str, role: str, tree, *, epoch: int = 0, wait: bool = True) -> str:
    """Save a nested dict/list of tensors (a two-stage model's trainable
    part, its BatchNorm state) as ``{directory}/{role}.pt``."""
    return _save(directory, role, tree, epoch, mutable_only=False, wait=wait)


def load_tree(directory: str, role: str, device):
    """The tree :func:`save_tree` wrote, on ``device``; returns (tree, epoch)."""
    ckpt = torch.load(checkpoint_path(directory, role), map_location=device, weights_only=True)
    return ckpt["state"], int(ckpt["epoch"])
