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
optimizer.

Loading copies the saved values into the template's own tensors, so the
optimizer keeps pointing at the tensors it updates.
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ecg_byte_tpu_torch.models.lora import leaves

# the largest host snapshot taken; only a full fine-tune's state exceeds it
SNAPSHOT_LIMIT_BYTES = 2 << 30


def checkpoint_path(directory: str, role: str) -> str:
    return os.path.join(directory, f"{role}.pt")


def _payload(state, mutable_only: bool) -> Dict[str, Any]:
    out = {
        "trainable": state.trainable,
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
    }
    if not mutable_only:
        out["base"] = state.base
    return out


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class HostSnapshot(NamedTuple):
    """Host copy of a state's mutable part (the crash-save fallback)."""

    payload: Dict[str, Any]
    mutable_only: bool
    nbytes: int


def snapshot_state(state) -> Optional[HostSnapshot]:
    """Copy the mutable part of ``state`` to host memory: {trainable,
    optimizer, scheduler, step} under LoRA training, everything otherwise.
    None when that exceeds ``SNAPSHOT_LIMIT_BYTES``."""
    mutable_only = state.base is not None
    payload = _payload(state, mutable_only)
    nbytes = sum(t.numel() * t.element_size() for t in leaves(payload))
    if nbytes > SNAPSHOT_LIMIT_BYTES:
        return None
    return HostSnapshot(_to_host(payload), mutable_only, nbytes)


def _save(directory: str, role: str, payload, epoch: int, mutable_only: bool) -> str:
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, role)
    tmp = path + ".tmp"
    torch.save({"state": payload, "epoch": int(epoch), "mutable_only": bool(mutable_only)}, tmp)
    os.replace(tmp, path)  # never leave a half-written checkpoint
    return path


def save_checkpoint(directory: str, role: str, state, *, epoch: int = 0,
                    mutable_only: bool = False) -> str:
    """Save the train state as ``{directory}/{role}.pt``; ``mutable_only``
    leaves the frozen base out.  Returns the path."""
    return _save(directory, role, _payload(state, mutable_only), epoch, mutable_only)


def state_is_alive(state) -> bool:
    """False while a step is updating the tensors in place: after an
    exception there, the live state is half-updated."""
    return not state.in_step


def save_crash_checkpoint(directory: str, state, fallback: Optional[HostSnapshot], *,
                          epoch: int = 0, fallback_epoch: int = 0) -> str:
    """The crash save: the live state when it is whole, else ``fallback``,
    the host snapshot of the last epoch boundary.  Under LoRA training both
    carry only the mutable part.  Returns ``"live"``, ``"snapshot"`` or
    ``"none"`` (nothing savable)."""
    if state_is_alive(state):
        save_checkpoint(directory, "crash_model", state, epoch=epoch,
                        mutable_only=state.base is not None)
        return "live"
    if fallback is not None:
        _save(directory, "crash_model", fallback.payload, fallback_epoch, fallback.mutable_only)
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
    _copy_into(target.trainable, state["trainable"], f"{role}.trainable")
    if not ckpt["mutable_only"] and target.base is not None:
        _copy_into(target.base, state["base"], f"{role}.base")
    target.optimizer.load_state_dict(state["optimizer"])
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
