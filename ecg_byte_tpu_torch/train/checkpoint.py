"""Checkpoints with the reference's file roles.

Only the ``best_model`` role that serving reads is ported: a ``torch.save``
of the parameter dict at ``runs/<seed>/<cfg>/best_model.pt``.  The crash
and periodic roles and resume come with training.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def checkpoint_path(directory: str, role: str) -> str:
    return os.path.join(directory, f"{role}.pt")


def save_checkpoint(directory: str, role: str, params: Dict[str, Any]) -> str:
    """Save the parameter dict as ``{directory}/{role}.pt``; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, role)
    tmp = path + ".tmp"
    torch.save(params, tmp)
    os.replace(tmp, path)  # never leave a half-written checkpoint
    return path


def load_checkpoint(directory: str, role: str, like: Dict[str, Any], device) -> Dict[str, Any]:
    """Load ``{directory}/{role}.pt`` onto ``device``.

    ``like`` is a parameter dict of the model being served; the checkpoint
    must hold the same names with the same shapes and dtypes.
    """
    params = torch.load(checkpoint_path(directory, role), map_location=device, weights_only=True)
    _check_like(params, like, role)
    return params


def _check_like(got, want, where: str) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint {where}: names differ from the model's")
        for k in want:
            _check_like(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise ValueError(f"checkpoint {where}: layer count differs from the model's")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_like(g, w, f"{where}[{i}]")
    elif got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(
            f"checkpoint {where}: {tuple(got.shape)} {got.dtype}, model has "
            f"{tuple(want.shape)} {want.dtype}"
        )
