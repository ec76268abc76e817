"""Device selection.  The port runs on a CUDA card; the CPU only on request."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(arg: Optional[str] = None) -> torch.device:
    """Map a ``--device`` value to a ``torch.device``.

    ``None`` means the CUDA card and raises ``RuntimeError`` when there is
    none: a serving run that silently fell back to the CPU would report CPU
    numbers as if they were the card's.  The CPU is used only when the
    caller passes ``"cpu"``.
    """
    if arg is not None and torch.device(arg).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device(arg if arg is not None else "cuda")
