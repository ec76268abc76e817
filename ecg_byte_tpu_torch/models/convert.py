"""Carry JAX-package parameters into the port's layout.

``params_from_jax`` takes ``jax.tree.map(np.asarray, params)`` of an
``ecg_byte_tpu`` model (numpy only; no JAX needed here) and returns the
port's parameter dict: the leading layer axis is unstacked into a list of
per-layer dicts, and every projection kernel stored ``(in, out)`` becomes a
PyTorch ``(out, in)`` weight.  Values are copied exactly, bf16 included.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ecg_byte_tpu_torch.models.config import TransformerConfig


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    return t.to(device)


def _proj(p: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    if "kernel" not in p:
        raise NotImplementedError("int8 serving trees are not ported yet")
    out = {"weight": _tensor(np.swapaxes(np.asarray(p["kernel"]), -1, -2), device).contiguous()}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"], device)
    return out


def params_from_jax(tree: Dict[str, Any], config: TransformerConfig, device) -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> port parameter dict on ``device``."""
    if "lm_head_q" in tree:
        raise NotImplementedError("int8 serving trees are not ported yet")
    layers = []
    for i in range(config.num_layers):
        layer: Dict[str, Any] = {}
        for name, leaf in tree["layers"].items():
            if isinstance(leaf, dict):
                layer[name] = _proj({k: np.asarray(v)[i] for k, v in leaf.items()}, device)
            else:
                layer[name] = _tensor(np.asarray(leaf)[i], device)
        layers.append(layer)
    params: Dict[str, Any] = {"layers": layers}
    for name in ("embed", "final_norm", "final_norm_bias", "pos_embed"):
        if name in tree:
            params[name] = _tensor(tree[name], device)
    if "lm_head" in tree:  # JAX (D, V) -> (V, D)
        params["lm_head"] = _tensor(np.asarray(tree["lm_head"]).T, device).contiguous()
    return params
