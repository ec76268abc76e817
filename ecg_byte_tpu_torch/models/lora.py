"""LoRA adapters as an overlay beside the base parameters.

The port of ``ecg_byte_tpu/models/lora.py``: rank 16, alpha 32, dropout 0.05
on the seven projections (``config.lora_targets``), gate_proj only where the
architecture is gated.  Adapters live in their own tree, ``{"layers": [per
layer {name: {"a", "b"}}]}``, one dict per layer beside the base model's
per-layer dicts; under LoRA training only this tree is trainable.

Layout: ``a`` is ``(in, r)`` and ``b`` is ``(r, out)``, the JAX package's
own (PEFT stores the transposes), so ``x @ a @ b`` reads as in the JAX code
and ``convert.lora_from_jax`` only unstacks the layer axis.  The base
weights keep PyTorch's ``(out, in)``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ecg_byte_tpu_torch.models.config import TransformerConfig

Params = Dict[str, Any]

_PROJ_DIMS = {  # name -> (d_in, d_out)
    "q_proj": lambda c: (c.hidden_size, c.qkv_dim),
    "k_proj": lambda c: (c.hidden_size, c.kv_dim),
    "v_proj": lambda c: (c.hidden_size, c.kv_dim),
    "o_proj": lambda c: (c.qkv_dim, c.hidden_size),
    "gate_proj": lambda c: (c.hidden_size, c.intermediate_size),
    "up_proj": lambda c: (c.hidden_size, c.intermediate_size),
    "down_proj": lambda c: (c.intermediate_size, c.hidden_size),
}


def targets(config: TransformerConfig):
    """The projections that carry adapters, in ``config.lora_targets`` order."""
    gated = config.hidden_act in ("silu", "gelu_tanh")
    return [n for n in config.lora_targets
            if n in _PROJ_DIMS and (n != "gate_proj" or gated)]


def init_lora(config: TransformerConfig, generator: torch.Generator, device) -> Params:
    """A uniform in +-(1/d_in)^0.5 (f32 draws cast to the model dtype), B = 0,
    so the adapted model starts exactly at the base model.  ``generator``
    must live on ``device``."""
    c = config
    dt = getattr(torch, c.dtype)
    layers = []
    for _ in range(c.num_layers):
        layer = {}
        for name in targets(c):
            d_in, d_out = _PROJ_DIMS[name](c)
            bound = (1.0 / d_in) ** 0.5
            a = torch.rand(d_in, c.lora_rank, generator=generator, device=device)
            layer[name] = {
                "a": (a * (2 * bound) - bound).to(dt),
                "b": torch.zeros(c.lora_rank, d_out, dtype=dt, device=device),
            }
        layers.append(layer)
    return {"layers": layers}


@torch.no_grad()
def merge_lora(params: Params, lora: Params, config: TransformerConfig) -> Params:
    """Fold adapters into the base weights: W' = W + (alpha/r) (A B)^T in f32,
    cast back to W's dtype.  Returns a new tree; ``params`` is unchanged."""
    scale = config.lora_alpha / config.lora_rank
    layers = []
    for layer_p, lora_p in zip(params["layers"], lora["layers"]):
        layer = dict(layer_p)
        for name, ab in lora_p.items():
            proj = dict(layer[name])
            w = proj["weight"]
            delta = (ab["a"].float() @ ab["b"].float()).T * scale  # (out, in)
            proj["weight"] = (w.float() + delta).to(w.dtype)
            layer[name] = proj
        layers.append(layer)
    return {**params, "layers": layers}


def leaves(tree):
    """Every tensor of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in leaves(x)]
    return []


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))
