"""Carry JAX-package parameters into the port's layout.

``params_from_jax`` takes ``jax.tree.map(np.asarray, params)`` of an
``ecg_byte_tpu`` model (numpy only; no JAX needed here) and returns the
port's parameter dict: the leading layer axis is unstacked into a list of
per-layer dicts, and every projection kernel stored ``(in, out)`` becomes a
PyTorch ``(out, in)`` weight.  An int8 serving tree
(``ecg_byte_tpu/models/quantized.py``) carries ``kernel_q`` (in, out) and
``kernel_scale`` (1, out), which become ``weight_q`` (out, in) and
``weight_scale`` (out,), and ``lm_head_q`` (D, V) with ``lm_head_scale``
(1, V), which become (V, D) and (V,): the layout of
``models/quantized.py``.  ``lora_from_jax`` does the same for a LoRA tree.  The two-stage trees
carry across with ``resnet_from_jax`` (conv weights and BatchNorm keep
their layout), ``merl_head_from_jax``, ``vit_from_jax``, ``clip_from_jax``
(layer stacks unstacked, dense kernels transposed) and
``fusion_from_jax`` (each ``{"w", "b"}`` to ``{"weight", "bias"}``).
Values are copied exactly, bf16 and int8 included.  ``config_from_jax``
carries a JAX ``TransformerConfig`` across, every field (``norm_folded``
of a folded tree included).  A folded tree
(``ecg_byte_tpu/models/transformer.fold_norm_scales``) carries across as
any other: its ``attn_norm_w`` / ``mlp_norm_w`` are per-layer vectors.
"""

from __future__ import annotations

import dataclasses
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


def _transposed(x, device) -> torch.Tensor:
    return _tensor(np.swapaxes(np.asarray(x), -1, -2), device).contiguous()


def _proj(p: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    if "kernel_q" in p:  # int8 serving entry
        out = {"weight_q": _transposed(p["kernel_q"], device),
               "weight_scale": _tensor(np.asarray(p["kernel_scale"]).reshape(-1), device)}
    else:
        out = {"weight": _transposed(p["kernel"], device)}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"], device)
    return out


def config_from_jax(config) -> TransformerConfig:
    """A JAX ``TransformerConfig`` (any dataclass with its fields) as the
    port's, field for field."""
    return TransformerConfig(**dataclasses.asdict(config))


def params_from_jax(tree: Dict[str, Any], config: TransformerConfig, device) -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> port parameter dict on ``device``."""
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
        params["lm_head"] = _transposed(tree["lm_head"], device)
    if "lm_head_q" in tree:
        params["lm_head_q"] = _transposed(tree["lm_head_q"], device)
        params["lm_head_scale"] = _tensor(np.asarray(tree["lm_head_scale"]).reshape(-1), device)
    return params


def lora_from_jax(tree: Dict[str, Any], config: TransformerConfig, device) -> Dict[str, Any]:
    """JAX LoRA tree (numpy leaves, ``{"layers": {name: {"a": (L, in, r),
    "b": (L, r, out)}}}``) -> the port's ``{"layers": [per layer {name:
    {"a": (in, r), "b": (r, out)}}]}`` on ``device``.  Both packages keep A
    as (in, r) and B as (r, out), so only the layer axis is unstacked."""
    layers = []
    for i in range(config.num_layers):
        layers.append({
            name: {k: _tensor(np.asarray(v)[i], device).contiguous() for k, v in ab.items()}
            for name, ab in tree["layers"].items()
        })
    return {"layers": layers}


def _tree(tree, device):
    """Every numpy leaf of a nested dict as a tensor, layouts unchanged."""
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def resnet_from_jax(params, state, device):
    """JAX ResNet (params, BN state) -> the port's: the same names and
    layouts (conv weights (out, in, k))."""
    return _tree(params, device), _tree(state, device)


def merl_head_from_jax(head, device):
    """JAX MERL head -> the port's: dense kernels (in, out) -> (out, in)."""
    pool = head["att_pool"]
    dense = ("in_proj", "out_proj", "c_proj")
    out = {k: _transposed(v, device) if k in ("linear1", "linear2", "proj_t_w1", "proj_t_w2")
           else _tensor(v, device) for k, v in head.items() if k != "att_pool"}
    out["att_pool"] = {k: _transposed(v, device) if k in dense else _tensor(v, device)
                       for k, v in pool.items()}
    return out


_STACK_DENSE = ("qkv", "out", "fc1", "fc2")


def _stack_from_jax(stack, device):
    n = np.asarray(stack["ln1"]).shape[0]
    return [{k: (_transposed if k in _STACK_DENSE else _tensor)(np.asarray(v)[i], device)
             for k, v in stack.items()} for i in range(n)]


def vit_from_jax(tree, device):
    """JAX ViT -> the port's: the layer stack unstacked, dense (in, out)
    kernels transposed; the patch conv keeps its (out, C, P, P) layout."""
    out = {k: _tensor(v, device) for k, v in tree.items() if k not in ("encoder", "decoder")}
    out["encoder"] = _stack_from_jax(tree["encoder"], device)
    out["decoder"] = _transposed(tree["decoder"], device)
    return out


def clip_from_jax(tree, device):
    """JAX CLIP -> the port's (both towers as in :func:`vit_from_jax`)."""
    projections = ("visual_projection", "text_projection")
    out = {k: _transposed(v, device) if k in projections else _tensor(v, device)
           for k, v in tree.items() if k not in ("vision", "text_encoder")}
    out["vision"] = vit_from_jax(tree["vision"], device)
    out["text_encoder"] = _stack_from_jax(tree["text_encoder"], device)
    return out


def fusion_from_jax(tree, device):
    """JAX fusion projections ``{"w": (in, out), "b"}`` -> ``{"weight":
    (out, in), "bias"}``."""
    return {name: {"weight": _transposed(p["w"], device), "bias": _tensor(p["b"], device)}
            for name, p in tree.items()}
