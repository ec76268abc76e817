"""Weight-only int8 serving copy of a parameter tree (``--int8_decode``).

The port of ``ecg_byte_tpu/models/quantized.py`` onto the port's ``(out,
in)`` weights.  Greedy decode streams every weight once per token, so int8
weights halve the bytes a token reads.  Each projection entry ``{"weight",
("bias")}`` becomes ``{"weight_q": int8 (out, in), "weight_scale": bf16
(out,), ("bias")}``: symmetric, one scale per output channel over the
contraction axis.  The head becomes ``lm_head_q`` (V, D) with
``lm_head_scale`` (V,); a tied model's head is quantized from ``embed``,
and ``embed`` itself stays as it is for the input gather.  Biases and norm
scales stay as they are.

``models/transformer`` applies such entries through ``ops/int8_linear``.
Quantize after merging LoRA, so the adapters are quantized with the weights
they modify.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ecg_byte_tpu_torch.models.config import TransformerConfig

Params = Dict[str, Any]

_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@torch.no_grad()
def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (int8 (out, in), bf16 scale (out,)), w ~= q *
    scale: the f32 absmax over the contraction axis, ``scale = amax/127``
    (1 where amax is 0), ``q = clip(round(w/scale), -127, 127)``
    (``_quantize_kernel``).  The divisor 127 is a tensor on w's device:
    PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The materialized bf16 weight ``q * scale`` (``dequantize_kernel``),
    for tests."""
    return q.to(torch.bfloat16) * scale[:, None]


def quantize_lm_int8(params: Params, config: TransformerConfig) -> Params:
    """The int8 serving copy of ``params`` (see the module docstring); a new
    tree, ``params`` is unchanged."""
    layers = []
    for layer_p in params["layers"]:
        layer = dict(layer_p)
        for name in _PROJ_NAMES:
            if name not in layer:
                continue
            entry = dict(layer[name])
            entry["weight_q"], entry["weight_scale"] = quantize_weight(entry.pop("weight"))
            layer[name] = entry
        layers.append(layer)
    out = {k: v for k, v in params.items() if k != "lm_head"}
    out["layers"] = layers
    head = params["embed"] if config.tie_word_embeddings else params["lm_head"]
    out["lm_head_q"], out["lm_head_scale"] = quantize_weight(head)
    return out
