"""The plain reference: GPT-2 and Llama-architecture causal LMs with LoRA
adapters, in float32, with no kernel, cache or batching of the program.

It follows the published descriptions:

- GPT-2: learned absolute positions, pre-LayerNorm blocks (weight and
  bias), biased projections, GELU with the tanh approximation
  (``gelu_new``), MLP up then down, tied output head.
- Llama (SmolLM2): RMSNorm (weight), rotary positions (rotate-half, base
  ``rope_theta``), SwiGLU MLP ``down(silu(gate) * up)``, no biases, tied
  head.
- Attention: causal, keys at left-pad positions masked, softmax in f32.
- LoRA: ``y = x W^T + b + (alpha / r) * drop(x A) B`` on the targets, with
  inverted dropout on the (B, S, r) product ("rank" dropout, the mask
  rule of :mod:`bench_port.reference.dropout`).

Positions come from the validity mask (the count of valid positions
before, pads at 0), so a left-padded row computes what its unpadded
prompt computes.  Query rows at pad positions attend no valid key; what
they hold differs between implementations and reaches neither a valid
position nor the loss, so no comparison reads them.

``mm`` is the product every matrix multiplication goes through:
:func:`f32_mm`, or the control's lower precision
(:func:`bench_port.reference.precision.fp8_mm`).  Imports nothing of the
program and nothing of JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from bench_port.spec import Spec

NEG = -1e30
Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _linear(x, p, mm: Mm):
    y = mm(x, p["weight"].t())
    return y + p["bias"] if "bias" in p else y


def _norm(x, w, b, s: Spec):
    if s.model_type == "gpt2":
        return F.layer_norm(x, (x.shape[-1],), w, b, s.eps)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + s.eps) * w


def _rope(x, pos, s: Spec):
    d = s.head_dim
    inv = 1.0 / (s.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                device=x.device) / d))
    ang = pos[..., None].float() * inv  # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, mask, s: Spec, mm: Mm):
    """q (B, S, H, D), k/v (B, S, KH, D), mask (B, S) -> (B, S, H * D)."""
    b, n, h, d = q.shape
    g = h // s.kv_heads
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    logits = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    ok = causal[None, None] & mask[:, None, None, :].bool()
    probs = torch.softmax(logits.masked_fill(~ok, NEG), dim=-1)
    return mm(probs, v).transpose(1, 2).reshape(b, n, h * d)


def _adapt(x, y, name, lora_p, masks, s: Spec, mm: Mm):
    if lora_p is None or name not in lora_p:
        return y
    xa = mm(x, lora_p[name]["a"])
    if masks is not None:
        xa = torch.where(masks[name], xa / (1.0 - s.lora_dropout), 0.0)
    return y + mm(xa, lora_p[name]["b"]) * (s.lora_alpha / s.lora_rank)


def _proj(x, layer, name, lora_p, masks, s, mm):
    return _adapt(x, _linear(x, layer[name], mm), name, lora_p, masks, s, mm)


def block(h, layer, lora_p, masks, mask, pos, s: Spec, mm: Mm):
    b, n, _ = h.shape
    x = _norm(h, layer["attn_norm"], layer.get("attn_norm_bias"), s)
    q, k, v = (_proj(x, layer, nm, lora_p, masks, s, mm).view(b, n, -1, s.head_dim)
               for nm in ("q_proj", "k_proj", "v_proj"))
    if s.model_type == "llama":
        q, k = _rope(q, pos, s), _rope(k, pos, s)
    h = h + _proj(_attention(q, k, v, mask, s, mm), layer, "o_proj", lora_p, masks, s, mm)
    x = _norm(h, layer["mlp_norm"], layer.get("mlp_norm_bias"), s)
    if s.gated:
        inner = F.silu(_proj(x, layer, "gate_proj", lora_p, masks, s, mm)) * _proj(
            x, layer, "up_proj", lora_p, masks, s, mm)
    else:
        inner = F.gelu(_proj(x, layer, "up_proj", lora_p, masks, s, mm), approximate="tanh")
    return h + _proj(inner, layer, "down_proj", lora_p, masks, s, mm)


def positions(mask: torch.Tensor) -> torch.Tensor:
    m = mask.long()
    return torch.where(m == 1, torch.cumsum(m, dim=1) - 1, 0)


def hidden_states(w: Dict, s: Spec, ids, mask, lora: Optional[Dict] = None, masks=None,
                  mm: Mm = f32_mm):
    """The final-normed hidden states (B, S, D).  ``masks``: per layer,
    {target: (B, S, r) bool keep mask} or None (no dropout)."""
    pos = positions(mask)
    h = w["embed"][ids]
    if s.model_type == "gpt2":
        h = h + w["pos_embed"][pos]
    for i, layer in enumerate(w["layers"]):
        h = block(h, layer, lora["layers"][i] if lora else None,
                  masks[i] if masks is not None else None, mask, pos, s, mm)
    return _norm(h, w["final_norm"], w.get("final_norm_bias"), s)


def logits(w: Dict, s: Spec, hidden, mm: Mm = f32_mm):
    head = w["embed"] if s.tie else w["lm_head"]
    return mm(hidden, head.t())


def loss_sum(w: Dict, s: Spec, batch: Dict, lora=None, masks=None, mm: Mm = f32_mm):
    """The summed next-token cross entropy over labels that are not -100."""
    hid = hidden_states(w, s, batch["input_ids"], batch["attn_mask"], lora, masks, mm)
    lg = logits(w, s, hid[:, :-1], mm)
    labels = batch["labels"][:, 1:].long()
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1),
                           ignore_index=-100, reduction="sum")
