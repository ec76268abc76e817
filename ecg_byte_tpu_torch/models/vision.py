"""ViT and CLIP encoders of the two-stage baselines.

The port of ``ecg_byte_tpu/models/vision.py``:

- the ViT of masked image modeling: a patch embedding with a mask token at
  the masked patches, a pre-LN encoder, a pixel decoder and the L1 loss on
  the masked patches, and every hidden state for the fusion LLM;
- CLIP: a ViT image tower and a causal text tower with projections, a
  learnable logit scale and the symmetric contrastive loss.

Both towers share one pre-LN encoder.  Its layers are a list of dicts with
PyTorch's ``(out, in)`` weights (``models/convert.vit_from_jax`` and
``clip_from_jax`` unstack and transpose the JAX package's trees); LayerNorm
takes the population variance at eps 1e-5, GELU the tanh approximation.
The image towers attend bidirectionally with plain torch ops (the JAX
package's XLA ``full_attention``); the causal text tower goes through the
plain ``ops/attention.grouped_attention``, as the JAX package opts it out
of every Pallas kernel (``use_flash=False``).  Everything runs in f32.

Under ``--dis`` (``rows``: a rank's rows of the global batch) CLIP's loss
is the rank's rows of the global batch's loss against the gathered
embeddings (``parallel.distributed.gather_rows``), and the masked-image
loss the rank's sum over the global count of masked patches, so the
ranks' losses and gradients sum to one process's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.models.bert import full_attention
from ecg_byte_tpu_torch.models.resnet1d import conv_f32
from ecg_byte_tpu_torch.ops.attention import grouped_attention
from ecg_byte_tpu_torch.parallel import distributed
from ecg_byte_tpu_torch.parallel.distributed import Rows

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    channels: int = 3

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    max_length: int = 77


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    vision: VisionConfig = VisionConfig(patch_size=32)
    text: ClipTextConfig = ClipTextConfig()
    projection_dim: int = 512


def tiny_vision_config(**kw) -> VisionConfig:
    base = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                num_heads=4, intermediate_size=64)
    base.update(kw)
    return VisionConfig(**base)


def tiny_clip_config() -> ClipConfig:
    return ClipConfig(
        vision=tiny_vision_config(),
        text=ClipTextConfig(vocab_size=300, hidden_size=32, num_layers=2,
                            num_heads=4, intermediate_size=64, max_length=16),
        projection_dim=24,
    )


# ---------------------------------------------------------------------------
# Shared pre-LN encoder


def _normal(gen, shape, device, std=0.02):
    return torch.randn(shape, generator=gen, device=device) * std


def _init_stack(gen, layers, hidden, mlp, device) -> List[Params]:
    def zeros(n):
        return torch.zeros(n, device=device)

    def ones(n):
        return torch.ones(n, device=device)

    return [{
        "ln1": ones(hidden), "ln1_b": zeros(hidden),
        "qkv": _normal(gen, (3 * hidden, hidden), device), "qkv_b": zeros(3 * hidden),
        "out": _normal(gen, (hidden, hidden), device), "out_b": zeros(hidden),
        "ln2": ones(hidden), "ln2_b": zeros(hidden),
        "fc1": _normal(gen, (mlp, hidden), device), "fc1_b": zeros(mlp),
        "fc2": _normal(gen, (hidden, mlp), device), "fc2_b": zeros(hidden),
    } for _ in range(layers)]


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _stack_forward(layers: List[Params], x, num_heads: int, *, causal: bool = False,
                   pad_mask=None, collect_hidden: bool = False):
    """Pre-LN transformer encoder; returns (last hidden, hidden list: the
    input and every layer's output when ``collect_hidden``)."""
    b, s, h = x.shape
    d = h // num_heads
    hidden_states = [x] if collect_hidden else []
    for lp in layers:
        hn = _ln(x, lp["ln1"], lp["ln1_b"])
        q, k, v = F.linear(hn, lp["qkv"], lp["qkv_b"]).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, s, num_heads, d) for t in (q, k, v))
        if causal:
            attn = grouped_attention(q.reshape(b, s, num_heads, 1, d), k, v, pad_mask)
        else:
            attn = full_attention(q, k, v, pad_mask)
        x = x + F.linear(attn.reshape(b, s, h), lp["out"], lp["out_b"])
        hn = _ln(x, lp["ln2"], lp["ln2_b"])
        inner = F.gelu(F.linear(hn, lp["fc1"], lp["fc1_b"]), approximate="tanh")
        x = x + F.linear(inner, lp["fc2"], lp["fc2_b"])
        if collect_hidden:
            hidden_states.append(x)
    return x, hidden_states


# ---------------------------------------------------------------------------
# ViT (masked image modeling)


def init_vit(gen: torch.Generator, config: VisionConfig, device=None) -> Params:
    device = gen.device if device is None else device
    c = config
    pix = c.patch_size * c.patch_size * c.channels
    return {
        "patch_embed": _normal(gen, (c.hidden_size, c.channels, c.patch_size, c.patch_size),
                               device),
        "patch_bias": torch.zeros(c.hidden_size, device=device),
        "cls_token": _normal(gen, (1, 1, c.hidden_size), device),
        "mask_token": _normal(gen, (1, 1, c.hidden_size), device),
        "pos_embed": _normal(gen, (1, c.num_patches + 1, c.hidden_size), device),
        "encoder": _init_stack(gen, c.num_layers, c.hidden_size, c.intermediate_size, device),
        "final_ln": torch.ones(c.hidden_size, device=device),
        "final_ln_b": torch.zeros(c.hidden_size, device=device),
        "decoder": _normal(gen, (pix, c.hidden_size), device),
        "decoder_b": torch.zeros(pix, device=device),
    }


def _patchify_embed(p, config: VisionConfig, pixels):
    """(B, C, H, W) -> (B, N, hidden) through the patch conv (TF32 off,
    forward and backward)."""
    out = conv_f32(pixels, p["patch_embed"], stride=config.patch_size)
    return out.flatten(2).transpose(1, 2) + p["patch_bias"]


def vit_encode(p: Params, config: VisionConfig, pixels, bool_masked_pos=None,
               collect_hidden: bool = False):
    """Returns (sequence output (B, N + 1, H), hidden states list)."""
    x = _patchify_embed(p, config, pixels)
    if bool_masked_pos is not None:
        mask = bool_masked_pos[..., None].to(x.dtype)
        x = x * (1 - mask) + p["mask_token"] * mask
    cls = p["cls_token"].expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + p["pos_embed"]
    x, hiddens = _stack_forward(p["encoder"], x, config.num_heads,
                                collect_hidden=collect_hidden)
    return _ln(x, p["final_ln"], p["final_ln_b"]), hiddens


def vit_mim_loss(p: Params, config: VisionConfig, pixels, bool_masked_pos):
    """Masked image modeling: the L1 reconstruction loss on masked patches,
    this batch's sum over the global batch's count of them (``--dis``: the
    count summed over the ranks)."""
    seq, _ = vit_encode(p, config, pixels, bool_masked_pos)
    patch_pred = F.linear(seq[:, 1:], p["decoder"], p["decoder_b"])  # (B, N, P*P*C)
    c = config
    ps, g, b = c.patch_size, c.image_size // c.patch_size, pixels.shape[0]
    target = pixels.reshape(b, c.channels, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    l1 = (patch_pred - target.reshape(b, g * g, patch_pred.shape[-1])).abs().mean(-1)
    mask = bool_masked_pos.float()
    return (l1 * mask).sum() / distributed.sum_over_ranks(mask.sum()).clamp_min(1.0)


# ---------------------------------------------------------------------------
# CLIP


def init_clip(gen: torch.Generator, config: ClipConfig, device=None) -> Params:
    device = gen.device if device is None else device
    v, t = config.vision, config.text
    return {
        "vision": init_vit(gen, v, device),
        "text_embed": _normal(gen, (t.vocab_size, t.hidden_size), device),
        "text_pos": _normal(gen, (t.max_length, t.hidden_size), device),
        "text_encoder": _init_stack(gen, t.num_layers, t.hidden_size, t.intermediate_size,
                                    device),
        "text_final_ln": torch.ones(t.hidden_size, device=device),
        "text_final_ln_b": torch.zeros(t.hidden_size, device=device),
        "visual_projection": _normal(gen, (config.projection_dim, v.hidden_size), device),
        "text_projection": _normal(gen, (config.projection_dim, t.hidden_size), device),
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), device=device),
    }


def clip_image_embeds(p, config: ClipConfig, pixel_values):
    seq, _ = vit_encode(p["vision"], config.vision, pixel_values)
    return F.linear(seq[:, 0], p["visual_projection"])


def clip_text_embeds(p, config: ClipConfig, input_ids, attention_mask):
    t = config.text
    s = input_ids.shape[1]
    x = p["text_embed"][input_ids] + p["text_pos"][:s]
    x, _ = _stack_forward(p["text_encoder"], x, t.num_heads, causal=True,
                          pad_mask=attention_mask)
    x = _ln(x, p["text_final_ln"], p["text_final_ln_b"])
    # HF convention: the pooled state sits at the highest-id (eot) token
    eot = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return F.linear(pooled, p["text_projection"])


def clip_forward(p: Params, config: ClipConfig, input_ids, attention_mask, pixel_values,
                 return_loss: bool = False, rows: Optional[Rows] = None):
    """dict(loss, image_embeds, text_embeds), as HF ``CLIPModel``.  The
    loss is this batch's rows of the loss of the global batch whose
    ``rows`` it holds (None: the batch itself): its text rows against every
    image and its image rows against every text, summed over the global
    batch size."""
    image_embeds = clip_image_embeds(p, config, pixel_values)
    text_embeds = clip_text_embeds(p, config, input_ids, attention_mask)
    out = {"image_embeds": image_embeds, "text_embeds": text_embeds, "loss": None}
    if return_loss:
        rows = rows if rows is not None else Rows.whole(input_ids.shape[0])
        ie = image_embeds / (torch.linalg.vector_norm(image_embeds, dim=-1, keepdim=True) + 1e-8)
        te = text_embeds / (torch.linalg.vector_norm(text_embeds, dim=-1, keepdim=True) + 1e-8)
        scale = torch.exp(p["logit_scale"])
        labels = rows.positions(te.device)
        logits = te @ distributed.gather_rows(ie, rows).T * scale
        logits_t = ie @ distributed.gather_rows(te, rows).T * scale
        out["loss"] = (F.cross_entropy(logits, labels, reduction="sum")
                       + F.cross_entropy(logits_t, labels, reduction="sum")) / (2.0 * rows.total)
    return out
