"""Two-stage fusion: a frozen signal encoder's embedding spliced into the
LLM's input at the ``<signal>`` slot.

The port of ``ecg_byte_tpu/models/fusion.py``: ``adapt_sequence`` (the
reference's splice, vectorized as a gather), the trainable projections of
each backbone kind, ``encoder_embedding`` through the frozen backbone (run
under ``torch.no_grad``, the JAX package's ``stop_gradient``), the stage-2
loss on ``inputs_embeds`` and the greedy decode whose prompt is consumed as
spliced embeddings.  The ``<signal>`` id comes from the tokenizer.
Projections keep PyTorch's ``(out, in)`` layout (``models/convert.
fusion_from_jax``).  The LLM runs through the port's transformer, so its
attention and RMSNorm take the CUDA kernels on the card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.models import resnet1d, vision
from ecg_byte_tpu_torch.models import transformer as T

Params = Dict[str, Any]

IGNORE_INDEX = -100


def adapt_sequence(sig_embed: torch.Tensor, text_embed: torch.Tensor, token_ids: torch.Tensor,
                   attn_mask: torch.Tensor, labels: Optional[torch.Tensor] = None,
                   position_ids: Optional[torch.Tensor] = None, sig_id: int = -1,
                   ignore_index: int = IGNORE_INDEX) -> Dict[str, torch.Tensor]:
    """Insert ``sig_embed`` (B, 1, D) right after the ``<signal>`` token of
    ``text_embed`` (B, S, D).

    Training (``labels`` given): the slot after ``<signal>`` is consumed and
    the output keeps length S; the inserted label is ``ignore_index`` and the
    position ids after the slot shift by one.  Inference: a pure insert,
    length S + 1."""
    b, s, _ = text_embed.shape
    add_idx = 2 if labels is not None else 1
    s_out = s + 2 - add_idx
    p = (token_ids == sig_id).to(torch.int32).argmax(dim=-1) + 1  # insertion slot
    j = torch.arange(s_out, device=token_ids.device)[None, :]
    pv = p[:, None]
    # source index into cat([text (0..S-1), sig (S)])
    src = torch.where(j < pv, j, torch.where(j == pv, s, j + add_idx - 2)).clamp(0, s).long()

    ext = torch.cat([text_embed, sig_embed.to(text_embed.dtype)], dim=1)
    combined = ext.gather(1, src[..., None].expand(-1, -1, ext.shape[-1]))

    def splice(field, value):
        col = torch.full((b, 1), value, dtype=field.dtype, device=field.device)
        return torch.cat([field, col], dim=1).gather(1, src)

    out = {"combined_embeds": combined, "attn_mask": splice(attn_mask.to(torch.int32), 1)}
    if labels is not None:
        out["labels"] = splice(labels, ignore_index)
        before = position_ids.gather(1, (p - 1).clamp_min(0)[:, None].long())
        ext_pos = torch.cat([position_ids, (before + 1).to(position_ids.dtype)], dim=1)
        new_pos = ext_pos.gather(1, src)
        out["position_ids"] = torch.where(j > pv, new_pos + 1, new_pos)
    return out


# ---------------------------------------------------------------------------
# Projections and the frozen backbones' embeddings


def init_projection(gen: torch.Generator, d_in: int, d_out: int, device=None) -> Params:
    device = gen.device if device is None else device
    bound = (1.0 / d_in) ** 0.5

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=device) * (2 * bound) - bound

    return {"weight": uniform((d_out, d_in)), "bias": uniform((d_out,))}


def init_fusion(gen: torch.Generator, kind: str, llm_hidden: int, resnet_channels: int = 2048,
                clip_dim: int = 512, vit_dim: int = 768, device=None) -> Params:
    """The trainable stage-2 parameters of each backbone kind."""
    if kind == "clip_model":
        return {"image_projection": init_projection(gen, clip_dim, llm_hidden, device)}
    if kind == "vit_model":
        return {"image_projection": init_projection(gen, vit_dim, llm_hidden, device)}
    if kind == "clip_vit_model":
        return {
            "clip_projection": init_projection(gen, clip_dim, llm_hidden, device),
            "vit_projection": init_projection(gen, vit_dim, llm_hidden, device),
            "fusion_w1": init_projection(gen, 2 * llm_hidden, llm_hidden, device),
            "fusion_w2": init_projection(gen, llm_hidden, llm_hidden, device),
        }
    if kind == "resnet_model":
        return {"image_projection": init_projection(gen, resnet_channels, llm_hidden, device)}
    raise ValueError(f"unknown fusion kind {kind!r}")


def _apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["weight"], p["bias"])


def _vit_embedding(vit, batch):
    _, hiddens = vision.vit_encode(vit[0], vit[1], batch["vit_pixel"], batch.get("mask"),
                                   collect_hidden=True)
    return torch.stack(hiddens).mean(dim=0).mean(dim=1)


def encoder_embedding(kind: str, fusion: Params, batch: Dict[str, torch.Tensor], *,
                      clip=None, vit=None, resnet=None) -> torch.Tensor:
    """Frozen backbone -> projected (B, 1, llm_hidden) embedding.  ``clip``
    and ``vit`` are (params, config), ``resnet`` (params, state, meta).

    CLIP: its image embedding; ViT: the mean over every hidden state and
    token; ResNet: the length-pooled features; CLIP + ViT: both projected,
    then a two-layer fusion MLP."""
    with torch.no_grad():
        if kind == "clip_model":
            emb = vision.clip_image_embeds(clip[0], clip[1], batch["clip_pixel"])
        elif kind == "vit_model":
            emb = _vit_embedding(vit, batch)
        elif kind == "clip_vit_model":
            clip_emb = vision.clip_image_embeds(clip[0], clip[1], batch["clip_pixel"])
            vit_emb = _vit_embedding(vit, batch)
        elif kind == "resnet_model":
            feats, _ = resnet1d.resnet_forward(resnet[0], resnet[1], resnet[2],
                                               batch["norm_signal"], train=False)
            emb = feats.mean(dim=-1)
        else:
            raise ValueError(kind)
    if kind == "clip_vit_model":
        fused = torch.cat([_apply(fusion["clip_projection"], clip_emb),
                           _apply(fusion["vit_projection"], vit_emb)], dim=-1)
        proj = _apply(fusion["fusion_w2"], F.relu(_apply(fusion["fusion_w1"], fused)))
    else:
        proj = _apply(fusion["image_projection"], emb)
    return proj[:, None, :]


def label_count(token_ids, labels, sig_id: int) -> int:
    """The labelled next tokens the stage-2 loss counts, from a batch's host
    arrays: :func:`adapt_sequence`'s training splice turns the label of the
    slot after ``<signal>`` into ``IGNORE_INDEX``."""
    ids, lab = np.asarray(token_ids), np.array(labels)
    slot = (ids == sig_id).argmax(axis=-1) + 1
    inside = slot < ids.shape[1]
    lab[np.nonzero(inside)[0], slot[inside]] = IGNORE_INDEX
    return int((lab[:, 1:] != IGNORE_INDEX).sum())


def fusion_lm_loss(llm_params, llm_config, fusion: Params, kind: str,
                   batch: Dict[str, torch.Tensor], sig_id: int, *, encoders: Dict[str, Any],
                   lora=None, dropout_generator: Optional[torch.Generator] = None,
                   remat: str = "none", chunked_loss: bool = False, rows=None,
                   count=None) -> torch.Tensor:
    """Stage-2 training loss: the splice, then the causal LM on
    ``inputs_embeds``, its cross entropy through ``lm_loss_from_hidden``
    (or ``chunked_lm_loss``).  ``dropout_generator``, ``remat`` and
    ``rows`` as in ``transformer.forward``; ``count`` the global batch's
    labelled tokens (``--dis``: :func:`label_count` summed over the
    ranks), over which the loss is this batch's sum."""
    sig_embed = encoder_embedding(kind, fusion, batch, **encoders)
    token_ids = batch["tokenized_signal"]
    adapted = adapt_sequence(
        sig_embed, llm_params["embed"][token_ids], token_ids,
        batch["attn_mask"].to(torch.int32), batch["quantized_signal_ids_input"],
        batch["position_ids"], sig_id=sig_id,
    )
    hidden = T.forward(
        llm_params, llm_config, None, adapted["attn_mask"], adapted["position_ids"],
        inputs_embeds=adapted["combined_embeds"], lora=lora,
        dropout_generator=dropout_generator, remat=remat, return_hidden=True, rows=rows,
    )
    loss_fn = T.chunked_lm_loss if chunked_loss else T.lm_loss_from_hidden
    return loss_fn(llm_params, llm_config, hidden, adapted["labels"], count=count)


@torch.inference_mode()
def fusion_generate(llm_params, llm_config, fusion: Params, kind: str,
                    batch: Dict[str, torch.Tensor], sig_id: int, *, encoders: Dict[str, Any],
                    lora=None, max_new_tokens: int = 128, eos_token_id: int = -1,
                    pad_token_id: int = 0, int8_kv: bool = False,
                    stats: Optional[dict] = None) -> torch.Tensor:
    """Stage-2 greedy decode: the prompt ``tokenized_signal2`` consumed as
    spliced embeddings, the continuation as ids.  Returns the (B,
    max_new_tokens) new tokens, as ``infer.greedy_generate``."""
    from ecg_byte_tpu_torch.infer.decode import greedy_generate

    sig_embed = encoder_embedding(kind, fusion, batch, **encoders)
    token_ids = batch["tokenized_signal2"]
    adapted = adapt_sequence(sig_embed, llm_params["embed"][token_ids], token_ids,
                             batch["attn_mask2"].to(torch.int32), sig_id=sig_id)
    return greedy_generate(
        llm_params, llm_config, None, adapted["attn_mask"],
        inputs_embeds=adapted["combined_embeds"], lora=lora, max_new_tokens=max_new_tokens,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id, int8_kv=int8_kv, stats=stats,
    )
