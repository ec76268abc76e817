"""BERT encoder over plain tensors, for local BERTScore.

The port of ``BertConfig``, ``bert_forward`` and ``load_hf_bert`` of
``ecg_byte_tpu/models/bert.py``: a post-LN BERT (word + position + type
embeddings with LayerNorm; blocks x = LN(x + attn), x = LN(x + mlp); a tanh
pooler over [CLS]) whose weights load from a local HF checkpoint
(``bert.``-prefixed keys or not).  Weights keep PyTorch's ``(out, in)``
layout and q, k, v are fused into one ``(3H, H)`` product.

Numerics are the JAX package's: LayerNorm with the population variance,
exact-erf GELU, and bidirectional attention as its XLA ``full_attention``:
scaled scores, masked keys filled with the finite ``-1e30``, the softmax in
f32 cast back to the activations' dtype.  Plain PyTorch ops, no fused
attention call.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def full_attention(q, k, v, pad_mask=None):
    """Bidirectional attention, q/k/v (B, S, H, D) -> (B, S, H, D)."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d ** -0.5)
    if pad_mask is not None:
        key_ok = pad_mask[:, None, None, :].bool()
        logits = logits + torch.where(key_ok, 0.0, _NEG_INF).to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def bert_forward(
    params: Params,
    config: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    return_all_layers: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (last_hidden (B, S, H), pooler_output (B, H)).

    ``return_all_layers=True`` returns ((L+1, B, S, H) hidden states, the
    embedding output first, pooler_output): BERTScore takes an intermediate
    layer (``utils/bertscore.py``).
    """
    c = config
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=input_ids.device)
    x = (params["word_embed"][input_ids] + params["pos_embed"][:s][None]
         + params["type_embed"][0][None, None])
    x = _ln(x, params["embed_ln"], params["embed_ln_b"], c.norm_eps)
    states = [x]
    heads, d = c.num_heads, c.hidden_size // c.num_heads
    for lp in params["layers"]:
        q, k, v = F.linear(x, lp["qkv"], lp["qkv_b"]).chunk(3, dim=-1)
        attn = full_attention(q.reshape(b, s, heads, d), k.reshape(b, s, heads, d),
                              v.reshape(b, s, heads, d), attention_mask)
        attn = attn.reshape(b, s, c.hidden_size)
        x = _ln(x + F.linear(attn, lp["out"], lp["out_b"]), lp["attn_ln"], lp["attn_ln_b"],
                c.norm_eps)
        h = F.gelu(F.linear(x, lp["fc1"], lp["fc1_b"]))
        x = _ln(x + F.linear(h, lp["fc2"], lp["fc2_b"]), lp["mlp_ln"], lp["mlp_ln_b"],
                c.norm_eps)
        states.append(x)
    pooled = torch.tanh(F.linear(x[:, 0], params["pooler_w"], params["pooler_b"]))
    if return_all_layers:
        return torch.stack(states), pooled
    return x, pooled


def load_hf_bert(model_dir: str, device=None) -> Tuple[Params, BertConfig]:
    """A local HF BERT checkpoint -> (f32 params on ``device``, default the
    CUDA card; config)."""
    from ecg_byte_tpu_torch.models.hf_loader import load_safetensors

    device = torch.device("cuda" if device is None else device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    config = BertConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        norm_eps=hf.get("layer_norm_eps", 1e-12),
    )
    t = load_safetensors(model_dir)

    def g(key):
        w = t[key] if key in t else t["bert." + key]
        return w.to(device=device, dtype=torch.float32, copy=True)

    layers = []
    for i in range(config.num_layers):
        p = f"encoder.layer.{i}."
        qkv = [p + f"attention.self.{n}." for n in ("query", "key", "value")]
        layers.append({
            "qkv": torch.cat([g(k + "weight") for k in qkv], 0),
            "qkv_b": torch.cat([g(k + "bias") for k in qkv], 0),
            "out": g(p + "attention.output.dense.weight"),
            "out_b": g(p + "attention.output.dense.bias"),
            "attn_ln": g(p + "attention.output.LayerNorm.weight"),
            "attn_ln_b": g(p + "attention.output.LayerNorm.bias"),
            "fc1": g(p + "intermediate.dense.weight"),
            "fc1_b": g(p + "intermediate.dense.bias"),
            "fc2": g(p + "output.dense.weight"),
            "fc2_b": g(p + "output.dense.bias"),
            "mlp_ln": g(p + "output.LayerNorm.weight"),
            "mlp_ln_b": g(p + "output.LayerNorm.bias"),
        })
    params = {
        "word_embed": g("embeddings.word_embeddings.weight"),
        "pos_embed": g("embeddings.position_embeddings.weight"),
        "type_embed": g("embeddings.token_type_embeddings.weight"),
        "embed_ln": g("embeddings.LayerNorm.weight"),
        "embed_ln_b": g("embeddings.LayerNorm.bias"),
        "layers": layers,
        "pooler_w": g("pooler.dense.weight"),
        "pooler_b": g("pooler.dense.bias"),
    }
    return params, config


class BertTextEncoder:
    """A frozen text encoder over a loaded BERT: ``(input_ids,
    attention_mask) -> pooler_output (B, H)`` on the parameters' device.
    ``tokenizer`` is the checkpoint's own WordPiece tokenizer (or None)."""

    def __init__(self, params: Params, config: BertConfig, tokenizer=None):
        self.params = params
        self.config = config
        self.tokenizer = tokenizer

    @torch.no_grad()
    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        dev = self.params["word_embed"].device
        ids = torch.as_tensor(input_ids, device=dev).long()
        mask = torch.as_tensor(attention_mask, device=dev).to(torch.int32)
        return bert_forward(self.params, self.config, ids, mask)[1]
