"""The Marian encoder-decoder (opus-mt) of the report translation, in f32.

The port of ``ecg_byte_tpu/models/marian.py``: plain functions on a
parameter dict of tensors, on any device.  The architecture of HF
``MarianMTModel``:

  - shared embeddings scaled by sqrt(d_model), static sinusoidal position
    embeddings in the Bart/Marian layout (sin of the even columns in the
    first half, cos of the odd ones in the second, no offset);
  - post-LayerNorm encoder layers (residual, add, LN), decoder layers with
    causal self-attention and cross-attention over the encoder output;
  - logits = hidden . shared^T + final_logits_bias.

Linear weights are stored ``(out, in)``, as HF stores them, for
``F.linear``.  Attention and LayerNorm are plain PyTorch, as the JAX
package leaves them to XLA (no Pallas kernel): f32 logits, masked with the
finite ``-1e30``, softmax, P.V.

:func:`greedy_generate` is ``_greedy_impl``'s loop: the encoder and every
layer's cross K/V once, then one decode step a token over a self-attention
KV cache of ``max_length`` rows.  The host reads the stop flag only every
:data:`STOP_CHECK` steps: a row that is done emits the pad token, so the
steps run past the last row's end leave the output as it was.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]
NEG_INF = -1e30
STOP_CHECK = 16  # decode steps between two reads of the stop flag on the host


@dataclass(frozen=True)
class MarianConfig:
    vocab_size: int
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    activation: str = "swish"
    max_position_embeddings: int = 512
    pad_token_id: int = 58100
    eos_token_id: int = 0
    decoder_start_token_id: int = 58100
    scale_embedding: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def config_from_hf(hf: dict) -> MarianConfig:
    return MarianConfig(
        vocab_size=hf["vocab_size"],
        d_model=hf.get("d_model", 512),
        encoder_layers=hf.get("encoder_layers", 6),
        decoder_layers=hf.get("decoder_layers", 6),
        num_heads=hf.get("encoder_attention_heads", 8),
        ffn_dim=hf.get("encoder_ffn_dim", 2048),
        activation=hf.get("activation_function", "swish"),
        max_position_embeddings=hf.get("max_position_embeddings", 512),
        pad_token_id=hf.get("pad_token_id", 58100),
        eos_token_id=hf.get("eos_token_id", 0),
        decoder_start_token_id=hf.get("decoder_start_token_id", hf.get("pad_token_id", 58100)),
        scale_embedding=hf.get("scale_embedding", True),
    )


def config_to_hf(config: MarianConfig) -> dict:
    """The ``config.json`` keys :func:`config_from_hf` reads, with HF's
    names for both stacks."""
    c = config
    return {
        "model_type": "marian", "architectures": ["MarianMTModel"],
        "vocab_size": c.vocab_size, "d_model": c.d_model,
        "encoder_layers": c.encoder_layers, "decoder_layers": c.decoder_layers,
        "encoder_attention_heads": c.num_heads, "decoder_attention_heads": c.num_heads,
        "encoder_ffn_dim": c.ffn_dim, "decoder_ffn_dim": c.ffn_dim,
        "activation_function": c.activation,
        "max_position_embeddings": c.max_position_embeddings,
        "pad_token_id": c.pad_token_id, "eos_token_id": c.eos_token_id,
        "decoder_start_token_id": c.decoder_start_token_id,
        "scale_embedding": c.scale_embedding, "static_position_embeddings": True,
        "share_encoder_decoder_embeddings": True,
    }


def sinusoidal_positions(n_pos: int, dim: int) -> np.ndarray:
    """MarianSinusoidalPositionalEmbedding's weight: the sin block, then the
    cos block (float64 on the host, rounded once to f32)."""
    pos = np.arange(n_pos, dtype=np.float64)[:, None]
    j = np.arange(dim, dtype=np.float64)[None, :]
    enc = pos / np.power(10000.0, 2.0 * (j // 2) / dim)
    out = np.zeros((n_pos, dim), np.float32)
    half = dim // 2
    out[:, :half] = np.sin(enc[:, 0::2])
    out[:, half:] = np.cos(enc[:, 1::2])
    return out


def _act(x, kind: str):
    if kind in ("swish", "silu"):
        return F.silu(x)
    if kind == "relu":
        return F.relu(x)
    if kind in ("gelu", "gelu_new"):
        return F.gelu(x, approximate="tanh" if kind == "gelu_new" else "none")
    raise NotImplementedError(f"activation {kind!r}")


def _ln(x, p):
    """LayerNorm in f32: biased variance, eps 1e-5."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * p["w"] + p["b"]).to(x.dtype)


def _dense(x, p):
    return F.linear(x, p["w"], p["b"])


def _split_heads(x, n_heads):
    b, s, d = x.shape
    return x.view(b, s, n_heads, d // n_heads)


def _attention(q, k, v, bias):
    """q (B, Sq, H, D), k/v (B, Sk, H, D), bias broadcastable to (B, H, Sq, Sk)."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q * d**-0.5, k).float() + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    b, s, h, dd = out.shape
    return out.reshape(b, s, h * dd)


def _mha(x, kv, p, n_heads, bias):
    q = _split_heads(_dense(x, p["q"]), n_heads)
    k = _split_heads(_dense(kv, p["k"]), n_heads)
    v = _split_heads(_dense(kv, p["v"]), n_heads)
    return _dense(_attention(q, k, v, bias), p["o"])


def _ffn(x, p, activation):
    return _dense(_act(_dense(x, p["fc1"]), activation), p["fc2"])


def _scale(config: MarianConfig) -> float:
    return float(np.sqrt(config.d_model).astype(np.float32)) if config.scale_embedding else 1.0


def _embed(params, config: MarianConfig, ids, pos_start=0):
    h = params["shared"][ids] * _scale(config)
    s = ids.shape[1]
    return h + params["positions"][pos_start: pos_start + s][None]


def _key_bias(mask):
    """(B, S) 1/0 key mask -> (B, 1, 1, S) additive f32 bias."""
    return torch.where(mask[:, None, None, :].bool(), 0.0, NEG_INF).float()


def encode(params: Params, config: MarianConfig, src_ids, src_mask):
    """Encoder forward -> (B, S, D) hidden states."""
    h = _embed(params, config, src_ids)
    bias = _key_bias(src_mask)
    for layer in params["encoder"]:
        h = _ln(h + _mha(h, h, layer["self"], config.num_heads, bias), layer["self_ln"])
        h = _ln(h + _ffn(h, layer, config.activation), layer["final_ln"])
    return h


def _decoder_layer(h, layer, config, self_bias, cross_kv, cross_bias, self_kv=None):
    """One decoder layer; ``self_kv=(k, v)`` are the (cached) self-attention
    keys and values that ``self_bias`` masks."""
    n = config.num_heads
    q = _split_heads(_dense(h, layer["self"]["q"]), n)
    if self_kv is None:
        k = _split_heads(_dense(h, layer["self"]["k"]), n)
        v = _split_heads(_dense(h, layer["self"]["v"]), n)
    else:
        k, v = self_kv
    attn = _dense(_attention(q, k, v, self_bias), layer["self"]["o"])
    h = _ln(h + attn, layer["self_ln"])
    ck, cv = cross_kv
    q = _split_heads(_dense(h, layer["cross"]["q"]), n)
    cross = _dense(_attention(q, ck, cv, cross_bias), layer["cross"]["o"])
    h = _ln(h + cross, layer["cross_ln"])
    return _ln(h + _ffn(h, layer, config.activation), layer["final_ln"])


def _cross_kv(params, config, enc_h):
    return [
        (_split_heads(_dense(enc_h, layer["cross"]["k"]), config.num_heads),
         _split_heads(_dense(enc_h, layer["cross"]["v"]), config.num_heads))
        for layer in params["decoder"]
    ]


def _logits(params, h):
    return (F.linear(h, params["shared"]) + params["final_logits_bias"]).float()


def forward(params: Params, config: MarianConfig, src_ids, src_mask, tgt_ids):
    """Teacher-forced seq2seq forward -> f32 logits (B, St, V)."""
    enc_h = encode(params, config, src_ids, src_mask)
    cross_bias = _key_bias(src_mask)
    st = tgt_ids.shape[1]
    causal = torch.ones((st, st), dtype=torch.bool, device=tgt_ids.device).tril()
    self_bias = torch.where(causal[None, None], 0.0, NEG_INF).float()
    h = _embed(params, config, tgt_ids)
    for layer, ckv in zip(params["decoder"], _cross_kv(params, config, enc_h)):
        h = _decoder_layer(h, layer, config, self_bias, ckv, cross_bias)
    return _logits(params, h)


@torch.no_grad()
def greedy_generate(params: Params, config: MarianConfig, src_ids, src_mask,
                    max_length: int = 128, stats: Optional[dict] = None) -> torch.Tensor:
    """HF ``generate(max_length=..., num_beams=1)``: start at
    ``decoder_start_token_id``, greedy argmax with the pad token banned,
    each row stopping at eos, then pads; the start token is kept.  Returns
    (B, max_length) int32 on the parameters' device.  ``stats`` (a dict)
    receives the decode steps run."""
    c = config
    dev = params["shared"].device
    src_ids = torch.as_tensor(src_ids).to(dev, torch.long)
    src_mask = torch.as_tensor(src_mask).to(dev, torch.int32)
    b = src_ids.shape[0]
    enc_h = encode(params, c, src_ids, src_mask)
    cross_bias = _key_bias(src_mask)
    kvs = _cross_kv(params, c, enc_h)
    nh, hd = c.num_heads, c.head_dim
    k_cache = torch.zeros((c.decoder_layers, b, max_length, nh, hd), dtype=torch.float32,
                          device=dev)
    v_cache = torch.zeros_like(k_cache)
    tokens = torch.full((b, max_length), c.pad_token_id, dtype=torch.long, device=dev)
    tokens[:, 0] = c.decoder_start_token_id
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    slots = torch.arange(max_length, device=dev)
    pad = torch.tensor(c.pad_token_id, device=dev)
    steps = 0
    for i in range(max_length - 1):
        if i % STOP_CHECK == 0 and i and bool(done.all()):
            break
        # the position row clamped to the table, as JAX's dynamic slice reads it
        h = _embed(params, c, tokens[:, i: i + 1], pos_start=min(i, c.max_position_embeddings - 1))
        self_bias = torch.where(slots <= i, 0.0, NEG_INF).float()[None, None, None, :]
        for li, (layer, ckv) in enumerate(zip(params["decoder"], kvs)):
            k_cache[li, :, i] = _dense(h, layer["self"]["k"])[:, 0].view(b, nh, hd)
            v_cache[li, :, i] = _dense(h, layer["self"]["v"])[:, 0].view(b, nh, hd)
            h = _decoder_layer(h, layer, c, self_bias, ckv, cross_bias,
                               self_kv=(k_cache[li], v_cache[li]))
        logits = _logits(params, h[:, 0])
        # HF Marian bans the pad token from generation (bad_words_ids)
        logits[:, c.pad_token_id] = -math.inf
        nxt = torch.where(done, pad, logits.argmax(dim=-1))
        tokens[:, i + 1] = nxt
        done |= nxt == c.eos_token_id
        steps += 1
    if stats is not None:
        stats["steps"] = steps
    return tokens.to(torch.int32)


# ---------------------------------------------------------------------------
# HF checkpoints


def _prefix_dense(prefix):
    return {"w": f"{prefix}.weight", "b": f"{prefix}.bias"}


def _layer_names(kind: str, i: int) -> dict:
    """Parameter tree of encoder or decoder layer ``i`` -> HF tensor names
    (without the ``model.`` prefix)."""
    p = f"{kind}.layers.{i}"
    names = {
        "self": {k: _prefix_dense(f"{p}.self_attn.{n}")
                 for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                              ("o", "out_proj"))},
        "self_ln": _prefix_dense(f"{p}.self_attn_layer_norm"),
        "fc1": _prefix_dense(f"{p}.fc1"),
        "fc2": _prefix_dense(f"{p}.fc2"),
        "final_ln": _prefix_dense(f"{p}.final_layer_norm"),
    }
    if kind == "decoder":
        names["cross"] = {k: _prefix_dense(f"{p}.encoder_attn.{n}")
                          for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                       ("o", "out_proj"))}
        names["cross_ln"] = _prefix_dense(f"{p}.encoder_attn_layer_norm")
    return names


def _map_names(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_names(v, fn) for k, v in tree.items()}
    return fn(tree)


def load_hf_marian(model_dir: str, device=None) -> Tuple[Params, MarianConfig]:
    """A local HF MarianMT checkpoint (``config.json`` and ``*.safetensors``,
    read by ``models/hf_loader.load_safetensors``) as f32 parameters on
    ``device`` (default the CPU)."""
    from ecg_byte_tpu_torch.models.hf_loader import load_safetensors

    with open(os.path.join(model_dir, "config.json")) as f:
        config = config_from_hf(json.load(f))
    t = load_safetensors(model_dir)
    device = torch.device(device or "cpu")

    def g(name):
        for key in (name, f"model.{name}"):
            if key in t:
                return t[key].to(device=device, dtype=torch.float32, copy=True)
        raise KeyError(name)

    try:
        bias = g("final_logits_bias").reshape(-1)
    except KeyError:
        bias = torch.zeros((config.vocab_size,), dtype=torch.float32, device=device)
    params: Params = {
        "shared": g("shared.weight"),
        "positions": torch.from_numpy(
            sinusoidal_positions(config.max_position_embeddings, config.d_model)).to(device),
        "encoder": [_map_names(_layer_names("encoder", i), g)
                    for i in range(config.encoder_layers)],
        "decoder": [_map_names(_layer_names("decoder", i), g)
                    for i in range(config.decoder_layers)],
        "final_logits_bias": bias,
    }
    return params, config


def init_params(config: MarianConfig, generator: torch.Generator, device=None,
                std: float = 0.02) -> Params:
    """Random f32 parameters of ``config``'s shapes (normal with ``std``;
    LayerNorms at weight 1, bias 0), from ``generator``."""
    c = config
    device = torch.device(device or "cpu")

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device) * std

    def dense(out_dim, in_dim):
        return {"w": normal(out_dim, in_dim), "b": normal(out_dim)}

    def ln():
        return {"w": torch.ones(c.d_model, device=device),
                "b": torch.zeros(c.d_model, device=device)}

    def attn():
        return {k: dense(c.d_model, c.d_model) for k in ("q", "k", "v", "o")}

    def layer(cross):
        out = {"self": attn(), "self_ln": ln(), "fc1": dense(c.ffn_dim, c.d_model),
               "fc2": dense(c.d_model, c.ffn_dim), "final_ln": ln()}
        if cross:
            out["cross"] = attn()
            out["cross_ln"] = ln()
        return out

    return {
        "shared": normal(c.vocab_size, c.d_model),
        "positions": torch.from_numpy(
            sinusoidal_positions(c.max_position_embeddings, c.d_model)).to(device),
        "encoder": [layer(False) for _ in range(c.encoder_layers)],
        "decoder": [layer(True) for _ in range(c.decoder_layers)],
        "final_logits_bias": normal(c.vocab_size),
    }


def save_hf_marian(params: Params, config: MarianConfig, model_dir: str) -> int:
    """Write ``params`` as a HF MarianMT directory (``config.json`` and one
    ``model.safetensors`` under HF's names, ``final_logits_bias`` (1, V));
    returns the bytes of tensor data written."""
    from ecg_byte_tpu_torch.models.hf_loader import save_safetensors

    os.makedirs(model_dir, exist_ok=True)
    tensors = {"model.shared.weight": params["shared"]}
    for kind in ("encoder", "decoder"):
        for i, layer in enumerate(params[kind]):
            names = _layer_names(kind, i)

            def put(tree, name_tree):
                for k, v in name_tree.items():
                    if isinstance(v, dict):
                        put(tree[k], v)
                    else:
                        tensors[f"model.{v}"] = tree[k]

            put(layer, names)
    tensors["final_logits_bias"] = params["final_logits_bias"].reshape(1, -1)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config_to_hf(config), f)
    return save_safetensors(tensors, os.path.join(model_dir, "model.safetensors"))
