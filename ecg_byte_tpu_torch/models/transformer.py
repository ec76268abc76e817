"""Causal-LM transformer for Llama-3.2 / Gemma / GPT-2: forward, prefill and
KV-cache decode.

The port of ``ecg_byte_tpu/models/transformer.py``.  Parameters are a plain
dict of tensors: ``embed``, ``final_norm`` (+ ``final_norm_bias``,
``pos_embed``, ``lm_head`` where the config has them) and ``layers``, a list
with one dict per layer.  Projections keep PyTorch's ``(out, in)`` weight
layout (``{"weight", "bias"}``, applied with ``F.linear``); the JAX package
stacks layers on axis 0 and stores ``(in, out)`` kernels, and
``models/convert.params_from_jax`` carries weights across.  Layers run in a
Python loop where the JAX package scans.

Numerics follow the JAX code: norms and RoPE in f32 and cast back, logits
returned in f32, masked attention logits filled with the finite ``-1e30``.
RMSNorm goes through the Triton kernel, prefill attention and decode
attention through the CUDA kernels (plain PyTorch on the CPU).

The KV cache is updated in place: prefill writes slots ``[0, S)``, each
decode step writes its row at ``write_idx`` before the decode kernel reads
the cache.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.models.config import TransformerConfig
from ecg_byte_tpu_torch.ops import attention, attention_decode, rmsnorm

Params = Dict[str, Any]


def _dtype(config: TransformerConfig) -> torch.dtype:
    return getattr(torch, config.dtype)


# ---------------------------------------------------------------------------
# Initialization


def init_params(
    config: TransformerConfig,
    generator: torch.Generator,
    device: torch.device,
) -> Params:
    """Random-init parameters: normal(0.02) dense weights, unit norms, zero
    biases.  ``generator`` must live on ``device``."""
    c = config
    dt = _dtype(c)

    def dense(out_dim, in_dim, scale=0.02):
        w = torch.randn(out_dim, in_dim, generator=generator, device=device)
        return (w * scale).to(dt)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=device)

    gated = c.hidden_act in ("silu", "gelu_tanh")  # llama / gemma
    shapes = {
        "q_proj": (c.qkv_dim, c.hidden_size),
        "k_proj": (c.kv_dim, c.hidden_size),
        "v_proj": (c.kv_dim, c.hidden_size),
        "o_proj": (c.hidden_size, c.qkv_dim),
        "up_proj": (c.intermediate_size, c.hidden_size),
        "down_proj": (c.hidden_size, c.intermediate_size),
    }
    if gated:
        shapes["gate_proj"] = (c.intermediate_size, c.hidden_size)
    layers = []
    for _ in range(c.num_layers):
        layer: Params = {"attn_norm": ones(c.hidden_size), "mlp_norm": ones(c.hidden_size)}
        for name, (out_dim, in_dim) in shapes.items():
            layer[name] = {"weight": dense(out_dim, in_dim)}
            if c.use_bias:
                layer[name]["bias"] = zeros(out_dim)
        if c.use_bias:
            layer["attn_norm_bias"] = zeros(c.hidden_size)
            layer["mlp_norm_bias"] = zeros(c.hidden_size)
        layers.append(layer)

    params: Params = {
        "embed": dense(c.vocab_size, c.hidden_size),
        "layers": layers,
        "final_norm": ones(c.hidden_size),
    }
    if c.use_bias:
        params["final_norm_bias"] = zeros(c.hidden_size)
    if c.learned_pos_embeddings:
        params["pos_embed"] = dense(c.max_position_embeddings, c.hidden_size)
    if not c.tie_word_embeddings:
        params["lm_head"] = dense(c.vocab_size, c.hidden_size)
    return params


def resize_embeddings(
    params: Params, config: TransformerConfig, new_vocab_size: int
) -> Tuple[Params, TransformerConfig]:
    """Grow the embedding (and untied head) to ``new_vocab_size`` with new
    rows set to the mean of the existing rows (HF mean-resizing)."""
    old = params["embed"]
    n_new = new_vocab_size - old.shape[0]
    if n_new <= 0:
        return params, config
    params = dict(params)
    for name in ("embed", "lm_head"):
        if name in params:
            w = params[name]
            mean_row = w.float().mean(0, keepdim=True).to(w.dtype)
            params[name] = torch.cat([w, mean_row.expand(n_new, -1)], 0)
    return params, config.replace(vocab_size=new_vocab_size)


# ---------------------------------------------------------------------------
# Building blocks


def _norm(x, weight, bias, config: TransformerConfig):
    """LayerNorm (gpt2) or RMSNorm, statistics in f32, output in x's dtype."""
    eps = config.norm_eps
    if config.arch == "gpt2":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * weight.float()
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)
    w = weight.float()
    if config.rmsnorm_unit_offset:  # gemma: scale by (1 + w)
        w = 1.0 + w
    return rmsnorm.rmsnorm(x, w, eps)


def rope_inv_freq(config: TransformerConfig, d: int) -> np.ndarray:
    """Inverse RoPE frequencies with HF rope_scaling parity (default,
    'linear', 'llama3').  The numpy code of the JAX package, so the
    frequencies are bit-identical."""
    inv = 1.0 / (
        config.rope_theta ** (np.arange(0, d, 2, dtype=np.float32) / d)
    )
    t = config.rope_scaling_type
    if t in (None, "default"):
        return inv
    if t == "linear":
        return inv / config.rope_scaling_factor
    if t == "llama3":
        factor = config.rope_scaling_factor
        low = config.rope_low_freq_factor
        high = config.rope_high_freq_factor
        old_len = config.rope_original_max_position
        low_wavelen = old_len / low
        high_wavelen = old_len / high
        wavelen = 2 * np.pi / inv
        # long wavelengths (low freq): divide by factor; short: unchanged
        inv_l = np.where(wavelen > low_wavelen, inv / factor, inv)
        # medium band: smooth interpolation between the two
        smooth = (old_len / wavelen - low) / (high - low)
        smoothed = (1 - smooth) * inv_l / factor + smooth * inv_l
        is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        return np.where(is_medium, smoothed, inv_l).astype(np.float32)
    raise NotImplementedError(f"rope_scaling type {t!r}")


def _rope_tables(positions: torch.Tensor, config: TransformerConfig, d: int):
    """cos/sin tables (B, S, 1, D/2) f32, computed once per forward."""
    inv_freq = torch.from_numpy(np.asarray(rope_inv_freq(config, d), np.float32))
    angles = positions[..., None].float() * inv_freq.to(positions.device)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rope(x, cos, sin):
    """Rotary embedding, HF rotate-half convention, in f32.  x: (B, S, H, D)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    # gemma 'gelu_tanh' and gpt2 'gelu_new' are both tanh-approximated gelu
    return F.gelu(x, approximate="tanh")


def _linear(x, p):
    return F.linear(x, p["weight"], p.get("bias"))


def _block(config: TransformerConfig, h, layer_p: Params, rope, attn_fn):
    """One transformer block; ``attn_fn(q, k, v) -> (B, S, H, D)``."""
    c = config
    b, s, _ = h.shape
    hn = _norm(h, layer_p["attn_norm"], layer_p.get("attn_norm_bias"), c)
    q = _linear(hn, layer_p["q_proj"]).view(b, s, c.num_heads, c.head_dim)
    k = _linear(hn, layer_p["k_proj"]).view(b, s, c.num_kv_heads, c.head_dim)
    v = _linear(hn, layer_p["v_proj"]).view(b, s, c.num_kv_heads, c.head_dim)
    if rope is not None:
        q = _apply_rope(q, *rope)
        k = _apply_rope(k, *rope)
    attn = attn_fn(q, k, v).reshape(b, s, c.qkv_dim)
    h = h + _linear(attn, layer_p["o_proj"])

    hn = _norm(h, layer_p["mlp_norm"], layer_p.get("mlp_norm_bias"), c)
    if "gate_proj" in layer_p:
        inner = _act(_linear(hn, layer_p["gate_proj"]), c.hidden_act) * _linear(
            hn, layer_p["up_proj"]
        )
    else:
        inner = _act(_linear(hn, layer_p["up_proj"]), c.hidden_act)
    return h + _linear(inner, layer_p["down_proj"])


def _embed(params, config: TransformerConfig, input_ids, positions):
    h = params["embed"][input_ids]
    if config.embed_scale:
        h = h * torch.tensor(math.sqrt(config.hidden_size), dtype=h.dtype)
    if config.learned_pos_embeddings:
        h = h + params["pos_embed"][positions]
    return h


def _unembed(params, config: TransformerConfig, h):
    hn = _norm(h, params["final_norm"], params.get("final_norm_bias"), config)
    head = params["embed"] if config.tie_word_embeddings else params["lm_head"]
    return F.linear(hn, head).float()


def _rope_for(config: TransformerConfig, positions):
    if config.learned_pos_embeddings:
        return None
    return _rope_tables(positions, config, config.head_dim)


# ---------------------------------------------------------------------------
# Public forward


def make_position_ids(attn_mask: torch.Tensor) -> torch.Tensor:
    """cumsum-over-valid minus one, pads pinned to 0."""
    mask = attn_mask.to(torch.int32)
    pos = torch.cumsum(mask, dim=-1, dtype=torch.int32) - 1
    return torch.where(mask == 0, 0, pos)


def forward(
    params: Params,
    config: TransformerConfig,
    input_ids: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal LM forward pass -> float32 logits (B, S, V).

    ``attn_mask``: (B, S) 1/0 validity (left pads are 0).
    ``position_ids``: (B, S); defaults to the cumsum convention.
    """
    c = config
    if attn_mask is None:
        attn_mask = torch.ones(input_ids.shape, dtype=torch.int32, device=input_ids.device)
    attn_mask = attn_mask.to(torch.int32).contiguous()
    if position_ids is None:
        position_ids = make_position_ids(attn_mask)
    h = _embed(params, c, input_ids, position_ids)
    rope = _rope_for(c, position_ids)

    def attn_fn(q, k, v):
        return attention.causal_attention(q, k, v, attn_mask)

    for layer_p in params["layers"]:
        h = _block(c, h, layer_p, rope, attn_fn)
    return _unembed(params, c, h)


# ---------------------------------------------------------------------------
# KV-cache decode


def init_kv_cache(
    config: TransformerConfig, batch: int, max_len: int, device: torch.device
) -> Params:
    """KV cache ``{"k", "v"}`` of (L, B, S_max, KH, D) in the model dtype;
    layer ``i`` reads the contiguous slice ``cache["k"][i]``."""
    shape = (config.num_layers, batch, max_len, config.num_kv_heads, config.head_dim)
    dt = _dtype(config)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def prefill(
    params: Params,
    config: TransformerConfig,
    input_ids: torch.Tensor,
    attn_mask: torch.Tensor,
    cache: Params,
    position_ids: Optional[torch.Tensor] = None,
):
    """Run the prompt, filling cache slots [0, S) in place.

    Returns (last-position logits (B, V) f32, cache, next_positions (B,)).
    """
    c = config
    attn_mask = attn_mask.to(torch.int32).contiguous()
    if position_ids is None:
        position_ids = make_position_ids(attn_mask)
    s = input_ids.shape[1]
    h = _embed(params, c, input_ids, position_ids)
    rope = _rope_for(c, position_ids)
    for i, layer_p in enumerate(params["layers"]):

        def attn_fn(q, k, v, i=i):
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            return attention.causal_attention(q, k, v, attn_mask)

        h = _block(c, h, layer_p, rope, attn_fn)
    logits = _unembed(params, c, h[:, -1:].contiguous())[:, 0]
    next_pos = make_position_ids(attn_mask).max(dim=-1).values + 1
    return logits, cache, next_pos


def decode_step(
    params: Params,
    config: TransformerConfig,
    token: torch.Tensor,  # (B,) int
    positions: torch.Tensor,  # (B,) rope/absolute position of this token
    write_idx: int,  # cache slot to write
    cache: Params,
    cache_mask: torch.Tensor,  # (B, S_max) int32, valid slots incl. this one
):
    """One decode step.  Appends this token's K/V rows to the cache in place;
    returns (logits (B, V) f32, cache)."""
    c = config
    pos2d = positions[:, None]
    h = _embed(params, c, token[:, None], pos2d)
    rope = _rope_for(c, pos2d)
    for i, layer_p in enumerate(params["layers"]):

        def attn_fn(q, k, v, i=i):
            cache["k"][i, :, write_idx] = k[:, 0]
            cache["v"][i, :, write_idx] = v[:, 0]
            return attention_decode.decode_attention_fused(
                q, cache["k"][i], cache["v"][i], cache_mask
            )

        h = _block(c, h, layer_p, rope, attn_fn)
    return _unembed(params, c, h)[:, 0], cache
