"""Causal-LM transformer for Llama-3.2 / Gemma / GPT-2: forward with LoRA,
the training losses, prefill and KV-cache decode.

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
RMSNorm goes through the Triton kernels (forward and backward), prefill
attention through the CUDA kernels (forward and backward), decode attention
through its CUDA kernel; on the CPU each takes its plain PyTorch version.

LoRA (``models/lora.py`` trees) overlays the projections as in the JAX
``_proj`` / ``_proj_group``: the A-products of a group that shares its input
(q/k/v, gate/up) run as one product against the concatenated A, with one
dropout mask per group.  Dropout masks come from a ``torch.Generator``, so
their bits differ from JAX's ``fold_in(rng, hash(name))`` stream.

The KV cache is updated in place: prefill writes slots ``[0, S)``, each
decode step writes its row at ``write_idx`` before the decode kernel reads
the cache.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

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
    return rmsnorm.RMSNorm.apply(x.contiguous(), w, eps)


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


class _Dropout:
    """Inverted LoRA dropout for one layer, from its own device generator
    seeded with ``seed`` (None or a zero rate: no dropout)."""

    def __init__(self, config: TransformerConfig, seed: Optional[int], device):
        self.rate = config.lora_dropout
        self.style = config.lora_dropout_style
        self.gen = None
        if seed is not None and self.rate > 0.0:
            self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, x):
        if self.gen is None:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def _lora_out(xa, b, config: TransformerConfig):
    return (xa @ b) * (config.lora_alpha / config.lora_rank)


def _proj(x, layer_p, name, lora_p, config: TransformerConfig, drop: _Dropout):
    """Dense projection with the LoRA overlay of ``name`` if it has one."""
    y = _linear(x, layer_p[name])
    if lora_p is not None and name in lora_p:
        a, b = lora_p[name]["a"], lora_p[name]["b"]  # (in, r), (r, out)
        if drop.style == "rank":  # mask the (B, S, r) adapter activations
            xa = drop(x @ a)
        else:  # "input": HF PEFT, mask the adapter's input rows
            xa = drop(x) @ a
        y = y + _lora_out(xa, b, config)
    return y


def _proj_group(x, layer_p, names: Sequence[str], lora_p, config: TransformerConfig,
                drop: _Dropout):
    """Projections sharing input ``x``; their LoRA A-products fused into one
    product against the concatenated A, one dropout mask for the group."""
    use_lora = lora_p is not None and all(n in lora_p for n in names)
    if use_lora:
        a_cat = torch.cat([lora_p[n]["a"] for n in names], dim=-1)
        xa = drop(x @ a_cat) if drop.style == "rank" else drop(x) @ a_cat
        r = config.lora_rank
    outs = []
    for i, name in enumerate(names):
        if use_lora:
            y = _linear(x, layer_p[name])
            y = y + _lora_out(xa[..., i * r:(i + 1) * r], lora_p[name]["b"], config)
        else:
            y = _proj(x, layer_p, name, lora_p, config, drop)
        outs.append(y)
    return outs


def _block(config: TransformerConfig, h, layer_p: Params, rope, attn_fn,
           lora_p: Optional[Params] = None, drop: Optional[_Dropout] = None):
    """One transformer block; ``attn_fn(q, k, v) -> (B, S, H, D)``."""
    c = config
    drop = drop if drop is not None else _Dropout(c, None, None)
    b, s, _ = h.shape
    hn = _norm(h, layer_p["attn_norm"], layer_p.get("attn_norm_bias"), c)
    q, k, v = _proj_group(hn, layer_p, ("q_proj", "k_proj", "v_proj"), lora_p, c, drop)
    q = q.view(b, s, c.num_heads, c.head_dim)
    k = k.view(b, s, c.num_kv_heads, c.head_dim)
    v = v.view(b, s, c.num_kv_heads, c.head_dim)
    if rope is not None:
        q = _apply_rope(q, *rope)
        k = _apply_rope(k, *rope)
    attn = attn_fn(q, k, v).reshape(b, s, c.qkv_dim)
    h = h + _proj(attn, layer_p, "o_proj", lora_p, c, drop)

    hn = _norm(h, layer_p["mlp_norm"], layer_p.get("mlp_norm_bias"), c)
    if "gate_proj" in layer_p:
        gate, up = _proj_group(hn, layer_p, ("gate_proj", "up_proj"), lora_p, c, drop)
        inner = _act(gate, c.hidden_act) * up
    else:
        inner = _act(_proj(hn, layer_p, "up_proj", lora_p, c, drop), c.hidden_act)
    return h + _proj(inner, layer_p, "down_proj", lora_p, c, drop)


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
    *,
    lora: Optional[Params] = None,
    dropout_generator: Optional[torch.Generator] = None,
    return_hidden: bool = False,
    remat: str = "none",
) -> torch.Tensor:
    """Causal LM forward pass -> float32 logits (B, S, V).

    ``attn_mask``: (B, S) 1/0 validity (left pads are 0).
    ``position_ids``: (B, S); defaults to the cumsum convention.
    ``lora``: adapters (``models/lora.py``) overlaid on the projections.
    ``dropout_generator``: a CPU ``torch.Generator``; with ``lora`` and a
    non-zero ``config.lora_dropout`` it turns LoRA dropout on.  It draws one
    seed per layer on the host (no device sync), and each layer draws its
    masks from a device generator seeded with it, so a layer replayed under
    ``remat="full"`` draws the same masks.
    ``return_hidden``: return the pre-final-norm hidden states (B, S, D)
    for :func:`lm_loss_from_hidden` instead of logits.
    ``remat``: ``"none"`` keeps every activation for the backward;
    ``"full"`` keeps only each layer's input and replays the layer
    (``torch.utils.checkpoint``) in the backward.
    """
    c = config
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
    if attn_mask is None:
        attn_mask = torch.ones(input_ids.shape, dtype=torch.int32, device=input_ids.device)
    attn_mask = attn_mask.to(torch.int32).contiguous()
    if position_ids is None:
        position_ids = make_position_ids(attn_mask)
    h = _embed(params, c, input_ids, position_ids)
    rope = _rope_for(c, position_ids)

    def attn_fn(q, k, v):
        return attention.causal_attention(q, k, v, attn_mask)

    n = len(params["layers"])
    seeds = [None] * n
    if lora is not None and dropout_generator is not None and c.lora_dropout > 0.0:
        seeds = torch.randint(0, 2**62, (n,), generator=dropout_generator).tolist()
    lora_layers = lora["layers"] if lora is not None else [None] * n
    for layer_p, lora_p, seed in zip(params["layers"], lora_layers, seeds):

        def layer(h, layer_p=layer_p, lora_p=lora_p, seed=seed):
            return _block(c, h, layer_p, rope, attn_fn, lora_p, _Dropout(c, seed, h.device))

        if remat == "full" and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(layer, h, use_reentrant=False)
        else:
            h = layer(h)
    if return_hidden:
        return h
    return _unembed(params, c, h)


# ---------------------------------------------------------------------------
# Losses


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """HF CausalLM loss: shift-by-one cross entropy, -100 ignored, mean."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0).long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_ll = logp.gather(-1, safe[..., None])[..., 0]
    total = torch.where(valid, -token_ll, 0.0).sum()
    return total / valid.sum().clamp(min=1)


class _DenseCE(torch.autograd.Function):
    """Mean cross entropy over valid rows of ``h2 @ head^T``; -100 ignored.

    The port of the JAX ``_dense_ce``: the loss in f32 from f32 logits and
    their logsumexp; the (M, V) residual saved as bf16 logits centred on
    the logsumexp; the backward recomputes the probabilities from it and
    writes dlogits in h2's dtype before the dX product.  ``head`` is the
    (V, D) embedding or LM head; its gradient is computed only where it
    trains.
    """

    @staticmethod
    def forward(ctx, h2, head, labels):
        logits = F.linear(h2, head).float()  # (M, V)
        valid = labels != -100
        safe = torch.where(valid, labels, 0).long()
        m = logits.amax(dim=-1)
        lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
        lab = logits.gather(1, safe[:, None])[:, 0]
        count = valid.sum().clamp(min=1)
        loss = torch.where(valid, lse - lab, 0.0).sum() / count
        centered = (logits - lse[:, None]).to(torch.bfloat16)
        ctx.save_for_backward(h2, head, centered, safe, valid, count)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        h2, head, centered, safe, valid, count = ctx.saved_tensors
        probs = torch.exp(centered.float())
        probs[torch.arange(probs.shape[0], device=probs.device), safe] -= 1.0  # - onehot
        coeff = torch.where(valid, gbar / count.float(), 0.0)
        dlogits = (probs * coeff[:, None]).to(h2.dtype)
        del probs
        dh2 = dlogits @ head
        dhead = dlogits.T @ h2 if ctx.needs_input_grad[1] else None
        return dh2, dhead, None


def lm_loss_from_hidden(params: Params, config: TransformerConfig, hidden: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Dense HF CausalLM loss from pre-final-norm hidden states: the value
    of ``causal_lm_loss(_unembed(hidden), labels)`` with the bf16 backward
    of :class:`_DenseCE` (the final norm's gradient flows by autograd)."""
    c = config
    hn = _norm(hidden, params["final_norm"], params.get("final_norm_bias"), c)
    head = params["embed"] if c.tie_word_embeddings else params["lm_head"]
    d = hn.shape[-1]
    h2 = hn[:, :-1].reshape(-1, d)
    return _DenseCE.apply(h2, head, labels[:, 1:].reshape(-1))


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
