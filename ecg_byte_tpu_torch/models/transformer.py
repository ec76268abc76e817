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
RMSNorm goes through its CUDA kernels (forward and backward), prefill
attention through the CUDA kernels (forward and backward), decode attention
through its CUDA kernel; on the CPU each takes its plain PyTorch version.

LoRA (``models/lora.py`` trees) overlays the projections as in the JAX
``_proj`` / ``_proj_group``: the A-products of a group that shares its input
(q/k/v, gate/up) run as one product against the concatenated A, with one
dropout mask per group.  Dropout masks come from a ``torch.Generator``, so
their bits differ from JAX's ``fold_in(rng, hash(name))`` stream.

``fold_norm_scales`` is a load-time transform of a frozen base (LoRA
training, serving) for RMSNorm models: ``RMSNorm(x) W^T = s * (x (w W)^T)``
with ``s = rsqrt(mean(x^2) + eps)`` per row, so the norm's per-feature
weight ``w`` folds into the input columns of q/k/v and gate/up, and a block
of a ``norm_folded`` config feeds the raw residual stream to those
products and scales their outputs by ``s``: the normalized (B, S, D)
tensor and its backward are never made, and the two RMSNorm kernels of a
layer are not launched.  The adapters fold ``w`` into A at each call, so
they see the normalized input as on the classic path.  A folded tree is
not sharded under ``--tp`` / ``--fsdp`` (the JAX package's sharding specs
have no entry for its ``attn_norm_w`` / ``mlp_norm_w``).

The KV cache is updated in place: prefill writes slots ``[0, S)``
(``ops/kv_quant`` for the int8 cache), and each decode step hands its row
to the decode kernel with ``write_idx`` (the fresh-row contract of the JAX
``decode_step``), which writes it into the stale cache as it attends.  The
int8 serving cache (``init_kv_cache(dtype=torch.int8)``) quantizes the rows
it is given as they are written, with one bf16 scale per (position, kv
head); prefill attention still reads the fresh K/V, only the cache copy is
quantized.  An int8 serving tree (``models/quantized.py``:
``weight_q``/``weight_scale`` entries, ``lm_head_q``/``lm_head_scale``) goes
through ``ops/int8_linear``.

Under ``--tp`` (``parallel/mesh.py``) a rank holds its blocks of the tree
(``parallel/sharding.py``): q/k/v and gate/up are column-parallel and make
this rank's heads and MLP columns as contiguous tensors, o and down are
row-parallel and their outputs summed over the tp group
(``reduce_from_tp``), and the input of each column group passes through
``copy_to_tp``, so every tp rank holds the same hidden states and the same
gradients of what it holds whole.  Attention runs on the rank's H/T query
and KH/T KV heads, with no collective inside.  The embedding is a masked
lookup of this rank's vocabulary rows, summed over tp; the logits are this
rank's columns, the cross entropy and the greedy argmax reduced over tp.
Under ``--fsdp`` each layer's weights (and the embedding, for each use)
are gathered over the fsdp group (``sharding.gather_fsdp``) and the layer
runs under ``torch.utils.checkpoint``, so the gathered weights are freed
after its forward and gathered again for its backward.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.models.config import TransformerConfig
from ecg_byte_tpu_torch.ops import attention, attention_decode, int8_linear, kv_quant, rmsnorm
from ecg_byte_tpu_torch.parallel import distributed, mesh, sharding
from ecg_byte_tpu_torch.parallel.distributed import Rows, copy_to_tp, reduce_from_tp
from ecg_byte_tpu_torch.utils.profiling import span

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
    w = weight  # the kernel converts a bf16 weight in registers
    if config.rmsnorm_unit_offset:  # gemma: scale by (1 + w), the sum in f32
        w = 1.0 + weight.float()
    return rmsnorm.RMSNorm.apply(x.contiguous(), w, eps)


def _norm_scale(x, config: TransformerConfig):
    """The per-row RMSNorm scale ``rsqrt(mean(x^2) + eps)``, (B, S, 1) f32,
    of the norm-folded path."""
    return torch.rsqrt(x.float().square().mean(-1, keepdim=True) + config.norm_eps)


def fold_norm_scales(params: Params, config: TransformerConfig):
    """Fold the RMSNorm per-feature weights into the projection weights.

    The port of ``ecg_byte_tpu/models/transformer.py:141-204`` in the
    port's ``(out, in)`` layout: q/k/v take the attention norm's ``w`` and
    gate/up the MLP norm's on their input columns (``weight * w[None, :]``
    in f32, cast back; Gemma's ``w`` is ``1 + weight``); the layers keep
    ``w`` as ``attn_norm_w`` / ``mlp_norm_w`` for the adapters, and the
    norm entries become the identity (1, or 0 under the unit offset), so a
    classic block computes the same function on the folded tree.  An
    untied ``lm_head`` takes the final norm's ``w`` and ``final_norm``
    becomes the identity; a tied model keeps its final norm.

    Returns ``(params', config')`` with ``config'.norm_folded``; a GPT-2
    config or an already folded one returns ``(params, config)``
    themselves.  A load-time transform for a frozen base: checkpoints keep
    the unfolded tree."""
    if config.arch == "gpt2" or config.norm_folded:
        return params, config
    ident = 0.0 if config.rmsnorm_unit_offset else 1.0

    def w_of(norm_w):
        w = norm_w.float()
        return 1.0 + w if config.rmsnorm_unit_offset else w

    def fold(weight, w):  # w on the input columns, in f32, rounded once
        return (weight.float() * w[None, :]).to(weight.dtype)

    layers = []
    for layer_p in params["layers"]:
        layer = dict(layer_p)
        for norm, names in (("attn_norm", ("q_proj", "k_proj", "v_proj")),
                            ("mlp_norm", ("gate_proj", "up_proj"))):
            w = w_of(layer_p[norm])
            for name in names:
                if name in layer:
                    layer[name] = {**layer[name], "weight": fold(layer[name]["weight"], w)}
            layer[f"{norm}_w"] = w.to(layer_p[norm].dtype)
            layer[norm] = torch.full_like(layer_p[norm], ident)
        layers.append(layer)
    out = {**params, "layers": layers}
    if "lm_head" in params and not config.tie_word_embeddings:
        out["lm_head"] = fold(params["lm_head"], w_of(params["final_norm"]))
        out["final_norm"] = torch.full_like(params["final_norm"], ident)
    return out, config.replace(norm_folded=True)


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


def _linear(x, p, post_scale=None):
    """``x`` times the entry's weight (bf16, or int8 for a serving entry)
    plus its bias.  ``post_scale`` (the norm-folded path): the product is
    scaled per row, in its own dtype, before the bias."""
    bias = p.get("bias")
    if post_scale is not None:
        y = _linear(x, {k: v for k, v in p.items() if k != "bias"})
        y = y * post_scale.to(y.dtype)
        return y if bias is None else y + bias
    if "weight_q" in p:  # int8 serving entry
        return int8_linear.int8_linear(x, p["weight_q"], p["weight_scale"], bias)
    return F.linear(x, p["weight"], bias)


class _Dropout:
    """Inverted LoRA dropout for one layer, from its own device generator
    seeded with ``seed`` (None or a zero rate: no dropout).  Each mask is
    drawn for the whole global batch whose ``rows`` the batch holds (None:
    the batch itself), and the batch keeps its rows of it, so a rank's
    rows are masked as one process masks the same rows."""

    def __init__(self, config: TransformerConfig, seed: Optional[int], device,
                 rows: Optional[Rows] = None):
        self.rate = config.lora_dropout
        self.style = config.lora_dropout_style
        self.rows = rows
        self.gen = None
        if seed is not None and self.rate > 0.0:
            self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, x, cols: Optional[Tuple[int, int]] = None):
        """``cols``: (the whole width, the first column) where ``x`` holds a
        tp rank's columns of the input: the mask is drawn for the whole
        width, as one process draws it, and this rank's columns kept."""
        if self.gen is None:
            return x
        rows = self.rows if self.rows is not None else Rows.whole(x.shape[0])
        shape = [rows.total, *x.shape[1:]]
        if cols:
            shape[-1] = cols[0]
        u = rows.take(torch.rand(shape, generator=self.gen, device=x.device))
        if cols:
            u = u[..., cols[1]:cols[1] + x.shape[-1]]
        return torch.where(u < 1.0 - self.rate, x / (1.0 - self.rate), 0.0)


def _lora_out(xa, b, config: TransformerConfig):
    return (xa @ b) * (config.lora_alpha / config.lora_rank)


def _lora_in(x, a, drop: _Dropout, cols=None, post_scale=None):
    """The adapter's rank-space product ``x @ a`` with its dropout: "rank"
    masks the (B, S, r) product, "input" (HF PEFT) the adapter's input.
    ``post_scale`` (the norm-folded path) scales the product per row,
    before the "rank" mask."""

    def scaled(xa):
        return xa if post_scale is None else xa * post_scale.to(xa.dtype)

    if drop.style == "rank":
        return drop(scaled(x @ a))
    return scaled((drop(x) if cols is None else drop(x, cols)) @ a)


def _proj(x, layer_p, name, lora_p, config: TransformerConfig, drop: _Dropout):
    """Dense projection with the LoRA overlay of ``name`` if it has one."""
    y = _linear(x, layer_p[name])
    if lora_p is not None and name in lora_p:
        a, b = lora_p[name]["a"], lora_p[name]["b"]  # (in, r), (r, out)
        y = y + _lora_out(_lora_in(x, a, drop), b, config)
    return y


def _lora_rank_space(xa):
    """A column group's rank-space product ``x @ a``, the same on every tp
    rank: each rank's B reads it, so its gradient (and A's) is the sum of
    the ranks' parts (``copy_to_tp``)."""
    return copy_to_tp(xa)


def _proj_group(x, layer_p, names: Sequence[str], lora_p, config: TransformerConfig,
                drop: _Dropout, post_scale=None, fold_w=None):
    """Projections sharing input ``x``; their LoRA A-products fused into one
    product against the concatenated A, one dropout mask for the group.

    Under ``--tp`` they are column-parallel: this rank's output columns of
    each (its heads, its MLP columns), from ``copy_to_tp(x)``.  A is whole
    and B this rank's columns, so the rank-space product passes through
    ``copy_to_tp`` too: its gradient, and A's, sums the ranks' parts.

    The norm-folded path (``post_scale``, ``fold_w``: the block's
    :func:`_norm_scale` and ``*_norm_w``): ``x`` is the raw residual
    stream; each base product and the rank-space product are scaled per
    row by ``post_scale``, and the concatenated A by ``fold_w`` on its
    rows, so the adapters see the normalized input.  In a group where only
    some projections carry adapters, each adapted one is :func:`_proj` of
    the raw ``x``, with neither scale, as the JAX package computes it
    (``ecg_byte_tpu/models/transformer.py:457-458``; ROADMAP.md, limits of
    the checks)."""
    x_in = copy_to_tp(x)
    use_lora = lora_p is not None and all(n in lora_p for n in names)
    if use_lora:
        a_cat = torch.cat([lora_p[n]["a"] for n in names], dim=-1)
        if fold_w is not None:
            a_cat = fold_w[:, None].to(a_cat.dtype) * a_cat
        xa = _lora_rank_space(_lora_in(x, a_cat, drop, post_scale=post_scale))
        r = config.lora_rank
    outs = []
    for i, name in enumerate(names):
        if post_scale is not None and not use_lora and lora_p is not None and name in lora_p:
            outs.append(_proj(x, layer_p, name, lora_p, config, drop))
            continue
        y = _linear(x_in, layer_p[name], post_scale)
        if use_lora:
            y = y + _lora_out(xa[..., i * r:(i + 1) * r], lora_p[name]["b"], config)
        elif lora_p is not None and name in lora_p:
            ab = lora_p[name]
            y = y + _lora_out(_lora_rank_space(_lora_in(x, ab["a"], drop)), ab["b"], config)
        outs.append(y)
    return outs


def _row(x, layer_p, name, lora_p, config: TransformerConfig, drop: _Dropout):
    """o or down.  One process: :func:`_proj`.  Under ``--tp``
    row-parallel: ``x`` is this rank's input columns (its heads, its MLP
    columns), the weight's matching columns make a partial output, summed
    over the tp group before the bias.  LoRA's A is this rank's rows, so
    ``x @ a`` is partial too and is summed before the "rank" dropout and B;
    the "input" mask is this rank's columns of the whole input's."""
    t = mesh.tp_size()
    if t == 1:
        return _proj(x, layer_p, name, lora_p, config, drop)
    p = layer_p[name]
    y = reduce_from_tp(F.linear(x, p["weight"]))
    if p.get("bias") is not None:
        y = y + p["bias"]
    if lora_p is not None and name in lora_p:
        a, b = lora_p[name]["a"], lora_p[name]["b"]
        if drop.style == "rank":
            xa = drop(reduce_from_tp(x @ a))
        else:
            w = x.shape[-1]
            xa = reduce_from_tp(_lora_in(x, a, drop, (w * t, w * mesh.tp_rank())))
        y = y + _lora_out(xa, b, config)
    return y


def _block(config: TransformerConfig, h, layer_p: Params, rope, attn_fn,
           lora_p: Optional[Params] = None, drop: Optional[_Dropout] = None):
    """One transformer block; ``attn_fn(q, k, v) -> (B, S, H, D)``.  On a
    tree of :func:`fold_norm_scales` under a ``norm_folded`` config the
    projection groups read the raw ``h`` (:func:`_proj_group`)."""
    c = config
    drop = drop if drop is not None else _Dropout(c, None, None)
    folded = c.norm_folded and "attn_norm_w" in layer_p
    if folded and mesh.grid().sharded:
        raise ValueError(sharding.FOLDED_UNSHARDED)
    layer_p = sharding.gather_layer(layer_p)  # --fsdp: this layer's weights, whole
    b, s, _ = h.shape
    if folded:
        q, k, v = _proj_group(h, layer_p, ("q_proj", "k_proj", "v_proj"), lora_p, c, drop,
                              _norm_scale(h, c), layer_p["attn_norm_w"])
    else:
        hn = _norm(h, layer_p["attn_norm"], layer_p.get("attn_norm_bias"), c)
        q, k, v = _proj_group(hn, layer_p, ("q_proj", "k_proj", "v_proj"), lora_p, c, drop)
    # this rank's heads under --tp (H / T and KH / T), every head otherwise
    q = q.view(b, s, -1, c.head_dim)
    k = k.view(b, s, -1, c.head_dim)
    v = v.view(b, s, -1, c.head_dim)
    if rope is not None:
        q = _apply_rope(q, *rope)
        k = _apply_rope(k, *rope)
    attn = attn_fn(q, k, v).reshape(b, s, -1)
    h = h + _row(attn, layer_p, "o_proj", lora_p, c, drop)

    if folded:
        gate, up = _proj_group(h, layer_p, ("gate_proj", "up_proj"), lora_p, c, drop,
                               _norm_scale(h, c), layer_p["mlp_norm_w"])
        return h + _row(_act(gate, c.hidden_act) * up, layer_p, "down_proj", lora_p, c, drop)
    hn = _norm(h, layer_p["mlp_norm"], layer_p.get("mlp_norm_bias"), c)
    if "gate_proj" in layer_p:
        gate, up = _proj_group(hn, layer_p, ("gate_proj", "up_proj"), lora_p, c, drop)
        inner = _act(gate, c.hidden_act) * up
    else:
        (up,) = _proj_group(hn, layer_p, ("up_proj",), lora_p, c, drop)
        inner = _act(up, c.hidden_act)
    return h + _row(inner, layer_p, "down_proj", lora_p, c, drop)


def _lookup(table, ids, vocab: int):
    """``table[ids]``.  Under ``--tp`` ``table`` is this rank's block of the
    vocabulary: the ids it holds are looked up, the others give zero rows,
    and the sum over the tp group is every row (``reduce_from_tp``)."""
    table = sharding.gather_fsdp(table)
    if mesh.tp_size() == 1:
        return table[ids]
    lo, hi = sharding.vocab_range(table.shape[0], vocab)
    local = ids - lo
    held = (local >= 0) & (local < hi - lo)
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return reduce_from_tp(torch.where(held[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                        device=rows.device)))


def _embed(params, config: TransformerConfig, input_ids, positions):
    h = _lookup(params["embed"], input_ids, config.vocab_size)
    if config.embed_scale:
        h = h * torch.tensor(math.sqrt(config.hidden_size), dtype=h.dtype)
    if config.learned_pos_embeddings:
        h = h + sharding.gather_fsdp(params["pos_embed"])[positions]
    return h


def _inputs_to_hidden(params, config: TransformerConfig, input_ids, positions, inputs_embeds):
    """The embedding lookup, or ``inputs_embeds`` cast to the model dtype in
    its place (the two-stage fusion path); the scale and learned positions
    apply to either."""
    if inputs_embeds is None:
        return _embed(params, config, input_ids, positions)
    h = inputs_embeds.to(_dtype(config))
    if config.embed_scale:
        h = h * torch.tensor(math.sqrt(config.hidden_size), dtype=h.dtype)
    if config.learned_pos_embeddings:
        h = h + sharding.gather_fsdp(params["pos_embed"])[positions]
    return h


def _head(params, config: TransformerConfig):
    """The (V, D) output head, whole over fsdp; under ``--tp`` this rank's
    vocabulary rows without the padding of the last block, and the first
    of them: ``(head, lo)``."""
    head = params["embed"] if config.tie_word_embeddings else params["lm_head"]
    head = sharding.gather_fsdp(head)
    if mesh.tp_size() == 1:
        return head, 0
    lo, hi = sharding.vocab_range(head.shape[0], config.vocab_size)
    return head[:hi - lo], lo


def _unembed(params, config: TransformerConfig, h):
    """f32 logits; under ``--tp`` this rank's vocabulary columns
    (:func:`vocab_argmax`, :func:`gather_vocab`)."""
    hn = _norm(h, params["final_norm"], params.get("final_norm_bias"), config)
    if "lm_head_q" in params:  # int8 serving copy
        return int8_linear.int8_linear(hn, params["lm_head_q"], params["lm_head_scale"],
                                       out_dtype=torch.float32)
    head, _ = _head(params, config)
    return F.linear(copy_to_tp(hn), head).float()


def vocab_argmax(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``argmax(-1)`` of logits that are, under ``--tp``, this rank's block
    of a vocabulary of ``vocab`` (:func:`_unembed`): the largest value and
    then the lowest index holding it, reduced over the tp group, as
    ``torch.argmax`` picks the first of equal maxima."""
    if mesh.tp_size() == 1:
        return torch.argmax(logits, -1)
    g = mesh.grid()
    idx = torch.argmax(logits, -1)
    val = logits.gather(-1, idx[..., None])[..., 0]
    top = distributed.all_reduce_(val.clone(), g.tp_group, "max")
    lo = g.t * -(-vocab // g.tp)
    cand = torch.where(val == top, idx + lo, torch.iinfo(torch.int64).max)
    return distributed.all_reduce_(cand, g.tp_group, "min")


def gather_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The whole vocabulary's logits from each tp rank's columns (no
    gradient; every rank of the tp group takes part)."""
    if mesh.tp_size() == 1:
        return logits
    g = mesh.grid()
    pad = -(-vocab // g.tp) - logits.shape[-1]
    if pad:
        logits = F.pad(logits, (0, pad), value=-math.inf)
    parts = distributed.all_gather(logits.detach().contiguous(), g.tp_group)
    return torch.cat(parts.unbind(0), -1)[..., :vocab]


def _rope_for(config: TransformerConfig, positions):
    if config.learned_pos_embeddings:
        return None
    return _rope_tables(positions, config, config.head_dim)


def _layer_loras(lora: Optional[Params], n: int):
    return lora["layers"] if lora is not None else [None] * n


# ---------------------------------------------------------------------------
# Public forward


def make_position_ids(attn_mask: torch.Tensor) -> torch.Tensor:
    """cumsum-over-valid minus one, pads pinned to 0."""
    mask = attn_mask.to(torch.int32)
    pos = torch.cumsum(mask, dim=-1, dtype=torch.int32) - 1
    return torch.where(mask == 0, 0, pos)


def dropout_seeds(config: TransformerConfig, n: int, lora: Optional[Params],
                  dropout_generator: Optional[torch.Generator]) -> List[Optional[int]]:
    """The per-layer LoRA dropout seeds :func:`forward` draws from
    ``dropout_generator`` (None each when dropout is off).  A rank with no
    rows of a global batch calls it in the forward's place, so its
    generator stays in step with the other ranks'."""
    if lora is not None and dropout_generator is not None and config.lora_dropout > 0.0:
        return torch.randint(0, 2**62, (n,), generator=dropout_generator).tolist()
    return [None] * n


def forward(
    params: Params,
    config: TransformerConfig,
    input_ids: Optional[torch.Tensor],
    attn_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    *,
    lora: Optional[Params] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    dropout_generator: Optional[torch.Generator] = None,
    return_hidden: bool = False,
    remat: str = "none",
    rows: Optional[Rows] = None,
    return_attentions: bool = False,
):
    """Causal LM forward pass -> float32 logits (B, S, V).

    ``attn_mask``: (B, S) 1/0 validity (left pads are 0).
    ``position_ids``: (B, S); defaults to the cumsum convention.
    ``lora``: adapters (``models/lora.py``) overlaid on the projections.
    ``inputs_embeds``: (B, S, D) in place of the embedding lookup (the
    two-stage fusion path); ``input_ids`` may then be None.
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
    ``rows``: the rows of a global batch this batch holds (``--dis``):
    dropout masks are drawn for the global batch (:class:`_Dropout`).
    ``return_attentions``: the eager capture; every layer's attention
    takes the plain probability path (``causal_attention(...,
    return_probs=True)``) and the call returns ``(logits, probs)``, probs
    the (L, B, H, S, S) stack in the model's dtype.  For inference only.
    """
    c = config
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
    if attn_mask is None:
        ref = input_ids if inputs_embeds is None else inputs_embeds[..., 0]
        attn_mask = torch.ones(ref.shape, dtype=torch.int32, device=ref.device)
    attn_mask = attn_mask.to(torch.int32).contiguous()
    if position_ids is None:
        position_ids = make_position_ids(attn_mask)
    h = _inputs_to_hidden(params, c, input_ids, position_ids, inputs_embeds)
    rope = _rope_for(c, position_ids)

    probs = []

    def attn_fn(q, k, v):
        if return_attentions:
            out, p = attention.causal_attention(q, k, v, attn_mask, return_probs=True)
            probs.append(p)
            return out
        return attention.causal_attention(q, k, v, attn_mask)

    n = len(params["layers"])
    seeds = dropout_seeds(c, n, lora, dropout_generator)
    for layer_p, lora_p, seed in zip(params["layers"], _layer_loras(lora, n), seeds):

        def layer(h, layer_p=layer_p, lora_p=lora_p, seed=seed):
            return _block(c, h, layer_p, rope, attn_fn, lora_p,
                          _Dropout(c, seed, h.device, rows))

        # --fsdp: the layer's gathered weights live for its forward alone and
        # are gathered again when the backward replays it
        if (remat == "full" or mesh.fsdp_size() > 1) and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(layer, h, use_reentrant=False)
        else:
            h = layer(h)
    if return_hidden:
        return h
    if return_attentions:
        return _unembed(params, c, h), torch.stack(probs)
    return _unembed(params, c, h)


@torch.no_grad()
def mean_attention(
    params: Params,
    config: TransformerConfig,
    input_ids: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    *,
    lora: Optional[Params] = None,
) -> torch.Tensor:
    """Layer- and head-averaged attention probabilities (B, S, S), f32,
    streamed (``ecg_byte_tpu/models/transformer.py:759``): each layer's
    (B, H, S, S) probabilities are added, as their f32 head mean, into one
    f32 sum and dropped before the next layer, so memory holds one layer's
    probabilities, not the eager (L, B, H, S, S) stack of
    ``forward(return_attentions=True)``, whose mean over layers and heads
    this equals up to f32 summation order."""
    c = config
    if attn_mask is None:
        attn_mask = torch.ones(input_ids.shape, dtype=torch.int32, device=input_ids.device)
    attn_mask = attn_mask.to(torch.int32).contiguous()
    if position_ids is None:
        position_ids = make_position_ids(attn_mask)
    h = _inputs_to_hidden(params, c, input_ids, position_ids, None)
    rope = _rope_for(c, position_ids)
    b, s = input_ids.shape
    acc = torch.zeros((b, s, s), dtype=torch.float32, device=h.device)

    def attn_fn(q, k, v):
        out, p = attention.causal_attention(q, k, v, attn_mask, return_probs=True)
        acc.add_(p.float().mean(dim=1))
        return out

    n = len(params["layers"])
    for layer_p, lora_p in zip(params["layers"], _layer_loras(lora, n)):
        h = _block(c, h, layer_p, rope, attn_fn, lora_p)
    return acc / n


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


def _count(valid: torch.Tensor, count):
    """The loss's denominator, at least 1: the valid rows here (a device
    tensor), or ``count`` (a global batch's, from the host: a number, so
    no copy to the device waits for its queue)."""
    if count is None:
        return valid.sum().clamp(min=1)
    return max(int(count), 1)


class _DenseCE(torch.autograd.Function):
    """Mean cross entropy over valid rows of ``h2 @ head^T``; -100 ignored.

    The port of the JAX ``_dense_ce``: the loss in f32 from f32 logits and
    their logsumexp; the (M, V) residual saved as bf16 logits centred on
    the logsumexp; the backward recomputes the probabilities from it and
    writes dlogits in h2's dtype before the dX product.  ``head`` is the
    (V, D) embedding or LM head; its gradient is computed only where it
    trains.

    ``tp``: (the first vocabulary row of ``head``, the tp group) where
    ``head`` is a tp rank's block of the vocabulary (vocab-parallel, as
    Megatron's cross entropy): the max, the sum of exponentials and the
    label's logit are reduced over the group, and dh2 is this block's part
    (``h2`` comes through ``copy_to_tp``, which sums the parts).
    """

    @staticmethod
    def forward(ctx, h2, head, labels, count, tp=None):
        logits = F.linear(h2, head).float()  # (M, V)
        valid = labels != -100
        safe = torch.where(valid, labels, 0).long()
        ctx.count = _count(valid, count)
        if tp is None:
            m = logits.amax(dim=-1)
            lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
            lab = logits.gather(1, safe[:, None])[:, 0]
            held = valid
        else:
            lo, group = tp
            safe = safe - lo
            held = valid & (safe >= 0) & (safe < head.shape[0])
            safe = safe.clamp(0, max(head.shape[0] - 1, 0))
            m = distributed.all_reduce_(logits.amax(dim=-1), group, "max")
            se = distributed.all_reduce_(torch.exp(logits - m[:, None]).sum(dim=-1), group)
            lse = m + torch.log(se)
            lab = distributed.all_reduce_(
                torch.where(held, logits.gather(1, safe[:, None])[:, 0], 0.0), group)
        loss = torch.where(valid, lse - lab, 0.0).sum() / ctx.count
        centered = (logits - lse[:, None]).to(torch.bfloat16)
        ctx.save_for_backward(h2, head, centered, safe, valid, held)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        with span("ecg.model.head.bwd"):
            h2, head, centered, safe, valid, held = ctx.saved_tensors
            probs = torch.exp(centered.float())
            # minus the one-hot of each held label
            probs[torch.arange(probs.shape[0], device=probs.device), safe] -= held.float()
            coeff = torch.where(valid, gbar / ctx.count, 0.0)
            dlogits = (probs * coeff[:, None]).to(h2.dtype)
            del probs
            dh2 = dlogits @ head
            dhead = dlogits.T @ h2 if ctx.needs_input_grad[1] else None
        return dh2, dhead, None, None, None


def _tp_arg(lo):
    g = mesh.grid()
    return (lo, g.tp_group) if g.tp > 1 else None


def lm_loss_from_hidden(params: Params, config: TransformerConfig, hidden: torch.Tensor,
                        labels: torch.Tensor, count=None) -> torch.Tensor:
    """Dense HF CausalLM loss from pre-final-norm hidden states: the value
    of ``causal_lm_loss(_unembed(hidden), labels)`` with the bf16 backward
    of :class:`_DenseCE` (the final norm's gradient flows by autograd).
    ``count``: the labelled tokens of the global batch (``--dis``): the
    loss is then this batch's sum over it.  Under ``--tp`` vocab-parallel
    (:class:`_DenseCE`)."""
    c = config
    with span("ecg.model.head"):
        hn = _norm(hidden, params["final_norm"], params.get("final_norm_bias"), c)
        head, lo = _head(params, c)
        d = hn.shape[-1]
        h2 = copy_to_tp(hn[:, :-1].reshape(-1, d))
        return _DenseCE.apply(h2, head, labels[:, 1:].reshape(-1), count, _tp_arg(lo))


def _ce_tile(h2, head_tile, safe, lo, m_run, l_run, lab_run):
    """One vocabulary tile of :func:`chunked_lm_loss`: the running max,
    sum of exponentials and label logit after columns [lo, lo + tile)."""
    logits = F.linear(h2, head_tile).float()  # (M, tile)
    m_new = torch.maximum(m_run, logits.amax(dim=-1))
    l_new = l_run * torch.exp(m_run - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    local = safe - lo
    in_tile = (local >= 0) & (local < head_tile.shape[0])
    picked = logits.gather(1, local.clamp(0, head_tile.shape[0] - 1)[:, None])[:, 0]
    return m_new, l_new, torch.where(in_tile, picked, lab_run)


def chunked_lm_loss(params: Params, config: TransformerConfig, hidden: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 8192, count=None) -> torch.Tensor:
    """The HF CausalLM loss of ``causal_lm_loss(_unembed(hidden), labels)``
    without the (B, S, V) logits: vocabulary tiles of ``chunk`` columns, a
    running logsumexp, and the label logit picked in its tile.  Each tile
    is replayed in the backward (``torch.utils.checkpoint``), so peak
    memory is O(B * S * chunk).  Equal to the dense loss up to f32
    logsumexp rounding.  ``count`` as in :func:`lm_loss_from_hidden`.
    Under ``--tp`` the tiles are this rank's block of the vocabulary
    (``ecg_byte_tpu/models/transformer.py:934-943``): its running max, sum
    and label logit are combined over the tp group at the end."""
    c = config
    hn = _norm(hidden, params["final_norm"], params.get("final_norm_bias"), c)
    head, v_lo = _head(params, c)  # (V, D), this rank's rows under --tp
    h2 = copy_to_tp(hn[:, :-1].reshape(-1, hn.shape[-1]))
    shift = labels[:, 1:].reshape(-1)
    valid = shift != -100
    safe = torch.where(valid, shift, 0).long() - v_lo
    m = torch.full((h2.shape[0],), -math.inf, device=h2.device)
    l_run = torch.zeros(h2.shape[0], device=h2.device)
    lab = torch.zeros(h2.shape[0], device=h2.device)
    for lo in range(0, head.shape[0], chunk):
        m, l_run, lab = torch.utils.checkpoint.checkpoint(
            _ce_tile, h2, head[lo:lo + chunk], safe, lo, m, l_run, lab, use_reentrant=False)
    if mesh.tp_size() > 1:
        # the max is a shift: its gradient cancels, so it is taken detached
        g = mesh.grid()
        top = distributed.all_reduce_(m.detach().clone(), g.tp_group, "max")
        l_run = reduce_from_tp(l_run * torch.exp(m - top))
        m, lab = top, reduce_from_tp(lab)
    nll = m + torch.log(l_run) - lab
    return torch.where(valid, nll, 0.0).sum() / _count(valid, count)


# ---------------------------------------------------------------------------
# KV-cache decode


def init_kv_cache(
    config: TransformerConfig, batch: int, max_len: int, device: torch.device,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """KV cache ``{"k", "v"}`` of (L, B, S_max, KH, D) in ``dtype``, by
    default the model's; layer ``i`` reads the contiguous slice
    ``cache["k"][i]``.  ``dtype=torch.int8`` is the int8 serving cache: it
    adds ``k_scale`` and ``v_scale`` of (L, B, S_max, KH) bf16, set to 1
    (not 0: unfilled slots are masked, but a 0 scale would still make
    0 * -inf NaNs if a backend reordered the mask).  Under ``--tp`` it
    holds this rank's KV heads."""
    # under --tp this rank's KV heads
    shape = (config.num_layers, batch, max_len, config.num_kv_heads // mesh.tp_size(),
             config.head_dim)
    dt = dtype or _dtype(config)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }
    if dt == torch.int8:
        cache["k_scale"] = torch.ones(shape[:-1], dtype=torch.bfloat16, device=device)
        cache["v_scale"] = torch.ones(shape[:-1], dtype=torch.bfloat16, device=device)
    return cache


def _append_kv(cache: Params, i: int, k, v) -> None:
    """Write a prompt's (B, s, KH, D) K/V rows at slots [0, s) of layer
    ``i``'s cache in place, quantizing them for the int8 cache."""
    if cache["k"].dtype == torch.int8:
        kv_quant.append_kv(k, v, cache["k"][i], cache["v"][i], cache["k_scale"][i],
                           cache["v_scale"][i], 0)
    else:
        s = k.shape[1]
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v


def prefill(
    params: Params,
    config: TransformerConfig,
    input_ids: Optional[torch.Tensor],
    attn_mask: torch.Tensor,
    cache: Params,
    position_ids: Optional[torch.Tensor] = None,
    *,
    lora: Optional[Params] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
):
    """Run the prompt, filling cache slots [0, S) in place; ``lora``:
    adapters applied beside the base weights (no dropout);
    ``inputs_embeds``: the prompt as (B, S, D) embeddings, as in
    :func:`forward`.

    Returns (last-position logits (B, V) f32, cache, next_positions (B,)).
    """
    c = config
    attn_mask = attn_mask.to(torch.int32).contiguous()
    if position_ids is None:
        position_ids = make_position_ids(attn_mask)
    h = _inputs_to_hidden(params, c, input_ids, position_ids, inputs_embeds)
    rope = _rope_for(c, position_ids)
    layers = params["layers"]
    for i, (layer_p, lora_p) in enumerate(zip(layers, _layer_loras(lora, len(layers)))):

        def attn_fn(q, k, v, i=i):
            # attention reads the fresh K/V; only the cache copy may be int8
            _append_kv(cache, i, k, v)
            return attention.causal_attention(q, k, v, attn_mask)

        h = _block(c, h, layer_p, rope, attn_fn, lora_p)
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
    *,
    lora: Optional[Params] = None,
):
    """One decode step.  Decode attention writes this token's K/V rows into
    the cache at ``write_idx`` in place as it attends them (the fresh-row
    contract); returns (logits (B, V) f32, cache).  ``lora`` as in
    :func:`prefill`."""
    c = config
    pos2d = positions[:, None]
    h = _embed(params, c, token[:, None], pos2d)
    rope = _rope_for(c, pos2d)
    int8 = "k_scale" in cache
    layers = params["layers"]
    for i, (layer_p, lora_p) in enumerate(zip(layers, _layer_loras(lora, len(layers)))):

        def attn_fn(q, k, v, i=i):
            return attention_decode.decode_attention_fused(
                q, cache["k"][i], cache["v"][i], cache_mask,
                cache["k_scale"][i] if int8 else None, cache["v_scale"][i] if int8 else None,
                fresh_k=k, fresh_v=v, write_idx=write_idx,
            )

        h = _block(c, h, layer_p, rope, attn_fn, lora_p)
    return _unembed(params, c, h)[:, 0], cache
