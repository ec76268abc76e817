"""Signal and text encoder heads of the two-stage (MERL) pipeline.

The port of ``ecg_byte_tpu/models/encoders.py``: the cls-token attention
pool over ResNet features, the symmetric CLIP loss with precision@k, the
MERL pretrain head (1x1 down-conv, two dropout views, the frozen
text-encoder projection) and its combined cross-modal + uni-modal loss, and
the frozen text encoders: the hashed-embedding stand-in and a local BERT
(MedCPT) checkpoint.

Dense weights keep PyTorch's ``(out, in)`` layout and apply with
``F.linear``; ``models/convert.merl_head_from_jax`` transposes the JAX
package's ``(in, out)`` kernels.  GELU is the tanh approximation, as
``jax.nn.gelu``'s default.  Dropout masks come from a ``torch.Generator``,
so their bits differ from JAX's; with no generator there is no dropout.

Under ``--dis`` (``rows``: a rank's rows of the global batch) the losses
are the JAX package's on the global batch: each rank gathers the global
embeddings (``parallel.distributed.gather_rows``, which keeps the gradient
of its own rows) and computes its rows of the loss, a sum over the global
batch size, so the ranks' losses and gradients sum to one process's; the
dropout masks are drawn for the global batch and the rank keeps its rows.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.models.resnet1d import conv1d
from ecg_byte_tpu_torch.parallel import distributed
from ecg_byte_tpu_torch.parallel.distributed import Rows

Params = Dict[str, Any]


def _dense(gen, d_in, d_out, device):
    """(out, in) weight, uniform in +-(1/d_in)^0.5."""
    bound = (1.0 / d_in) ** 0.5
    return torch.rand(d_out, d_in, generator=gen, device=device) * (2 * bound) - bound


def _l2_normalize(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


# ---------------------------------------------------------------------------
# Attention pooling


def init_attention_pool(gen: torch.Generator, spacial_dim: int, embed_dim: int,
                        num_heads: int, output_dim: Optional[int] = None, device=None) -> Params:
    device = gen.device if device is None else device
    out_dim = output_dim or embed_dim
    return {
        "pos_embed": torch.randn(1, spacial_dim + 1, embed_dim, generator=gen,
                                 device=device) / embed_dim,
        "cls_token": torch.randn(1, 1, embed_dim, generator=gen, device=device),
        "in_proj": _dense(gen, embed_dim, 3 * embed_dim, device),
        "in_proj_bias": torch.zeros(3 * embed_dim, device=device),
        "out_proj": _dense(gen, embed_dim, embed_dim, device),
        "out_proj_bias": torch.zeros(embed_dim, device=device),
        "c_proj": _dense(gen, embed_dim, out_dim, device),
        "c_proj_bias": torch.zeros(out_dim, device=device),
    }


def attention_pool(p: Params, x: torch.Tensor, num_heads: int = 4
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C, L) -> pooled (B, out_dim), attention map (B, L): the cls
    token as the single query over [cls; tokens] with positional
    embeddings; the map averages the heads and drops the cls key."""
    b, h = x.shape[0], num_heads
    x = x.transpose(1, 2)  # (B, L, C)
    e = x.shape[-1]
    cls = (p["cls_token"] + p["pos_embed"][:, :1]).expand(b, 1, e)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"].to(x.dtype)
    q, k, v = F.linear(x, p["in_proj"], p["in_proj_bias"]).chunk(3, dim=-1)
    q = q[:, :1].reshape(b, 1, h, e // h)
    k = k.reshape(b, k.shape[1], h, e // h)
    v = v.reshape(b, v.shape[1], h, e // h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * ((e // h) ** -0.5)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, 1, e)
    out = F.linear(out, p["out_proj"], p["out_proj_bias"])
    out = F.linear(out, p["c_proj"], p["c_proj_bias"])
    return out[:, 0], probs[:, :, 0, 1:].mean(dim=1)


# ---------------------------------------------------------------------------
# CLIP-style contrastive loss


def _hit_counts(sim: torch.Tensor, labels: torch.Tensor, ks=(1, 5)):
    """Rows whose label is among the k highest scores, for each k."""
    order = torch.argsort(-sim, dim=1, stable=True)
    hits = order == labels[:, None]
    return [hits[:, :k].any(dim=1).float().sum() for k in ks]


def precision_at_k(sim: torch.Tensor, labels: torch.Tensor, ks=(1, 5)):
    """Percent of rows whose label is among the k highest scores."""
    return [h / sim.shape[0] * 100.0 for h in _hit_counts(sim, labels, ks)]


def clip_loss(x: torch.Tensor, y: torch.Tensor, temperature: float = 0.07,
              rows: Optional[Rows] = None):
    """Symmetric InfoNCE over the global batch whose ``rows`` ``x`` and
    ``y`` hold (None: the batch itself); returns (loss, acc1, acc5).  This
    rank's rows of the similarity matrix and of its transpose against the
    gathered embeddings, summed over the global batch size, so the ranks'
    losses sum to the global batch's; the accuracies are the global
    batch's."""
    rows = rows if rows is not None else Rows.whole(x.shape[0])
    x, y = _l2_normalize(x), _l2_normalize(y)
    labels = rows.positions(x.device)
    sim = x @ distributed.gather_rows(y, rows).T / temperature
    sim_t = y @ distributed.gather_rows(x, rows).T / temperature
    loss = (F.cross_entropy(sim, labels, reduction="sum")
            + F.cross_entropy(sim_t, labels, reduction="sum")) / rows.total
    with torch.no_grad():  # hit counts of the rank's rows, summed over the ranks
        hits = torch.stack(_hit_counts(sim, labels) + _hit_counts(sim_t, labels))
        acc = distributed.sum_over_ranks(hits) / rows.total * 100.0
    return loss, (acc[0] + acc[2]) / 2.0, (acc[1] + acc[3]) / 2.0


# ---------------------------------------------------------------------------
# MERL pretrain head


def init_merl_head(gen: torch.Generator, feature_channels: int = 2048, proj_out: int = 256,
                   text_dim: int = 768, spacial_dim: int = 32, device=None) -> Params:
    device = gen.device if device is None else device
    return {
        "downconv": torch.randn(proj_out, feature_channels, 1, generator=gen, device=device)
        * (1.0 / np.sqrt(feature_channels)),
        "att_pool": init_attention_pool(gen, spacial_dim, proj_out, 4, proj_out, device),
        "linear1": _dense(gen, proj_out, proj_out, device),
        "linear2": _dense(gen, proj_out, proj_out, device),
        "proj_t_w1": _dense(gen, text_dim, proj_out, device),
        "proj_t_b1": torch.zeros(proj_out, device=device),
        "proj_t_w2": _dense(gen, proj_out, proj_out, device),
        "proj_t_b2": torch.zeros(proj_out, device=device),
    }


def _dropout(x, rate, gen, rows: Optional[Rows] = None):
    """The global batch's mask (``rows``: as in :func:`clip_loss`), this
    batch's rows of it."""
    rows = rows if rows is not None else Rows.whole(x.shape[0])
    u = rows.take(torch.rand((rows.total,) + tuple(x.shape[1:]), generator=gen,
                             device=x.device))
    return torch.where(u < 1 - rate, x / (1 - rate), 0.0)


def merl_pretrain_loss(head: Params, features: torch.Tensor, text_emb: torch.Tensor, *,
                       dropout_generator: Optional[torch.Generator] = None,
                       dropout_rate: float = 0.1, rows: Optional[Rows] = None):
    """Cross-modal + uni-modal contrastive loss of the MERL head on ResNet
    features (B, C, L') and the frozen text embedding (B, text_dim).
    Dropout of the two uni-modal views draws from ``dropout_generator``
    (on the features' device); None turns it off.  ``rows``: this rank's
    rows of the global batch (``--dis``; :func:`clip_loss`)."""
    ecg_emb = conv1d(features, head["downconv"])  # (B, 256, L')
    proj_ecg, att_map = attention_pool(head["att_pool"], ecg_emb)
    proj_ecg = _l2_normalize(proj_ecg)

    pooled = ecg_emb.mean(dim=-1)
    e1 = F.linear(pooled, head["linear1"])
    e2 = F.linear(pooled, head["linear2"])
    if dropout_generator is not None and dropout_rate > 0:
        e1 = _dropout(e1, dropout_rate, dropout_generator, rows)
        e2 = _dropout(e2, dropout_rate, dropout_generator, rows)

    proj_text = F.gelu(F.linear(text_emb, head["proj_t_w1"], head["proj_t_b1"]),
                       approximate="tanh")
    proj_text = _l2_normalize(F.linear(proj_text, head["proj_t_w2"], head["proj_t_b2"]))

    cma_loss, acc1, acc5 = clip_loss(proj_ecg, proj_text, rows=rows)
    uma_loss, _, _ = clip_loss(e1, e2, rows=rows)
    return cma_loss + uma_loss, {"acc1": acc1, "acc5": acc5, "att_map": att_map}


# ---------------------------------------------------------------------------
# Frozen text encoders


class HashTextEncoder:
    """The offline stand-in for the frozen MedCPT BERT: hashed token
    embeddings, mean-pooled over the valid tokens.  The table is the JAX
    package's (``np.random.default_rng(seed)``, in the dtype numpy gives
    it), held on ``device``; the pool adds the tokens one by one in order,
    as numpy's reduction over the token axis does, so the embeddings are
    the JAX package's bit for bit."""

    def __init__(self, dim: int = 768, vocab_hash: int = 1 << 16, seed: int = 0, device=None):
        rng = np.random.default_rng(seed)
        table = rng.normal(size=(vocab_hash, dim)).astype(np.float32) / np.sqrt(dim)
        self.table = torch.from_numpy(table).to("cuda" if device is None else device)
        self.vocab_hash = vocab_hash
        self.dim = dim

    @torch.no_grad()
    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        dev = self.table.device
        ids = torch.as_tensor(np.asarray(input_ids), device=dev).long() % self.vocab_hash
        mask = torch.as_tensor(np.asarray(attention_mask), device=dev).float()[..., None]
        mask = mask.to(self.table.dtype)
        emb = self.table[ids] * mask  # (B, S, D)
        total = emb[:, 0]
        for s in range(1, emb.shape[1]):
            total = total + emb[:, s]
        return total / mask.sum(1).clamp_min(1.0)


def load_frozen_text_encoder(model_name: Optional[str] = None,
                             allow_hash_fallback: bool = False, device=None):
    """The frozen text encoder on ``device`` (default the CUDA card): a
    local BERT checkpoint (e.g. MedCPT-Query-Encoder) tokenized by its own
    ``vocab.txt``, or the hash encoder when no checkpoint is named.  A
    named checkpoint that fails to load raises, unless
    ``allow_hash_fallback`` (``--allow_hash_text_encoder``) was set."""
    if model_name:
        try:
            from ecg_byte_tpu_torch.models.bert import BertTextEncoder, load_hf_bert

            params, config = load_hf_bert(model_name, device)
            tokenizer = None
            vocab_file = os.path.join(model_name, "vocab.txt")
            if os.path.exists(vocab_file):
                from ecg_byte_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer

                lower = True
                cfg_file = os.path.join(model_name, "tokenizer_config.json")
                if os.path.exists(cfg_file):
                    with open(cfg_file) as f:
                        lower = json.load(f).get("do_lower_case", True)
                tokenizer = WordPieceTokenizer(vocab_file, lower_case=lower)
            return BertTextEncoder(params, config, tokenizer)
        except Exception as e:
            if not allow_hash_fallback:
                raise RuntimeError(
                    f"text encoder checkpoint {model_name!r} failed to load ({e}); pass "
                    "allow_hash_fallback=True (--allow_hash_text_encoder) to degrade to the "
                    "hash encoder instead") from e
            print(f"local BERT unavailable ({e}); using hash text encoder")
    return HashTextEncoder(device=device)
