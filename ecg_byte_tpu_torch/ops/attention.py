"""Attention: plain grouped causal attention and plain decode attention, and
the dispatch of prefill attention to its kernel.

Masking follows ``ecg_byte_tpu/ops/attention.py``: masked logits get the
finite fill ``-1e30`` (never ``-inf``), so a query row whose keys are all
masked (a left-pad row) stays finite.  Heads split as HF ``repeat_kv``
orders them: query head ``h`` reads KV head ``h // G``, so ``H`` reshapes
to ``(KH, G)``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def grouped_attention(qg, k, v, pad_mask: Optional[torch.Tensor]):
    """Plain causal grouped-query attention (``_grouped_attention``).

    qg (B, S, KH, G, D), k/v (B, S, KH, D), pad_mask (B, S) 1 = valid key.
    Logits and softmax in f32 (f64 for f64 inputs); the probabilities are
    rounded to the input dtype before P.V, which accumulates in f32.
    Returns (B, S, KH, G, D).
    """
    ct = torch.promote_types(qg.dtype, torch.float32)
    d = qg.shape[-1]
    s = qg.shape[1]
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(ct), k.to(ct)) * d**-0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=qg.device).tril()
    bias = torch.where(causal, 0.0, NEG_INF)
    if pad_mask is not None:
        key_ok = pad_mask[:, None, None, None, :].bool()
        bias = bias + torch.where(key_ok, 0.0, NEG_INF)
    probs = torch.softmax(logits + bias.to(ct), dim=-1).to(qg.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(ct), v.to(ct))
    return out.to(qg.dtype)


def causal_attention(q, k, v, pad_mask: torch.Tensor) -> torch.Tensor:
    """Causal attention with left-pad key masking.

    q (B, S, H, D); k, v (B, S, KH, D); pad_mask (B, S) int32.  Goes
    through ``attention_resident.ResidentAttention`` (differentiable), whose
    wrappers take the plain versions for CPU tensors.  Returns (B, S, H, D).
    """
    from ecg_byte_tpu_torch.ops import attention_resident

    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d).contiguous()
    out = attention_resident.ResidentAttention.apply(qg, k.contiguous(), v.contiguous(), pad_mask)
    return out.reshape(b, s, h, d)


def decode_attention(q, k_cache, v_cache, valid_mask) -> torch.Tensor:
    """Plain single-position attention over a KV cache (``decode_attention``).

    q (B, 1, H, D); k_cache, v_cache (B, S_max, KH, D); valid_mask
    (B, S_max), 1 for cache slots that may be attended.  f32 logits and
    softmax, probabilities rounded to the cache dtype before P.V, which
    accumulates in f32.  Returns (B, 1, H, D).
    """
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * d**-0.5
    logits = logits + torch.where(valid_mask[:, None, None, :].bool(), 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs.float(), v_cache.float())
    return out.to(q.dtype).reshape(b, 1, h, d)
