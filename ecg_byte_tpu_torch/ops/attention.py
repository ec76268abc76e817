"""Attention: plain grouped causal attention and plain decode attention, and
the dispatch of prefill and training attention to the resident or the
flash kernels.

Masking follows ``ecg_byte_tpu/ops/attention.py``: masked logits get the
finite fill ``-1e30`` (never ``-inf``), so a query row whose keys are all
masked (a left-pad row) stays finite.  Heads split as HF ``repeat_kv``
orders them: query head ``h`` reads KV head ``h // G``, so ``H`` reshapes
to ``(KH, G)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.utils.profiling import span

NEG_INF = -1e30


def _causal(s, device):
    """(S, S) bool: query position q sees key t where t <= q."""
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


# the resident kernels take sequence lengths in multiples of this
RESIDENT_SEQ_TILE = 16


def grouped_probs(qg, k, pad_mask: Optional[torch.Tensor]):
    """The probabilities of :func:`grouped_attention` (``_grouped_probs``):
    (B, KH, G, S, S), f32 logits and softmax with the causal and pad
    masks, rounded to qg's dtype."""
    ct = torch.promote_types(qg.dtype, torch.float32)
    d = qg.shape[-1]
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(ct), k.to(ct)) * d**-0.5
    return masked_probs(logits, pad_mask, qg.dtype)


def masked_probs(logits, pad_mask: Optional[torch.Tensor], dtype):
    """The softmax of (B, KH, G, S, S) scaled logits under the causal and
    pad masks, in the logits' dtype, rounded to ``dtype``: the second half
    of :func:`grouped_probs`."""
    s = logits.shape[-1]
    bias = torch.where(_causal(s, logits.device), 0.0, NEG_INF)
    if pad_mask is not None:
        key_ok = pad_mask[:, None, None, None, :].bool()
        bias = bias + torch.where(key_ok, 0.0, NEG_INF)
    return torch.softmax(logits + bias.to(logits.dtype), dim=-1).to(dtype)


def grouped_attention(qg, k, v, pad_mask: Optional[torch.Tensor]):
    """Plain causal grouped-query attention (``_grouped_attention``).

    qg (B, S, KH, G, D), k/v (B, S, KH, D), pad_mask (B, S) 1 = valid key.
    Logits and softmax in f32 (f64 for f64 inputs); the probabilities are
    rounded to the input dtype before P.V, which accumulates in f32.
    Returns (B, S, KH, G, D).
    """
    ct = torch.promote_types(qg.dtype, torch.float32)
    probs = grouped_probs(qg, k, pad_mask)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(ct), v.to(ct))
    return out.to(qg.dtype)


# From this many positions on, prefill and training attention take the
# flash kernels, as ecg_byte_tpu/ops/attention.py:142-144 does.
FLASH_MIN_SEQ = 4096


def resident_padded(qg, k, v, pad_mask):
    """``ResidentAttention`` on qg, k and v padded at the end to a multiple
    of :data:`RESIDENT_SEQ_TILE` positions, the pad mask extended with 0,
    and the extra rows dropped.  The extra keys lie after every real
    query, so the causal mask hides them; the extra rows' output gradient
    is 0, so they add nothing to dq, dk or dv of the real positions."""
    from ecg_byte_tpu_torch.ops import attention_resident

    s = qg.shape[1]
    extra = -s % RESIDENT_SEQ_TILE
    qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, extra))
    k = F.pad(k, (0, 0, 0, 0, 0, extra))
    v = F.pad(v, (0, 0, 0, 0, 0, extra))
    pad_mask = F.pad(pad_mask, (0, extra))
    return attention_resident.ResidentAttention.apply(qg, k, v, pad_mask)[:, :s]


def causal_attention(q, k, v, pad_mask: torch.Tensor, *, return_probs: bool = False):
    """Causal attention with left-pad key masking.

    q (B, S, H, D); k, v (B, S, KH, D); pad_mask (B, S) int32.  The call's
    own S decides, before any launch: S >= ``FLASH_MIN_SEQ`` with a head
    dim that JAX's ``flash_attention`` takes (a multiple of 8 up to 256,
    ``ecg_byte_tpu/ops/flash_attention.py:378-384``) goes through
    ``flash_attention.FlashAttention``, anything else through
    ``attention_resident.ResidentAttention``; both are differentiable, and
    their wrappers take the plain versions for CPU tensors.  On the card
    an S that is not a multiple of :data:`RESIDENT_SEQ_TILE` goes through
    :func:`resident_padded`.  Returns (B, S, H, D).

    ``return_probs=True`` takes the plain path of the JAX package's eager
    capture (``ecg_byte_tpu/ops/attention.py:182-184``, XLA there, no
    kernel) on any device and returns ``(out, probs)``, probs (B, H, S, S)
    rounded to q's dtype and out = probs . V with f32 accumulation.
    """
    from ecg_byte_tpu_torch.ops import attention_resident, flash_attention

    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d).contiguous()
    if return_probs:
        probs = grouped_probs(qg, k, pad_mask)
        ct = torch.promote_types(q.dtype, torch.float32)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(ct), v.to(ct)).to(q.dtype)
        return out.reshape(b, s, h, d), probs.reshape(b, h, s, s)
    with span("ecg.attn.fwd"):
        k, v = k.contiguous(), v.contiguous()
        if s >= FLASH_MIN_SEQ and d % 8 == 0 and d <= 256:
            out = flash_attention.FlashAttention.apply(qg, k, v, pad_mask)
        elif qg.device.type != "cpu" and s % RESIDENT_SEQ_TILE:
            out = resident_padded(qg, k, v, pad_mask)
        else:
            out = attention_resident.ResidentAttention.apply(qg, k, v, pad_mask)
    return out.reshape(b, s, h, d)


def decode_attention(q, k_cache, v_cache, valid_mask, k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain single-position attention over a KV cache (``decode_attention``).

    q (B, 1, H, D); k_cache, v_cache (B, S_max, KH, D); valid_mask
    (B, S_max), 1 for cache slots that may be attended.  f32 logits and
    softmax, probabilities rounded to q's dtype before P.V, which
    accumulates in f32.  For the int8 cache, ``k_scale`` and ``v_scale``
    (B, S_max, KH) hold each row's scale: the K scale multiplies the f32
    logits after the ``D^-0.5`` scaling, the V scale the f32 probabilities
    after normalisation, before their rounding.  Returns (B, 1, H, D).
    """
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * d**-0.5
    if k_scale is not None:
        logits = logits * k_scale.transpose(1, 2)[:, :, None, :].float()
    logits = logits + torch.where(valid_mask[:, None, None, :].bool(), 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.transpose(1, 2)[:, :, None, :].float()
    probs = probs.to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs.float(), v_cache.float())
    return out.to(q.dtype).reshape(b, 1, h, d)
