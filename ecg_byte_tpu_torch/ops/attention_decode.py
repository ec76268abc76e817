"""Decode attention over a bf16 or an int8 KV cache: the wrapper of the CUDA
kernel in ``csrc/attention_decode.cu``.

Replaces the Pallas kernel ``_kernel`` of ``ecg_byte_tpu/ops/attention_decode.py``
(reached through ``decode_attention_fused``) for both cache types: one
query position against the cache in its native (B, S_max, KH, D) layout,
query head ``h`` reading KV head ``h // G``, a (B, S_max) validity mask,
f32 logits and softmax, P.V with f32 accumulation.  The int8 cache comes
with (B, S_max, KH) bf16 scales: the K scale multiplies the logits, the V
scale the normalized probabilities before they are rounded to bf16, as in
the TPU kernel's ``int8_scales`` branch.  The JAX package sends the int8
cache to XLA unless ``ECG_BYTE_FUSED_DECODE_ATTN=force`` (a TPU
measurement); on the card there is no XLA to fold the scales, so both cache
types take the kernel.

What bounds it on the H100: bytes.  Each step streams the whole K and V
cache of a layer (2·S_max·KH·D·2 bytes, 2.4 MB at Llama-3.2-1B with
S_max = 1152; half that with the int8 cache) for a few FLOPs per byte.
The kernel reads each cache row for all G query heads of its KV head at
once: one block per (batch, kv-head), 64-position tiles staged through
shared memory, so no f32 logit row has to fit in shared memory at any
S_max.  It makes two
passes, the first for each head's softmax max and sum, the second for the
exact probabilities and P.V, so that they are rounded to bf16 after
normalisation as in the plain version; that reads K twice.  With B = 1
there are only KH blocks on 132 SMs; splitting S across blocks is later
work.  The int8 rows are converted to bf16 as they are staged (exact), so
the compute is the bf16 branch's.

The TPU kernel's block-diagonal query, lane-roll gather and ones-block
expansion fed the TPU's matrix unit and have no counterpart here.  Nor has
its fresh-row substitution: it existed because JAX updates the cache
functionally.  The port appends this token's K/V row to the cache in place
(quantized for the int8 cache) before the kernel runs, so the kernel reads
the updated cache and the result is the same.
"""

from __future__ import annotations

import torch

from ecg_byte_tpu_torch.ops import _cuda

MAX_HEAD_DIM = 256


def _check(q, k_cache, v_cache, valid_mask, k_scale, v_scale):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError("k_cache must be (B, S_max, KH, D) matching q")
    if v_cache.shape != k_cache.shape:
        raise ValueError("v_cache must have k_cache's shape")
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} KV heads")
    if valid_mask.shape != (b, s) or valid_mask.dtype != torch.int32:
        raise ValueError("valid_mask must be an int32 (B, S_max) tensor")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bfloat16, got {q.dtype}")
    int8 = k_cache.dtype == torch.int8
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != (torch.int8 if int8 else torch.bfloat16):
            raise ValueError(f"{name} must be bfloat16 or int8 like k_cache, got {t.dtype}")
    scales = []
    if int8:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 cache needs k_scale and v_scale")
        scales = [("k_scale", k_scale), ("v_scale", v_scale)]
        for name, t in scales:
            if t.shape != (b, s, kh) or t.dtype != torch.bfloat16:
                raise ValueError(f"{name} must be bfloat16 (B, S_max, KH), got {t.dtype} "
                                 f"{tuple(t.shape)}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales go with an int8 cache only")
    for name, t in [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid_mask", valid_mask)] + scales:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 up to {MAX_HEAD_DIM}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention_fused(q, k_cache, v_cache, valid_mask, k_scale=None, v_scale=None):
    """Single-position attention over the cache; returns (B, 1, H, D).
    ``k_scale``, ``v_scale``: the (B, S_max, KH) bf16 scales of an int8
    cache, None for a bf16 one.

    A CPU tensor takes ``attention.decode_attention``; a CUDA tensor
    launches the kernel or raises.  ``.launches`` counts the launches over
    a bf16 cache, ``.int8_launches`` those over an int8 cache.
    """
    if q.device.type == "cpu":
        from ecg_byte_tpu_torch.ops.attention import decode_attention

        return decode_attention(q, k_cache, v_cache, valid_mask, k_scale, v_scale)
    _check(q, k_cache, v_cache, valid_mask, k_scale, v_scale)
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    lib = _cuda.library()
    int8 = k_cache.dtype == torch.int8
    stream = _cuda.stream(q)
    if int8:
        err = lib.ecg_decode_attention_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), valid_mask.data_ptr(), out.data_ptr(), b, s, kh, h // kh, d,
            stream,
        )
    else:
        err = lib.ecg_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_mask.data_ptr(), out.data_ptr(), b, s, kh, h // kh, d, stream,
        )
    _cuda.check(err, "decode attention")
    if int8:
        decode_attention_fused.int8_launches += 1
    else:
        decode_attention_fused.launches += 1
    return out


decode_attention_fused.launches = 0
decode_attention_fused.int8_launches = 0
