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
One block per (batch, kv-head) is only 8 blocks on 132 SMs at batch 1, so
the kernel splits the cache's 64-position tiles into :func:`num_splits`
contiguous ranges, one block each, in three launches from one C call:
(A) each range's logits (to scratch) and its softmax max and sum; (B) the
row's max and sum combined from every range's in range order, then the
exact probabilities exp(logit - m) / l, rounded to bf16 after
normalisation as in the plain version, and each range's P.V in f32; (C)
the ranges' partials summed in range order and rounded.  K is read once,
all G query heads of a KV head share each staged tile, and the int8 rows
are converted to bf16 as they are staged (exact), so the compute is the
bf16 branch's.  The wrapper allocates one f32 scratch tensor a call
(:func:`scratch_floats`).

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
KEYS = 64  # cache positions per tile
BLOCKS_PER_SM = 8  # num_splits aims at one wave of this many blocks on every SM


def num_splits(b: int, kh: int, s_max: int, sm_count: int) -> int:
    """How many ranges the kernel splits the cache's tiles into: about one
    wave of BLOCKS_PER_SM blocks on each of ``sm_count`` SMs over the
    B x KH (batch row, kv head) pairs, at least 1 and at most one range a
    tile, so that no range is empty; then as few ranges as give every
    range the same most tiles (the slowest range sets the time)."""
    tiles = -(-s_max // KEYS)
    target = max(1, min(tiles, BLOCKS_PER_SM * sm_count // (b * kh)))
    per = -(-tiles // target)  # tiles of the longest range
    return -(-tiles // per)


def split_ranges(s_max: int, splits: int) -> list:
    """The (first, last + 1) cache positions of each range, as the kernel
    cuts them: range i starts at tile i * tiles // splits."""
    tiles = -(-s_max // KEYS)
    starts = [i * tiles // splits * KEYS for i in range(splits + 1)]
    return [(lo, min(hi, s_max)) for lo, hi in zip(starts, starts[1:])]


def scratch_floats(b: int, s_max: int, kh: int, g: int, d: int, splits: int) -> int:
    """The f32 scratch of one call: logits (B, KH, G, S_max), each range's
    max and sum (B, KH, splits, G, 2), and with more than one range their
    P.V partials (B, KH, splits, G, D)."""
    rows = b * kh * g
    return rows * (s_max + 2 * splits + (splits * d if splits > 1 else 0))


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


def decode_attention_fused(q, k_cache, v_cache, valid_mask, k_scale=None, v_scale=None,
                           splits=None):
    """Single-position attention over the cache; returns (B, 1, H, D).
    ``k_scale``, ``v_scale``: the (B, S_max, KH) bf16 scales of an int8
    cache, None for a bf16 one.  ``splits`` overrides :func:`num_splits`.

    A CPU tensor takes ``attention.decode_attention``; a CUDA tensor
    launches the kernel or raises.  ``.launches`` counts the wrapper's
    calls over a bf16 cache, ``.int8_launches`` those over an int8 cache.
    """
    if q.device.type == "cpu":
        from ecg_byte_tpu_torch.ops.attention import decode_attention

        return decode_attention(q, k_cache, v_cache, valid_mask, k_scale, v_scale)
    _check(q, k_cache, v_cache, valid_mask, k_scale, v_scale)
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if splits is None:
        splits = num_splits(b, kh, s, _cuda.sm_count(q.device.index))
    elif not 1 <= splits <= -(-s // KEYS):
        raise ValueError(f"splits must be 1 to {-(-s // KEYS)} (one a tile), got {splits}")
    out = torch.empty_like(q)
    work = torch.empty(scratch_floats(b, s, kh, h // kh, d, splits), dtype=torch.float32,
                       device=q.device)
    lib = _cuda.library()
    int8 = k_cache.dtype == torch.int8
    stream = _cuda.stream(q)
    if int8:
        err = lib.ecg_decode_attention_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), valid_mask.data_ptr(), out.data_ptr(), work.data_ptr(),
            b, s, kh, h // kh, d, splits, stream,
        )
    else:
        err = lib.ecg_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_mask.data_ptr(),
            out.data_ptr(), work.data_ptr(), b, s, kh, h // kh, d, splits, stream,
        )
    _cuda.check(err, "decode attention")
    if int8:
        decode_attention_fused.int8_launches += 1
    else:
        decode_attention_fused.launches += 1
    return out


decode_attention_fused.launches = 0
decode_attention_fused.int8_launches = 0
