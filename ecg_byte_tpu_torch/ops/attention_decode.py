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

The fresh-row contract of the TPU kernel: with ``fresh_k``, ``fresh_v``
and ``write_idx`` the cache comes in stale and this token's (B, 1, KH, D)
bf16 rows come beside it.  The kernel writes them into slot ``write_idx``
in place (for the int8 cache quantized, with their bf16 scales, by the
quantizer of ``csrc/kv_quant.cu``: IEEE division, round half to even, the
bits of ``_quant_kv_rows``), and attends as if they had been appended
first: phase A's block whose range holds the slot writes the rows and
stages its K row from shared memory, phase B reads the written V row.  So
a decode step launches nothing to append.  One difference from the JAX
signature: the JAX caller quantizes the rows and passes ``fresh_ks`` and
``fresh_vs``; here the kernel quantizes them itself, and the rows come in
bf16 for both cache types.  The TPU kernel substitutes the row in VMEM
and leaves the cache's update to XLA; this one updates the cache too.

The TPU kernel's block-diagonal query, lane-roll gather and ones-block
expansion fed the TPU's matrix unit and have no counterpart here.
"""

from __future__ import annotations

import torch

from ecg_byte_tpu_torch.ops import _cuda, kv_quant
from ecg_byte_tpu_torch.utils.profiling import span

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


def _check(q, k_cache, v_cache, valid_mask, k_scale, v_scale, fresh):
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
    if fresh is not None:
        fresh_k, fresh_v, write_idx = fresh
        for name, t in (("fresh_k", fresh_k), ("fresh_v", fresh_v)):
            if t.shape != (b, 1, kh, d) or t.dtype != torch.bfloat16:
                raise ValueError(f"{name} must be bfloat16 (B, 1, KH, D), got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if not t.is_cuda or t.device != q.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on q's CUDA device")
        if not 0 <= write_idx < s:
            raise ValueError(f"write_idx {write_idx} outside the cache's {s} slots")


def decode_attention_fused_plain(q, k_cache, v_cache, valid_mask, k_scale=None, v_scale=None,
                                 *, fresh_k=None, fresh_v=None, write_idx=None):
    """The plain version of :func:`decode_attention_fused`: the fresh rows
    appended at slot ``write_idx`` in place (quantized by
    ``kv_quant.append_kv_plain`` for an int8 cache, copied for a bf16 one),
    then ``attention.decode_attention`` on the updated cache."""
    from ecg_byte_tpu_torch.ops.attention import decode_attention

    if fresh_k is not None and k_scale is not None:
        kv_quant.append_kv_plain(fresh_k, fresh_v, k_cache, v_cache, k_scale, v_scale, write_idx)
    elif fresh_k is not None:
        k_cache[:, write_idx:write_idx + 1] = fresh_k
        v_cache[:, write_idx:write_idx + 1] = fresh_v
    return decode_attention(q, k_cache, v_cache, valid_mask, k_scale, v_scale)


def decode_attention_fused(q, k_cache, v_cache, valid_mask, k_scale=None, v_scale=None,
                           splits=None, *, fresh_k=None, fresh_v=None, write_idx=None):
    """Single-position attention over the cache; returns (B, 1, H, D).
    ``k_scale``, ``v_scale``: the (B, S_max, KH) bf16 scales of an int8
    cache, None for a bf16 one.  ``splits`` overrides :func:`num_splits`.
    ``fresh_k``, ``fresh_v`` (B, 1, KH, D) and ``write_idx``: this token's
    rows, written into the (stale) cache at slot ``write_idx`` in place,
    quantized for an int8 cache, before they are attended.

    A CPU tensor takes :func:`decode_attention_fused_plain`; a CUDA tensor
    launches the kernel or raises.  ``.launches`` counts the wrapper's
    calls over a bf16 cache, ``.int8_launches`` those over an int8 cache.
    """
    if (fresh_k is None) != (fresh_v is None) or (fresh_k is None) != (write_idx is None):
        raise ValueError("fresh_k, fresh_v and write_idx go together")
    with span("ecg.attn.decode"):
        if q.device.type == "cpu":
            return decode_attention_fused_plain(q, k_cache, v_cache, valid_mask, k_scale,
                                                v_scale, fresh_k=fresh_k, fresh_v=fresh_v,
                                                write_idx=write_idx)
        fresh = None if fresh_k is None else (fresh_k, fresh_v, int(write_idx))
        _check(q, k_cache, v_cache, valid_mask, k_scale, v_scale, fresh)
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
        fk, fv, idx = (None, None, -1) if fresh is None else (fresh[0].data_ptr(),
                                                             fresh[1].data_ptr(), fresh[2])
        if int8:
            err = lib.ecg_decode_attention_int8(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), valid_mask.data_ptr(), fk, fv, out.data_ptr(), work.data_ptr(),
                b, s, kh, h // kh, d, splits, idx, stream,
            )
        else:
            err = lib.ecg_decode_attention(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_mask.data_ptr(), fk, fv,
                out.data_ptr(), work.data_ptr(), b, s, kh, h // kh, d, splits, idx, stream,
            )
        _cuda.check(err, "decode attention")
        if int8:
            decode_attention_fused.int8_launches += 1
        else:
            decode_attention_fused.launches += 1
        return out


decode_attention_fused.launches = 0
decode_attention_fused.int8_launches = 0
