"""The int8 KV cache's append: quantize this step's K/V rows and write them
into one layer's cache, through the CUDA kernel in ``csrc/kv_quant.cu`` or
its plain PyTorch version.

The port of ``_quant_kv_rows`` and ``_append_kv`` of
``ecg_byte_tpu/models/transformer.py``, which XLA fuses on the TPU (no
Pallas kernel).  Each cached (position, kv head) row keeps its own absmax
scale over D: the row is quantized with the f32 scale, and the scale is
stored, and later dequantized, rounded to bf16.

Why a kernel: the plain version costs about twelve launches per layer
(absmax, where, divide, round, clamp, casts and four slice writes).  The
kernel is one launch per layer for K and V together, and equals the plain
version bit for bit: IEEE division and round-half-to-even in both.  It
appends a prompt's rows at prefill, where it is bound by bytes: a group of
D / 8 lanes quantizes a row of K and V from 16-byte loads (its design is in
the source).  A decode step's row is quantized and written by decode
attention itself (``ops/attention_decode``), with the same arithmetic
(``csrc/kv_quant.cuh``), so the step launches nothing to append.  The
kernel takes head dims that are a multiple of 8, up to 256.

A CPU tensor takes :func:`append_kv_plain`; a CUDA tensor launches the
kernel or raises.  ``append_kv.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from ecg_byte_tpu_torch.ops import _cuda

MAX_HEAD_DIM = 256


def quant_kv_rows(new: torch.Tensor):
    """(B, s, KH, D) -> (int8 rows, (B, s, KH) bf16 scales): per-row
    symmetric absmax over D (``_quant_kv_rows``).  The divisor 127 is a
    tensor on the rows' device: PyTorch's CUDA division by a CPU scalar
    multiplies by its reciprocal, which is not IEEE division."""
    f = new.float()
    amax = f.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def append_kv_plain(k, v, k_cache, v_cache, k_scale, v_scale, idx: int) -> None:
    """Quantize ``k``, ``v`` (B, s, KH, D) and write them, with their
    scales, at cache slots [idx, idx + s) of one layer's (B, S, KH, D) int8
    cache and (B, S, KH) bf16 scales, in place."""
    s = k.shape[1]
    for new, cache, scales in ((k, k_cache, k_scale), (v, v_cache, v_scale)):
        q, sc = quant_kv_rows(new)
        cache[:, idx:idx + s] = q
        scales[:, idx:idx + s] = sc


def _check(k, v, k_cache, v_cache, k_scale, v_scale, idx):
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, s, KH, D), got {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, kh, d = k.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[2:] != (kh, d):
        raise ValueError(f"k_cache must be (B, S, KH, D) matching k, got {tuple(k_cache.shape)}")
    big_s = k_cache.shape[1]
    if v_cache.shape != k_cache.shape:
        raise ValueError("v_cache must have k_cache's shape")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.shape != (b, big_s, kh) or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 (B, S, KH), got {t.dtype} {tuple(t.shape)}")
    for name, t, dt in (("k", k, torch.bfloat16), ("v", v, torch.bfloat16),
                        ("k_cache", k_cache, torch.int8), ("v_cache", v_cache, torch.int8)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("k", k), ("v", v), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if not t.is_cuda or t.device != k.device:
            raise ValueError(f"{name} must lie on k's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up to {MAX_HEAD_DIM}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned")
    if idx < 0 or idx + s > big_s:
        raise ValueError(f"slots [{idx}, {idx + s}) outside the cache's {big_s}")


def append_kv(k, v, k_cache, v_cache, k_scale, v_scale, idx: int) -> None:
    """Quantize and append ``k``, ``v`` at slot ``idx`` of one layer's int8
    cache, in place (see :func:`append_kv_plain`)."""
    if k.device.type == "cpu":
        return append_kv_plain(k, v, k_cache, v_cache, k_scale, v_scale, idx)
    # the kernel loads 16 bytes a lane: a misaligned view is copied
    k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (k, v))
    _check(k, v, k_cache, v_cache, k_scale, v_scale, idx)
    b, s, kh, d = k.shape
    lib = _cuda.library()
    stream = _cuda.stream(k)
    err = lib.ecg_kv_quant(
        k.data_ptr(), v.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), b, s, k_cache.shape[1], kh, d, idx, stream,
    )
    _cuda.check(err, "kv quant")
    append_kv.launches += 1


append_kv.launches = 0
