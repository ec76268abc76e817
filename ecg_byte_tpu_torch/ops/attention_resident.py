"""Prefill attention: the wrapper of the CUDA kernel in
``csrc/attention_prefill.cu``.

Replaces the Pallas forward kernel ``_fwd_kernel`` of
``ecg_byte_tpu/ops/attention_resident.py`` (reached through
``resident_attention`` and ``_resident_impl``): causal grouped-query
attention with a (B, S) left-pad key mask, f32 logits and softmax, P.V on
bf16 probabilities with f32 accumulation.  The layout at the interface is
the JAX one, ``qg (B, S, KH, G, D)`` and ``k, v (B, S, KH, D)``.

The TPU kernel holds a whole (batch, kv-head) row of keys in VMEM and takes
an exact softmax over it.  A Hopper block has at most 227 KB of shared
memory, so the CUDA kernel tiles instead: one block per (batch, kv-head,
tile of query positions), the G query heads of that KV head folded into
the tile's 64 rows so each K/V tile loaded into shared memory serves all
of them, and loops over 64-key tiles up to the causal edge.  The first loop
finds each row's softmax max and sum; the second recomputes the scores and
forms the exact probabilities, rounded to bf16 after normalisation as the
TPU kernel and the plain version round them, for P.V.  (An online softmax
rounds unnormalized probabilities; through 16 layers of random weights
that moved the logits past the end-to-end bound.)  What bounds it at
S = 1024 is arithmetic: about 6·S²·H·D/2 operations with the recomputed
scores against O(S·H·D) bytes; this first version does them as f32 FMAs
from shared memory, not on the tensor cores (``mma.sync``/``wgmma`` are
later work).

Masked logits get the finite ``-1e30`` of the JAX code, and every row sees
at least its first key tile, so a left-pad query row whose keys are all
masked ends finite: its V average is garbage that nothing valid reads, but
never NaN, which decode's P.V would spread through the cache.
"""

from __future__ import annotations

import torch

from ecg_byte_tpu_torch.ops import _cuda

ROWS = 64  # query rows per block: G heads x (ROWS / G) positions
HEAD_DIMS = (64, 128, 256)  # the kernel's template instances


def _check(qg, k, v, pad_mask):
    if qg.dim() != 5:
        raise ValueError(f"qg must be (B, S, KH, G, D), got {tuple(qg.shape)}")
    b, s, kh, g, d = qg.shape
    if k.shape != (b, s, kh, d) or v.shape != (b, s, kh, d):
        raise ValueError("k and v must be (B, S, KH, D) matching qg")
    if pad_mask.shape != (b, s) or pad_mask.dtype != torch.int32:
        raise ValueError("pad_mask must be an int32 (B, S) tensor")
    for name, t in (("qg", qg), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    for name, t in (("qg", qg), ("k", k), ("v", v), ("pad_mask", pad_mask)):
        if not t.is_cuda or t.device != qg.device:
            raise ValueError(f"{name} must lie on qg's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if ROWS % g:
        raise ValueError(f"{g} query heads per KV head do not divide {ROWS}")
    if s % 16:
        raise ValueError(f"sequence length {s} is not a multiple of 16")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qg, k, v)):
        raise NotImplementedError(
            "prefill attention kernel is forward only; run under "
            "torch.inference_mode()"
        )


def resident_attention(qg, k, v, pad_mask):
    """Causal grouped-query attention; returns (B, S, KH, G, D).

    A CPU tensor takes ``attention.grouped_attention``; a CUDA tensor
    launches the kernel or raises.
    """
    if qg.device.type == "cpu":
        from ecg_byte_tpu_torch.ops.attention import grouped_attention

        return grouped_attention(qg, k, v, pad_mask)
    _check(qg, k, v, pad_mask)
    b, s, kh, g, d = qg.shape
    out = torch.empty_like(qg)
    lib = _cuda.library()
    with torch.cuda.device(qg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ecg_prefill_attention(
            qg.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(),
            out.data_ptr(), b, s, kh, g, d, stream,
        )
    _cuda.check(err, "prefill attention")
    resident_attention.launches += 1
    return out


resident_attention.launches = 0
