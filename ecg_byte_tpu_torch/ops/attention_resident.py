"""Prefill and training attention: the wrappers of the CUDA kernels in
``csrc/attention_prefill.cu`` (forward) and ``csrc/attention_prefill_bwd.cu``
(backward), and :class:`ResidentAttention`, the autograd function that
joins them.

Replaces the Pallas kernels of ``ecg_byte_tpu/ops/attention_resident.py``:
the forward ``_fwd_kernel`` (reached through ``_resident_impl``) and the
backward ``_bwd_kernel`` (reached through ``_resident_bwd``).  Causal
grouped-query attention with a (B, S) left-pad key mask, f32 logits and
softmax, P.V on bf16 probabilities with f32 accumulation.  The layout at
the interface is the JAX one, ``qg (B, S, KH, G, D)`` and
``k, v (B, S, KH, D)``.

The TPU kernel holds a whole (batch, kv-head) row of keys in VMEM and takes
an exact softmax over it.  A Hopper block has at most 227 KB of shared
memory, so the CUDA kernel tiles instead: one block (one warpgroup) per
(batch, kv-head, tile of query positions), the G query heads of that KV
head folded into the tile's 64 rows so each K/V tile loaded into shared
memory serves all of them, and loops over 64-key tiles up to the causal
edge.  The first loop finds each row's softmax max and sum; the second
recomputes the scores and forms the exact probabilities, rounded to bf16
after normalisation as the TPU kernel and the plain version round them,
for P.V.  (An online softmax rounds unnormalized probabilities; through 16
layers of random weights that moved the logits past the end-to-end
bound.)  What bounds it on the H100 is operations: 17.2 GFLOP of causal
products at B4 S1024 (half again for the first loop's scores) against 42
MB.  So both products run on the tensor cores (``wgmma``, the forward
core ``csrc/attention_fwd_tc.cuh``): the scores from Q and K tiles in
shared memory, P.V with P straight from the score accumulators as the
register operand and V read N-major, while the next K/V tile loads.  The
first loop and the probability are the backward's own (below), so the
backward recomputes the forward's P bit for bit.

Masked logits get the finite ``-1e30`` of the JAX code, and every row sees
at least its first key tile, so a left-pad query row whose keys are all
masked ends finite: its V average is garbage that nothing valid reads, but
never NaN, which decode's P.V would spread through the cache.

The backward follows the TPU kernel's math (``resident_attention_bwd_plain``
repeats it in plain PyTorch): the exact probabilities recomputed in f32
from each row's max and sum over all its keys, dV = bf16(P)^T dO, dP = dO
V^T, delta = rowsum(dO O), dS = bf16(P (dP - delta) scale), dQ = dS K, dK =
dS^T Q, dK and dV summed over the G query heads in f32 and rounded once.
It is bounded by operations too, and all five products run on the tensor
cores (``wgmma``, ``csrc/attention_bwd_tc.cuh``): P and dS go from the
score accumulators straight into the next product's register operand, and
the next key or query tile loads while the current one computes.  Where
the TPU kernel carries dK and dV across a sequential grid axis, the CUDA
backward splits the work FlashAttention-2 style into a dQ kernel over
query tiles (its first pass finds each row's max and sum) and a dK/dV
kernel over key tiles, with no atomics, so a call is deterministic.  Its P
is the same in both kernels and the forward's.
"""

from __future__ import annotations

import torch

from ecg_byte_tpu_torch.ops import _cuda
from ecg_byte_tpu_torch.ops.attention import NEG_INF, _causal, grouped_attention
from ecg_byte_tpu_torch.utils.profiling import span

ROWS = 64  # query rows per block: G heads x (ROWS / G) positions
HEAD_DIMS = (64, 128, 256)  # the kernel's template instances


def check_inputs(qg, k, v, pad_mask):
    """Raise unless the inputs are what the attention kernels take: bf16
    ``qg (B, S, KH, G, D)``, ``k, v (B, S, KH, D)`` and an int32 (B, S)
    mask, contiguous on one CUDA device, D one of :data:`HEAD_DIMS` and G
    dividing the tile's :data:`ROWS`."""
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


def _check(qg, k, v, pad_mask):
    check_inputs(qg, k, v, pad_mask)
    s = qg.shape[1]
    if s % 16:
        raise ValueError(f"sequence length {s} is not a multiple of 16")


def resident_attention(qg, k, v, pad_mask):
    """Causal grouped-query attention, forward only; returns (B, S, KH, G, D).

    A CPU tensor takes ``attention.grouped_attention``; a CUDA tensor
    launches the kernel or raises.  Differentiable callers go through
    :class:`ResidentAttention`.
    """
    if qg.device.type == "cpu":
        return grouped_attention(qg, k, v, pad_mask)
    _check(qg, k, v, pad_mask)
    b, s, kh, g, d = qg.shape
    out = torch.empty_like(qg)
    lib = _cuda.library()
    stream = _cuda.stream(qg)
    err = lib.ecg_prefill_attention(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(),
        out.data_ptr(), b, s, kh, g, d, stream,
    )
    _cuda.check(err, "prefill attention")
    resident_attention.launches += 1
    return out


resident_attention.launches = 0

# The ways ``csrc/attention_bwd_tc.cuh`` can sum the score product S = Q K^T
# (its ``Dot``): one wgmma accumulator chained over the k16 steps, a zeroed
# accumulator a k16 step with the partials added in f32, f32 FMAs on the
# CUDA cores.  Every model path takes the one that file names ``kDot``; the
# two diagnostics below take any, for ``chip_smoke.py --blame``.
SCORE_DOTS = {"chain": 0, "split": 1, "fma": 2}
# The diagnostic forwards of ``ecg_prefill_attention_dot``: the scores each
# way, then f32 FMA scores with every other step rounded to nearest too
# (P.V on f32 FMAs, p = expf(s - m) / l).
FORWARD_VARIANTS = {"chain scores": 0, "split scores": 1, "fma scores": 2,
                    "fma scores, fma P.V, expf": 3}


def resident_attention_dot(qg, k, v, pad_mask, variant):
    """:func:`resident_attention` with its arithmetic changed as
    ``variant`` (a key of :data:`FORWARD_VARIANTS`) says, D = 64 only.  A
    diagnostic: no model path calls it.  A CPU tensor takes
    ``grouped_attention``."""
    if qg.device.type == "cpu":
        return grouped_attention(qg, k, v, pad_mask)
    _check(qg, k, v, pad_mask)
    b, s, kh, g, d = qg.shape
    if d != 64:
        raise ValueError(f"the score variants are built for D 64 only, got {d}")
    out = torch.empty_like(qg)
    err = _cuda.library().ecg_prefill_attention_dot(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(),
        out.data_ptr(), b, s, kh, g, d, FORWARD_VARIANTS[variant], _cuda.stream(qg),
    )
    _cuda.check(err, f"prefill attention, {variant}")
    resident_attention_dot.launches += 1
    return out


resident_attention_dot.launches = 0


def attention_scores(q, k, dot):
    """The attention cores' score product alone: ``q . k^T`` in f32 of T
    tile pairs, q and k (T, 64, 64) bf16, summed as ``dot`` (a key of
    :data:`SCORE_DOTS`) says.  A diagnostic: no model path calls it.  A
    CPU tensor takes the plain f32 product."""
    if q.device.type == "cpu":
        return torch.einsum("trd,tsd->trs", q.float(), k.float())
    if q.dim() != 3 or q.shape[1:] != (ROWS, 64) or k.shape != q.shape:
        raise ValueError(f"q and k must be (T, {ROWS}, 64), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    for name, t in (("q", q), ("k", k)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous bf16 on q's device")
    out = torch.empty(q.shape[0], ROWS, ROWS, dtype=torch.float32, device=q.device)
    err = _cuda.library().ecg_attention_scores(
        q.data_ptr(), k.data_ptr(), out.data_ptr(), q.shape[0], 64, SCORE_DOTS[dot],
        _cuda.stream(q),
    )
    _cuda.check(err, f"attention scores, {dot}")
    attention_scores.launches += 1
    return out


attention_scores.launches = 0


def resident_attention_bwd_plain(qg, k, v, pad_mask, out, grad):
    """The TPU backward kernel's math in plain PyTorch: returns (dq, dk, dv).

    Computes in f32 (f64 for f64 inputs), with the probabilities and dS
    rounded to the input dtype where the kernel rounds them to bf16.
    """
    ct = torch.promote_types(qg.dtype, torch.float32)
    d, s = qg.shape[-1], qg.shape[1]
    scale = d**-0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(ct), k.to(ct)) * scale
    causal = _causal(s, qg.device)
    bias = torch.where(causal, 0.0, NEG_INF)
    if pad_mask is not None:
        bias = bias + torch.where(pad_mask[:, None, None, None, :].bool(), 0.0, NEG_INF)
    p = torch.softmax(logits + bias.to(ct), dim=-1)  # (B, KH, G, S, S)
    g = grad.to(ct)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(qg.dtype).to(ct), g)
    dp = torch.einsum("bqkgd,bskd->bkgqs", g, v.to(ct))
    delta = (g * out.to(ct)).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B, KH, G, S, 1)
    ds = (p * (dp - delta) * scale).to(qg.dtype).to(ct)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(ct))
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg.to(ct))
    return dq.to(qg.dtype), dk.to(k.dtype), dv.to(v.dtype)


def resident_attention_bwd(qg, k, v, pad_mask, out, grad):
    """Gradients (dq, dk, dv) of :func:`resident_attention` at output ``out``
    for the output gradient ``grad``.

    A CPU tensor takes :func:`resident_attention_bwd_plain`; a CUDA tensor
    launches the two backward kernels or raises.
    """
    if qg.device.type == "cpu":
        return resident_attention_bwd_plain(qg, k, v, pad_mask, out, grad)
    _check(qg, k, v, pad_mask)
    for name, t in (("out", out), ("grad", grad)):
        if t.shape != qg.shape or t.dtype != qg.dtype or t.device != qg.device:
            raise ValueError(f"{name} must match qg's shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, s, kh, g, d = qg.shape
    dq, dk, dv = torch.empty_like(qg), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(3 * b * kh * s * g, dtype=torch.float32, device=qg.device)
    lib = _cuda.library()
    stream = _cuda.stream(qg)
    err = lib.ecg_prefill_attention_bwd(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(),
        out.data_ptr(), grad.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), b, s, kh, g, d, stream,
    )
    _cuda.check(err, "prefill attention backward")
    resident_attention_bwd.launches += 1
    return dq, dk, dv


resident_attention_bwd.launches = 0


class ResidentAttention(torch.autograd.Function):
    """Differentiable causal grouped-query attention (``resident_attention``
    with its ``jax.custom_vjp``): the forward kernel, and the backward
    kernels from the saved inputs and output.  The wrappers are looked up
    when called, so a test can swap in their plain versions."""

    @staticmethod
    def forward(ctx, qg, k, v, pad_mask):
        out = resident_attention(qg, k, v, pad_mask)
        ctx.save_for_backward(qg, k, v, pad_mask, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        with span("ecg.attn.bwd"):
            qg, k, v, pad_mask, out = ctx.saved_tensors
            dq, dk, dv = resident_attention_bwd(qg, k, v, pad_mask, out, grad.contiguous())
        return dq, dk, dv, None
