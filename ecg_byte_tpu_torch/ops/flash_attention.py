"""Long-context attention: the wrappers of the CUDA kernels in
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward), their plain PyTorch versions, and :class:`FlashAttention`, the
autograd function that joins them.

The counterpart of ``ecg_byte_tpu/ops/flash_attention.py``, which the JAX
package runs for S >= 4096 (``ecg_byte_tpu/ops/attention.py:142-144``):

- :func:`flash_attention_fwd` replaces ``_fwd_kernel`` (``:41``), reached
  through ``_flash_fwd`` (``:200``);
- :func:`flash_attention_bwd` replaces ``_bwd_dq_kernel`` (``:93``) and
  ``_bwd_dkv_kernel`` (``:131``), reached through ``_flash_bwd`` (``:251``).

It computes a different function from the resident kernels
(``attention_resident.py``), and the difference is in the rounding: keys
come in blocks of ``block_k`` (128), and per block the row max steps to
``m_new = max(m, max_block s)``, ``p = exp(s - m_new)`` in f32 enters the
row sum ``l`` as it is and ``P.V`` rounded to the input dtype, against a
running max that a later block may raise; the output is ``acc / l`` and
the saved log-sum-exp ``lse = m + log(l)``.  So the probabilities rounded
are unnormalised, and what they are rounded against depends on where the
128-key boundaries fall.  Key blocks wholly after the query's block are
skipped (``:53``); query blocks have ``block_k`` rows too.  The backward
recomputes ``p = exp(s - lse)`` per block: ``dV = bf16(p)^T dO``, ``dP =
dO V^T``, ``delta = rowsum(dO O)`` from the bf16 output, ``dS = bf16(p (dP
- delta) scale)``, ``dQ = dS K``, ``dK = dS^T Q``; the JAX code rounds dK
and dV per query head, then sums the G heads of each KV head (``:339-343``).

What bounds both kernels on the H100 is operations: at B1 S4096 the
forward's causal products are 68.7 GFLOP against 42 MB, the backward's
172 GFLOP against 84 MB.  So both run every product on the tensor cores
(``wgmma``).  The forward (``csrc/attention_fwd_tc.cuh``, flash policy,
the core it shares with the resident forward) takes one block per 64
query rows and streams whole 128-key blocks through a cp.async ring: both
64-key score products land before the row max steps, so it steps where
the TPU kernel's does, and P goes from the score accumulators straight
into P.V's register operand.  The backward (``csrc/attention_bwd_tc.cuh``,
flash policy, shared with the resident backward) is a dQ kernel over query
tiles and a dK/dV kernel over (key tile, KV head) that walks the G query
heads in order and sums their bf16-rounded dK, dV in f32 in shared memory,
rounding once at the end, so no per-head buffer goes through device memory.

Masked logits get the finite ``-1e30``.  A row whose keys so far are all
masked (left padding longer than a block) has ``m = -1e30`` and ``p = 1``
on every key; the first valid key's block wipes them with ``exp(-1e30 -
m) = 0``.  A left-pad row never meets a valid key: it ends with the mean of
V over its blocks and ``lse = -1e30``, and its backward sees ``p = 1`` on
every key of those blocks.  Everything stays finite.

Layouts are the port's: ``qg (B, S, KH, G, D)``, ``k, v (B, S, KH, D)``,
``pad_mask (B, S)`` int32; ``lse (B, KH, G, S)`` f32, one row per (batch,
query head) as the JAX kernel's ``(B*H, S)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ecg_byte_tpu_torch.ops import _cuda
from ecg_byte_tpu_torch.ops.attention import NEG_INF
from ecg_byte_tpu_torch.ops.attention_resident import check_inputs
from ecg_byte_tpu_torch.utils.profiling import span

BLOCK_K = 128  # keys per max step, and query rows per block: the JAX kernel's at S >= 4096


def _padded(x, sp, dim=1):
    """``x`` with dimension ``dim`` zero-padded to ``sp``."""
    return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, sp - x.shape[dim]])


def _layout(qg, k, v, pad_mask, block_k):
    """Pad S to a multiple of ``block_k`` and lay out per (batch, head):
    q (B, KH, G, Sp, D) and k (B, KH, Sp, D) in the compute type (f32,
    f64 for f64 inputs), v (B, KH, Sp, D) as given, key_ok (B, 1, 1, 1,
    Sp) bool."""
    ct = torch.promote_types(qg.dtype, torch.float32)
    s = qg.shape[1]
    sp = -(-s // block_k) * block_k
    q = _padded(qg, sp).permute(0, 2, 3, 1, 4).to(ct)
    kk = _padded(k, sp).permute(0, 2, 1, 3).to(ct)
    vv = _padded(v, sp).permute(0, 2, 1, 3)
    key_ok = _padded(pad_mask, sp).bool()[:, None, None, None, :]
    return ct, sp, q, kk, vv, key_ok


def _scores(q_rows, k_keys, key_ok, r0, t1, scale):
    """Masked scores of query rows [r0, r0 + n) against keys [0, t1) (or
    the key block ending at t1, with ``k_keys`` and ``key_ok`` cut to it)."""
    s = torch.einsum("bkgqd,bktd->bkgqt", q_rows, k_keys) * scale
    n, t = q_rows.shape[-2], k_keys.shape[-2]
    q_pos = torch.arange(r0, r0 + n, device=s.device)[:, None]
    k_pos = torch.arange(t1 - t, t1, device=s.device)[None, :]
    return torch.where((q_pos >= k_pos) & key_ok, s, NEG_INF)


def flash_attention_fwd_plain(qg, k, v, pad_mask, block_k=BLOCK_K):
    """The TPU forward kernel's math in plain PyTorch: returns ``(out,
    lse)``, out like ``qg`` and lse (B, KH, G, S) f32 (f64 for f64 inputs).

    Loops over key blocks with the online recurrence, each block updating
    only the query rows of its own and later blocks, as the kernel skips
    the rest; no (S, S) tensor is formed.
    """
    b, s, kh, g, d = qg.shape
    ct, sp, q, kk, vv, key_ok = _layout(qg, k, v, pad_mask, block_k)
    scale = d**-0.5
    m = torch.full((b, kh, g, sp), NEG_INF, dtype=ct, device=qg.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kh, g, sp, d), dtype=ct, device=qg.device)
    for t0 in range(0, sp, block_k):
        t1 = t0 + block_k
        sc = _scores(q[..., t0:, :], kk[:, :, t0:t1], key_ok[..., t0:t1], t0, t1, scale)
        m_prev = m[..., t0:]
        m_new = torch.maximum(m_prev, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l[..., t0:] = l[..., t0:] * corr + p.sum(-1)
        pv = torch.einsum("bkgqt,bktd->bkgqd", p.to(qg.dtype).to(ct), vv[:, :, t0:t1].to(ct))
        acc[..., t0:, :] = acc[..., t0:, :] * corr[..., None] + pv
        m[..., t0:] = m_new
    safe_l = torch.where(l == 0, 1.0, l)
    out = (acc / safe_l[..., None]).to(qg.dtype)[..., :s, :].permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(safe_l))[..., :s]
    return out.contiguous(), lse.contiguous()


def flash_attention_bwd_plain(qg, k, v, pad_mask, out, lse, grad, block_k=BLOCK_K):
    """The TPU backward kernels' math in plain PyTorch: returns (dq, dk,
    dv) like (qg, k, v).

    One query block at a time from the saved ``lse``, against the keys of
    its own and earlier blocks; dK and dV are summed per query head in the
    compute type, rounded to the input dtype, then summed over the G heads
    of each KV head and rounded again, as the JAX code does.
    """
    b, s, kh, g, d = qg.shape
    ct, sp, q, kk, vv, key_ok = _layout(qg, k, v, pad_mask, block_k)
    vv = vv.to(ct)
    scale = d**-0.5
    do = _padded(grad, sp).permute(0, 2, 3, 1, 4).to(ct)
    delta = (do * _padded(out, sp).permute(0, 2, 3, 1, 4).to(ct)).sum(-1)
    lse_p = _padded(lse.to(ct), sp, dim=3)
    dq = torch.zeros_like(q)
    dk_h = torch.zeros_like(q)
    dv_h = torch.zeros_like(q)
    for r0 in range(0, sp, block_k):
        r1 = r0 + block_k
        sc = _scores(q[..., r0:r1, :], kk[:, :, :r1], key_ok[..., :r1], r0, r1, scale)
        p = torch.exp(sc - lse_p[..., r0:r1, None])
        do_r = do[..., r0:r1, :]
        dv_h[..., :r1, :] += torch.einsum("bkgqt,bkgqd->bkgtd", p.to(qg.dtype).to(ct), do_r)
        dp = torch.einsum("bkgqd,bktd->bkgqt", do_r, vv[:, :, :r1])
        ds = (p * (dp - delta[..., r0:r1, None]) * scale).to(qg.dtype).to(ct)
        dq[..., r0:r1, :] = torch.einsum("bkgqt,bktd->bkgqd", ds, kk[:, :, :r1])
        dk_h[..., :r1, :] += torch.einsum("bkgqt,bkgqd->bkgtd", ds, q[..., r0:r1, :])

    dq = dq.to(qg.dtype)[..., :s, :].permute(0, 3, 1, 2, 4).contiguous()
    return dq, _head_sum(dk_h, qg.dtype, s), _head_sum(dv_h, qg.dtype, s)


def _head_sum(x, dtype, s):
    """Per-query-head gradients ``x`` (B, KH, G, Sp, D) in the compute type ->
    (B, s, KH, D) in ``dtype``: each head rounded to ``dtype``, summed over
    the G heads in the compute type and rounded again, as the JAX code does
    (``ecg_byte_tpu/ops/flash_attention.py:338-343``)."""
    ct = x.dtype
    return x.to(dtype).to(ct).sum(2).to(dtype)[:, :, :s].transpose(1, 2).contiguous()


def flash_attention_fwd(qg, k, v, pad_mask):
    """Causal grouped-query flash attention, forward: returns ``(out,
    lse)``.  A CPU tensor takes :func:`flash_attention_fwd_plain`; a CUDA
    tensor launches the kernel or raises.  Differentiable callers go
    through :class:`FlashAttention`."""
    if qg.device.type == "cpu":
        return flash_attention_fwd_plain(qg, k, v, pad_mask)
    check_inputs(qg, k, v, pad_mask)
    b, s, kh, g, d = qg.shape
    out = torch.empty_like(qg)
    lse = torch.empty((b, kh, g, s), dtype=torch.float32, device=qg.device)
    err = _cuda.library().ecg_flash_attention(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, kh, g, d, _cuda.stream(qg),
    )
    _cuda.check(err, "flash attention")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(qg, k, v, pad_mask, out, lse, grad):
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd` from its
    ``out`` and ``lse`` for the output gradient ``grad``.  A CPU tensor
    takes :func:`flash_attention_bwd_plain`; a CUDA tensor launches the
    backward kernels (one count) or raises."""
    if qg.device.type == "cpu":
        return flash_attention_bwd_plain(qg, k, v, pad_mask, out, lse, grad)
    check_inputs(qg, k, v, pad_mask)
    b, s, kh, g, d = qg.shape
    for name, t in (("out", out), ("grad", grad)):
        if t.shape != qg.shape or t.dtype != qg.dtype or t.device != qg.device:
            raise ValueError(f"{name} must match qg's shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (lse.shape != (b, kh, g, s) or lse.dtype != torch.float32 or lse.device != qg.device
            or not lse.is_contiguous()):
        raise ValueError("lse must be a contiguous f32 (B, KH, G, S) tensor on qg's device")
    dq, dk, dv = torch.empty_like(qg), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, kh, g, s), dtype=torch.float32, device=qg.device)
    err = _cuda.library().ecg_flash_attention_bwd(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(), out.data_ptr(),
        lse.data_ptr(), grad.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), b, s, kh, g, d, _cuda.stream(qg),
    )
    _cuda.check(err, "flash attention backward")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (``_flash`` with its
    ``jax.custom_vjp``): the forward kernel, and the backward kernels from
    the saved inputs, output and log-sum-exp; no probabilities are kept.
    The wrappers are looked up when called, so a test can swap in their
    plain versions."""

    @staticmethod
    def forward(ctx, qg, k, v, pad_mask):
        out, lse = flash_attention_fwd(qg, k, v, pad_mask)
        ctx.save_for_backward(qg, k, v, pad_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        with span("ecg.attn.bwd"):
            qg, k, v, pad_mask, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd(qg, k, v, pad_mask, out, lse, grad.contiguous())
        return dq, dk, dv, None
