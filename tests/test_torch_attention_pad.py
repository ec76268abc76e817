"""The resident route at a sequence length that is not a multiple of 16.

The resident kernels take S in multiples of ``RESIDENT_SEQ_TILE`` (16); a
training item is ``pad_to_max + 4`` tokens, so ``cli.main``'s default
``--pad_to_max 1000`` gives S 1004 and the README's 500 gives S 504.  On
the card ``causal_attention`` pads such a call at the end
(``attention.resident_padded``) and drops the extra rows.  Here, on the
CPU, the plain versions stand in for the kernels: the padded route's
output and dq, dk, dv equal the unpadded call's, in bf16 as the model runs
them.  The plain versions are torch einsums, whose CPU kernels sum the 16
extra zero products in another blocking than the unpadded call, so the
bound is stated: the padding changes no f32 term, only the order of f32
sums before their one bf16 rounding, so an element may land on the other
side of a rounding boundary.  Each element is within 2^-8 (one bf16 ulp)
of its tensor's largest magnitude, and at most one element in 10,000
differs (measured: 0 to 4 of 32k-128k; 1.1e-4 of the largest).  A meta
tensor stands in for a CUDA one: the dispatch pads and never reaches
``_check``'s refusal.
"""

import numpy as np
import pytest
import torch

from ecg_byte_tpu_torch.ops import attention, attention_resident


def _inputs(b, s, kh=2, g=2, d=16, left_pad=37, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    mask = np.ones((b, s), np.int32)
    mask[-1, :left_pad] = 0
    return t(b, s, kh, g, d), t(b, s, kh, d), t(b, s, kh, d), torch.from_numpy(mask), \
        t(b, s, kh, g, d)


def _run(fn, qg, k, v, mask, grad):
    qg, k, v = (x.clone().requires_grad_() for x in (qg, k, v))
    out = fn(qg, k, v, mask)
    out.backward(grad)
    return out.detach(), qg.grad, k.grad, v.grad


def _one_rounding_apart(got, want, what):
    d = (got.float() - want.float()).abs()
    top = want.float().abs().max()
    assert d.max() <= 2.0 ** -8 * top, f"{what}: max |d| {d.max().item():.3g} of {top:.3g}"
    assert (d > 0).sum() <= d.numel() // 10_000, f"{what}: {int((d > 0).sum())} elements differ"


@pytest.mark.parametrize("s", [1004, 504])
def test_padded_route_equals_the_unpadded_call(s):
    qg, k, v, mask, grad = _inputs(2, s)
    got = _run(attention.resident_padded, qg, k, v, mask, grad)
    want = _run(attention_resident.ResidentAttention.apply, qg, k, v, mask, grad)
    assert got[0].shape == want[0].shape == qg.shape
    exact = 0
    for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
        assert torch.isfinite(g.float()).all()
        exact += torch.equal(g, w)
        _one_rounding_apart(g, w, f"S {s} {what}")
    print(f"S {s}: {exact} of 4 tensors bit-equal")


def test_cuda_route_pads_instead_of_raising(monkeypatch):
    """On a non-CPU tensor (meta here) at S 1004, causal_attention hands the
    resident wrappers S 1008, a multiple of 16, and returns S 1004; at S
    1008 it passes the call through unpadded; on the CPU it never pads."""
    seen = []

    def spy(qg, k, v, pad_mask):
        seen.append((qg.shape[1], k.shape[1], v.shape[1], pad_mask.shape[1]))
        return torch.empty_like(qg)

    monkeypatch.setattr(attention_resident, "resident_attention", spy)
    for s, padded in ((1004, 1008), (504, 512), (1008, 1008)):
        q = torch.empty(2, s, 32, 64, dtype=torch.bfloat16, device="meta")
        kv = torch.empty(2, s, 8, 64, dtype=torch.bfloat16, device="meta")
        mask = torch.empty(2, s, dtype=torch.int32, device="meta")
        out = attention.causal_attention(q, kv, kv, mask)
        assert out.shape == (2, s, 32, 64)
        assert seen.pop() == (padded,) * 4
    q, k, v, mask, _ = _inputs(1, 1004, kh=1, g=2)
    calls = []
    monkeypatch.setattr(attention, "resident_padded", lambda *a: calls.append(a))
    attention.causal_attention(q.reshape(1, 1004, 2, 16), k, v, mask)
    assert not calls
