"""``chip_smoke.py``'s checks of the two backward kernels, on the CPU: they
pass the plain versions' own output and refuse outputs with the faults the
bounds are there for.  The plain versions stand in for the kernels here
(the kernels themselves run only on the card)."""

import importlib.util
import os

import pytest
import torch

from ecg_byte_tpu_torch.ops import attention_resident, rmsnorm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _attention_grads(s=256, pad=37, drop_rows=None):
    """bf16 (dq, dk, dv) of the plain backward, (B, S, KH, G, D) = (1, s, 2,
    4, 64), left pad ``pad``; ``drop_rows`` zeroes the output gradient of a
    slice of query rows, as a kernel that skipped that query tile would."""
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    q, k, v = randn(1, s, 2, 4, 64), randn(1, s, 2, 64), randn(1, s, 2, 64)
    mask = torch.ones(1, s, dtype=torch.int32)
    mask[:, :pad] = 0
    out = attention_resident.resident_attention(q, k, v, mask)
    gout = randn(*q.shape) * mask[:, :, None, None, None].to(torch.bfloat16)
    if drop_rows is not None:
        gout[:, drop_rows] = 0
    return attention_resident.resident_attention_bwd_plain(q, k, v, mask, out, gout)


def test_attention_bwd_check_passes_plain():
    want = _attention_grads()
    assert chip_smoke.check_attention_bwd(want, want, "plain") == 0.0


def test_attention_bwd_check_refuses_a_skipped_query_tile():
    want = _attention_grads()
    got = _attention_grads(drop_rows=slice(192, 208))
    with pytest.raises(AssertionError, match="K1 bwd"):
        chip_smoke.check_attention_bwd(got, want, "a 16-row query tile skipped")


@pytest.mark.parametrize("scale", [1.05, 1.005], ids=["5%", "0.5%"])
def test_attention_bwd_norm_bound_catches_what_max_bound_misses(scale):
    """dq off by ``scale`` on the later half of the rows: within 4e-2 of
    max|ref| (the gradients there are small), but 2.6e-2 (5%) or 3.0e-3
    (0.5%, after bf16 rounding) off in the 2-norm, against its bound of
    1e-3."""
    want = _attention_grads()
    got = [t.clone() for t in want]
    got[0][:, 128:] *= scale
    dq, ref = got[0].float(), want[0].float()
    assert (dq - ref).abs().max() <= 4e-2 * ref.abs().max()
    with pytest.raises(AssertionError, match=r"dq: \|d\|/\|ref\|"):
        chip_smoke.check_attention_bwd(got, want, f"later dq rows x {scale}")


def _norm_grads(rows=64, d=256):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(rows, d, generator=gen).to(torch.bfloat16)
    g = torch.randn(rows, d, generator=gen).to(torch.bfloat16)
    w = torch.randn(d, generator=gen)
    dx, _ = rmsnorm.rmsnorm_bwd_plain(x, w, g, 1e-5, False)
    return x, w, g, dx


def test_rmsnorm_bwd_dx_check_passes_plain():
    x, w, g, dx = _norm_grads()
    assert chip_smoke.check_rmsnorm_bwd_dx(dx, dx, x, w, g, 1e-5, "plain") == 0.0


@pytest.mark.parametrize("ulps", [2.5, 1e3], ids=["many-just-beyond", "one-far-off"])
def test_rmsnorm_bwd_dx_check_refuses_errors(ulps):
    """2.5 ulps on every element of a row: each may pass the bound taken at
    the larger term, but far more than 1e-5 of the elements are beyond 2
    ulps of dx; 1000 ulps on one element passes neither."""
    x, w, g, dx = _norm_grads()
    bad = dx.float()
    if ulps < 10:
        bad[0] += ulps * chip_smoke.bf16_ulp(dx[0])
    else:
        bad[0, 0] += ulps * chip_smoke.bf16_ulp(dx[0, 0])
    with pytest.raises(AssertionError, match="K3 bwd"):
        chip_smoke.check_rmsnorm_bwd_dx(bad, dx, x, w, g, 1e-5, "mutated")
