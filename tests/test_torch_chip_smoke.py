"""``chip_smoke.py``'s checks of the attention backward kernels, of both
attention forwards, of both RMSNorm kernels, of the int8 weight product, of
the device BPE encoder's token streams and of phase 15's preprocessing (the
chain against float64 scipy, the threshold's median, skip counts, the
written tree, the token cache), of phases 9 and 16's teacher-forced
logits, of phase 17's two-rank steps and per-rank counts, of phase 18's
attention mean, translation streams, profiler trace and memory readings,
and of phase 20's folded launch counts and teacher-forced streams, on the
CPU: they pass the plain versions' own output and refuse outputs with the
faults the bounds are there for.  The plain versions stand in for the
kernels here (the kernels themselves run only on the card).  Phases 18, 19
and 20 also run whole, at tiny sizes."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from ecg_byte_tpu_torch.cli.make_synthetic import make_signal
from ecg_byte_tpu_torch.models.quantized import quantize_weight
from ecg_byte_tpu_torch.ops import (
    attention,
    attention_resident,
    bpe_encode,
    bpe_match,
    flash_attention,
    int8_linear,
    kv_quant,
    rmsnorm,
)
from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
from ecg_byte_tpu_torch.tokenizer import BpeTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
sys.modules["chip_smoke"] = chip_smoke  # its dataclasses look their module up
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


def _flash_case(s=384, pad=37):
    """bf16 inputs (1, s, 2, 2, 64) with a left pad, the plain forward's
    (out, lse) and backward's (dq, dk, dv) for a random output gradient
    (pad rows included), and a forward and a backward of the plain versions
    under another mask or lse, to stand in for faulty kernels."""
    gen = torch.Generator().manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    q, k, v = randn(1, s, 2, 2, 64), randn(1, s, 2, 64), randn(1, s, 2, 64)
    gout = randn(1, s, 2, 2, 64)
    mask = torch.ones(1, s, dtype=torch.int32)
    mask[:, :pad] = 0
    fwd = flash_attention.flash_attention_fwd_plain(q, k, v, mask)
    bwd = flash_attention.flash_attention_bwd_plain(q, k, v, mask, *fwd, gout)

    def fwd_with(m):
        return flash_attention.flash_attention_fwd_plain(q, k, v, m)

    def bwd_with(m, lse):
        return flash_attention.flash_attention_bwd_plain(q, k, v, m, fwd[0], lse, gout)

    return mask, fwd, bwd, fwd_with, bwd_with


def _skipping_block(mask, t0, t1=None):
    """``mask`` with keys [t0, t1) dropped: what a kernel that skipped that
    key block computes for the rows after it."""
    m = mask.clone()
    m[:, t0:t1] = 0
    return m


def _lse_one_block_short(mask, fwd_with):
    """The plain lse, except that the rows of the last 128-query block take
    the lse of the keys before their own block: a kernel whose max and sum
    stopped one key block early."""
    lse = fwd_with(mask)[1].clone()
    lse[..., 256:] = fwd_with(_skipping_block(mask, 256))[1][..., 256:]
    return lse


def test_flash_fwd_check_passes_plain():
    mask, fwd, _, _, _ = _flash_case()
    assert chip_smoke.check_flash_fwd(fwd, fwd, mask, "plain") == 0.0


@pytest.mark.parametrize("fault", ["skipped-key-block", "lse-one-block-short", "nan-pad-row"])
def test_flash_fwd_check_refuses_faults(fault):
    """A forward that skipped the key block [128, 256), whose lse stopped one
    key block early on the last query block, or with a NaN in a left-pad
    row of out is refused."""
    mask, fwd, _, fwd_with, _ = _flash_case()
    if fault == "skipped-key-block":
        got, match = fwd_with(_skipping_block(mask, 128, 256)), "out max"
    elif fault == "lse-one-block-short":
        got, match = (fwd[0], _lse_one_block_short(mask, fwd_with)), "lse relative"
    else:
        out = fwd[0].clone()
        out[0, 5, 1, 0, 3] = float("nan")
        got, match = (out, fwd[1]), "non-finite out"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_flash_fwd(got, fwd, mask, fault)


@pytest.mark.parametrize("fault", ["last-32-keys-twice", "last-block-x1.25"])
def test_flash_fwd_norm_bounds_catch_a_late_pv_fault(fault, monkeypatch):
    """At S 4096 a fault in P.V on the last keys alone (a 32-key V sub-tile
    summed twice, or the last block's P.V scaled by 1.25) moves only the
    rows of the last query block, whose |out| is ~sqrt(e / 4096): lse is
    unchanged and max|d| stays within 2e-2.  |d|/|ref| over all rows (2e-3)
    refuses it, and so does the row bound on its own (those rows are 6-9%
    off)."""
    s = 4096
    gen = torch.Generator().manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    q, k, v = randn(1, s, 2, 2, 64), randn(1, s, 2, 64), randn(1, s, 2, 64)
    mask = torch.ones(1, s, dtype=torch.int32)
    mask[:, :300] = 0
    want = flash_attention.flash_attention_fwd_plain(q, k, v, mask)
    bad_v = v.clone()
    if fault == "last-32-keys-twice":
        bad_v[:, s - 32:] *= 2
    else:
        bad_v[:, s - 128:] *= 1.25
    got = flash_attention.flash_attention_fwd_plain(q, k, bad_v, mask)
    assert torch.equal(got[1], want[1])
    assert (got[0].float() - want[0].float()).abs().max() <= 2e-2
    with pytest.raises(AssertionError, match=r"out \|d\|/\|ref\|"):
        chip_smoke.check_flash_fwd(got, want, mask, fault)
    monkeypatch.setattr(chip_smoke, "FLASH_OUT_NORM", float("inf"))
    with pytest.raises(AssertionError, match=r"out row \|d\|/\|ref\|"):
        chip_smoke.check_flash_fwd(got, want, mask, fault)


def _resident_case(s=3072, pad=300):
    """bf16 inputs (1, s, 2, 2, 64) with a left pad longer than a key tile
    and the plain forward's out."""
    gen = torch.Generator().manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    q, k, v = randn(1, s, 2, 2, 64), randn(1, s, 2, 64), randn(1, s, 2, 64)
    mask = torch.ones(1, s, dtype=torch.int32)
    mask[:, :pad] = 0
    return q, k, v, mask, attention.grouped_attention(q, k, v, mask)


def test_resident_fwd_check_passes_plain():
    _, _, _, mask, want = _resident_case()
    assert chip_smoke.check_resident_fwd(want, want, mask, "plain") == 0.0


@pytest.mark.parametrize("fault", ["skipped-key-tile", "last-32-keys-twice", "last-tile-x1.25",
                                   "nan-pad-row", "sees-next-key", "loses-own-key"])
def test_resident_fwd_check_refuses_faults(fault, monkeypatch):
    """The faults the flash check is fed, as a resident forward would have
    them: a skipped 64-key tile, P.V over the last 32 keys counted twice or
    over the last key tile scaled by 1.25, a NaN in a left-pad row, the
    causal diagonal off by one either way.  At S 3072 the two late P.V
    faults move only the last rows, whose |out| is ~sqrt(e / 3072): they
    pass the allclose bound (max|d| 1.8e-2 and 6.1e-3), and the norm (3.4e-3
    and 1.6e-3 of |ref|) and row bounds refuse them."""
    q, k, v, mask, want = _resident_case()
    s = q.shape[1]
    if fault == "skipped-key-tile":
        got = attention.grouped_attention(q, k, v, _skipping_block(mask, 384, 448))
    elif fault in ("last-32-keys-twice", "last-tile-x1.25"):
        bad_v = v.clone()
        if fault == "last-32-keys-twice":
            bad_v[:, s - 32:] *= 2
        else:
            bad_v[:, s - 64:] *= 1.25
        got = attention.grouped_attention(q, k, bad_v, mask)
        valid = mask.bool()
        assert torch.allclose(got.float()[valid], want.float()[valid], atol=2e-2, rtol=2e-2)
    elif fault == "nan-pad-row":
        got = want.clone()
        got[0, 5, 1, 0, 3] = float("nan")
    else:
        diagonal = 1 if fault == "sees-next-key" else -1
        monkeypatch.setattr(attention, "_causal",
                            lambda n, device: torch.ones((n, n), dtype=torch.bool,
                                                         device=device).tril(diagonal))
        got = attention.grouped_attention(q, k, v, mask)
    with pytest.raises(AssertionError, match="K1 fwd"):
        chip_smoke.check_resident_fwd(got, want, mask, fault)


def test_flash_bwd_check_passes_plain():
    _, _, bwd, _, _ = _flash_case()
    assert chip_smoke.check_attention_bwd(bwd, bwd, "plain", name="flash_attention_bwd",
                                          tag="flash bwd") == 0.0


@pytest.mark.parametrize("fault", ["skipped-key-block", "lse-one-block-short", "nan-pad-row"])
def test_flash_bwd_check_refuses_faults(fault):
    """A backward that skipped the key block [128, 256), that read an lse one
    key block short on the last query block, or with a NaN in a left-pad
    row of dq is refused."""
    mask, fwd, bwd, fwd_with, bwd_with = _flash_case()
    if fault == "skipped-key-block":
        got = bwd_with(_skipping_block(mask, 128, 256), fwd[1])
    elif fault == "lse-one-block-short":
        got = bwd_with(mask, _lse_one_block_short(mask, fwd_with))
    else:
        got = [t.clone() for t in bwd]
        got[0][0, 5, 1, 0, 3] = float("nan")
    with pytest.raises(AssertionError, match="flash bwd"):
        chip_smoke.check_attention_bwd(got, bwd, fault, name="flash_attention_bwd",
                                       tag="flash bwd")


# The faults a tensor-core backward is likeliest to have, built from the
# plain versions: a causal mask off by one on the diagonal tile (each row
# also sees the next key, or loses its own), flash dK/dV summed over G - 1
# of the G query heads, and flash dK/dV rounded once after the head sum
# instead of per head.


@pytest.mark.parametrize("diagonal", [1, -1], ids=["sees-next-key", "loses-own-key"])
def test_attention_bwd_check_refuses_an_off_by_one_diagonal(diagonal, monkeypatch):
    want = _attention_grads()
    monkeypatch.setattr(attention_resident, "_causal",
                        lambda s, device: torch.ones((s, s), dtype=torch.bool,
                                                     device=device).tril(diagonal))
    got = _attention_grads()
    with pytest.raises(AssertionError, match="K1 bwd"):
        chip_smoke.check_attention_bwd(got, want, f"causal diagonal {diagonal:+d}")


@pytest.mark.parametrize("diagonal", [1, -1], ids=["sees-next-key", "loses-own-key"])
def test_flash_bwd_check_refuses_an_off_by_one_diagonal(diagonal, monkeypatch):
    mask, fwd, bwd, _, bwd_with = _flash_case()
    scores = flash_attention._scores

    def off_by_one(q_rows, k_keys, key_ok, r0, t1, scale):
        # query position q sees key t where t <= q + diagonal
        return scores(q_rows, k_keys, key_ok, r0 + diagonal, t1, scale)

    monkeypatch.setattr(flash_attention, "_scores", off_by_one)
    got = bwd_with(mask, fwd[1])
    with pytest.raises(AssertionError, match="flash bwd"):
        chip_smoke.check_attention_bwd(got, bwd, f"causal diagonal {diagonal:+d}",
                                       name="flash_attention_bwd", tag="flash bwd")


def test_flash_bwd_check_refuses_a_lost_query_head():
    """dK and dV summed over G - 1 of the G query heads of a KV head: the
    dK/dV of a run whose last head has a zero output gradient (so it adds
    nothing to them), beside the right dq."""
    mask, fwd, bwd, _, _ = _flash_case()
    gen = torch.Generator().manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    q, k, v = randn(1, 384, 2, 2, 64), randn(1, 384, 2, 64), randn(1, 384, 2, 64)
    gout = randn(1, 384, 2, 2, 64)
    gout[:, :, :, -1] = 0
    _, dk, dv = flash_attention.flash_attention_bwd_plain(q, k, v, mask, *fwd, gout)
    with pytest.raises(AssertionError, match=r"flash bwd G - 1 heads dk: max"):
        chip_smoke.check_attention_bwd((bwd[0], dk, dv), bwd, "G - 1 heads",
                                       name="flash_attention_bwd", tag="flash bwd")


def test_flash_bwd_check_refuses_rounding_once_after_the_head_sum(monkeypatch):
    """dK and dV summed over the heads in f32 and rounded once, where the
    JAX code rounds each head first: here that moves them 2.8e-3 and 2.9e-3
    of their norm, past the check's 1e-3 (dq does not change)."""
    mask, fwd, bwd, _, bwd_with = _flash_case()
    monkeypatch.setattr(flash_attention, "_head_sum",
                        lambda x, dtype, s: x.sum(2).to(dtype)[:, :, :s].transpose(1, 2)
                        .contiguous())
    got = bwd_with(mask, fwd[1])
    assert torch.equal(got[0], bwd[0])
    for a, w in zip(got[1:], bwd[1:]):
        rel = torch.linalg.vector_norm(a.float() - w.float()) / torch.linalg.vector_norm(w.float())
        assert 2e-3 < rel < 4e-3, rel
    with pytest.raises(AssertionError, match=r"flash bwd rounded once dk: \|d\|/\|ref\|"):
        chip_smoke.check_attention_bwd(got, bwd, "rounded once", name="flash_attention_bwd",
                                       tag="flash bwd")


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


def _norm_out(rows=64, d=256):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(rows, d, generator=gen).to(torch.bfloat16)
    w = torch.randn(d, generator=gen).to(torch.bfloat16)
    return rmsnorm.rmsnorm_plain(x, w, 1e-5)


def test_rmsnorm_fwd_check_passes_plain_and_one_ulp():
    y = _norm_out()
    assert chip_smoke.check_rmsnorm_fwd(y, y, "plain") == 0.0
    near = y.float()
    near[5] += chip_smoke.bf16_ulp(y[5])  # a whole row 1 ulp off: the tolerance
    assert chip_smoke.check_rmsnorm_fwd(near.to(torch.bfloat16), y, "1 ulp") > 0


@pytest.mark.parametrize("fault", ["two-ulps", "row-scaled", "nan"])
def test_rmsnorm_fwd_check_refuses_errors(fault):
    """One element 2 ulps off, one row scaled by 1.02 (a wrong r for one
    row), one NaN."""
    y = _norm_out()
    bad = y.float()
    if fault == "two-ulps":
        bad[5, 7] += 2 * chip_smoke.bf16_ulp(y[5, 7])
    elif fault == "row-scaled":
        bad[9] *= 1.02
    else:
        bad[3, 0] = float("nan")
    with pytest.raises(AssertionError, match="K3"):
        chip_smoke.check_rmsnorm_fwd(bad.to(torch.bfloat16), y, "mutated")


def _norm_dw(rows=64, d=256, parts=16):
    """The plain dw, and dw from per-block partials of g x r (rows in
    contiguous runs, as the kernel's blocks take them) summed in order and
    in reverse order."""
    x, w, g, _ = _norm_grads(rows, d)
    _, pdw = rmsnorm.rmsnorm_bwd_plain(x, w, g, 1e-5, True)
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
    part = (gf * xf * r).reshape(parts, rows // parts, d).sum(1)
    ordered, reverse = torch.zeros(d), torch.zeros(d)
    for p in range(parts):
        ordered += part[p]
        reverse += part[parts - 1 - p]
    return pdw, ordered, reverse


def test_rmsnorm_dw_check_passes_plain_and_blocked():
    pdw, ordered, _ = _norm_dw()
    assert chip_smoke.check_rmsnorm_dw(pdw, pdw, pdw.clone(), "plain") == 0.0
    assert chip_smoke.check_rmsnorm_dw(ordered, pdw, ordered.clone(), "blocked") < 1e-6


def test_rmsnorm_dw_check_refuses_another_order():
    """A second call whose partials were summed in another order: within
    1e-3 of the first, but not equal to it."""
    pdw, ordered, reverse = _norm_dw()
    assert not torch.equal(ordered, reverse)
    with pytest.raises(AssertionError, match="two calls' dw differ"):
        chip_smoke.check_rmsnorm_dw(ordered, pdw, reverse, "another order")


@pytest.mark.parametrize("fault", ["beyond-1e-3", "nan"])
def test_rmsnorm_dw_check_refuses_errors(fault):
    """A dw 2e-3 of max|dw| off in one element (its partials summed with
    one dropped would be further), and a NaN; the second call equal to the
    first, so only the bound can refuse them."""
    pdw, ordered, _ = _norm_dw()
    bad = ordered.clone()
    if fault == "nan":
        bad[0] = float("nan")
    else:
        bad[17] += 2e-3 * pdw.abs().max()
    with pytest.raises(AssertionError, match="K3 bwd"):
        chip_smoke.check_rmsnorm_dw(bad, pdw, bad.clone(), "mutated")


def _encoded_batch():
    """Three 12 x 100 records encoded by ``quantize_and_encode`` on the CPU
    with a 60-merge tokenizer of their own, and the host trie's streams."""
    rng = np.random.default_rng(2)
    sigs = np.stack([make_signal(rng, i % 2 == 0, 100) for i in range(3)])
    p1, p99 = float(np.percentile(sigs, 1)), float(np.percentile(sigs, 99))
    corpus = quantized_to_string(normalize_quantize(torch.from_numpy(sigs), p1, p99)[1])
    merges = BpeTokenizer.train(corpus, 60).merges
    table = bpe_encode.build_automaton(merges, torch.device("cpu"))
    ids, counts = bpe_encode.quantize_and_encode(torch.from_numpy(sigs), p1, p99, table)
    return ids, counts, chip_smoke.host_streams(sigs, p1, p99, merges)


def test_token_stream_check_passes_the_host_trie():
    ids, counts, want = _encoded_batch()
    chip_smoke.check_streams(ids, counts, want, "plain")


@pytest.mark.parametrize("fault", ["changed-token", "count-plus-one", "count-minus-one"])
def test_token_stream_check_refuses_faults(fault):
    """One token changed, or one record's count off by one (a token too many
    is a PAD_TOKEN, one too few drops the last): each is refused."""
    ids, counts, want = _encoded_batch()
    ids, counts = ids.clone(), counts.clone()
    if fault == "changed-token":
        ids[1, 7] += 1
        match = "record 1 token 7"
    else:
        counts[2] += 1 if fault == "count-plus-one" else -1
        match = "record 2 has"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_streams(ids, counts, want, fault)


def _int8_product(with_bias, m=4, n=64, k=256):
    """x (m, k) bf16, an int8 weight quantized from a random bf16 one, its
    scales, a bias or None, and the plain product."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16)
    q, scale = quantize_weight((0.02 * torch.randn(n, k, generator=gen)).to(torch.bfloat16))
    bias = (0.1 * torch.randn(n, generator=gen)).to(torch.bfloat16) if with_bias else None
    return x, q, scale, bias, int8_linear.int8_linear_plain(x, q, scale, bias)


@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
def test_int8_linear_check_passes_plain(with_bias):
    x, q, scale, bias, want = _int8_product(with_bias)
    assert chip_smoke.check_int8_linear(want, want, x, q, scale, bias, "plain") == 0.0


@pytest.mark.parametrize("fault", ["skipped-chunk", "neighbour-scale", "4-ulps"])
def test_int8_linear_check_refuses_faults(fault):
    """A kernel that skipped one 16-byte chunk of K, read the next row's
    scale, or is 4 bf16 ulps off on one element is refused."""
    x, q, scale, bias, want = _int8_product(False)
    if fault == "skipped-chunk":
        xs = x.clone()
        xs[:, 16:32] = 0
        got = int8_linear.int8_linear_plain(xs, q, scale)
    elif fault == "neighbour-scale":
        got = int8_linear.int8_linear_plain(x, q, scale.roll(1))
    else:
        got = want.float()
        got[1, 5] += 4 * chip_smoke.bf16_ulp(want[1, 5])
    with pytest.raises(AssertionError, match="int8_linear"):
        chip_smoke.check_int8_linear(got, want, x, q, scale, None, fault)


_split_spec = importlib.util.spec_from_file_location(
    "test_torch_decode_split", os.path.join(REPO, "tests", "test_torch_decode_split.py"))
_decode_split = importlib.util.module_from_spec(_split_spec)
_split_spec.loader.exec_module(_decode_split)


def _long_decode(int8=False, s=5248, pad=32, filled=5184):
    """One query against the long serving path's cache, as chip_smoke.py
    phase 3 makes it: B1, S_max 5,248, 32/8 heads of 64, N(0, 1) rows (the
    int8 cache quantized from them), 32 slots of left padding and the last
    64 unfilled; returns the inputs and the plain version's output."""
    gen = torch.Generator().manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    q, k, v = randn(1, 1, 32, 64), randn(1, s, 8, 64), randn(1, s, 8, 64)
    scales = (None, None)
    if int8:
        from ecg_byte_tpu_torch.ops import kv_quant

        (k, ks), (v, vs) = kv_quant.quant_kv_rows(k), kv_quant.quant_kv_rows(v)
        scales = (ks, vs)
    mask = torch.ones(1, s, dtype=torch.int32)
    mask[:, filled:] = 0
    mask[0, :pad] = 0
    from ecg_byte_tpu_torch.ops import attention

    return (q, k, v, mask, *scales), attention.decode_attention(q, k, v, mask, *scales)


def test_decode_check_passes_plain_and_the_split_arithmetic():
    """The plain output passes, and so does the split kernel's arithmetic
    (tests/test_torch_decode_split.py) at 7 ranges and at one a tile."""
    args, want = _long_decode()
    assert chip_smoke.check_decode(want, want, "plain") == 0.0
    for splits in (7, 82):
        got = _decode_split.split_decode(*args[:4], splits, *args[4:])
        chip_smoke.check_decode(got, want, f"{splits} ranges")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("splits,fault", [(82, "drop"), (82, "double"), (7, "drop"),
                                          (7, "double")])
def test_decode_check_refuses_a_lost_or_doubled_range(int8, splits, fault):
    """A reduction that leaves one range's partial out, or counts it twice,
    is refused.  At 82 ranges the output moves by ~1/9 of its size, but
    |out| ~ 0.02 over a 5k cache keeps max|d| under the 2e-2 bound, so the
    relative bounds are what refuse it."""
    args, want = _long_decode(int8)
    mid = splits // 2
    got = _decode_split.split_decode(*args[:4], splits, *args[4:],
                                     **{fault: mid})
    err = (got.float() - want.float()).abs().max().item()
    if splits == 82:
        assert err <= 2e-2  # the max bound alone would pass it
    with pytest.raises(AssertionError, match="K2"):
        chip_smoke.check_decode(got, want, f"{fault} range {mid} of {splits}")


def _fresh_case(int8, s=256, idx=130):
    """A stale (B1, S, 2, 64) cache, this token's rows and a decode step's
    mask (slots up to ``idx``); returns (q, stale caches, fk, fv, mask)."""
    from ecg_byte_tpu_torch.ops import kv_quant

    gen = torch.Generator().manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    q, k, v, fk, fv = randn(1, 1, 8, 64), randn(1, s, 2, 64), randn(1, s, 2, 64), \
        randn(1, 1, 2, 64), randn(1, 1, 2, 64)
    stale = [k, v]
    if int8:
        (k, ks), (v, vs) = kv_quant.quant_kv_rows(k), kv_quant.quant_kv_rows(v)
        stale = [k, v, ks, vs]
    mask = torch.zeros(1, s, dtype=torch.int32)
    mask[:, :idx + 1] = 1
    return q, stale, fk, fv, mask


def _fused(q, caches, fk, fv, mask, idx):
    from ecg_byte_tpu_torch.ops import attention_decode

    scales = caches[2:] if len(caches) == 4 else (None, None)
    return attention_decode.decode_attention_fused(q, caches[0], caches[1], mask, *scales,
                                                   fresh_k=fk, fresh_v=fv, write_idx=idx)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_fused_decode_check_passes_the_pair(int8):
    """check_fused_decode passes the fused call against chip_smoke's
    stand-in for the old decode step (append_then_kernel), on the CPU."""
    q, stale, fk, fv, mask = _fresh_case(int8)
    got_c, want_c = [t.clone() for t in stale], [t.clone() for t in stale]
    got = _fused(q, got_c, fk, fv, mask, 130)
    scales = want_c[2:] if int8 else (None, None)
    want = chip_smoke.append_then_kernel(q, want_c[0], want_c[1], mask, *scales,
                                         fresh_k=fk, fresh_v=fv, write_idx=130)
    chip_smoke.check_fused_decode(got, want, got_c, want_c, "pair")


@pytest.mark.parametrize("fault", ["next slot", "stale scale", "stale v row", "one ulp"])
def test_fused_decode_check_refuses_faults(fault):
    """A row written one slot off, a scale or a V row left stale, an output
    one bf16 ulp off: each is refused."""
    q, stale, fk, fv, mask = _fresh_case(True)
    want_c = [t.clone() for t in stale]
    want = _fused(q, want_c, fk, fv, mask, 130)
    got_c = [t.clone() for t in stale]
    got = _fused(q, got_c, fk, fv, mask, 131 if fault == "next slot" else 130)
    if fault == "stale scale":
        got_c[2][:, 130] = stale[2][:, 130] * 2
    if fault == "stale v row":
        got_c[1][:, 130] = stale[1][:, 130]
    if fault == "one ulp":
        got = got.clone()
        got.view(torch.int16)[0, 0, 0, 0] += 1
    with pytest.raises(AssertionError, match="K2 fresh"):
        chip_smoke.check_fused_decode(got, want, got_c, want_c, fault)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_step_under_the_plain_swap_and_the_old_pair(int8):
    """The decode step's call of decode attention (this token's row and
    write_idx) reaches the plain swap of ``plain_path`` and
    ``append_then_kernel`` with the signature they take: three decode steps
    give the same logits and caches each way."""
    from unittest import mock

    from ecg_byte_tpu_torch.models import tiny_test_config
    from ecg_byte_tpu_torch.models import transformer as T
    from ecg_byte_tpu_torch.ops import attention_decode

    c = tiny_test_config("llama", dtype="bfloat16")
    params = T.init_params(c, torch.Generator().manual_seed(0), torch.device("cpu"))
    ids = torch.randint(0, c.vocab_size, (1, 10), generator=torch.Generator().manual_seed(1))

    def run():
        mask = torch.ones(1, 10, dtype=torch.int32)
        cache = T.init_kv_cache(c, 1, 13, torch.device("cpu"),
                                dtype=torch.int8 if int8 else None)
        _, cache, pos = T.prefill(params, c, ids, mask, cache)
        cache_mask = torch.cat([mask, torch.zeros(1, 3, dtype=torch.int32)], 1)
        out = []
        for step in range(3):
            cache_mask[:, 10 + step] = 1
            logits, cache = T.decode_step(params, c, ids[:, step].int(), pos.int() + step,
                                          10 + step, cache, cache_mask)
            out.append(logits)
        return torch.stack(out), cache

    want, want_cache = run()
    with chip_smoke.plain_path():
        plain = run()
    with mock.patch.object(attention_decode, "decode_attention_fused",
                           chip_smoke.append_then_kernel):
        old = run()
    for logits, cache in (plain, old):
        assert torch.equal(logits, want)
        assert all(torch.equal(cache[n], want_cache[n]) for n in want_cache)


def test_int8_serve_path_appends_per_prefill_only():
    """The int8 serving path launches kv_quant once a layer per prefill and
    not per decode step: decode attention appends the step's row."""
    path = chip_smoke.SERVE_INT8
    assert path.per_prefill["kv_quant"] == chip_smoke.LAYERS
    assert "kv_quant" not in path.per_step and "kv_quant" not in path.per_forward


def _matched():
    """A toy vocabulary's table, two 300-symbol records of a walk and the
    plain matcher's (match_tok, match_len) of them."""
    rng = np.random.default_rng(4)
    walk = (np.abs(np.cumsum(rng.integers(-1, 2, size=(2, 300)), axis=1)) % 26).astype(np.uint8)
    merges = BpeTokenizer.train(quantized_to_string(walk), 40).merges
    table = bpe_encode.build_automaton(merges, torch.device("cpu"))
    return bpe_match.longest_match_plain(torch.from_numpy(walk), table)


def test_match_check_passes_plain():
    want = _matched()
    chip_smoke.check_match(want, want, "plain")


@pytest.mark.parametrize("fault", ["length-one-short", "wrong-id"])
def test_match_check_refuses_faults(fault):
    """One position's match one symbol short (a kernel whose sweep starts
    a symbol too late), or one position's token id wrong: each is refused
    and named."""
    want = _matched()
    tok, ln = (t.clone() for t in want)
    p = int((ln[1] > 1).nonzero()[0])  # a position with a token of 2 symbols or more
    if fault == "length-one-short":
        ln[1, p] -= 1
        match = f"match_len at record 1 position {p}"
    else:
        tok[1, p] += 1
        match = f"match_tok at record 1 position {p}"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_match((tok, ln), want, fault)


def _appended(idx=3, shift=0):
    """One layer's int8 cache of 8 slots after the plain append of 2 x 3
    rows of 2 kv heads of 64 at slot ``idx + shift``."""
    gen = torch.Generator().manual_seed(6)
    k, v = (torch.randn(2, 3, 2, 64, generator=gen).to(torch.bfloat16) for _ in range(2))
    cache = (torch.zeros(2, 8, 2, 64, dtype=torch.int8), torch.zeros(2, 8, 2, 64, dtype=torch.int8),
             torch.ones(2, 8, 2, dtype=torch.bfloat16), torch.ones(2, 8, 2, dtype=torch.bfloat16))
    kv_quant.append_kv_plain(k, v, *cache, idx + shift)
    return cache


def test_kv_quant_check_passes_plain():
    want = _appended()
    chip_smoke.check_kv_quant(want, want, "plain")


@pytest.mark.parametrize("fault", ["row-one-off", "scale-one-ulp", "one-slot-off"])
def test_kv_quant_check_refuses_faults(fault):
    """One int8 value one off, one bf16 scale one ulp off, or the rows
    written one slot late: each is refused and named."""
    want = _appended()
    got = tuple(t.clone() for t in want)
    if fault == "row-one-off":
        got[1][1, 4, 0, 9] += 1 if got[1][1, 4, 0, 9] < 127 else -1
        match = "v_cache differs from the plain version at batch row 1, slot 4"
    elif fault == "scale-one-ulp":
        s = got[2][0, 5, 1].float()
        got[2][0, 5, 1] = torch.nextafter(s.to(torch.bfloat16), torch.tensor(
            float("inf"), dtype=torch.bfloat16))
        match = "k_scale differs from the plain version at batch row 0, slot 5"
    else:
        got = _appended(shift=1)
        match = "k_cache differs from the plain version at batch row 0, slot 3"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_kv_quant(got, want, fault)


def _hf_checks():
    """The inputs of phase 14's checks as a correct run gives them: two
    tensors written and read back, launch counts, each seed's metric
    modes and every sample's F1, the card's and the CPU's scores."""
    gen = torch.Generator().manual_seed(0)
    written = {"embed": torch.randn(64, 16, generator=gen).to(torch.bfloat16),
               "norm": torch.ones(16, dtype=torch.bfloat16)}
    read = {k: v.clone() for k, v in written.items()}
    counts = {"prefill_attention": 160, "decode_attention": 20320, "rmsnorm": 42240,
              "bpe_match": 0}
    expected = {"prefill_attention": 160, "decode_attention": 20320, "rmsnorm": 42240}
    modes = [{"meteor": ["exact"], "bertscore": ["local-bert"]}] * 5
    f1s = [0.5615, 0.5697, 1.0]
    card = {"precision": [0.9, 0.5], "recall": [0.8, 0.6], "f1": [0.847, 0.545]}
    cpu = {k: [x + 5e-5 for x in v] for k, v in card.items()}
    return written, read, counts, expected, modes, f1s, card, cpu


def _run_hf_checks(written, read, counts, expected, modes, f1s, card, cpu):
    chip_smoke.check_readback(written, read)
    chip_smoke.check_launch_counts(counts, expected, "HF serving")
    chip_smoke.check_bertscore(modes, f1s)
    return chip_smoke.check_scorers(card, cpu)


def test_hf_checks_pass_a_correct_run():
    assert _run_hf_checks(*_hf_checks()) == pytest.approx(5e-5)


@pytest.mark.parametrize("fault", ["byte-changed", "zero-fill", "f1-zero", "launch-off-by-one",
                                   "scorer-gap", "mode-missing", "dtype-changed"])
def test_hf_checks_refuse_faults(fault):
    """Phase 14 refuses a tensor read back with one byte changed (or in
    another dtype), a BERTScore mode of "zero-fill" in one seed (or none at
    all), an F1 of 0, a launch count off by one and a card-against-CPU
    score gap above 1e-4."""
    written, read, counts, expected, modes, f1s, card, cpu = _hf_checks()
    if fault == "byte-changed":
        raw = read["embed"].view(torch.uint8).view(-1)
        raw[77] ^= 1
        match = "embed: read back differs"
    elif fault == "dtype-changed":
        read["norm"] = read["norm"].float()
        match = "norm: read torch.float32"
    elif fault == "zero-fill":
        modes = modes[:4] + [{"meteor": ["exact"], "bertscore": ["zero-fill"]}]
        match = "BERTScore modes"
    elif fault == "mode-missing":
        modes = [{}] * 5
        match = "BERTScore modes"
    elif fault == "f1-zero":
        f1s = f1s + [0.0]
        match = r"F1 outside \(0, 1\]"
    elif fault == "launch-off-by-one":
        counts = dict(counts, decode_attention=20321)
        match = "decode_attention launched 20321 times, expected 20320"
    else:
        cpu = dict(cpu, recall=[0.8, 0.6 + 1.5e-4])
        match = "BERTScore recall"
    with pytest.raises(AssertionError, match=match):
        _run_hf_checks(written, read, counts, expected, modes, f1s, card, cpu)


def test_round_trip_check_refuses_a_lossy_tokenizer():
    """check_round_trip passes the byte tokenizer and refuses one whose
    decode drops a character."""
    from ecg_byte_tpu_torch.data.text_tokenizer import ByteTextTokenizer

    texts = ["The heart rate is slow.", "Ünïcödé ١٢٣"]
    tok = ByteTextTokenizer()
    chip_smoke.check_round_trip(tok, texts)

    class Lossy(ByteTextTokenizer):
        def decode(self, ids, skip_special_tokens=False):
            return super().decode(ids)[:-1]

    with pytest.raises(AssertionError, match="decode\\(encode"):
        chip_smoke.check_round_trip(Lossy(), texts)


# ------------------------------------------------------- phase 15: preprocess


@pytest.fixture(scope="module")
def preprocessed():
    """Two records of 12 x 1,000 through the port's chain on the CPU, the
    float64 reference of phase 15 and the |cD4| band of the first product
    (72 values at this n, an even length)."""
    from ecg_byte_tpu_torch.ops import dsp

    rng = np.random.default_rng(0)
    x = np.stack([chip_smoke.raw_ecg(rng, n=1000).T for _ in range(2)]).astype(np.float32)
    got = dsp.preprocess_records(torch.from_numpy(x))
    filtered = dsp.advanced_ecg_filter(torch.from_numpy(x))
    dec, _, seg = dsp.preprocess_operators(1000, 500.0, 250.0)
    cd = dsp.apply_operator(torch.from_numpy(x), dec)[..., seg[0]: seg[0] + seg[1]].abs()
    return x, got, filtered, cd, chip_smoke.scipy_chain(x.astype(np.float64))


def test_preprocess_checks_pass_the_plain_chain(preprocessed):
    """The CPU path passes phase 15's checks: the whole chain and the filter
    within FILTER_TOL of float64 scipy, the resample within RESAMPLE_TOL,
    the median of |cD4| numpy's exactly at 72 and 71 values."""
    from ecg_byte_tpu_torch.ops import dsp, wavelet

    x, got, filtered, cd, (want_filtered, denoised, resampled) = preprocessed
    assert chip_smoke.check_rel(got, resampled, chip_smoke.FILTER_TOL, "chain") < 1e-4
    chip_smoke.check_rel(filtered, want_filtered, chip_smoke.FILTER_TOL, "filter")
    chip_smoke.check_rel(dsp.nsample_ecg(torch.from_numpy(denoised).float(), 500.0, 250.0),
                         resampled, chip_smoke.RESAMPLE_TOL, "resample")
    for band in (cd, cd[..., :-1]):
        chip_smoke.check_median(wavelet.median(band), band.numpy(), "median")


def test_preprocess_check_refuses_a_filter_past_its_bound(preprocessed):
    """A filter output 3e-4 of max|ref| off at one sample is refused."""
    _, _, filtered, _, (want_filtered, _, _) = preprocessed
    bad = filtered.clone()
    bad[1, 4, 500] += 3e-4 * float(np.abs(want_filtered).max())
    with pytest.raises(AssertionError, match="filter: .* > 2e-04"):
        chip_smoke.check_rel(bad, want_filtered, chip_smoke.FILTER_TOL, "filter")


def test_preprocess_checks_refuse_a_lower_median(preprocessed, monkeypatch):
    """``torch.median``'s lower middle value in place of the mean of the two
    is refused by the median check, and moves the whole chain past its
    bound against the float64 reference (whose median is numpy's)."""
    from ecg_byte_tpu_torch.ops import dsp, wavelet

    x, _, _, cd, (_, _, resampled) = preprocessed
    monkeypatch.setattr(wavelet, "median", lambda t: t.median(-1, keepdim=True).values)
    with pytest.raises(AssertionError, match="medians differ from numpy's"):
        chip_smoke.check_median(wavelet.median(cd), cd.numpy(), "median of |cD4|")
    with pytest.raises(AssertionError, match="chain: .* > 2e-04"):
        chip_smoke.check_rel(dsp.preprocess_records(torch.from_numpy(x)), resampled,
                             chip_smoke.FILTER_TOL, "chain")


def test_skip_check_passes_and_refuses_a_count_off_by_one():
    log = ("Total instances skipped in train split: 4\n"
           "Total instances skipped in val split: 0\n"
           "Total instances skipped in test split: 0\n")
    chip_smoke.check_skips(log, {"train": 4, "val": 0, "test": 0})
    for wrong in ({"train": 3, "val": 0, "test": 0}, {"train": 4, "val": 1, "test": 0}):
        with pytest.raises(AssertionError, match="skip count of"):
            chip_smoke.check_skips(log, wrong)


def test_expected_splits_are_the_clis():
    """Phase 15's expected splits (their definition, written out) are the
    port's ``train_test_split`` and skip the bad records where they fall."""
    from ecg_byte_tpu_torch.utils.sk import train_test_split

    splits, skips = chip_smoke.expected_mimic()
    train, rest = train_test_split(list(range(chip_smoke.RAW_RECORDS)), 0.3, 42)
    val, test = train_test_split(rest, 0.6, 42)
    assert splits == {"train": train, "val": val, "test": test}
    assert [len(s) for s in splits.values()] == [358, 61, 93] and sum(skips.values()) == 4


def test_tree_check_passes_and_refuses_a_missing_segment(tmp_path):
    for kind, ext in (("ecg", "npy"), ("text", "json")):
        os.makedirs(tmp_path / kind / "train")
        for p in (0, 2):
            for j in range(2):
                path = tmp_path / kind / "train" / f"{kind}_{p}_{j}.{ext}"
                if ext == "npy":
                    np.save(path, np.zeros((12, 8), np.float32))
                else:
                    path.write_text(f'"record {p}"')
    texts = lambda split, p: f"record {p}"  # noqa: E731
    names = lambda p, j: f"{p}_{j}"  # noqa: E731
    assert chip_smoke.check_tree(str(tmp_path), {"train": [0, 2]}, 2, names, texts) == 4
    os.remove(tmp_path / "ecg" / "train" / "ecg_2_1.npy")
    with pytest.raises(AssertionError, match="missing \\['ecg_2_1.npy'\\]"):
        chip_smoke.check_tree(str(tmp_path), {"train": [0, 2]}, 2, names, texts)


def test_token_cache_check_refuses_a_stream_one_token_off():
    gen = np.random.default_rng(1)
    want = [gen.integers(0, 600, size=n).tolist() for n in (40, 57, 33)]
    chip_smoke.check_token_cache([list(w) for w in want], want, "cache")
    changed = [list(w) for w in want]
    changed[1][20] += 1
    with pytest.raises(AssertionError, match="record 1 differs from the host encoder at token 20"):
        chip_smoke.check_token_cache(changed, want, "cache")
    short = [list(w) for w in want]
    short[2].pop()
    with pytest.raises(AssertionError, match="record 2 differs .* at token 32 \\(32 tokens, the host 33\\)"):
        chip_smoke.check_token_cache(short, want, "cache")


def _logits(steps=6, b=2, v=50, seed=0):
    """f32 logits (steps, B, V) and a bf16 path's: the f32 ones rounded to
    bf16 and back, the plain path's error against them."""
    gen = torch.Generator().manual_seed(seed)
    ref = 4 * torch.randn(steps, b, v, generator=gen)
    return ref, ref.to(torch.bfloat16).float()


def test_logits_check_passes_a_kernel_within_the_bf16_error():
    """Phases 9 and 16's check of teacher-forced logits: the plain path
    itself, and a kernel path rounded another way (half a bf16 step of
    noise on the f32 logits), pass."""
    ref, plain = _logits()
    chip_smoke.hold_logits(plain.clone(), plain, ref)
    noise = (plain - ref).abs() * torch.rand(ref.shape, generator=torch.Generator().manual_seed(1))
    chip_smoke.hold_logits(ref + noise, plain, ref)


@pytest.mark.parametrize("fault", ["far", "opposite"])
def test_logits_check_refuses_faults(fault):
    """A kernel path 3x the plain path's error from f32 at one step, or
    within 1.2x of it but on the other side of f32 (2.2x from the plain
    path), is a kernel fault."""
    ref, plain = _logits()
    err = plain - ref
    if fault == "far":
        kern = plain.clone()
        kern[3] = ref[3] + 3 * err[3]
        match = "kernel path further from f32"
    else:
        kern = ref - 1.2 * err
        match = "differ beyond the bf16 error"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.hold_logits(kern, plain, ref)


# ---------------------------------------------------------------- phase 17

_DDP = dict(llm="tiny-llama", batch=4, pad_to_max=508, pretrain_data="ptb_500", pretrain_batch=6,
            finetune_pad_to_max=510, tiny=True)


@pytest.fixture(scope="module")
def dis_harness(tmp_path_factory):
    """Phase 17's two-rank harness at tiny sizes on the CPU (the real rank
    function, two gloo ranks) and the one-process pretrain step beside it."""
    from ecg_byte_tpu_torch.parallel.spawn import spawn

    root = str(tmp_path_factory.mktemp("dis"))
    vocab, merges = chip_smoke.make_data(root, n_train=7, n_val=3, n_test=2, seg_len=60,
                                         num_merges=30)
    ddp = chip_smoke.Ddp(**_DDP)
    # the ranks import chip_smoke by name, and the rank function pickles as
    # this module's (other test files load chip_smoke.py under that name too)
    sys.path.insert(0, REPO)
    sys.modules["chip_smoke"] = chip_smoke
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # a torch thread a rank
    try:
        ranks = spawn(chip_smoke.ddp_rank, (root, vocab, merges, ddp, True, "cpu"), world=2,
                      timeout_s=300)
    finally:
        sys.path.remove(REPO)
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    model = chip_smoke._ddp_merl_model(root, ddp, torch.device("cpu"))
    one = chip_smoke.ddp_merl_run(*model)
    ref = chip_smoke.ddp_merl_run(*chip_smoke._f64(model))
    lm = chip_smoke.ddp_lm_run(*chip_smoke._ddp_lm_model(root, vocab, merges, ddp,
                                                          torch.device("cpu")))
    return ranks, (one, ref), lm, model


def test_dis_step_check_passes_two_ranks(dis_harness):
    """Phase 17's harness on the CPU: each rank's pretrain step passes
    check_dis_step against one process (f32 and f64), and the main path's
    step (loss, every LoRA group) is one process's to f32 rounding."""
    ranks, (one, ref), lm, _ = dis_harness
    for r in ranks:
        chip_smoke.check_dis_step(r["merl"], one, ref)
        loss, _, _, grads = r["lm"]
        assert abs(loss - lm[0]) <= 1e-6 * abs(lm[0])
        for k, g in lm[3].items():
            assert (torch.linalg.vector_norm(grads[k] - g) / torch.linalg.vector_norm(g)) < 1e-5
    # every row's cross entropies, rank r holding global rows j * 2 + r
    got = [ranks[g % 2]["lm"][1][g // 2] for g in range(4)]
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in zip(got, lm[1]))


@pytest.mark.parametrize("fault", ["gradient-over-world", "local-batchnorm"])
def test_dis_step_check_refuses_faults(dis_harness, fault):
    """A two-rank step whose gradients were averaged over the ranks (the
    1/W of a contrastive loss gathered without its gradient, or a mean
    all-reduce), or whose BatchNorm took the rank's own statistics, is
    refused."""
    from ecg_byte_tpu_torch.parallel import Rows
    from ecg_byte_tpu_torch.parallel.batches import shard_rows

    ranks, (one, ref), _, (trainable, bn, loss_fn, batch) = dis_harness
    loss, grads, update = ranks[0]["merl"]
    if fault == "gradient-over-world":
        got = (loss, {k: g / 2 for k, g in grads.items()}, update)
        match = "gradient"
    else:  # rank 0's rows alone, as a BatchNorm without the all-reduce sees them
        local = chip_smoke.ddp_merl_run(trainable, bn, loss_fn,
                                        shard_rows(batch, Rows.stride(len(batch["norm_signal"]), 2, 0)))
        got = (loss, grads, local[2])
        match = "BatchNorm update"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_dis_step(got, one, ref)


def _dis_out(counts):
    def rank(r):
        return {"rank": r, "launches": counts[r], "training": {"steps": 4, "train_loss": [1.0],
                                                               "val_loss": [2.0]},
                "written": ["best_model", "crash_model"] if r == 0 else []}

    return {"ranks": [rank(0), rank(1)]}


def test_dis_rank_check_passes_and_refuses_a_launch_count_off_by_one():
    """Phase 17's per-rank check: exact launch counts (rank 0 evaluates the
    one validation record, rank 1 none), and rank 0 alone writing."""
    want = [chip_smoke.dis_train_counts(16, chip_smoke.rank_steps(6, 4, 2, r),
                                        chip_smoke.rank_steps(1, 4, 2, r)) for r in range(2)]
    assert want[0]["prefill_attention"] == 96 and want[1]["prefill_attention"] == 64
    assert want[0]["rmsnorm"] == 198 and want[1]["rmsnorm_bwd"] == 128
    chip_smoke.check_dis_ranks(_dis_out([dict(w) for w in want]), want, "W = 2")
    off = [dict(w) for w in want]
    off[1]["prefill_attention_bwd"] += 1
    with pytest.raises(AssertionError, match="rank 1: prefill_attention_bwd launched 65"):
        chip_smoke.check_dis_ranks(_dis_out(off), want, "W = 2")
    both = _dis_out([dict(w) for w in want])
    both["ranks"][1]["written"] = ["best_model"]
    with pytest.raises(AssertionError, match="written"):
        chip_smoke.check_dis_ranks(both, want, "W = 2")


# ------------------------------------------------------------------ phase 18


def _attention_mean(layers_dropped=0):
    """The tiny llama's streamed mean and eager stack mean on a left-padded
    batch; ``layers_dropped`` leaves the last layers out of the stack's
    mean, as a stream that lost them would."""
    from ecg_byte_tpu_torch.models import tiny_test_config
    from ecg_byte_tpu_torch.models import transformer as T

    config = tiny_test_config("llama", dtype="bfloat16")
    params = T.init_params(config, torch.Generator().manual_seed(0), torch.device("cpu"))
    ids = torch.randint(0, 512, (2, 24), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 24, dtype=torch.int32)
    mask[1, :5] = 0
    mean = T.mean_attention(params, config, ids, mask)
    with torch.no_grad():
        stack = T.forward(params, config, ids, mask, return_attentions=True)[1]
    stack = stack[: stack.shape[0] - layers_dropped]
    return mean, stack.float().mean(dim=(0, 2)), mask


def test_attention_mean_check_passes_the_stream():
    mean, stack_mean, mask = _attention_mean()
    d, sums = chip_smoke.check_attention_mean(mean, stack_mean, mask, "tiny")
    assert d <= chip_smoke.MEAN_TOL and sums <= chip_smoke.ROW_SUM_TOL


@pytest.mark.parametrize("fault", ["lost-layer", "pad-column", "row-scaled"])
def test_attention_mean_check_refuses_faults(fault):
    """A stream that lost a layer, a valid row that attends a left-pad key,
    and a row whose probabilities were scaled (a softmax over the wrong
    keys) are refused."""
    mean, stack_mean, mask = _attention_mean(layers_dropped=fault == "lost-layer")
    if fault == "pad-column":
        mean[1, 10, 2] = 1e-3
        stack_mean = mean
    elif fault == "row-scaled":
        mean[0, 7] *= 1.01
        stack_mean = mean
    with pytest.raises(AssertionError, match="streamed mean|pad or future|sums to 1"):
        chip_smoke.check_attention_mean(mean, stack_mean, mask, fault)


def _marian_run():
    from ecg_byte_tpu_torch.models import marian

    config = marian.MarianConfig(vocab_size=60, d_model=32, encoder_layers=1, decoder_layers=2,
                                 num_heads=4, ffn_dim=64, pad_token_id=59,
                                 decoder_start_token_id=59)
    params = marian.init_params(config, torch.Generator().manual_seed(0), std=0.3)
    src = torch.randint(1, 59, (3, 8), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 8, dtype=torch.int32)
    tokens = marian.greedy_generate(params, config, src, mask, max_length=12)
    logits = marian.forward(params, config, src, mask, tokens[:, :-1].long())
    return tokens, logits, config


def bound_of(logits):
    return chip_smoke.MARIAN_TOL * logits.abs().max()


def test_marian_stream_check_passes_the_cpu_run():
    tokens, logits, c = _marian_run()
    d, bound, held, ties = chip_smoke.check_marian_streams(
        tokens, logits + 1e-3 * bound_of(logits), logits, c.eos_token_id, c.pad_token_id)
    assert d <= bound and held + ties >= 3


@pytest.mark.parametrize("fault", ["logits", "token"])
def test_marian_stream_check_refuses_faults(fault):
    """Logits past the bound, and a greedy token that is not the CPU's
    argmax at a step with a clear margin, are refused."""
    tokens, logits, c = _marian_run()
    card = logits.clone()
    if fault == "logits":
        card[1, 3, 7] += 2 * bound_of(logits)
        match = "logits"
    else:
        tokens = tokens.clone()
        tokens[0, 1] = (tokens[0, 1] + 1) % 59
        match = "the card chose"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_marian_streams(tokens, card, logits, c.eos_token_id, c.pad_token_id)


def test_slice_phase_rehearsal(tmp_path, monkeypatch):
    """Phase 18 end to end on the CPU at tiny sizes: cli.main at its default
    --pad_to_max, the train-step check at S 1004, cli.interp_analysis on a
    checkpoint and its checks, translate_reports with a random Marian
    directory held to its own greedy streams, and the analysis CLIs."""
    from ecg_byte_tpu_torch.cli import main as cli_main

    root = str(tmp_path)
    vocab, merges = chip_smoke.make_data(root, n_train=4, n_val=1, n_test=2, seg_len=60,
                                         num_merges=30)
    monkeypatch.chdir(root)
    ckpt = cli_main.main(["--model", "tiny-llama", "--dataset", "ptb_500", "--tokenizer_check",
                          "tokenizer_30", "--num_merges", "30", "--percentiles",
                          "data/ptb_500_dataset_stats.npy", "--device", "cpu", "--peft", "--dev",
                          "--batch_size", "2", "--pad_to_max", "300"])["training"]["directory"]
    for name, value in dict(N_TRAIN=4, N_VAL=1, N_TEST=2, SEG_LEN=60, NUM_MERGES=30).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "check_launch_counts", lambda *a: None)
    tiny = dict(vocab_size=400, d_model=32, encoder_layers=1, decoder_layers=1, num_heads=4,
                ffn_dim=64, pad_token_id=399, decoder_start_token_id=399)
    sl = chip_smoke.Slice(model="tiny-llama", batch=2, interp_pad_to_max=300,
                          marian=tuple(tiny.items()), sentences=8, check_items=1)
    counts, out = chip_smoke.slice_phase(root, vocab, merges, os.path.basename(ckpt), sl,
                                         dev="cpu")
    assert set(counts) == {"train_pad1000", "interpret"}
    assert out["sentences_per_s"] > 0 and out["interp_ms_per_record"] > 0
    reports = chip_smoke.german_reports(64)
    assert len(set(reports)) == 64 and all(r.endswith(".") for r in reports)


# ------------------------------------------------------------------ phase 19

_GRID = dict(llm="tiny-llama", batch=4, pad_to_max=508, long_pad_to_max=1020, layers=2,
             new_tokens=4)


@pytest.fixture(scope="module")
def grid_rehearsal(tmp_path_factory):
    """Phase 19 whole on the CPU at tiny sizes: the two grid CLI runs (each
    checkpoint served by ``cli.main --inference``), the four-rank harness
    and the tp decode, with the one-process ``cli.main`` run of phase 17
    before it.  The hold functions record what they were given (in f32
    the one-process run is the f32 reference itself, so the 1.25x rules
    have no plain error to scale) and the launch counts are not held (no
    kernel launches on the CPU)."""
    from ecg_byte_tpu_torch.cli import main as cli_main

    root = str(tmp_path_factory.mktemp("grid"))
    vocab, merges = chip_smoke.make_data(root, n_train=7, n_val=3, n_test=2, seg_len=60,
                                         num_merges=30)
    held, served = {"train": [], "logits": []}, []
    args = ["--model", "tiny-llama", "--dataset", "ptb_500", "--tokenizer_check", "tokenizer_30",
            "--num_merges", "30", "--percentiles", "data/ptb_500_dataset_stats.npy"]

    def serve(root_, checkpoint, path):
        with chip_smoke.contextlib.chdir(root_):
            out = cli_main.main(args + ["--device", "cpu", "--inference", "--dev", "--peft",
                                        "--toy", "--checkpoint", checkpoint])
        served.append(out["serving"]["records"])
        return dict.fromkeys(chip_smoke.SOURCES, 0), out["serving"]["decode_ms_per_step"]

    patches = dict(N_TRAIN=7, N_VAL=3, N_TEST=2, _cli_args=lambda: list(args),
                   check_launch_counts=lambda *a: None, serve_phase=serve,
                   hold_train_paths=lambda k, p, r: held["train"].append((k, p, r)),
                   hold_logits=lambda k, p, r: held["logits"].append((k, p, r)))
    saved = {k: getattr(chip_smoke, k) for k in patches}
    for k, v in patches.items():
        setattr(chip_smoke, k, v)
    sys.path.insert(0, REPO)
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # a torch thread a rank
    cwd = os.getcwd()
    try:
        os.chdir(root)  # phase 17's W = 1 checkpoint: the one-process tree
        cli_main.main(args + ["--device", "cpu", "--peft", "--dev", "--toy", "--batch_size", "4",
                              "--pad_to_max", "508"])
        os.chdir(cwd)
        by_path, numbers = chip_smoke.grid_phase(root, vocab, merges, (root, vocab, merges),
                                                 chip_smoke.Grid(**_GRID), dev="cpu")
    finally:
        os.chdir(cwd)
        sys.path.remove(REPO)
        for k, v in saved.items():
            setattr(chip_smoke, k, v)
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return by_path, numbers, held, served


def test_grid_phase_rehearsal(grid_rehearsal):
    """Phase 19 ran every path: both CLI grids (each checkpoint the
    one-process tree's shapes, rank 0 alone writing, served), the harness's
    two steps held to one process (loss 1e-5, every LoRA group 1e-5 in the
    2-norm) and the tp decode held to one process's logits (1e-5 of the
    largest)."""
    by_path, numbers, held, served = grid_rehearsal
    assert set(by_path) == {"grid_tp", "grid_fsdp", "serve_grid_tp", "serve_grid_fsdp",
                            "grid_harness"}
    assert served == [5, 5] and numbers["wall_s"] > 0  # a record, 5 seeds
    assert len(held["train"]) == 2 and len(held["logits"]) == 4  # two steps; four ranks decode
    for (kern,), (one,), _ in held["train"]:
        assert abs(kern[0] - one[0]) <= 1e-5 * abs(one[0])
        assert kern[1].shape == one[1].shape and kern[2].shape == one[2].shape
        for k, g in one[3].items():
            assert (torch.linalg.vector_norm(kern[3][k] - g) / torch.linalg.vector_norm(g)) < 1e-5
    for kern, one, _ in held["logits"]:
        assert (kern - one).abs().max() <= 1e-5 * one.abs().max()


def test_grid_step_check_refuses_a_gradient_scaled_by_t(grid_rehearsal):
    """The harness's step held by hold_train_paths beside a plain path 1e-3
    from f32: the grid's own result passes; with its gradients scaled by T
    (a row-parallel sum whose backward sums too) it is refused."""
    _, _, held, _ = grid_rehearsal
    (kern,), (one,), _ = held["train"][0]
    gen = torch.Generator().manual_seed(0)

    def noisy(t):
        return t + 1e-3 * t.abs().max() * torch.randn(t.shape, generator=gen)

    plain = (one[0] * (1 + 1e-3), noisy(one[1]), noisy(one[2]),
             {k: noisy(g) for k, g in one[3].items()})
    chip_smoke.hold_train_paths([kern], [plain], [one])
    scaled = (*kern[:3], {k: chip_smoke.GRID_TP * g for k, g in kern[3].items()})
    with pytest.raises(AssertionError, match="gradient groups"):
        chip_smoke.hold_train_paths([scaled], [plain], [one])


def test_grid_rank_check_refuses_a_count_off_by_one_and_a_write_by_rank_1():
    """The --fsdp CLI run's counts (each layer's forward again in its
    backward): exact per rank, and rank 0 alone writing."""
    want = chip_smoke.dis_train_counts(16, 4, 2, replay=True)
    assert want["prefill_attention"] == 16 * (4 + 2 + 4)
    assert want["rmsnorm"] == 33 * 6 + 32 * 4 and want["rmsnorm_bwd"] == 32 * 4
    chip_smoke.check_dis_ranks(_dis_out([dict(want), dict(want)]), [want] * 2, "F = 2")
    off = [dict(want), dict(want)]
    off[1]["rmsnorm"] -= 1
    with pytest.raises(AssertionError, match="rank 1: rmsnorm launched"):
        chip_smoke.check_dis_ranks(_dis_out(off), [want] * 2, "F = 2")
    both = _dis_out([dict(want), dict(want)])
    both["ranks"][1]["written"] = ["best_model"]
    with pytest.raises(AssertionError, match="written"):
        chip_smoke.check_dis_ranks(both, [want] * 2, "F = 2")


def test_tp_stream_check_refuses_a_parting_at_a_wide_margin():
    """Equal streams pass; streams that part where one process's top-2
    margin is within the logits bound (a near tie) pass, at that step; a
    parting where the margin is wider is refused."""
    assert chip_smoke.check_tp_stream([5, 6, 7], [5, 6, 7], [1.0] * 3, 0.1) is None
    assert chip_smoke.check_tp_stream([5, 6, 8], [5, 6, 7], [1.0, 1.0, 0.05], 0.1) == 2
    with pytest.raises(AssertionError, match="parts at step 1"):
        chip_smoke.check_tp_stream([5, 9, 7], [5, 6, 7], [1.0, 0.5, 1.0], 0.1)


# ------------------------------------------------------------------ phase 20


def test_fold_phase_rehearsal(tmp_path, monkeypatch):
    """Phase 20 whole on the CPU at tiny sizes: the folded LoRA step held by
    the rule of phase 7 on its own tree, and the folded tree in f32 beside
    the classic one (in f32 each plain path is its f32 reference itself,
    so hold_train_paths records what it is given: the folded step within
    1e-4 of the classic one), both trees' greedy streams in bf16 and int8
    through the stream check, every path's launch counts recorded."""
    root = str(tmp_path)
    vocab, merges = chip_smoke.make_data(root, n_train=2, n_val=1, n_test=1, seg_len=60,
                                         num_merges=30)
    held, logits = [], []
    monkeypatch.setattr(chip_smoke, "hold_train_paths",
                        lambda k, p, r, **kw: held.append((k, p, r)))

    def hold(kern, ref, ratio, what):  # on the CPU the bf16 paths run in f32
        logits.append((kern, ref, ratio))
        return dict.fromkeys(("classic_vs_f32", "folded_vs_f32", "fold_in_f32",
                              "folded_vs_classic_f32", "classic_prefill_abs"), 0.0)

    monkeypatch.setattr(chip_smoke, "hold_folded_logits", hold)
    fold = chip_smoke.Fold(model="tiny-llama", batch=2, pad_to_max=300, new_tokens=6)
    by_path, numbers = chip_smoke.fold_phase(root, vocab, merges, fold, dev="cpu")
    # the served logits (f32 on the CPU) held against each tree in f32 on
    # the plain versions over the classic stream: rows of the prefill and
    # each fed-back token, the folded tree within 1e-4 of the classic one
    assert len(logits) == 2 and all(r == chip_smoke.FOLD_LOGITS_RATIO for _, _, r in logits)
    for (kern, ref, _), int8 in zip(logits, (False, True)):
        assert all(x.shape == (fold.new_tokens, kern["classic"].shape[1])
                   for x in (*kern.values(), *ref.values()))
        assert torch.allclose(ref["folded"], ref["classic"], rtol=1e-4, atol=1e-4)
        # the int8 copy is held against the unquantized tree
        assert torch.equal(kern["classic"], ref["classic"]) != int8
    assert set(by_path) == {f"fold_{p}{c}" for p in ("train", "serve_bf16", "serve_int8")
                            for c in ("", "_classic")}
    assert all(not any(c.values()) for c in by_path.values())  # no kernel on the CPU
    ((kern,), (plain,), (folded32,)), ((fold,), (classic,), (ref,)) = held
    assert kern[0] == plain[0] == folded32[0] == fold[0] and classic[0] == ref[0]
    assert abs(fold[0] - classic[0]) <= 1e-4 * abs(classic[0])
    for k, g in classic[3].items():
        assert torch.equal(kern[3][k], plain[3][k])
        assert (torch.linalg.vector_norm(fold[3][k] - g) / torch.linalg.vector_norm(g)) < 1e-4
    assert set(numbers["folded_vs_classic_error_ratios"]) == {"ce_labelled", "ce_valid",
                                                              "grad_max", "grad_min"}
    assert numbers["wall_s"] > 0 and numbers["decode_int8_folded_ms_per_token"] > 0


def test_blame_phase_rehearsal(tmp_path, capsys, monkeypatch):
    """``chip_smoke.py --blame`` on the CPU at tiny sizes: both trees at
    both norm settings, with all the train path's kernels and with each
    alone, the resident forward with each way of summing its scores
    alone, attention without a kernel (its q.k sums reordered, the
    kernel's softmax arithmetic, P.V on the tensor cores; q.k on the
    tensor cores, alone and with the kernel's softmax and P.V there, says
    it needs the card), the folded plain path against
    the classic one, every call of the two forward kernels in item 0's
    step against f64, the score product's signed bias each way, and the
    flash path's reading (its threshold lowered between the two sizes).
    On the CPU every wrapper is its plain version, so each ratio is 0 and
    each call's two errors are equal."""
    root = str(tmp_path)
    vocab, merges = chip_smoke.make_data(root, n_train=2, n_val=1, n_test=1, seg_len=60,
                                         num_merges=30)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 512)
    fold = chip_smoke.Fold(model="tiny-llama", batch=2, pad_to_max=300)
    chip_smoke.blame_phase(root, vocab, merges, fold, items=2, dev="cpu",
                           long=(root, vocab, merges), long_pad_to_max=508)
    lines = capsys.readouterr().out.splitlines()
    variants = chip_smoke._FORWARD_VARIANTS
    assert list(chip_smoke.SCORE_DOTS) == list(attention_resident.SCORE_DOTS)
    assert list(chip_smoke.FORWARD_VARIANTS) == list(attention_resident.FORWARD_VARIANTS)
    rows = [ln for ln in lines if ln.startswith("shift ") and "on the card" in ln]
    assert len(rows) == 2 * 2 * (5 + len(variants)) and all("ce_valid 0.000" in ln for ln in rows)
    assert sum(" alone: " in ln for ln in rows) == 2 * 2 * len(variants)
    # in f32 the classic plain path is the f32 tree itself
    fold = [ln for ln in lines if ln.startswith("shift ") and "folded plain / " in ln]
    assert len(fold) == 2 and all("ce_valid inf" in ln for ln in fold)
    # no bf16 product with f32 output on the CPU: each witness that needs it
    # says so once
    needs = [ln for ln in lines if ln.startswith("witness ") and ": needs torch.bmm" in ln]
    assert [ln.split(":")[0] for ln in needs] == [f"witness {k}"
                                                  for k in chip_smoke._CARD_WITNESSES]
    witnesses = [k for k in chip_smoke._ATTENTION_WITNESSES if k not in chip_smoke._CARD_WITNESSES]
    swaps = [ln for ln in lines if any(f"tree, attention {k}: " in ln
                                       for k in chip_smoke._PAD_ROW_SWAPS)]
    assert len(swaps) == 2 * 2 * len(chip_smoke._PAD_ROW_SWAPS)
    witness = [ln for ln in lines if ", no kernel, attention " in ln]
    assert len(witness) == 2 * 2 * len(witnesses)
    calls = {ln.split(", item 0's")[0]: ln for ln in lines if "item 0's classic step" in ln}
    scores = {k: ln for k, ln in calls.items() if k.startswith("score product, ")}
    assert set(scores) == {f"score product, kernel {d}" for d in chip_smoke.SCORE_DOTS}
    assert all("2 calls" in ln for ln in scores.values())
    assert set(calls) - set(scores) == {"prefill_attention", "rmsnorm", *variants, *witnesses}
    assert all("2 calls" in calls[n] for n in ("prefill_attention", *variants, *witnesses))
    assert "6 calls" in calls["rmsnorm"]
    flash = [ln for ln in lines if ln.startswith("flash path, 2 items at B1 x 512")]
    assert len(flash) == 1 and "ce_valid 0.000" in flash[0]


@pytest.mark.parametrize("rounding", ["toward-zero", "to-nearest"])
def test_signed_ulp_bias_reads_the_rounding_direction(rounding):
    """Logits rounded toward zero from their f64 values read a negative
    bias for s > 0 and a positive one for s < 0, about half an f32 ulp of
    |s|; rounded to nearest they read within 0.1 ulp of 0 on either
    side."""
    exact = torch.from_numpy(np.random.default_rng(0).normal(0, 8, 20000))
    got = exact.float()
    if rounding == "toward-zero":
        past = got.double().abs() > exact.abs()
        got = torch.where(past, torch.nextafter(got, torch.zeros_like(got)), got)
        assert (got.double().abs() <= exact.abs()).all()
    pos, neg = chip_smoke.signed_ulp_bias(got, exact)
    if rounding == "toward-zero":
        assert -0.6 < pos < -0.4 and 0.4 < neg < 0.6
    else:
        assert abs(pos) < 0.1 and abs(neg) < 0.1


def test_score_tiles_pair_valid_query_and_key_rows():
    """The score product's tiles of one call hold only valid positions: per
    KV head the queries' rows (the G heads of a position together) and the
    keys', cut to whole tiles, and each tile pair's product is a block of
    the plain logits."""
    gen = torch.Generator().manual_seed(0)
    qg = torch.randn(1, 160, 2, 4, 16, generator=gen).to(torch.bfloat16)
    k = torch.randn(1, 160, 2, 16, generator=gen).to(torch.bfloat16)
    mask = torch.ones(1, 160, dtype=torch.int32)
    mask[:, :20] = 0
    q, kk = chip_smoke.score_tiles(qg, k, mask)
    assert q.shape == kk.shape == (2 * 2, 64, 16)  # 140 valid keys: 2 tiles a head
    assert torch.equal(q[2], qg[0, 20:36, 1].reshape(64, 16))
    assert torch.equal(kk[3], k[0, 84:148, 1])
    biases = chip_smoke.score_biases([(qg, k, None, mask)], tensor_cores=False)
    assert set(biases) == {f"kernel {d}" for d in chip_smoke.SCORE_DOTS}
    # the plain f32 product rounds to nearest: no lean either way
    assert all(len(b) == 1 and abs(b[0][0]) < 0.1 and abs(b[0][1]) < 0.1
               for b in biases.values()), biases


def test_off_one_norms_moves_every_norm_weight():
    from ecg_byte_tpu_torch.models import tiny_test_config
    from ecg_byte_tpu_torch.models import transformer as T

    config = tiny_test_config("llama", dtype="bfloat16")
    params = T.init_params(config, torch.Generator().manual_seed(0), torch.device("cpu"))
    moved = chip_smoke.off_one_norms(params, 0, 0.3)
    norms = [moved["final_norm"]] + [layer[n] for layer in moved["layers"]
                                     for n in ("attn_norm", "mlp_norm")]
    assert all(t.dtype == torch.bfloat16 and (t != 1).float().mean() > 0.9 for t in norms)
    assert 0.2 < torch.cat([t.float() - 1 for t in norms]).std() < 0.4
    assert moved["layers"][0]["q_proj"] is params["layers"][0]["q_proj"]


def test_folded_count_check_refuses_an_extra_norm_and_another_count():
    """RMSNorm's folded and classic counts exact; every other kernel as
    often on both trees."""
    classic = {"rmsnorm": 33, "rmsnorm_bwd": 32, "prefill_attention": 16, "bpe_match": 0}
    folded = dict(classic, rmsnorm=1, rmsnorm_bwd=1)
    per_norm = {"rmsnorm": (1, 33), "rmsnorm_bwd": (1, 32)}
    chip_smoke.check_folded_counts(folded, classic, per_norm, "step")
    with pytest.raises(AssertionError, match="rmsnorm launched 2 folded"):
        chip_smoke.check_folded_counts(dict(folded, rmsnorm=2), classic, per_norm, "step")
    with pytest.raises(AssertionError, match="prefill_attention launched 15 folded"):
        chip_smoke.check_folded_counts(dict(folded, prefill_attention=15), classic, per_norm,
                                       "step")


def _trace_file(tmp_path, names):
    events = [{"cat": "cpu_op", "name": "aten::mm"}] + [{"cat": "kernel", "name": n}
                                                         for n in names]
    path = tmp_path / "rank0.1.2.pt.trace.json"
    path.write_text(chip_smoke.json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_counts_check_passes_the_counters_and_refuses_one_off(tmp_path):
    """The kernel events of a trace, by wrapper: each attention forward and
    backward (by its dQ kernel) and both RMSNorm kernels, held to the
    counters exactly; a trace that lost one is refused, as is one without
    the resident backward on the card."""
    names = (["void ecg::fwd::fwd_kernel<64, false>(ecg::bwd::Args)"] * 3
             + ["void ecg::bwd::dq_kernel<64, false>(ecg::bwd::Args)",
                "void ecg::bwd::dkv_kernel<64, false, 3>(ecg::bwd::Args)",
                "void ecg::fwd::fwd_kernel<64, true>(ecg::bwd::Args)",
                "void (anonymous namespace)::rmsnorm_fwd_kernel<__nv_bfloat16, 2>(...)",
                "void (anonymous namespace)::rmsnorm_bwd_kernel<__nv_bfloat16, 2, false>(...)",
                "void (anonymous namespace)::rmsnorm_dw_sum_kernel<float>(...)",
                "nvjet_tst_64x8_64x16_2x1_v_bz_TNT"])
    traced, got = chip_smoke.trace_kernel_counts(_trace_file(tmp_path, names))
    assert got == names
    want = {"prefill_attention": 3, "prefill_attention_bwd": 1, "flash_attention": 1,
            "flash_attention_bwd": 0, "rmsnorm": 1, "rmsnorm_bwd": 1}
    assert traced == want
    chip_smoke.check_trace_counts(traced, dict(want, bpe_match=2), "cuda")
    with pytest.raises(AssertionError, match="3 prefill_attention kernels, the counter 4"):
        chip_smoke.check_trace_counts(traced, dict(want, prefill_attention=4), "cuda")
    lost = dict(want, prefill_attention_bwd=0)
    chip_smoke.check_trace_counts(lost, lost, "cpu")
    with pytest.raises(AssertionError, match="prefill_attention_bwd"):
        chip_smoke.check_trace_counts(lost, lost, "cuda")


def test_memory_lines_check_refuses_a_missing_reading_and_a_size_past_the_card():
    lines = [f"[memory] {tag}: 1.00 GB live on cuda:0 ({10**9} bytes; peak {2 * 10**9} bytes)"
             for tag in chip_smoke.MEMORY_TAGS]
    text = "\n".join(["Model llama-3.2-1b: ..."] + lines)
    assert chip_smoke.check_memory_lines(text, 80 * 10**9) == [10**9] * 3
    with pytest.raises(AssertionError, match="memory readings"):
        chip_smoke.check_memory_lines("\n".join(lines[:2]), 80 * 10**9)
    with pytest.raises(AssertionError, match=r"not in \(0, "):
        chip_smoke.check_memory_lines(text, 10**8)


def test_hold_train_paths_holds_the_positions_asked():
    """With ``held=("labelled",)`` the valid positions' cross entropy is
    printed, not held; the labelled positions' and every gradient group
    still are."""
    gen = torch.Generator().manual_seed(0)
    ref = (2.0, torch.rand(50, generator=gen) + 1, torch.rand(400, generator=gen) + 1,
           {"LoRA q_proj.a": torch.randn(64, generator=gen)})

    def noisy(t, scale):
        return t + scale * torch.randn(t.shape, generator=gen)

    def path(valid_noise):
        return (ref[0] + 1e-4, noisy(ref[1], 1e-3), noisy(ref[2], valid_noise),
                {k: noisy(g, 1e-3) for k, g in ref[3].items()})

    plain, kern = path(1e-3), path(3e-3)
    chip_smoke.hold_train_paths([kern], [plain], [ref], held=("labelled",))
    with pytest.raises(AssertionError, match="valid positions"):
        chip_smoke.hold_train_paths([kern], [plain], [ref])
    far = (kern[0], kern[1] * 1.01, *kern[2:])
    with pytest.raises(AssertionError, match="labelled positions"):
        chip_smoke.hold_train_paths([far], [plain], [ref], held=("labelled",))


def test_hold_train_paths_refuses_valid_positions_at_1_6x_by_default():
    """A step whose cross entropy at the valid positions sits 1.6x the
    plain path's distance from f32 (as the resident forward's tensor-core
    scores put it with the norm weights moved off 1) is refused by the
    default ``held``, while its loss, its labelled positions and every
    gradient group pass."""
    gen = torch.Generator().manual_seed(1)
    ref = (2.0, torch.rand(50, generator=gen) + 1, torch.rand(4000, generator=gen) + 1,
           {g: torch.randn(256, generator=gen) for g in ("LoRA q_proj.a", "LoRA q_proj.b")})
    noise = {j: torch.randn(ref[j].shape, generator=gen) for j in (1, 2)}
    grads = {g: torch.randn(t.shape, generator=gen) for g, t in ref[3].items()}

    def path(valid_scale):
        return (ref[0] + 1e-5, ref[1] + 1e-3 * noise[1], ref[2] + valid_scale * noise[2],
                {g: t + 1e-3 * grads[g] for g, t in ref[3].items()})

    plain, kern = path(1e-3), path(1.6e-3)
    chip_smoke.hold_train_paths([kern], [plain], [ref], held=("labelled",))
    with pytest.raises(AssertionError, match="cross entropy at the valid positions"):
        chip_smoke.hold_train_paths([kern], [plain], [ref])
    chip_smoke.hold_train_paths([path(1.1e-3)], [plain], [ref])


def test_valid_predictions_leave_out_the_last_left_pad_row():
    """The predictions held at the valid positions are those made at a
    valid position of a valid token: the last left-pad row, which
    predicts the first valid token but attends no key, is left out (as
    phase 16 always left it out), and a row without padding keeps all
    S - 1."""
    mask = torch.tensor([[0, 0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1, 1]], dtype=torch.int32)
    valid = chip_smoke.valid_predictions(mask)
    assert valid.tolist() == [[False, False, False, True, True, True],
                              [True, True, True, True, True, True]]
    last_pad = mask[:, 1:].bool() & ~valid
    assert last_pad.nonzero().tolist() == [[0, 2]]


def test_error_ratios_read_the_last_pad_rows_apart():
    """A step that differs from plain only at the last left-pad rows reads
    1 at the valid positions and far above it at those rows, alone and
    pooled with the valid positions."""
    gen = torch.Generator().manual_seed(2)
    ref = (2.0, torch.rand(20, generator=gen) + 1, torch.rand(400, generator=gen) + 1,
           {"LoRA q_proj.a": torch.randn(64, generator=gen)}, torch.rand(4, generator=gen) + 1)
    plain = tuple(x + 1e-3 if torch.is_tensor(x) else x for x in ref[:3]) + (
        {k: g + 1e-3 for k, g in ref[3].items()}, ref[4] + 1e-3)
    kern = plain[:4] + (ref[4] + 0.5,)
    r = chip_smoke.path_error_ratios(kern, plain, ref)
    assert r["ce_valid"] == 1.0 and r["ce_labelled"] == 1.0
    assert r["ce_last_pad"] > 100 and r["ce_valid_and_last_pad"] > 10
    assert set(chip_smoke.path_error_ratios(kern[:4], plain[:4], ref[:4])) == {
        "ce_labelled", "ce_valid", "grad_max", "grad_min"}


def test_folded_logits_hold_refuses_a_folded_path_or_a_fold_past_its_bound():
    """The folded path's distance from its f32 tree within ``ratio`` x the
    classic path's from its, and the fold in f32 within 1.25x: a folded
    path with a scale dropped in one row, or a fold that moved the f32
    logits, is refused."""
    gen = torch.Generator().manual_seed(0)
    classic32 = torch.randn(5, 40, generator=gen)
    ref = {"classic": classic32, "folded": classic32 + 1e-4 * torch.randn(5, 40, generator=gen)}

    def noisy(t, scale):
        return t + scale * torch.randn(t.shape, generator=gen)

    kern = {"classic": noisy(ref["classic"], 1e-2), "folded": noisy(ref["folded"], 1e-2)}
    d = chip_smoke.hold_folded_logits(kern, ref, 1.25, "ok")
    assert d["fold_in_f32"] < d["classic_vs_f32"] and d["classic_prefill_abs"] > 0
    dropped = kern["folded"].clone()
    dropped[3] *= 1.2  # one decode step's output without its scale
    with pytest.raises(AssertionError, match="folded path further"):
        chip_smoke.hold_folded_logits({**kern, "folded": dropped}, ref, 1.25, "dropped")
    moved = {**ref, "folded": noisy(ref["classic"], 5e-2)}
    with pytest.raises(AssertionError, match="the fold moves"):
        chip_smoke.hold_folded_logits({**kern, "folded": noisy(moved["folded"], 1e-2)}, moved,
                                      1.25, "moved")


def test_forced_argmax_check_refuses_a_flip_at_a_wide_margin():
    """Teacher-forced logits whose argmax is the reference's token pass; a
    step where it differs passes only where the reference's margin there
    is within the bound."""
    logits = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.0, 1.0], [0.0, 1.0, 1.5]])
    assert chip_smoke.check_forced_argmax(logits, [1, 0, 2], [1.0, 2.0, 0.5], 0.1, "ok") == []
    assert chip_smoke.check_forced_argmax(logits, [1, 0, 1], [1.0, 2.0, 0.05], 0.1, "tie") == [2]
    with pytest.raises(AssertionError, match=r"\(step, margin\) \[\(1, 0.5\)\]"):
        chip_smoke.check_forced_argmax(logits, [1, 2, 2], [1.0, 0.5, 0.5], 0.1, "flip")
