"""Parity of the port's kernel modules with the JAX package on the CPU.

On CPU tensors the port's wrappers take their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do, and its XLA reference paths.  Inputs are made with numpy from
a seed and handed to both.  The CUDA and Triton kernels themselves run only
on the card, where ``chip_smoke.py`` holds them against these plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu.ops import attention as jax_attention
from ecg_byte_tpu.ops import attention_decode as jax_decode
from ecg_byte_tpu.ops import attention_resident as jax_resident
from ecg_byte_tpu.ops import rmsnorm as jax_rmsnorm
from ecg_byte_tpu_torch import device as port_device
from ecg_byte_tpu_torch.ops import attention, attention_decode, attention_resident, rmsnorm


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _torch_bf16(x):
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------- RMSNorm


def _norm_inputs(seed=0, rows=32, d=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, rows // 2, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, w


def test_rmsnorm_f32_matches_pallas_and_norm():
    """f32 within 1e-6 of the Pallas kernel (interpret mode) and of
    ``transformer._norm``."""
    x, w = _norm_inputs()
    eps = 1e-5
    got = rmsnorm.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps).numpy()
    pallas = np.asarray(jax_rmsnorm.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps, 512, True))
    cfg = jax_config.tiny_test_config("llama", hidden_size=256, norm_eps=eps)
    norm = np.asarray(JT._norm(jnp.asarray(x), jnp.asarray(w), None, cfg))
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, norm, atol=1e-6, rtol=0)
    assert rmsnorm.rmsnorm.launches == 0  # CPU tensors never reach the kernel


def test_rmsnorm_bf16_matches_pallas():
    """bf16: the outputs are equal, bit for bit (the f32 statistics agree
    far inside one bf16 rounding step at this size)."""
    x, w = _norm_inputs(seed=1)
    xb = _bf16_np(x)
    got = rmsnorm.rmsnorm(_torch_bf16(xb), torch.from_numpy(w), 1e-5).float().numpy()
    want = np.asarray(
        jax_rmsnorm.rmsnorm(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(w), 1e-5, 512, True)
    ).astype(np.float32)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ prefill attention


def _attn_inputs(b, s, kh, g, d, left_pad, seed=0):
    rng = np.random.default_rng(seed)
    q = _bf16_np(rng.normal(size=(b, s, kh, g, d)))
    k = _bf16_np(rng.normal(size=(b, s, kh, d)))
    v = _bf16_np(rng.normal(size=(b, s, kh, d)))
    mask = np.ones((b, s), np.int32)
    mask[:, :left_pad] = 0
    return q, k, v, mask


@pytest.mark.parametrize("left_pad", [0, 37, 70])
@pytest.mark.parametrize(
    "b,s,kh,g,d,block_m",
    [
        (2, 256, 2, 4, 64, 512),  # G = 4, as llama
        (1, 256, 2, 1, 64, 256),  # G = 1, as gpt2
        # S a multiple of 16 but not of 64: the CUDA kernel's last query and
        # key tiles hold rows past S; with 70 left-pad positions the padding
        # passes its first key tile
        (1, 80, 2, 4, 64, 512),
    ],
)
def test_prefill_plain_matches_resident_kernel(b, s, kh, g, d, block_m, left_pad):
    """bf16; valid query rows within 2e-2 (atol and rtol, as
    tests/test_attention_resident.py) of the Pallas kernel in interpret
    mode; every row finite, the left-pad rows included."""
    q, k, v, mask = _attn_inputs(b, s, kh, g, d, left_pad)
    want = np.asarray(jax_resident.resident_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask), block_m, True,
    ), np.float32)
    got = attention_resident.resident_attention(
        _torch_bf16(q), _torch_bf16(k), _torch_bf16(v), torch.from_numpy(mask)
    ).float().numpy()
    assert np.isfinite(got).all()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-2, rtol=2e-2)
    # the dispatch in ops/attention.py reaches the same plain version
    flat = attention.causal_attention(
        _torch_bf16(q.reshape(b, s, kh * g, d)), _torch_bf16(k), _torch_bf16(v),
        torch.from_numpy(mask),
    ).float().numpy()
    np.testing.assert_array_equal(flat, got.reshape(b, s, kh * g, d))
    assert attention_resident.resident_attention.launches == 0


# ------------------------------------------------------- decode attention


def _decode_case(b=2, s=256, h=8, kh=2, d=64, seed=0):
    """The bf16-cache cases of tests/test_attention_decode.py, in f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[:, -s // 4:] = 0  # unfilled tail
    mask[0, :3] = 0  # left padding
    return q, k, v, mask


@pytest.mark.parametrize(
    "case",
    [dict(), dict(h=5, kh=5, seed=7), dict(b=1, s=128, h=4, kh=1, seed=3)],
    ids=["gqa", "mha-odd-heads", "single-kv-head"],
)
def test_decode_plain_matches_jax(case):
    """f32 within 2e-5 of the Pallas kernel (interpret mode) and of the XLA
    ``decode_attention``."""
    q, k, v, mask = _decode_case(**case)
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    fused = np.asarray(jax_decode.decode_attention_fused(*jargs, interpret=True))
    xla = np.asarray(jax_attention.decode_attention(*jargs))
    targs = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got = attention_decode.decode_attention_fused(*targs).numpy()
    np.testing.assert_array_equal(got, attention.decode_attention(*targs).numpy())
    np.testing.assert_allclose(got, fused, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)
    assert attention_decode.decode_attention_fused.launches == 0


# ------------------------------------------------------------- no fallback


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_rmsnorm_plain_bf16_weight_matches_f32_weight_and_pallas():
    """The stored bf16 norm weight goes to the kernels as it is: the plain
    forward with a bf16 w equals the one with ``w.float()`` bit for bit,
    and both equal the Pallas kernel (interpret mode) given the same bf16
    w, which it converts in-register."""
    x, w = _norm_inputs(seed=9)
    xb = _torch_bf16(_bf16_np(x))
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = rmsnorm.rmsnorm(xb, wb, 1e-5)
    assert torch.equal(got, rmsnorm.rmsnorm(xb, wb.float(), 1e-5))
    pallas = np.asarray(jax_rmsnorm.rmsnorm(jnp.asarray(_bf16_np(x), jnp.bfloat16),
                                            jnp.asarray(wb.float().numpy(), jnp.bfloat16),
                                            1e-5, 512, True)).astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy(), pallas)
    assert rmsnorm.rmsnorm.launches == 0


@pytest.mark.parametrize("width", [12, 4, 16392], ids=["not-8", "below-8", "too-wide"])
def test_rmsnorm_wrappers_refuse_widths(width):
    """A width the CUDA kernels do not take (not a multiple of 8, or a row
    above 2,048 vectors of 8) raises before the device is looked at; the
    widest they take, with either weight type, gets as far as the device
    check, and an x other than bf16 is refused."""
    x = torch.empty(4, width, device="meta", dtype=torch.bfloat16)
    w = torch.ones(width, device="meta")
    with pytest.raises(ValueError, match="width"):
        rmsnorm.rmsnorm(x, w, 1e-5)
    with pytest.raises(ValueError, match="width"):
        rmsnorm.rmsnorm_bwd(x, w, x, 1e-5, False)
    x = torch.empty(4, rmsnorm.MAX_WIDTH, device="meta", dtype=torch.bfloat16)
    for w_dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="device"):
            rmsnorm.rmsnorm(x, torch.ones(rmsnorm.MAX_WIDTH, device="meta", dtype=w_dtype), 1e-5)
    with pytest.raises(ValueError, match="x must be bfloat16"):
        rmsnorm.rmsnorm(x.float(), torch.ones(rmsnorm.MAX_WIDTH, device="meta"), 1e-5)


def test_wrappers_reject_other_devices():
    """Only a CPU tensor takes the plain version; anything else goes to the
    kernel's checks, which raise before any launch."""
    x = torch.empty(4, 256, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(x, torch.ones(256, device="meta"), 1e-5)
    qg = torch.empty(1, 32, 2, 4, 64, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, 32, 2, 64, device="meta", dtype=torch.bfloat16)
    mask = torch.ones(1, 32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm_bwd(x, torch.ones(256, device="meta"), x, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        attention_resident.resident_attention(qg, kv, kv, mask)
    with pytest.raises(ValueError, match="CUDA"):
        attention_resident.resident_attention_bwd(qg, kv, kv, mask, qg, qg)
    with pytest.raises(ValueError, match="CUDA"):
        attention_decode.decode_attention_fused(
            torch.empty(1, 1, 8, 64, device="meta", dtype=torch.bfloat16), kv, kv, mask
        )


# ------------------------------------------------------------- backwards


@pytest.mark.parametrize("left_pad", [0, 37])
@pytest.mark.parametrize(
    "b,s,kh,g,d,block_m",
    [
        (2, 256, 2, 4, 64, 512),  # the cases of tests/test_attention_resident.py
        (1, 256, 2, 1, 64, 256),
        (2, 128, 1, 2, 64, 128),
    ],
)
def test_attention_bwd_plain_matches_pallas_vjp(b, s, kh, g, d, block_m, left_pad):
    """bf16: dq, dk, dv of the plain backward within 4e-2 * max|ref| of the
    VJP of the Pallas kernel in interpret mode (the tolerance of
    tests/test_attention_resident.py); the output gradient is zero on
    left-pad rows, as on the training path."""
    q, k, v, mask = _attn_inputs(b, s, kh, g, d, left_pad, seed=3)
    rng = np.random.default_rng(4)
    gout = _bf16_np(rng.normal(size=q.shape)) * mask[:, :, None, None, None]
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_resident.resident_attention(q_, k_, v_, jnp.asarray(mask),
                                                           block_m, True), jq, jk, jv)
    want = vjp(jnp.asarray(gout, jnp.bfloat16))
    tq, tk, tv, tmask = _torch_bf16(q), _torch_bf16(k), _torch_bf16(v), torch.from_numpy(mask)
    out = attention_resident.resident_attention(tq, tk, tv, tmask)
    got = attention_resident.resident_attention_bwd(tq, tk, tv, tmask, out, _torch_bf16(gout))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        assert np.isfinite(a).all()
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(a / scale, w / scale, atol=4e-2, err_msg=name)
    assert attention_resident.resident_attention_bwd.launches == 0


@pytest.mark.parametrize("left_pad", [0, 5])
def test_attention_bwd_plain_matches_autograd_f32(left_pad):
    """f32: the plain backward equals autograd through the plain forward
    within 1e-5 absolute, left-pad rows included (their output gradient is
    random here)."""
    rng = np.random.default_rng(left_pad)
    b, s, kh, g, d = 2, 48, 2, 3, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).requires_grad_(True)
               for sh in ((b, s, kh, g, d), (b, s, kh, d), (b, s, kh, d)))
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[:, :left_pad] = 0
    gout = torch.from_numpy(rng.standard_normal((b, s, kh, g, d)).astype(np.float32))
    out = attention.grouped_attention(q, k, v, mask)
    want = torch.autograd.grad(out, (q, k, v), gout)
    got = attention_resident.resident_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                                          mask, out.detach(), gout)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("rows,block_rows", [(32, 32), (64, 16)], ids=["one-block", "multi-block"])
def test_rmsnorm_bwd_plain_matches_pallas_vjp(rows, block_rows):
    """f32: dx and dw of the plain backward within 1e-5 of the VJP of the
    Pallas kernel in interpret mode, dw summed over one or several row
    blocks there."""
    x, w = _norm_inputs(seed=5, rows=rows, d=256)
    gout = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_: jax_rmsnorm.rmsnorm(x_, w_, 1e-5, block_rows, True),
                     jnp.asarray(x), jnp.asarray(w))
    wdx, wdw = vjp(jnp.asarray(gout))
    dx, dw = rmsnorm.rmsnorm_bwd(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(gout), 1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(wdx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(wdw), atol=1e-5, rtol=1e-6)
    dx2, dw2 = rmsnorm.rmsnorm_bwd(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(gout), 1e-5, need_dw=False)
    assert dw2 is None and torch.equal(dx2, dx)
    assert rmsnorm.rmsnorm_bwd.launches == 0


@pytest.fixture
def one_thread():
    """One torch thread for the test, restored after: gradcheck's thousands
    of tiny ops on eight threads in each of six pytest workers spend their
    time waking threads (oversubscribed cores), not computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
def test_autograd_functions_gradcheck():
    """Both autograd functions pass gradcheck in f64 on the CPU (no pad:
    a fully masked row's logits lose q to the -1e30 fill, so its numeric
    derivative is zero while the analytic one is not)."""
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)

    x, w = t(3, 5, 16), t(16)
    assert torch.autograd.gradcheck(lambda x_, w_: rmsnorm.RMSNorm.apply(x_, w_, 1e-5), (x, w))
    q, k, v = t(1, 32, 2, 2, 8), t(1, 32, 2, 8), t(1, 32, 2, 8)
    mask = torch.ones(1, 32, dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: attention_resident.ResidentAttention.apply(q_, k_, v_, mask), (q, k, v))
    assert rmsnorm.rmsnorm.launches == rmsnorm.rmsnorm_bwd.launches == 0
    assert attention_resident.resident_attention.launches == 0
    assert attention_resident.resident_attention_bwd.launches == 0


def test_rmsnorm_weight_grad_only_where_it_trains():
    """The autograd function forms dw only when the weight requires grad
    (a frozen norm under LoRA training skips it)."""
    x = torch.randn(4, 8, 32, requires_grad=True)
    calls = []
    real = rmsnorm.rmsnorm_bwd

    def spy(x_, w_, g_, eps, need_dw):
        calls.append(need_dw)
        return real(x_, w_, g_, eps, need_dw)

    rmsnorm.rmsnorm_bwd = spy
    try:
        for w in (torch.ones(32), torch.ones(32, requires_grad=True)):
            rmsnorm.RMSNorm.apply(x, w, 1e-5).sum().backward()
    finally:
        rmsnorm.rmsnorm_bwd = real
    assert calls == [False, True]
