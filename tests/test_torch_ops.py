"""Parity of the port's kernel modules with the JAX package on the CPU.

On CPU tensors the port's wrappers take their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do, and its XLA reference paths.  Inputs are made with numpy from
a seed and handed to both.  The CUDA and Triton kernels themselves run only
on the card, where ``chip_smoke.py`` holds them against these plain
versions.
"""

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


@pytest.mark.parametrize("left_pad", [0, 37])
@pytest.mark.parametrize(
    "b,s,kh,g,d,block_m",
    [
        (2, 256, 2, 4, 64, 512),  # G = 4, as llama
        (1, 256, 2, 1, 64, 256),  # G = 1, as gpt2
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


def test_wrappers_reject_other_devices():
    """Only a CPU tensor takes the plain version; anything else goes to the
    kernel's checks, which raise before any launch."""
    x = torch.empty(4, 256, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(x, torch.ones(256, device="meta"), 1e-5)
    qg = torch.empty(1, 32, 2, 4, 64, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, 32, 2, 64, device="meta", dtype=torch.bfloat16)
    mask = torch.ones(1, 32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_resident.resident_attention(qg, kv, kv, mask)
    with pytest.raises(ValueError, match="CUDA"):
        attention_decode.decode_attention_fused(
            torch.empty(1, 1, 8, 64, device="meta", dtype=torch.bfloat16), kv, kv, mask
        )
