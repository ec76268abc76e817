"""The port's long-context attention against the JAX package on the CPU.

``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain`` against
``ecg_byte_tpu.ops.flash_attention`` in interpret mode (its ``_flash_fwd``
for the log-sum-exp, ``jax.vjp`` for the gradients), the dispatch of
``ops/attention.causal_attention`` at ``FLASH_MIN_SEQ``, a gradcheck of
``FlashAttention``, and one model-level loss and LoRA gradients at S = 4096
against the JAX model with its flash path forced.  Inputs are made with
numpy from a seed and handed to both.  The CUDA kernels run only on the
card, where ``chip_smoke.py`` holds them against these plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import lora as jax_lora
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu.ops import attention as jax_attention
from ecg_byte_tpu.ops import flash_attention as jax_flash
from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import lora_from_jax, params_from_jax
from ecg_byte_tpu_torch.ops import attention, attention_resident, flash_attention

CPU = torch.device("cpu")


def _inputs(b, s, kh, g, d, left_pad, dtype, seed):
    """q (B, S, KH, G, D), k, v, the output gradient (random on every row,
    pad rows included) as numpy values exact in ``dtype``, and the mask."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        x = jnp.asarray(rng.normal(size=shape), dtype)
        return np.asarray(x.astype(jnp.float32))

    mask = np.ones((b, s), np.int32)
    mask[:, :left_pad] = 0
    return (draw(b, s, kh, g, d), draw(b, s, kh, d), draw(b, s, kh, d),
            draw(b, s, kh, g, d), mask)


def _jax_flash(q, k, v, mask, dtype, block, gout):
    """JAX's out, lse (B, KH, G, S) and (dq, dk, dv), interpret mode."""
    b, s, kh, g, d = q.shape
    jq = jnp.asarray(q.reshape(b, s, kh * g, d), dtype)
    jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
    jm = jnp.asarray(mask)
    bq = min(block, int(np.ceil(s / 8) * 8))
    assert bq == block, "the JAX wrapper would pick another block here"
    _, res = jax_flash._flash_fwd(jq, jk, jv, jm, block, block, interpret=True)
    lse = np.asarray(res[5])[:, 0, :s].reshape(b, kh, g, s)
    fn = functools.partial(jax_flash.flash_attention, block_q=block, block_k=block,
                           interpret=True)
    out, vjp = jax.vjp(lambda q_, k_, v_: fn(q_, k_, v_, jm), jq, jk, jv)
    grads = vjp(jnp.asarray(gout.reshape(b, s, kh * g, d), dtype))
    f32 = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return (f32(out).reshape(q.shape), lse, f32(grads[0]).reshape(q.shape), f32(grads[1]),
            f32(grads[2]))


_F32, _BF16 = jnp.float32, jnp.bfloat16

# (b, s, kh, g, d, left_pad, block, dtype): GQA 4/2 (G 2), G = 1, KH = 1;
# left pads of 0, 1, several blocks and all but one; S a multiple of the
# block and ragged; blocks of 32 and 128; f32 and bf16
CASES = [
    (2, 128, 2, 2, 16, 0, 32, _F32),
    (1, 128, 2, 2, 16, 1, 32, _F32),
    (1, 160, 2, 2, 16, 70, 32, _F32),
    (1, 100, 2, 2, 16, 99, 32, _F32),
    (1, 300, 2, 1, 16, 130, 128, _F32),
    (1, 256, 1, 4, 16, 0, 128, _F32),
    (1, 300, 2, 2, 16, 299, 128, _F32),
    (1, 256, 2, 2, 32, 37, 128, _BF16),
    (1, 75, 2, 1, 16, 33, 32, _BF16),
    (1, 300, 1, 4, 16, 128, 128, _BF16),
    (1, 96, 2, 2, 16, 95, 32, _BF16),
]


def _ids(case):
    b, s, kh, g, d, pad, block, dtype = case
    return f"{jnp.dtype(dtype).name}-S{s}-kh{kh}g{g}-pad{pad}-blk{block}"


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plain_matches_jax_flash(case):
    """Forward (out, lse) and backward (dq, dk, dv) of the plain versions
    against the Pallas kernels in interpret mode.  Valid query rows (dq,
    out, lse) and valid keys (dk, dv) are compared: f32 within 2e-5 (out,
    lse) and 5e-5 (gradients) absolute; bf16 out within 1e-2 and each
    gradient within 1e-2 of its norm (bf16 roundings of p and dS may flip
    where the sums run in another order).  Every row is finite."""
    b, s, kh, g, d, pad, block, dtype = case
    q, k, v, gout, mask = _inputs(b, s, kh, g, d, pad, dtype, seed=s + pad)
    want = _jax_flash(q, k, v, mask, dtype, block, gout)
    tdt = torch.float32 if dtype is _F32 else torch.bfloat16
    tq, tk, tv, tg = (torch.tensor(x).to(tdt) for x in (q, k, v, gout))
    tm = torch.from_numpy(mask)
    out, lse = flash_attention.flash_attention_fwd_plain(tq, tk, tv, tm, block_k=block)
    grads = flash_attention.flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, tg,
                                                      block_k=block)
    got = [out, lse, *grads]
    assert all(torch.isfinite(x.float()).all() for x in got)
    valid = mask.astype(bool)
    lse_valid = np.moveaxis(lse.numpy(), 3, 1)[valid], np.moveaxis(want[1], 3, 1)[valid]
    np.testing.assert_allclose(*lse_valid, atol=2e-5, rtol=0, err_msg="lse")
    atol = 2e-5 if dtype is _F32 else 1e-2
    np.testing.assert_allclose(out.float().numpy()[valid], want[0][valid], atol=atol, rtol=0,
                               err_msg="out")
    for name, a, w in zip(("dq", "dk", "dv"), grads, want[2:]):
        a, w = a.float().numpy()[valid], w[valid]
        if dtype is _F32:
            np.testing.assert_allclose(a, w, atol=5e-5, rtol=0, err_msg=name)
        else:
            rel = np.linalg.norm(a - w) / max(np.linalg.norm(w), 1e-6)
            assert rel <= 1e-2, f"{name}: |d|/|ref| {rel:.3e}"
    assert flash_attention.flash_attention_fwd.launches == 0
    assert flash_attention.flash_attention_bwd.launches == 0


def test_left_pad_rows_are_the_mean_of_v():
    """A left-pad row meets no valid key: every key of its blocks has p = 1,
    so its output is the mean of V over those blocks (zeros past S), and
    its lse is the -1e30 fill.  Pads of 0 to S - 1 keys stay finite."""
    q, k, v, _, mask = _inputs(1, 200, 1, 2, 8, 150, _F32, seed=1)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out, lse = flash_attention.flash_attention_fwd_plain(tq, tk, tv, torch.from_numpy(mask), 64)
    # rows 128..149 are pads of query block 2: keys 0..191 of S = 200
    for g in range(2):
        np.testing.assert_allclose(out[0, 140, 0, g].numpy(), v[0, :192, 0].mean(0), atol=1e-6)
    assert (lse[0, 0, :, :150] == attention.NEG_INF).all()
    assert torch.isfinite(lse).all() and torch.isfinite(out).all()


def _spies(monkeypatch):
    calls = []
    for mod, name in ((flash_attention, "flash_attention_fwd"),
                      (attention_resident, "resident_attention")):
        real = getattr(mod, name)

        def spy(*args, real=real, name=name):
            calls.append(name)
            return real(*args)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("s,want", [(4096, "flash_attention_fwd"),
                                    (4095, "resident_attention")])
def test_dispatch_at_flash_min_seq(monkeypatch, s, want):
    """``causal_attention`` takes ``FlashAttention`` from S = 4096 on (the
    JAX package's threshold) and ``ResidentAttention`` below it."""
    calls = _spies(monkeypatch)
    q, k, v, _, mask = _inputs(1, s, 1, 1, 8, 3, _F32, seed=2)
    out = attention.causal_attention(torch.from_numpy(q.reshape(1, s, 1, 8)),
                                     torch.from_numpy(k), torch.from_numpy(v),
                                     torch.from_numpy(mask))
    assert attention.FLASH_MIN_SEQ == 4096
    assert calls == [want]
    assert out.shape == (1, s, 1, 8) and torch.isfinite(out).all()


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
def test_flash_attention_gradcheck():
    """``FlashAttention`` passes gradcheck in f64 (no pad: a fully masked
    row's logits lose q to the -1e30 fill, so its numeric derivative is zero
    while the analytic one is not)."""
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)

    q, k, v = t(1, 24, 2, 2, 4), t(1, 24, 2, 4), t(1, 24, 2, 4)
    mask = torch.ones(1, 24, dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: flash_attention.FlashAttention.apply(q_, k_, v_, mask), (q, k, v))
    assert flash_attention.flash_attention_fwd.launches == 0
    assert flash_attention.flash_attention_bwd.launches == 0


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_model_loss_and_lora_grads_at_4096_match_jax_flash(monkeypatch):
    """Tiny llama (one layer), f32, S = 4096 with 300 left pads: the port's
    loss and LoRA gradients against JAX ``forward`` + ``causal_lm_loss``
    with the JAX flash path forced (interpret mode).  Loss within 1e-5
    relative, gradients within 1e-5 of their largest magnitude (f32 sums
    over 4096 positions in other orders; measured 7.1e-7)."""
    monkeypatch.setattr(jax_attention, "_flash_available", lambda: True)
    jax_calls = []

    def interpreted(*args, real=jax_flash.flash_attention, **kw):
        jax_calls.append(args[0].shape)
        return real(*args, interpret=True, **kw)

    monkeypatch.setattr(jax_flash, "flash_attention", interpreted)
    jc = jax_config.tiny_test_config("llama", num_layers=1, lora_dropout=0.0)
    pc = tiny_test_config("llama", num_layers=1, lora_dropout=0.0)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    jl = _np_tree(jax_lora.init_lora(jc, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    for ab in jl["layers"].values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    s = 4096
    ids = rng.integers(0, pc.vocab_size, (1, s)).astype(np.int32)
    mask = np.ones((1, s), np.int32)
    mask[:, :300] = 0
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, : s - 64] = -100

    def jloss(lora):
        logits = JT.forward(jparams, jc, jnp.asarray(ids), jnp.asarray(mask), lora=lora,
                            remat=False)
        return JT.causal_lm_loss(logits, jnp.asarray(labels))

    want_loss, want_grads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jl))
    assert jax_calls == [(1, s, jc.num_heads, jc.head_dim)]  # the JAX flash path ran

    calls = _spies(monkeypatch)
    params = params_from_jax(_np_tree(jparams), pc, CPU)
    lora = lora_from_jax(jl, pc, CPU)
    for t in lora_lib.leaves(lora):
        t.requires_grad_(True)
    logits = T.forward(params, pc, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       lora=lora)
    loss = T.causal_lm_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    assert calls == ["flash_attention_fwd"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = lora_from_jax(_np_tree(want_grads), pc, CPU)
    for got_t, want_t in zip(lora_lib.leaves(lora), lora_lib.leaves(want)):
        w = want_t.numpy()
        np.testing.assert_allclose(got_t.grad.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


def test_wrappers_reject_non_cuda_tensors():
    """Only a CPU tensor takes the plain version; anything else goes to the
    kernel's checks, which raise before any launch."""
    qg = torch.empty(1, 64, 2, 4, 64, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, 64, 2, 64, device="meta", dtype=torch.bfloat16)
    mask = torch.ones(1, 64, dtype=torch.int32, device="meta")
    lse = torch.empty(1, 2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_fwd(qg, kv, kv, mask)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bwd(qg, kv, kv, mask, qg, lse, qg)
