"""The port's LoRA overlay against the JAX package on the CPU.

Both packages run one JAX initialisation of the base and of the adapters,
carried across with ``params_from_jax`` / ``lora_from_jax``, in f32.  B is
set to small random values wherever a zero B would hide the adapter path.
Dropout's random bits differ between the packages by design, so parity
runs with dropout off and a separate test checks the masks' statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import lora as jax_lora
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import lora_from_jax, params_from_jax

ARCHS = ["llama", "gpt2", "gemma"]
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch, seed=0, random_b=True):
    jc = jax_config.tiny_test_config(arch, lora_dropout=0.0)
    pc = tiny_test_config(arch, lora_dropout=0.0)
    jparams = JT.init_params(jc, jax.random.PRNGKey(seed))
    jl = _np_tree(jax_lora.init_lora(jc, jax.random.PRNGKey(seed + 1)))
    if random_b:
        rng = np.random.default_rng(seed)
        for ab in jl["layers"].values():
            ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    jlora = jax.tree.map(jnp.asarray, jl)
    return (jc, jparams, jlora), (pc, params_from_jax(_np_tree(jparams), pc, CPU),
                                  lora_from_jax(jl, pc, CPU))


def _batch(vocab, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :4] = 0
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    return ids, mask, labels


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_b_is_identity(arch):
    """With B = 0 the adapted model is the base model, exactly."""
    _, (pc, params, lora) = _models(arch, random_b=False)
    ids, mask, _ = _batch(pc.vocab_size)
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    base = T.forward(params, pc, ids, mask)
    adapted = T.forward(params, pc, ids, mask, lora=lora)
    torch.testing.assert_close(adapted, base, atol=0, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_merge_equals_overlay_and_jax(arch):
    """Merged weights give the overlay's logits (1e-5, f32: the product
    A B is summed in another order), and the overlay gives JAX's (1e-4, as
    tests/test_torch_transformer.py)."""
    (jc, jparams, jlora), (pc, params, lora) = _models(arch, seed=2)
    ids, mask, _ = _batch(pc.vocab_size, seed=3)
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    overlay = T.forward(params, pc, tids, tmask, lora=lora)
    merged = T.forward(lora_lib.merge_lora(params, lora, pc), pc, tids, tmask)
    np.testing.assert_allclose(merged.numpy(), overlay.numpy(), atol=1e-5, rtol=0)
    want = np.asarray(JT.forward(jparams, jc, jnp.asarray(ids), jnp.asarray(mask), lora=jlora))
    np.testing.assert_allclose(overlay.numpy(), want, atol=1e-4, rtol=0)
    # the JAX merge gives the same weights
    jmerged = params_from_jax(_np_tree(jax_lora.merge_lora(jparams, jlora, jc)), pc, CPU)
    for a, b in zip(lora_lib.leaves(lora_lib.merge_lora(params, lora, pc)),
                    lora_lib.leaves(jmerged)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_lora_from_jax_round_trips(arch):
    """lora_from_jax unstacks the layer axis and keeps every value; the
    port's own init has the JAX tree's names, shapes and bounds."""
    (jc, _, jlora), (pc, _, lora) = _models(arch)
    back = {name: {k: np.stack([layer[name][k].numpy() for layer in lora["layers"]])
                   for k in ("a", "b")} for name in lora["layers"][0]}
    ref = _np_tree(jlora)["layers"]
    assert back.keys() == ref.keys() == set(lora_lib.targets(pc))
    for name in ref:
        for k in ("a", "b"):
            np.testing.assert_array_equal(back[name][k], ref[name][k])
    own = lora_lib.init_lora(pc, torch.Generator().manual_seed(0), CPU)
    for name, ab in own["layers"][0].items():
        assert ab["a"].shape == lora["layers"][0][name]["a"].shape
        assert ab["b"].shape == lora["layers"][0][name]["b"].shape
        assert not ab["b"].any() and ab["a"].abs().max() <= ab["a"].shape[0] ** -0.5
    assert lora_lib.count_params(own) == sum(x.size for x in jax.tree.leaves(jlora))


@pytest.mark.parametrize("arch", ARCHS)
def test_lora_grads_match_jax(arch):
    """Dropout off: the loss and every LoRA gradient equal JAX's (f32,
    1e-5 absolute; the gradients are O(0.1))."""
    (jc, jparams, jlora), (pc, params, lora) = _models(arch, seed=4)
    ids, mask, labels = _batch(pc.vocab_size, seed=5)

    def jloss(l):
        h = JT.forward(jparams, jc, jnp.asarray(ids), jnp.asarray(mask), lora=l,
                       return_hidden=True, remat=False)
        return JT.lm_loss_from_hidden(jparams, jc, h, jnp.asarray(labels))

    want_loss, want_grads = jax.value_and_grad(jloss)(jlora)
    for t in lora_lib.leaves(lora):
        t.requires_grad_(True)
    h = T.forward(params, pc, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                  lora=lora, return_hidden=True)
    loss = T.lm_loss_from_hidden(params, pc, h, torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    want = lora_from_jax(_np_tree(want_grads), pc, CPU)
    for got_t, want_t in zip(lora_lib.leaves(lora), lora_lib.leaves(want)):
        np.testing.assert_allclose(got_t.grad.numpy(), want_t.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("style", ["rank", "input"])
def test_dropout_masks(style):
    """Each style's mask keeps 0.95 of its entries (within 1%) and scales
    the kept ones by 1/0.95; the group's mask lands where the style says:
    on the (B, S, 3r) adapter activations (rank) or the (B, S, D) input
    (input).  Rate 0 is exactly no dropout."""
    pc = tiny_test_config("llama", lora_dropout=0.05, lora_dropout_style=style)
    drop = T._Dropout(pc, 1234, CPU)
    y = drop(torch.ones(400, 2500))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.95) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.95))

    shapes = []
    real_call = T._Dropout.__call__

    def spy(self, x):
        shapes.append(tuple(x.shape))
        return real_call(self, x)

    _, (_, params, lora) = _models("llama")
    layer_p, lora_p = params["layers"][0], lora["layers"][0]
    x = torch.randn(2, 5, pc.hidden_size)
    T._Dropout.__call__ = spy
    try:
        q, k, v = T._proj_group(x, layer_p, ("q_proj", "k_proj", "v_proj"), lora_p, pc,
                                T._Dropout(pc, 7, CPU))
    finally:
        T._Dropout.__call__ = real_call
    want_shape = (2, 5, 3 * pc.lora_rank) if style == "rank" else (2, 5, pc.hidden_size)
    assert shapes == [want_shape]
    off = T._proj_group(x, layer_p, ("q_proj", "k_proj", "v_proj"), lora_p, pc,
                        T._Dropout(pc.replace(lora_dropout=0.0), 7, CPU))
    none = T._proj_group(x, layer_p, ("q_proj", "k_proj", "v_proj"), lora_p, pc,
                         T._Dropout(pc, None, CPU))
    for a, b, c in zip(off, none, (q, k, v)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
        assert not torch.equal(a, c)


def test_forward_dropout_replays_under_remat():
    """With dropout on, remat='full' gives the same loss and LoRA gradients
    as remat='none' from the same generator seed (each layer re-seeds its
    masks when it is replayed)."""
    _, (pc, params, lora) = _models("llama", seed=6)
    pc = pc.replace(lora_dropout=0.3)
    ids, mask, labels = _batch(pc.vocab_size, seed=7)
    results = []
    for remat in ("none", "full"):
        for t in lora_lib.leaves(lora):
            t.grad = None
            t.requires_grad_(True)
        h = T.forward(params, pc, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                      lora=lora, dropout_generator=torch.Generator().manual_seed(3),
                      return_hidden=True, remat=remat)
        loss = T.lm_loss_from_hidden(params, pc, h, torch.from_numpy(labels).long())
        loss.backward()
        results.append((loss.item(), [t.grad.clone() for t in lora_lib.leaves(lora)]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
