"""Parity of the port's ViT and CLIP with the JAX package's, on the tiny
configs, in f32 on the CPU.

Weights are the JAX init (LayerNorm scales and biases perturbed, so layout
faults show), carried across by ``vit_from_jax`` / ``clip_from_jax``;
pixels, masks and token ids are numpy draws from a seed.

Tolerances: encoder outputs, every hidden state, the MIM loss, CLIP's
embeddings and loss within 1e-5 relative to their max (f32 sums in
another order); the gradients of every parameter within 1e-4 relative to
their max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ecg_byte_tpu.models import vision as JV
from ecg_byte_tpu_torch.models import vision as V
from ecg_byte_tpu_torch.models.convert import clip_from_jax, vit_from_jax

CPU = torch.device("cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if "ln" in name or name.endswith("_b']") or "bias" in name:
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jax.tree.map(np.asarray, tree))


def _pixels(b, c, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, c.channels, c.image_size, c.image_size)).astype(np.float32)


def _check_grads(port_tree, jax_grads, convert):
    want = convert(jax.tree.map(np.asarray, jax_grads), CPU)
    got_leaves = jax.tree_util.tree_leaves_with_path(port_tree)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for (path, g), w in zip(got_leaves, want_leaves):
        if g.grad is None:  # unused (CLIP's ViT decoder): JAX's gradient is zero
            assert not w.any(), jax.tree_util.keystr(path)
            continue
        assert _rel(g.grad.numpy(), w.numpy()) < 1e-4, jax.tree_util.keystr(path)


def test_vit_encode_and_hidden_states_match_jax():
    cfg = JV.tiny_vision_config()
    tree = _perturbed(JV.init_vit(jax.random.PRNGKey(0), cfg), 0)
    p = vit_from_jax(tree, CPU)
    x = _pixels(3, cfg, 1)
    mask = np.random.default_rng(2).random((3, cfg.num_patches)) < 0.75
    want, want_h = JV.vit_encode(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(x),
                                 jnp.asarray(mask), collect_hidden=True)
    got, got_h = V.vit_encode(p, V.tiny_vision_config(), torch.from_numpy(x),
                              torch.from_numpy(mask), collect_hidden=True)
    assert got.shape == (3, cfg.num_patches + 1, cfg.hidden_size)
    assert _rel(got.numpy(), want) < 1e-5
    assert len(got_h) == len(want_h) == cfg.num_layers + 1
    for g, w in zip(got_h, want_h):
        assert _rel(g.numpy(), w) < 1e-5


def test_vit_mim_loss_and_gradients_match_jax():
    cfg = JV.tiny_vision_config()
    tree = _perturbed(JV.init_vit(jax.random.PRNGKey(3), cfg), 3)
    x = _pixels(2, cfg, 4)
    mask = np.random.default_rng(5).random((2, cfg.num_patches)) < 0.75
    want, grads = jax.value_and_grad(JV.vit_mim_loss)(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(x), jnp.asarray(mask))
    p = jax.tree.map(lambda t: t.requires_grad_(True), vit_from_jax(tree, CPU))
    got = V.vit_mim_loss(p, V.tiny_vision_config(), torch.from_numpy(x), torch.from_numpy(mask))
    got.backward()
    assert _rel(got.item(), want) < 1e-5
    _check_grads(p, grads, vit_from_jax)


def test_clip_forward_and_gradients_match_jax():
    cfg = JV.tiny_clip_config()
    tree = _perturbed(JV.init_clip(jax.random.PRNGKey(6), cfg), 6)
    rng = np.random.default_rng(7)
    b, s = 4, cfg.text.max_length
    ids = rng.integers(1, cfg.text.vocab_size - 1, (b, s)).astype(np.int32)
    lens = np.array([16, 9, 3, 12])
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    ids[np.arange(b), lens - 1] = cfg.text.vocab_size - 1  # the eot token: the highest id
    ids[mask == 0] = 0
    x = _pixels(b, cfg.vision, 8)

    def jloss(jp):
        out = JV.clip_forward(jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(x),
                              return_loss=True)
        return out["loss"], out

    (want, jout), grads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, tree))
    p = jax.tree.map(lambda t: t.requires_grad_(True), clip_from_jax(tree, CPU))
    out = V.clip_forward(p, V.tiny_clip_config(), torch.from_numpy(ids).long(),
                         torch.from_numpy(mask), torch.from_numpy(x), return_loss=True)
    out["loss"].backward()
    assert _rel(out["loss"].item(), want) < 1e-5
    for key in ("image_embeds", "text_embeds"):
        assert _rel(out[key].detach().numpy(), jout[key]) < 1e-5, key
    _check_grads(p, grads, clip_from_jax)
