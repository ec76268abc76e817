"""``fold_norm_scales`` and the norm-folded block path of the port, on the
CPU.

The port's twins of ``tests/test_norm_fold.py`` (the folded tree against
the classic one inside the port, at that file's tolerances: forward rtol
2e-5 / atol 2e-4, LoRA gradients with dropout rtol 5e-4 / atol 5e-5), and
the folded path against the JAX package's: the folded tree itself (exact),
forward, loss and LoRA gradients with dropout off (f32: logits 1e-4
absolute, the loss 1e-6 relative, gradients 1e-5 absolute, the tolerances
of ``tests/test_torch_transformer.py`` and ``tests/test_torch_lora.py``),
a group where only some projections carry adapters, the streamed
attention mean (1e-6), greedy streams with the bf16 and the int8 serving
copies (identical), and the refusal of a folded tree on a grid.

Weights are the JAX package's init with the norm weights moved off 1 by
numpy draws from a seed (as ``tests/test_norm_fold.py:_setup`` moves them),
carried across by ``params_from_jax``; every input is made by numpy from a
seed.  The port's wrappers take their plain versions on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.infer import greedy_generate as jax_greedy_generate
from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import lora as jax_lora
from ecg_byte_tpu.models import quantized as jax_quantized
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import config_from_jax, lora_from_jax, params_from_jax
from ecg_byte_tpu_torch.models.quantized import quantize_lm_int8
from ecg_byte_tpu_torch.parallel import mesh
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import create_train_state, shard_train_state

CPU = torch.device("cpu")
FOLDS = [(arch, tie) for arch in ("llama", "gemma") for tie in (True, False)]
FOLD_IDS = [f"{arch}-{'tied' if tie else 'untied'}" for arch, tie in FOLDS]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch="llama", tie=True, seed=0, **kw):
    """(JAX params, JAX config, port params, port config): the JAX init with
    its norm weights moved off 1 by 0.3 N(0, 1) draws of numpy."""
    jc = jax_config.tiny_test_config(arch, tie_word_embeddings=tie, **kw)
    tree = _np_tree(JT.init_params(jc, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    layers = dict(tree["layers"])
    for name in ("attn_norm", "mlp_norm"):
        layers[name] = (layers[name] + 0.3 * rng.standard_normal(layers[name].shape)).astype(
            layers[name].dtype)
    tree = dict(tree, layers=layers)
    tree["final_norm"] = (tree["final_norm"]
                          + 0.3 * rng.standard_normal(tree["final_norm"].shape)).astype(
        tree["final_norm"].dtype)
    pc = tiny_test_config(arch, tie_word_embeddings=tie, **kw)
    return jax.tree.map(jnp.asarray, tree), jc, params_from_jax(tree, pc, CPU), pc


def _lora(jc, pc, seed=7):
    """JAX's init of the adapters with B drawn by numpy (B = 0 would hide
    the adapter path), and the same in the port's layout."""
    jl = _np_tree(jax_lora.init_lora(jc, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for ab in jl["layers"].values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(ab["b"].dtype)
    return jax.tree.map(jnp.asarray, jl), lora_from_jax(jl, pc, CPU)


def _batch(vocab, b=2, s=16, seed=3, left_pad=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[-1, :left_pad] = 0
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return ids, mask, labels


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _loss_and_grads(params, config, lora, ids, mask, labels, gen_seed=None, remat="none"):
    lora = {"layers": [{n: {k: v.detach().clone().requires_grad_(True) for k, v in ab.items()}
                        for n, ab in layer.items()} for layer in lora["layers"]]}
    gen = None if gen_seed is None else torch.Generator().manual_seed(gen_seed)
    hidden = T.forward(params, config, _t(ids).long(), _t(mask), lora=lora, return_hidden=True,
                       dropout_generator=gen, remat=remat)
    loss = T.lm_loss_from_hidden(params, config, hidden, _t(labels).long())
    loss.backward()
    return loss.item(), [t.grad for t in lora_lib.leaves(lora)]


# ------------------------------------------- the twins of tests/test_norm_fold.py


@pytest.mark.parametrize("arch,tie", FOLDS, ids=FOLD_IDS)
def test_forward_parity(arch, tie):
    _, _, params, config = _models(arch, tie)
    ids, mask, _ = _batch(config.vocab_size)
    ref = T.forward(params, config, _t(ids).long(), _t(mask))
    fp, fc = T.fold_norm_scales(params, config)
    assert fc.norm_folded and not config.norm_folded
    got = T.forward(fp, fc, _t(ids).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-4)


def test_folded_tree_is_classic_path_compatible():
    """The folded tree on classic blocks (norm_folded off) computes the
    same function: its norm entries are the identity."""
    _, _, params, config = _models("llama", seed=1)
    ids, mask, _ = _batch(config.vocab_size, s=12, seed=4)
    fp, fc = T.fold_norm_scales(params, config)
    assert all((layer["attn_norm"] == 1).all() for layer in fp["layers"])
    got = T.forward(fp, fc.replace(norm_folded=False), _t(ids).long(), _t(mask))
    ref = T.forward(params, config, _t(ids).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("style", ["rank", "input"])
def test_lora_grad_parity_with_dropout(style, remat):
    """Dropout 0.3: one generator draws the same masks on both paths (same
    order, same shapes), and the adapters fold the norm weight, so the loss
    and every LoRA gradient match the classic path's; also when each layer
    is replayed in the backward (``remat="full"``)."""
    _, jc, params, config = _models("llama", lora_dropout=0.3, lora_dropout_style=style)
    _, lora = _lora(jc, config)
    ids, mask, labels = _batch(config.vocab_size, seed=5)
    fp, fc = T.fold_norm_scales(params, config)
    l_ref, g_ref = _loss_and_grads(params, config, lora, ids, mask, labels, 11, remat)
    l_new, g_new = _loss_and_grads(fp, fc, lora, ids, mask, labels, 11, remat)
    assert l_ref != _loss_and_grads(params, config, lora, ids, mask, labels, None)[0]
    np.testing.assert_allclose(l_new, l_ref, rtol=2e-5)
    for a, b in zip(g_ref, g_new):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-4, atol=5e-5)


def test_gpt2_fold_is_identity():
    config = tiny_test_config("gpt2")
    params = T.init_params(config, torch.Generator().manual_seed(0), CPU)
    fp, fc = T.fold_norm_scales(params, config)
    assert fp is params and fc is config and not fc.norm_folded
    fp, fc = T.fold_norm_scales(*_models("llama")[2:])  # a folded tree: the same objects
    again = T.fold_norm_scales(fp, fc)
    assert again[0] is fp and again[1] is fc


def test_decode_consistent_with_folded_train():
    """Greedy decode on the folded tree gives the original tree's tokens."""
    _, _, params, config = _models("llama", seed=2)
    ids, mask, _ = _batch(config.vocab_size, b=1, s=10, seed=8)
    want = greedy_generate(params, config, _t(ids).long(), _t(mask), max_new_tokens=8)
    fp, fc = T.fold_norm_scales(params, config)
    got = greedy_generate(fp, fc, _t(ids).long(), _t(mask), max_new_tokens=8)
    assert torch.equal(got, want)


# ------------------------------------------------------------ against JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,tie", FOLDS, ids=FOLD_IDS)
def test_folded_tree_equals_jax_fold(arch, tie, dtype):
    """JAX's folded tree carried across equals the port's fold of the
    carried unfolded tree, bit for bit (the same f32 products, rounded
    once), and the configs agree field for field."""
    jparams, jc, params, pc = _models(arch, tie, dtype=dtype)
    jfp, jfc = JT.fold_norm_scales(jparams, jc)
    fp, fc = T.fold_norm_scales(params, pc)
    assert fc == config_from_jax(jfc)
    want = params_from_jax(_np_tree(jfp), fc, CPU)
    assert sorted(fp) == sorted(want) and sorted(fp["layers"][0]) == sorted(want["layers"][0])
    assert ("lm_head" in fp) == (not tie) and "attn_norm_w" in fp["layers"][0]
    got_l, want_l = lora_lib.leaves(fp), lora_lib.leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch,tie", FOLDS, ids=FOLD_IDS)
def test_folded_forward_loss_and_grads_match_jax(arch, tie):
    """Dropout off, f32: the folded forward's logits, the loss and every
    LoRA gradient against JAX's on its own folded tree."""
    jparams, jc, params, pc = _models(arch, tie, seed=4, lora_dropout=0.0)
    jlora, lora = _lora(jc, pc, seed=9)
    jfp, jfc = JT.fold_norm_scales(jparams, jc)
    fp, fc = T.fold_norm_scales(params, pc)
    ids, mask, labels = _batch(pc.vocab_size, seed=6, left_pad=4)
    labels = np.where(mask == 1, labels, -100).astype(np.int32)
    want = np.asarray(JT.forward(jfp, jfc, jnp.asarray(ids), jnp.asarray(mask), lora=jlora,
                                 remat=False))
    got = T.forward(fp, fc, _t(ids).long(), _t(mask), lora=lora)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)

    def jloss(l):
        h = JT.forward(jfp, jfc, jnp.asarray(ids), jnp.asarray(mask), lora=l,
                       return_hidden=True, remat=False)
        return JT.lm_loss_from_hidden(jfp, jfc, h, jnp.asarray(labels))

    want_loss, want_grads = jax.value_and_grad(jloss)(jlora)
    loss, grads = _loss_and_grads(fp, fc, lora, ids, mask, labels)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)
    for g, w in zip(grads, lora_lib.leaves(lora_from_jax(_np_tree(want_grads), pc, CPU))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


def test_partial_targets_match_jax():
    """Adapters on q and v only: the q/k/v group carries adapters on some of
    its projections, where JAX's folded ``_proj_group`` gives each adapted
    one ``_proj`` of the raw residual stream, with neither scale
    (``ecg_byte_tpu/models/transformer.py:457-458``).  The port computes
    what JAX computes there; which differs from the classic path."""
    targets = ("q_proj", "v_proj")
    jparams, jc, params, pc = _models("llama", seed=5, lora_dropout=0.0, lora_targets=targets)
    jlora, lora = _lora(jc, pc, seed=10)
    assert sorted(lora["layers"][0]) == sorted(targets)
    jfp, jfc = JT.fold_norm_scales(jparams, jc)
    fp, fc = T.fold_norm_scales(params, pc)
    ids, mask, labels = _batch(pc.vocab_size, seed=7)

    def jloss(l, p, c):
        h = JT.forward(p, c, jnp.asarray(ids), jnp.asarray(mask), lora=l, return_hidden=True,
                       remat=False)
        return JT.lm_loss_from_hidden(p, c, h, jnp.asarray(labels))

    want_loss, want_grads = jax.value_and_grad(jloss)(jlora, jfp, jfc)
    classic_loss = float(jloss(jlora, jparams, jc))
    loss, grads = _loss_and_grads(fp, fc, lora, ids, mask, labels)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)
    assert abs(loss - classic_loss) > 1e-3 * abs(classic_loss)  # the limit of the reference
    for g, w in zip(grads, lora_lib.leaves(lora_from_jax(_np_tree(want_grads), pc, CPU))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


def test_folded_mean_attention_matches_jax():
    """The streamed layer and head mean of the attention probabilities on
    the folded tree (f32) against JAX's, and against the port's classic
    tree's."""
    jparams, jc, params, pc = _models("llama", seed=6)
    jfp, jfc = JT.fold_norm_scales(jparams, jc)
    fp, fc = T.fold_norm_scales(params, pc)
    ids, mask, _ = _batch(pc.vocab_size, s=20, seed=9, left_pad=5)
    want = np.asarray(JT.mean_attention(jfp, jfc, jnp.asarray(ids), jnp.asarray(mask)))
    got = T.mean_attention(fp, fc, _t(ids).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    classic = T.mean_attention(params, pc, _t(ids).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), classic.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_folded_greedy_stream_matches_jax(int8):
    """Greedy decode of the folded tree (prefill, then decode steps) gives
    JAX's folded stream; with the int8 serving copy (JAX's quantizer on its
    folded tree, carried across) and the int8 KV cache too."""
    jparams, jc, params, pc = _models("llama", seed=7)
    jfp, jfc = JT.fold_norm_scales(jparams, jc)
    fc = config_from_jax(jfc)
    if int8:
        jfp = jax_quantized.quantize_lm_int8(jfp, jfc)
    fp = params_from_jax(_np_tree(jfp), fc, CPU)
    ids, mask, _ = _batch(pc.vocab_size, s=14, seed=10, left_pad=3)
    kw = dict(max_new_tokens=10, int8_kv=int8)
    want = np.asarray(jax_greedy_generate(jfp, jfc, jnp.asarray(ids), jnp.asarray(mask), **kw))
    got = greedy_generate(fp, fc, _t(ids).long(), _t(mask), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if int8:  # the port's own int8 copy of its own fold: the same tree
        mine = quantize_lm_int8(T.fold_norm_scales(params, pc)[0], fc)
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(lora_lib.leaves(mine), lora_lib.leaves(fp)))


@pytest.mark.parametrize("tp,fsdp", [(2, 1), (1, 2)], ids=["tp2", "fsdp2"])
def test_folded_tree_is_refused_on_a_grid(tp, fsdp, monkeypatch):
    """Under --tp 2 or --fsdp 2 a folded tree is neither sharded nor run:
    the JAX specs have no entry for its norm weights."""
    _, _, params, config = _models("llama", seed=8)
    fp, fc = T.fold_norm_scales(params, config)
    monkeypatch.setattr(mesh, "_grid", mesh.Grid(dp=1, fsdp=fsdp, tp=tp, d=0, f=0, t=0))
    opt = make_optimizer(fc.hidden_size, 10)
    state = create_train_state(fc, opt, torch.Generator().manual_seed(0), peft=True, params=fp)
    with pytest.raises(ValueError, match="norm-folded tree"):
        shard_train_state(state, opt)
    ids, mask, _ = _batch(config.vocab_size)
    with pytest.raises(ValueError, match="attn_norm_w"):
        T.forward(fp, fc, _t(ids).long(), _t(mask))
