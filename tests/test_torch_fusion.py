"""Parity of the port's two-stage fusion with the JAX package's, on the CPU.

Every tree is the JAX package's init carried across by ``models/convert``:
tiny llama (norms perturbed), ResNet18, the fusion projections and LoRA
adapters with B != 0, so their gradients and outputs are not trivial.

Tolerances: ``adapt_sequence`` exactly, in both modes, on left-padded rows
with ``<signal>`` at different slots; the stage-2 loss within 1e-5
relative and the gradients of every LoRA and fusion tensor within 1e-4
relative to their max (f32 sums in another order), with the dense and
the vocabulary-tiled cross entropy; ``fusion_generate``'s
token streams identical, with the model-dtype KV cache (f32 here) and with
the int8 model and cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import fusion as JF
from ecg_byte_tpu.models import lora as jax_lora
from ecg_byte_tpu.models import quantized as jax_quantized
from ecg_byte_tpu.models import resnet1d as JR
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu_torch.models import fusion as F
from ecg_byte_tpu_torch.models import resnet1d as R
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models.convert import (
    fusion_from_jax,
    lora_from_jax,
    params_from_jax,
    resnet_from_jax,
)

CPU = torch.device("cpu")
VOCAB, SIG_ID = 128, 120


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def models():
    jc = jax_config.tiny_test_config("llama", vocab_size=VOCAB)
    rng = np.random.default_rng(0)
    llm = jax.tree_util.tree_map_with_path(
        lambda path, x: (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if "norm" in jax.tree_util.keystr(path) else x,
        _np(JT.init_params(jc, jax.random.PRNGKey(7))))
    rp, rs, meta = (_np(t) if i < 2 else t
                    for i, t in enumerate(JR.init_resnet(jax.random.PRNGKey(8), "resnet18")))
    fusion = _np(JF.init_fusion(jax.random.PRNGKey(9), "resnet_model", jc.hidden_size,
                                resnet_channels=512))
    lora = _np(jax_lora.init_lora(jc, jax.random.PRNGKey(10)))
    lora = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.05 * rng.standard_normal(x.shape)).astype(x.dtype)
        if jax.tree_util.keystr(path).endswith("['b']") else x, lora)
    pc = tiny_test_config("llama", vocab_size=VOCAB)
    jax_side = dict(llm=jax.tree.map(jnp.asarray, llm), config=jc,
                    fusion=jax.tree.map(jnp.asarray, fusion),
                    lora=jax.tree.map(jnp.asarray, lora),
                    encoders={"resnet": (jax.tree.map(jnp.asarray, rp),
                                         jax.tree.map(jnp.asarray, rs), meta)})
    p, s = resnet_from_jax(rp, rs, CPU)
    port = dict(llm=params_from_jax(llm, pc, CPU), config=pc, fusion=fusion_from_jax(fusion, CPU),
                lora=lora_from_jax(lora, pc, CPU), encoders={"resnet": (p, s, meta)})
    return jax_side, port


def _rows(b=3, s=14, seed=1):
    """Left-padded rows with <signal> at a different slot in each."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 100, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    for i, (pad, slot) in enumerate([(0, 2), (3, 5), (5, 9)][:b]):
        mask[i, :pad] = 0
        ids[i, :pad] = 0
        ids[i, slot] = SIG_ID
    pos = np.where(mask == 1, np.cumsum(mask, 1) - 1, 0)
    labels = np.where((mask == 1) & (rng.random((b, s)) < 0.6), ids, -100)
    return ids, mask, pos, labels, rng.normal(size=(b, 12, 128)).astype(np.float32)


@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
def test_adapt_sequence_matches_jax(train):
    ids, mask, pos, labels, _ = _rows()
    rng = np.random.default_rng(2)
    text = rng.normal(size=ids.shape + (8,)).astype(np.float32)
    sig = rng.normal(size=(ids.shape[0], 1, 8)).astype(np.float32)
    extra = (labels, pos) if train else (None, None)
    want = JF.adapt_sequence(jnp.asarray(sig), jnp.asarray(text), jnp.asarray(ids),
                             jnp.asarray(mask), *(None if x is None else jnp.asarray(x)
                                                  for x in extra), sig_id=SIG_ID)
    got = F.adapt_sequence(_t(sig), _t(text), _t(ids), _t(mask),
                           *(None if x is None else _t(x) for x in extra), sig_id=SIG_ID)
    assert set(got) == set(want)
    assert got["combined_embeds"].shape[1] == ids.shape[1] + (0 if train else 1)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_fusion_lm_loss_and_gradients_match_jax(models, chunked):
    jx, pt = models
    ids, mask, pos, labels, sig = _rows(seed=3)
    jbatch = {"tokenized_signal": jnp.asarray(ids, jnp.int32),
              "attn_mask": jnp.asarray(mask, jnp.float32),
              "quantized_signal_ids_input": jnp.asarray(labels, jnp.int32),
              "position_ids": jnp.asarray(pos, jnp.int32), "norm_signal": jnp.asarray(sig)}

    def jloss(trainable):
        return JF.fusion_lm_loss(jx["llm"], jx["config"], trainable["fusion"], "resnet_model",
                                 jbatch, SIG_ID, lora=trainable["lora"],
                                 encoders=jx["encoders"], chunked_loss=chunked)

    want, grads = jax.value_and_grad(jloss)({"fusion": jx["fusion"], "lora": jx["lora"]})
    fusion = jax.tree.map(lambda t: t.clone().requires_grad_(True), pt["fusion"])
    lora = jax.tree.map(lambda t: t.clone().requires_grad_(True), pt["lora"])
    batch = {"tokenized_signal": _t(ids), "attn_mask": _t(mask).float(),
             "quantized_signal_ids_input": _t(labels), "position_ids": _t(pos),
             "norm_signal": _t(sig)}
    got = F.fusion_lm_loss(pt["llm"], pt["config"], fusion, "resnet_model", batch, SIG_ID,
                           lora=lora, encoders=pt["encoders"], chunked_loss=chunked)
    got.backward()
    assert _rel(got.item(), want) < 1e-5
    for name, port_tree, want_tree in (
            ("fusion", fusion, fusion_from_jax(_np(grads["fusion"]), CPU)),
            ("lora", lora, lora_from_jax(_np(grads["lora"]), pt["config"], CPU))):
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(port_tree),
                                jax.tree_util.tree_leaves(want_tree)):
            assert _rel(g.grad.numpy(), w.numpy()) < 1e-4, name + jax.tree_util.keystr(path)


@pytest.mark.parametrize("int8", [False, True], ids=["model-dtype-cache", "int8"])
def test_fusion_generate_streams_identical(models, int8):
    jx, pt = models
    ids, mask, _, _, sig = _rows(seed=4)
    jllm, llm, lora, jlora = jx["llm"], pt["llm"], pt["lora"], jx["lora"]
    if int8:  # the CLI's --int8_decode: the adapters merged, then quantized
        jllm = jax_quantized.quantize_lm_int8(
            jax_lora.merge_lora(jllm, jlora, jx["config"]), jx["config"])
        llm = params_from_jax(_np(jllm), pt["config"], CPU)
        lora = jlora = None
    pad_id, n_new = 3, 10
    kw = dict(max_new_tokens=n_new, pad_token_id=pad_id, int8_kv=int8)
    jbatch = {"tokenized_signal2": jnp.asarray(ids, jnp.int32),
              "attn_mask2": jnp.asarray(mask, jnp.float32), "norm_signal": jnp.asarray(sig)}

    def jgen(eos):
        return np.asarray(JF.fusion_generate(jllm, jx["config"], jx["fusion"], "resnet_model",
                                             jbatch, SIG_ID, lora=jlora, encoders=jx["encoders"],
                                             eos_token_id=eos, **kw))

    eos_id = int(jgen(-1)[0, 4])  # row 0 emits it mid-stream
    want = jgen(eos_id)
    batch = {"tokenized_signal2": _t(ids), "attn_mask2": _t(mask).float(), "norm_signal": _t(sig)}
    got = F.fusion_generate(llm, pt["config"], pt["fusion"], "resnet_model", batch, SIG_ID,
                            lora=lora, encoders=pt["encoders"], eos_token_id=eos_id, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == pad_id).any()  # the eos and pad rules were exercised


def test_encoder_embedding_is_frozen(models):
    """The backbone runs without gradients; only the projection trains."""
    _, pt = models
    p, s, meta = pt["encoders"]["resnet"]
    p = jax.tree.map(lambda t: t.clone().requires_grad_(True), p)
    fusion = jax.tree.map(lambda t: t.clone().requires_grad_(True), pt["fusion"])
    sig = torch.randn(2, 12, 128, generator=torch.Generator().manual_seed(0))
    out = F.encoder_embedding("resnet_model", fusion, {"norm_signal": sig},
                              resnet=(p, s, meta))
    out.sum().backward()
    assert out.shape == (2, 1, pt["config"].hidden_size)
    assert fusion["image_projection"]["weight"].grad.abs().sum() > 0
    assert all(t.grad is None for t in jax.tree.leaves(p))
    feats, _ = R.resnet_forward(p, s, meta, sig)
    assert torch.allclose(out[:, 0].detach(), torch.nn.functional.linear(
        feats.mean(-1), fusion["image_projection"]["weight"], fusion["image_projection"]["bias"]))
