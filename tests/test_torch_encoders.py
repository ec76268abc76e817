"""Parity of the port's MERL encoder heads and frozen text encoders with the
JAX package's, on the CPU.

Weights are the JAX package's init, carried across by
``merl_head_from_jax``; inputs are numpy draws from a seed.  Dropout is off
in both (the port's masks come from a ``torch.Generator``).

Tolerances: pooled outputs, attention maps and losses within 1e-5
relative (f32 sums in another order); precision@k exactly; gradients of
every head tensor within 1e-4 relative to their max; the hash text
encoder bit for bit (the same numpy table, the tokens added in the same
order); the BERT text encoder within 1e-5 of JAX's pooled output.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.models import encoders as JE
from ecg_byte_tpu.tokenizer.wordpiece import WordPieceTokenizer as JaxWordPiece
from ecg_byte_tpu_torch.models import encoders as E
from ecg_byte_tpu_torch.models.bert import BertTextEncoder
from ecg_byte_tpu_torch.models.convert import merl_head_from_jax
from ecg_byte_tpu_torch.models.hf_loader import save_safetensors
from ecg_byte_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer

CPU = torch.device("cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _head(seed=0, channels=64, spacial=8, text_dim=48):
    jh = JE.init_merl_head(jax.random.PRNGKey(seed), feature_channels=channels,
                           proj_out=32, text_dim=text_dim, spacial_dim=spacial)
    rng = np.random.default_rng(seed)
    # non-zero biases, so a bias in the wrong place shows
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: (np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x))).astype(
            np.float32) if "b" in jax.tree_util.keystr(path)[-5:] else np.asarray(x),
        jh)
    return jax.tree.map(jnp.asarray, tree), merl_head_from_jax(tree, CPU)


def test_attention_pool_matches_jax():
    jh, h = _head()
    x = np.random.default_rng(1).normal(size=(3, 32, 8)).astype(np.float32)
    want, want_map = JE.attention_pool(jh["att_pool"], jnp.asarray(x))
    got, got_map = E.attention_pool(h["att_pool"], _t(x))
    assert got.shape == (3, 32) and got_map.shape == (3, 8)
    assert _rel(got.numpy(), want) < 1e-5
    assert _rel(got_map.numpy(), want_map) < 1e-5


def test_clip_loss_and_precision_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(12, 16)).astype(np.float32)
    y = (x + 0.8 * rng.normal(size=x.shape)).astype(np.float32)  # some rows mismatch
    want = JE.clip_loss(jnp.asarray(x), jnp.asarray(y))
    got = E.clip_loss(_t(x), _t(y))
    assert _rel(got[0].item(), want[0]) < 1e-5
    assert got[1].item() == float(want[1]) and got[2].item() == float(want[2])
    sim = rng.normal(size=(9, 9)).astype(np.float32)
    labels = np.arange(9)
    for g, w in zip(E.precision_at_k(_t(sim), _t(labels)),
                    JE.precision_at_k(jnp.asarray(sim), jnp.asarray(labels))):
        assert g.item() == float(w)


def test_merl_pretrain_loss_and_gradients_match_jax():
    jh, h = _head(seed=3)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(6, 64, 8)).astype(np.float32)
    text = rng.normal(size=(6, 48)).astype(np.float32)

    def jloss(jh, feats):
        return JE.merl_pretrain_loss(jh, feats, jnp.asarray(text))

    (want, aux), (wg_head, wg_feats) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jh, jnp.asarray(feats))
    h = jax.tree.map(lambda t: t.requires_grad_(True), h)
    f = _t(feats).requires_grad_(True)
    got, got_aux = E.merl_pretrain_loss(h, f, _t(text))
    got.backward()
    assert _rel(got.item(), want) < 1e-5
    assert got_aux["acc1"].item() == float(aux["acc1"])
    assert _rel(got_aux["att_map"].detach().numpy(), aux["att_map"]) < 1e-5
    assert _rel(f.grad.numpy(), wg_feats) < 1e-4
    ported = merl_head_from_jax(jax.tree.map(np.asarray, wg_head), CPU)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(h),
                                 jax.tree_util.tree_leaves_with_path(ported)):
        assert _rel(g.grad.numpy(), w.numpy()) < 1e-4, jax.tree_util.keystr(path)


def test_merl_dropout_draws_from_the_generator():
    _, h = _head(seed=5)
    rng = np.random.default_rng(6)
    feats, text = _t(rng.normal(size=(6, 64, 8)).astype(np.float32)), _t(
        rng.normal(size=(6, 48)).astype(np.float32))
    a = E.merl_pretrain_loss(h, feats, text, dropout_generator=torch.Generator().manual_seed(1))
    b = E.merl_pretrain_loss(h, feats, text, dropout_generator=torch.Generator().manual_seed(1))
    off = E.merl_pretrain_loss(h, feats, text)
    assert a[0].item() == b[0].item() != off[0].item()


def test_hash_text_encoder_bit_for_bit():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 200_000, (5, 64))
    mask = (np.arange(64)[None] < rng.integers(0, 65, (5, 1))).astype(np.int64)
    want = JE.HashTextEncoder(dim=96)(ids, mask)
    enc = E.HashTextEncoder(dim=96, device=CPU)
    assert np.array_equal(enc.table.numpy(), JE.HashTextEncoder(dim=96).table)
    got = enc(ids, mask)
    assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list("abcdefghijklmnopqrstuvwxyz.")
    vocab += ["heart", "rate", "rhythm", "normal", "sinus", "##s", "##ia"]
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    v, hdim, layers, inner = len(vocab), 32, 2, 64
    json.dump({"vocab_size": v, "hidden_size": hdim, "num_hidden_layers": layers,
               "num_attention_heads": 4, "intermediate_size": inner,
               "max_position_embeddings": 64, "type_vocab_size": 2,
               "layer_norm_eps": 1e-12}, open(d / "config.json", "w"))
    rng = np.random.default_rng(8)
    shapes = {
        "embeddings.word_embeddings.weight": (v, hdim),
        "embeddings.position_embeddings.weight": (64, hdim),
        "embeddings.token_type_embeddings.weight": (2, hdim),
        "embeddings.LayerNorm.weight": (hdim,), "embeddings.LayerNorm.bias": (hdim,),
        "pooler.dense.weight": (hdim, hdim), "pooler.dense.bias": (hdim,),
    }
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            shapes[p + f"attention.self.{n}.weight"] = (hdim, hdim)
            shapes[p + f"attention.self.{n}.bias"] = (hdim,)
        shapes.update({
            p + "attention.output.dense.weight": (hdim, hdim),
            p + "attention.output.dense.bias": (hdim,),
            p + "attention.output.LayerNorm.weight": (hdim,),
            p + "attention.output.LayerNorm.bias": (hdim,),
            p + "intermediate.dense.weight": (inner, hdim), p + "intermediate.dense.bias": (inner,),
            p + "output.dense.weight": (hdim, inner), p + "output.dense.bias": (hdim,),
            p + "output.LayerNorm.weight": (hdim,), p + "output.LayerNorm.bias": (hdim,),
        })
    tensors = {k: torch.from_numpy((0.1 * rng.normal(size=s) + (1.0 if "LayerNorm.weight" in k
                                                                  else 0.0)).astype(np.float32))
               for k, s in shapes.items()}
    save_safetensors(tensors, str(d / "model.safetensors"))
    return d


def test_bert_text_encoder_matches_jax(bert_dir):
    want_enc = JE.load_frozen_text_encoder(str(bert_dir))
    enc = E.load_frozen_text_encoder(str(bert_dir), device=CPU)
    assert isinstance(enc, BertTextEncoder) and isinstance(enc.tokenizer, WordPieceTokenizer)
    texts = ["normal sinus rhythm.", "heart rates"]
    jtok = JaxWordPiece(str(bert_dir / "vocab.txt"))
    out = enc.tokenizer(texts, return_tensors="np", padding="max_length", max_length=12,
                        truncation=True, add_special_tokens=True)
    ref = jtok(texts, return_tensors="np", padding="max_length", max_length=12,
               truncation=True, add_special_tokens=True)
    np.testing.assert_array_equal(out.input_ids, ref.input_ids)
    got = enc(out.input_ids, out.attention_mask)
    want = want_enc(ref.input_ids, ref.attention_mask)
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_broken_checkpoint_raises_without_optin(tmp_path):
    d = tmp_path / "corrupt"
    d.mkdir()
    (d / "config.json").write_text("{not json")
    with pytest.raises(RuntimeError, match="allow_hash_fallback"):
        E.load_frozen_text_encoder(str(d), device=CPU)
    enc = E.load_frozen_text_encoder(str(d), allow_hash_fallback=True, device=CPU)
    assert isinstance(enc, E.HashTextEncoder)
    assert isinstance(E.load_frozen_text_encoder(None, device=CPU), E.HashTextEncoder)
