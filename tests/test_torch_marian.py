"""The port's Marian model and report translation against the JAX package.

The twins of ``tests/test_marian.py``.  The tests write a tiny random
Marian directory with the port (``marian.init_params``,
``save_hf_marian``: ``config.json`` and ``model.safetensors`` under HF's
names) and a handmade SentencePiece model and ``vocab.json``; the JAX
package and the port both load it.  HF ``MarianMTModel`` (transformers,
here only) loads the same directory, which holds the writer to HF's
layout.

Bounds: f32 logits within 1e-5 absolute of JAX's and of HF's (f32 sums in
another order; the logits are O(1) at these sizes).  Greedy token streams,
the decoded translations and ``translate_reports``' output are equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.data.preprocess import translate_reports as jax_translate
from ecg_byte_tpu.models import marian as JM
from ecg_byte_tpu_torch.data.preprocess import translate_reports
from ecg_byte_tpu_torch.models import marian
from ecg_byte_tpu_torch.tokenizer import sp_model

VOCAB = 97
PAD, EOS = 96, 0
LOGITS_TOL = 1e-5
CONFIG = marian.MarianConfig(
    vocab_size=VOCAB, d_model=32, encoder_layers=2, decoder_layers=2, num_heads=4, ffn_dim=64,
    max_position_embeddings=64, pad_token_id=PAD, eos_token_id=EOS, decoder_start_token_id=PAD)
WORDS = ("der", "die", "das", "herz", "normal", "sinus")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("marian")
    # weights of std 0.3 and a raised eos logit: a random model whose
    # streams move and whose rows end at different steps
    params = marian.init_params(CONFIG, torch.Generator().manual_seed(0), std=0.3)
    params["final_logits_bias"][EOS] += 3.0
    marian.save_hf_marian(params, CONFIG, str(d))
    pieces = [("<unk>", 0.0), ("▁", -2.0)] + [(f"▁{w}", -1.0) for w in WORDS]
    pieces += [(c, -3.0) for c in "abcdefghijklmnopqrstuvwxyz"]
    sp_model.write_spm(str(d / "source.spm"), pieces)
    vocab = {"<pad>": PAD, "</s>": EOS}
    vocab.update((p, i + 1) for i, (p, _) in enumerate(pieces))
    json.dump(vocab, open(d / "vocab.json", "w"))
    return d


def _batch(rng, b=3, s=9):
    src = rng.integers(1, VOCAB - 1, size=(b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    src[1, -3:] = PAD  # a right-padded row: the encoder and cross masks
    mask[1, -3:] = 0
    return src, mask


def test_forward_logits_match_jax_and_hf(model_dir):
    params, config = marian.load_hf_marian(str(model_dir))
    jparams, jconfig = JM.load_hf_marian(str(model_dir))
    assert config == marian.MarianConfig(**vars(jconfig)) == CONFIG
    rng = np.random.default_rng(0)
    src, mask = _batch(rng)
    tgt = rng.integers(1, VOCAB - 1, size=(3, 7)).astype(np.int64)
    got = marian.forward(params, config, torch.from_numpy(src), torch.from_numpy(mask),
                         torch.from_numpy(tgt)).numpy()
    want = np.asarray(JM.forward(jparams, jconfig, jnp.asarray(src), jnp.asarray(mask),
                                 jnp.asarray(tgt)))
    assert got.dtype == np.float32 and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=0)
    transformers = pytest.importorskip("transformers")
    hf = transformers.MarianMTModel.from_pretrained(str(model_dir)).eval()
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(src), attention_mask=torch.from_numpy(mask),
                 decoder_input_ids=torch.from_numpy(tgt)).logits.numpy()
    np.testing.assert_allclose(got, ref, atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("max_length,eos_boost", [(16, 0.0), (40, 0.0), (40, 10.0)])
def test_greedy_generate_matches_jax(model_dir, max_length, eos_boost):
    """The whole (B, max_length) token array, pads after eos included: rows
    that end at different steps and rows that never end; with the eos logit
    raised every row ends at once, and the loop stops at the next read of
    the stop flag, with the same array."""
    params, config = marian.load_hf_marian(str(model_dir))
    jparams, jconfig = JM.load_hf_marian(str(model_dir))
    params["final_logits_bias"][EOS] += eos_boost
    jparams["final_logits_bias"] = jparams["final_logits_bias"].at[EOS].add(eos_boost)
    src, mask = _batch(np.random.default_rng(1), b=4, s=8)
    stats = {}
    got = marian.greedy_generate(params, config, src, mask, max_length=max_length, stats=stats)
    want = np.asarray(JM.greedy_generate(jparams, jconfig, src, mask, max_length=max_length))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and (got[:, 0] == PAD).all()
    ended = (want == EOS).any(axis=1)
    if eos_boost:
        assert ended.all() and stats["steps"] == marian.STOP_CHECK
    else:
        assert ended.any() and not ended.all() and stats["steps"] == max_length - 1
        assert len(set(want[~ended][0].tolist())) > 2  # a stream that moves


def test_translate_reports_matches_jax(model_dir):
    texts = np.asarray(["der herz normal", "", "sinus das", "  ", None,
                        "die herz sinus der das normal herz"] * 12, dtype=object)
    stats = {}
    got = translate_reports(texts, model_dir=str(model_dir), device="cpu", stats=stats)
    want = jax_translate(texts, model_dir=str(model_dir))
    assert got.shape == texts.shape and list(got) == list(want)
    assert got[1] == got[3] == got[4] == ""
    assert stats["sentences"] == 36 and stats["batches"] == 2
    assert any(t for t in got)


def test_translate_reports_without_a_checkpoint(tmp_path, monkeypatch):
    """No local checkpoint: the reports pass through, as in the JAX
    package, and no device is asked for."""
    monkeypatch.delenv("ECG_BYTE_TRANSLATION_MODEL", raising=False)
    texts = np.asarray(["der herz", ""], dtype=object)
    out = translate_reports(texts, model_dir=str(tmp_path / "missing"))
    assert list(out) == list(jax_translate(texts, model_dir=str(tmp_path / "missing")))
