"""The port's local BERTScore against the JAX package and ``transformers``,
in f32 on the CPU, on a tiny random BERT directory written here:

- ``bert_forward``: every layer's hidden states (and the pooler) within
  1e-5 of JAX's ``bert_forward`` with a padded batch, and of
  ``transformers.BertModel`` on a checkpoint it saved itself;
- ``LocalBertScorer``: P, R and F1 within 1e-5 of JAX's scorer;
- the WordPiece tokenizer: the same tokens and ids as JAX's and as
  ``transformers.BertTokenizer``;
- ``$ECG_BYTE_BERTSCORE_MODEL`` switches ``bertscore_with_mode`` to
  ``"local-bert"`` (zero-fill without it), and ``tester`` scores on the
  device it is given, also where the other metrics cannot run.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.numpy import save_file

from ecg_byte_tpu.models.bert import bert_forward as jax_bert_forward
from ecg_byte_tpu.models.bert import load_hf_bert as jax_load_hf_bert
from ecg_byte_tpu.tokenizer.wordpiece import WordPieceTokenizer as JaxWordPiece
from ecg_byte_tpu.utils.bertscore import LocalBertScorer as JaxScorer
from ecg_byte_tpu_torch.infer import evaluate
from ecg_byte_tpu_torch.models.bert import bert_forward, load_hf_bert
from ecg_byte_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer
from ecg_byte_tpu_torch.utils import bertscore, metrics

CPU = torch.device("cpu")
TOL = 1e-5
WORDS = ["the", "quick", "brown", "fox", "jumps", "normal", "sinus", "rhythm", "atrial",
         "fibrillation", "shows", "ecg", "heart", "rate", "is", "slow", "fast"]
PIECES = ["un", "##aff", "##able", "##ly", "##ing", "##s", "wait", "run"]
REFS = ["the quick brown fox jumps", "normal sinus rhythm", "The heart rate is slow."]
HYPS = ["the quick brown fox jumps", "atrial fibrillation shows", "The heart rate is fast."]


@pytest.fixture(scope="module", params=["", "bert."], ids=["plain-keys", "bert-prefix"])
def bert_ckpt(request, tmp_path_factory):
    """A tiny random BERT directory (``tests/test_metrics.py``'s layout,
    with random LayerNorm weights and biases), keys with or without the
    ``bert.`` prefix."""
    d = tmp_path_factory.mktemp("bert_ckpt")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += list("abcdefghijklmnopqrstuvwxyz0123456789.,!?-") + WORDS + PIECES
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    V, H, L, I = len(vocab), 32, 2, 64
    json.dump({"vocab_size": V, "hidden_size": H, "num_hidden_layers": L,
               "num_attention_heads": 4, "intermediate_size": I, "max_position_embeddings": 64,
               "type_vocab_size": 2, "layer_norm_eps": 1e-12}, open(d / "config.json", "w"))
    rng = np.random.default_rng(7)

    def ln(prefix):
        return {prefix + ".weight": 1 + 0.1 * rng.normal(size=H),
                prefix + ".bias": 0.1 * rng.normal(size=H)}

    t = {"embeddings.word_embeddings.weight": rng.normal(size=(V, H)),
         "embeddings.position_embeddings.weight": rng.normal(size=(64, H)),
         "embeddings.token_type_embeddings.weight": rng.normal(size=(2, H)),
         **ln("embeddings.LayerNorm"),
         "pooler.dense.weight": rng.normal(size=(H, H)), "pooler.dense.bias": rng.normal(size=H)}
    for i in range(L):
        p = f"encoder.layer.{i}."
        for nm in ("query", "key", "value"):
            t[p + f"attention.self.{nm}.weight"] = rng.normal(size=(H, H))
            t[p + f"attention.self.{nm}.bias"] = rng.normal(size=H)
        t[p + "attention.output.dense.weight"] = rng.normal(size=(H, H))
        t[p + "attention.output.dense.bias"] = rng.normal(size=H)
        t.update(ln(p + "attention.output.LayerNorm"))
        t[p + "intermediate.dense.weight"] = rng.normal(size=(I, H))
        t[p + "intermediate.dense.bias"] = rng.normal(size=I)
        t[p + "output.dense.weight"] = rng.normal(size=(H, I))
        t[p + "output.dense.bias"] = rng.normal(size=H)
        t.update(ln(p + "output.LayerNorm"))
    t = {request.param + k: (np.asarray(v) * (1 if "LayerNorm.weight" in k else 0.05)
                             ).astype(np.float32) for k, v in t.items()}
    save_file(t, str(d / "model.safetensors"))
    return d


def test_bert_forward_every_layer_matches_jax(bert_ckpt):
    jparams, jconfig = jax_load_hf_bert(str(bert_ckpt))
    params, config = load_hf_bert(str(bert_ckpt), CPU)
    assert config == type(config)(**vars(jconfig))
    ids = np.random.default_rng(0).integers(0, config.vocab_size, (3, 11)).astype(np.int32)
    mask = np.ones((3, 11), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    jstates, jpooled = jax_bert_forward(jparams, jconfig, jnp.asarray(ids), jnp.asarray(mask),
                                        return_all_layers=True)
    states, pooled = bert_forward(params, config, torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask), return_all_layers=True)
    assert states.shape == (config.num_layers + 1, 3, 11, config.hidden_size)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=TOL, rtol=TOL)
    last, _ = bert_forward(params, config, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert torch.equal(last, states[-1])


def test_bert_forward_matches_transformers(tmp_path):
    cfg = transformers.BertConfig(vocab_size=80, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=64, attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.BertModel(cfg).eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    params, config = load_hf_bert(str(tmp_path), CPU)
    ids = torch.randint(0, 80, (2, 9), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 9, dtype=torch.long)
    mask[1, 6:] = 0
    with torch.no_grad():
        out = model(input_ids=ids, attention_mask=mask, output_hidden_states=True)
    states, pooled = bert_forward(params, config, ids, mask, return_all_layers=True)
    for layer, want in enumerate(out.hidden_states):
        valid = mask.bool()
        np.testing.assert_allclose(states[layer][valid].numpy(), want[valid].numpy(),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(), atol=TOL, rtol=TOL)


def test_scorer_matches_jax(bert_ckpt):
    jax_scorer = JaxScorer(str(bert_ckpt))
    mine = bertscore.LocalBertScorer(str(bert_ckpt), device="cpu")
    assert mine.layer == jax_scorer.layer == 2
    refs = REFS + ["", "unaffably waiting... RUNS running?"]
    hyps = HYPS + ["ecg", "run"]
    want, got = jax_scorer.score(refs, hyps), mine.score(refs, hyps)
    for key in ("precision", "recall", "f1"):
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0)
    assert got["f1"][0] == pytest.approx(1.0, abs=1e-5)
    assert got["f1"][3] == 0.0  # an empty reference scores zero, as in JAX
    layer1 = bertscore.LocalBertScorer(str(bert_ckpt), layer=1, device="cpu").score(refs, hyps)
    np.testing.assert_allclose(layer1["f1"], JaxScorer(str(bert_ckpt), layer=1).score(
        refs, hyps)["f1"], atol=TOL, rtol=0)


def test_wordpiece_matches_jax_and_transformers(bert_ckpt):
    vocab_file = str(bert_ckpt / "vocab.txt")
    mine, jax_wp = WordPieceTokenizer(vocab_file), JaxWordPiece(vocab_file)
    hf = transformers.BertTokenizer(vocab_file, do_lower_case=True)
    for text in ["The quick brown fox jumps!", "Normal sinus rhythm, no atrial fibrillation.",
                 "unaffably waiting... RUNS running?", "weird\tspacing\n and  Café accents",
                 "un-tokenizable Zzz 123 .,!?", "漢字 ecg", ""]:
        assert mine.tokenize(text) == jax_wp.tokenize(text) == hf.tokenize(text), text
        assert mine.encode(text) == jax_wp.encode(text) == hf.encode(text), text
    batch = mine(["the fox", "normal sinus rhythm shows"], return_tensors="np")
    want = jax_wp(["the fox", "normal sinus rhythm shows"], return_tensors="np")
    assert np.array_equal(batch.input_ids, want.input_ids)
    assert np.array_equal(batch.attention_mask, want.attention_mask)


def test_env_switches_on_local_bert(bert_ckpt, monkeypatch):
    monkeypatch.setenv(bertscore.MODEL_ENV, str(bert_ckpt))
    monkeypatch.setenv(bertscore.LAYER_ENV, "1")
    scores, mode = metrics.bertscore_with_mode(REFS, HYPS, device="cpu")
    assert mode == "local-bert"
    want = JaxScorer(str(bert_ckpt), layer=1).score(REFS, HYPS)
    np.testing.assert_allclose(scores["hf-f1"], want["f1"], atol=TOL, rtol=0)
    scorer = bertscore.local_scorer_from_env("cpu")
    assert scorer.layer == 1 and scorer.device == CPU
    assert bertscore.local_scorer_from_env("cpu") is scorer  # loaded once
    monkeypatch.delenv(bertscore.MODEL_ENV)
    assert bertscore.local_scorer_from_env("cpu") is None
    scores, mode = metrics.bertscore_with_mode(REFS, HYPS, device="cpu")
    assert mode == "zero-fill" and scores["hf-f1"] == [0.0] * 3


def test_tester_scores_on_the_given_device(bert_ckpt, monkeypatch):
    """``tester(device=)`` reaches the scorer; BERTScore still scores where
    the other metrics' packages are missing (simulated), in mode
    ``local-bert``."""
    monkeypatch.setenv(bertscore.MODEL_ENV, str(bert_ckpt))
    seen = []
    real = bertscore.local_scorer_from_env

    def spy(device=None):
        seen.append(device)
        return real(device)

    monkeypatch.setattr(bertscore, "local_scorer_from_env", spy)
    loader = [{"answer": [r], "question": ["q"]} for r in REFS]
    hyps = iter(HYPS)
    out = evaluate.tester(lambda batch: next(hyps), loader, device="cpu")
    assert out["metric_modes"]["bertscore"] == ["local-bert"]
    assert seen == ["cpu"] * 3
    want = JaxScorer(str(bert_ckpt)).score(REFS, HYPS)["f1"]
    assert out["metrics"]["hf-f1"] == pytest.approx(float(np.mean(want)), abs=TOL)

    def missing(*args):
        raise ModuleNotFoundError("No module named 'nltk'")

    monkeypatch.setattr(metrics, "calculate_bleu", missing)
    hyps = iter(HYPS)
    out = evaluate.tester(lambda batch: next(hyps), loader, device="cpu")
    assert out["metric_modes"] == {"bertscore": ["local-bert"]}
    assert out["metrics"]["BLEU"] == 0.0
    assert out["metrics"]["hf-f1"] == pytest.approx(float(np.mean(want)), abs=TOL)
