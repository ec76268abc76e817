"""Interpretability in the port against the JAX package, on the CPU.

The same numpy inputs and weights (JAX init, carried across by
``params_from_jax``) go through both packages: the plain probability path
``causal_attention(..., return_probs=True)``, the eager stack of
``forward(return_attentions=True)``, the streamed ``mean_attention``, and
``interpreter`` over the same files; then ``cli.interp_analysis --device
cpu`` in-process on a checkpoint the port wrote.

Bounds: in f32, probabilities, logits and means within 1e-5 absolute (sums
in another order; every value is at most 1, the logits O(0.1)).  In bf16
the probabilities are rounded to bf16 in both packages after an f32
softmax, so they agree within one bf16 ulp of 1 (2^-8, 3.9e-3), as do the
layer and head means; the layers' outputs and logits within 3e-2
(one bf16 rounding apart in a layer, carried through two).  The streamed
mean equals the eager stack's mean within 2e-6, the JAX package's own
bound.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu import data as jdata
from ecg_byte_tpu.interpret import interpreter as jax_interpreter
from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu.ops import attention as JA
from ecg_byte_tpu_torch import data as tdata
from ecg_byte_tpu_torch.interpret import (
    expand_attention,
    get_component_indices,
    interpreter,
)
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import params_from_jax
from ecg_byte_tpu_torch.ops import attention
from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
from ecg_byte_tpu_torch.tokenizer import BpeTokenizer

CPU = torch.device("cpu")
F32_TOL = 1e-5
BF16_ULP1 = 2.0 ** -8
BF16_OUT = 3e-2
MEAN_TOL = 2e-6


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_return_probs_matches_jax(dtype):
    rng = np.random.default_rng(0)
    b, s, h, kh, d = 2, 24, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, :5] = 0
    jd = jnp.dtype(dtype)
    jout, jprobs = JA.causal_attention(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                                       jnp.asarray(mask), return_probs=True)
    td = getattr(torch, dtype)
    out, probs = attention.causal_attention(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                                            torch.from_numpy(v).to(td), torch.from_numpy(mask),
                                            return_probs=True)
    assert probs.shape == (b, h, s, s) and probs.dtype == td and out.shape == (b, s, h, d)
    tol_p, tol_o = (F32_TOL, F32_TOL) if dtype == "float32" else (BF16_ULP1, BF16_OUT)
    np.testing.assert_allclose(probs.float().numpy(), _np32(jprobs), atol=tol_p, rtol=0)
    np.testing.assert_allclose(out.float().numpy(), _np32(jout), atol=tol_o, rtol=0)
    # pad columns are zero and each row sums to 1 (up to the bf16 rounding)
    assert (probs[1, :, :, :5][:, 5:] == 0).all()
    rows = probs.float().sum(-1)[:, :, 5:]
    assert torch.allclose(rows, torch.ones_like(rows), atol=s * BF16_ULP1 / 2)


def _models(dtype, vocab=512, seed=0):
    jc = jax_config.tiny_test_config("llama", vocab_size=vocab, dtype=dtype)
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.PRNGKey(seed)))
    pc = tiny_test_config("llama", vocab_size=vocab, dtype=dtype)
    return jax.tree.map(jnp.asarray, tree), jc, params_from_jax(tree, pc, CPU), pc


def _prompt(b=2, s=20, vocab=512, left_pad=4, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :left_pad] = 0
    ids[1, :left_pad] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_stack_and_mean_attention_match_jax(dtype):
    """The 2-layer tiny llama: logits, the (L, B, H, S, S) stack and the
    streamed (B, S, S) mean against JAX's; the streamed mean against the
    port's own eager stack's mean."""
    jparams, jc, params, pc = _models(dtype)
    ids, mask = _prompt()
    jlogits, jstack = JT.forward(jparams, jc, jnp.asarray(ids), jnp.asarray(mask),
                                 return_attentions=True)
    jmean = JT.mean_attention(jparams, jc, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        logits, stack = T.forward(params, pc, torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask), return_attentions=True)
    mean = T.mean_attention(params, pc, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert stack.shape == (2, 2, 4, 20, 20) and mean.shape == (2, 20, 20)
    assert mean.dtype == torch.float32
    f32 = dtype == "float32"
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=F32_TOL if f32 else BF16_OUT, rtol=0)
    np.testing.assert_allclose(stack.float().numpy(), _np32(jstack),
                               atol=F32_TOL if f32 else BF16_ULP1, rtol=0)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean),
                               atol=F32_TOL if f32 else BF16_ULP1, rtol=0)
    np.testing.assert_allclose(mean.numpy(), stack.float().mean(dim=(0, 2)).numpy(),
                               atol=MEAN_TOL, rtol=0)
    # the plain forward (no capture) gives the same logits
    with torch.no_grad():
        plain = T.forward(params, pc, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert torch.equal(plain, logits)


def test_expand_attention_and_component_indices():
    vocab = {0: "ab", 1: "c", 2: "abcd"}
    assert expand_attention([0, 1, 2], [0.5, 0.2, 0.1], vocab) == \
        [0.5, 0.5, 0.2, 0.1, 0.1, 0.1, 0.1]
    tok = tdata.ByteTextTokenizer()
    tok.add_tokens(["<sig_start>", "<sig_end>"], special_tokens=True)
    tok.add_special_tokens({"pad_token": "<pad>"})
    ss = tok.convert_tokens_to_ids("<sig_start>")
    se = tok.convert_tokens_to_ids("<sig_end>")
    seq = [5, ss, 10, 11, se, 20, 21, 30, 31]
    labels = [-100, -100, -100, -100, -100, -100, -100, 30, 31]
    assert get_component_indices(seq, labels, tok) == (2, 5, 7)


def _write_records(root, n=3, seg=50, seed=0):
    rng = np.random.default_rng(seed)
    (root / "ecg").mkdir()
    (root / "text").mkdir()
    sigs = []
    for i in range(n):
        s = (np.cumsum(rng.normal(size=(12, seg)), -1) * 0.05).astype(np.float32)
        np.save(root / "ecg" / f"ecg_{i}_0.npy", s)
        json.dump("Normal sinus rhythm.", open(root / "text" / f"text_{i}_0.json", "w"))
        sigs.append(s)
    stats = np.stack(sigs)
    percentiles = {"percentile_1": float(np.percentile(stats, 1)),
                   "percentile_99": float(np.percentile(stats, 99))}
    _, q = normalize_quantize(torch.from_numpy(stats), percentiles["percentile_1"],
                              percentiles["percentile_99"])
    bpe = BpeTokenizer.train(quantized_to_string(q), 60)
    sig_paths = [str(root / "ecg" / f"ecg_{i}_0.npy") for i in range(n)]
    txt_paths = [str(root / "text" / f"text_{i}_0.json") for i in range(n)]
    return sig_paths, txt_paths, percentiles, bpe


def test_interpreter_matches_jax(tmp_path):
    """Both packages' interpreters over the same files and weights: the same
    region sequences, decoded signal texts, and attentions within 1e-5."""
    sig_paths, txt_paths, percentiles, bpe = _write_records(tmp_path)
    jtok, ttok = jdata.ByteTextTokenizer(), tdata.ByteTextTokenizer()
    jdata.register_ecg_tokens(jtok, bpe.vocab)
    tdata.register_ecg_tokens(ttok, bpe.vocab)
    jds = jdata.ECGTokenDataset(sig_paths, txt_paths, bpe.vocab, bpe.merges, tokenizer=jtok,
                                args=jdata.DataConfig(dataset="ptb_500", pad_to_max=420,
                                                      percentiles=percentiles))
    tds = tdata.ECGTokenDataset(sig_paths, txt_paths, bpe.vocab, bpe.merges, tokenizer=ttok,
                                args=tdata.DataConfig(dataset="ptb_500", pad_to_max=420,
                                                      percentiles=percentiles))
    jparams, jc, params, pc = _models("float32", vocab=len(ttok))

    def jfwd(batch):
        return JT.mean_attention(jparams, jc, np.asarray(batch["tokenized_signal"], np.int32),
                                 np.asarray(batch["attn_mask"], np.int32),
                                 np.asarray(batch["position_ids"], np.int32))

    def tfwd(batch):
        def f(name):
            return torch.from_numpy(np.asarray(batch[name], np.int32))

        return T.mean_attention(params, pc, f("tokenized_signal"), f("attn_mask"),
                                f("position_ids"))

    kw = dict(signal_shape=(12, 50), dev=True, max_plots=0)
    want = jax_interpreter(jfwd, jdata.DataLoader(jds, batch_size=1, pad_id=jds.pad_id,
                                                  prefetch=False),
                           jtok, bpe.vocab, percentiles, out_dir=str(tmp_path / "jax"), **kw)
    got = interpreter(tfwd, tdata.DataLoader(tds, batch_size=1, pad_id=tds.pad_id,
                                             prefetch=False),
                      ttok, bpe.vocab, percentiles, out_dir=str(tmp_path / "port"), **kw)
    assert len(got["signal"]["sequences"]) == 3
    assert got["signal"]["signal"] == want["signal"]["signal"]
    for region in ("signal", "question", "answer"):
        for g, w in zip(got[region]["sequences"], want[region]["sequences"], strict=True):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got[region]["attentions"], want[region]["attentions"], strict=True):
            np.testing.assert_allclose(g, np.asarray(w), atol=F32_TOL, rtol=0)


def test_interp_analysis_cli_on_a_port_checkpoint(tmp_path, monkeypatch):
    """``cli.interp_analysis --device cpu`` in-process on a LoRA checkpoint
    the port wrote: every test record interpreted, its attentions those of
    ``mean_attention`` with the saved adapters, the overlays written."""
    from ecg_byte_tpu_torch.cli import interp_analysis, make_synthetic
    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.train.checkpoint import load_weights, save_checkpoint
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import create_train_state
    from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

    monkeypatch.chdir(tmp_path)
    make_synthetic.main(["--n_train", "2", "--n_val", "1", "--n_test", "3", "--seg_len", "40"])
    stats = np.load("data/ptb_500_dataset_stats.npy", allow_pickle=True).item()
    sigs = np.stack([np.load(p) for p in sorted(
        str(p) for p in (tmp_path / "data/ptb_500/ecg/train").glob("*.npy"))])
    _, q = normalize_quantize(torch.from_numpy(sigs), stats["percentile_1"],
                              stats["percentile_99"])
    bpe = BpeTokenizer.train(quantized_to_string(q), 30)
    bpe.save("data/tokenizer_30.pkl")
    params, config, tok = build_model("tiny-llama", bpe.vocab, CPU)
    state = create_train_state(config, make_optimizer(config.hidden_size, 500),
                               torch.Generator().manual_seed(0), peft=True, params=params)
    with torch.no_grad():  # a LoRA that moves the attention
        for leaf in state.trainable["layers"][0].values():
            leaf["b"].normal_(0, 0.5, generator=torch.Generator().manual_seed(1))
    save_checkpoint("runs/0/ckpt", "best_model", state)
    out = interp_analysis.main([
        "--device", "cpu", "--model", "tiny-llama", "--dataset", "ptb_500",
        "--tokenizer_check", "tokenizer_30", "--num_merges", "30",
        "--percentiles", "data/ptb_500_dataset_stats.npy", "--checkpoint", "ckpt",
        "--seg_len", "40", "--pad_to_max", "200", "--max_plots", "0"])
    assert out["summary"]["records"] == len(out["signal"]["sequences"]) == 3
    assert out["summary"]["peak_gib"] is None
    params, lora = load_weights("runs/0/ckpt", "best_model",
                                build_model("tiny-llama", bpe.vocab, CPU)[0], peft=True)
    ds = tdata.ECGTokenDataset(
        *align_signal_text_files("data/ptb_500/ecg/test", "data/ptb_500/text/test"),
        bpe.vocab, bpe.merges, tokenizer=tok,
        args=tdata.DataConfig(dataset="ptb_500", pad_to_max=200,
                              percentiles="data/ptb_500_dataset_stats.npy"))
    batch = tdata.collate([ds[0]], pad_id=ds.pad_id)
    mean = T.mean_attention(params, config, torch.from_numpy(batch["tokenized_signal"]),
                            torch.from_numpy(batch["attn_mask"]),
                            torch.from_numpy(batch["position_ids"]), lora=lora)
    s0, q0, _ = get_component_indices(batch["tokenized_signal"][0],
                                      batch["quantized_signal_ids_input"][0], tok)
    np.testing.assert_allclose(out["signal"]["attentions"][0],
                               mean[0, s0:q0, s0:q0].mean(0).numpy(), atol=1e-6, rtol=0)
    assert os.path.isdir("pngs/attention")

