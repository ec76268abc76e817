"""The port's quantizer, BPE tokenizer, synthetic-data generator, dataset
packing and loader against the JAX package's, on synthetic records made from
a seed: identical values, item for item."""

import filecmp
import json
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.cli import make_synthetic as jax_make_synthetic
from ecg_byte_tpu.cli.make_synthetic import make_signal
from ecg_byte_tpu.data import DataConfig as JaxDataConfig
from ecg_byte_tpu.data import DataLoader as JaxDataLoader
from ecg_byte_tpu.data import ECGTokenDataset as JaxDataset
from ecg_byte_tpu.data.text_tokenizer import ByteTextTokenizer as JaxTokenizer
from ecg_byte_tpu.data.text_tokenizer import register_ecg_tokens as jax_register
from ecg_byte_tpu.ops.quantize import normalize_quantize as jax_quantize
from ecg_byte_tpu.ops.quantize import quantized_to_string as jax_to_string
from ecg_byte_tpu.tokenizer import BpeTokenizer as JaxBpeTokenizer
from ecg_byte_tpu.tokenizer import encode_text as jax_encode_text
from ecg_byte_tpu.tokenizer import load_vocab_and_merges as jax_load
from ecg_byte_tpu_torch.cli import make_synthetic
from ecg_byte_tpu_torch.data import (
    ByteTextTokenizer,
    DataConfig,
    DataLoader,
    ECGTokenDataset,
    register_ecg_tokens,
)
from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
from ecg_byte_tpu_torch.tokenizer import BpeTokenizer, encode_text, load_vocab_and_merges


def test_normalize_quantize_identical():
    rng = np.random.default_rng(0)
    sig = np.stack([make_signal(rng, i % 2 == 0, 300) for i in range(3)])
    sig[0, 0, :5] = [-50.0, 50.0, 0.0, np.float32(1e-7), -1e-7]  # clip edges
    p1, p99 = float(np.percentile(sig, 1)), float(np.percentile(sig, 99))
    jc, jq = jax_quantize(jnp.asarray(sig), p1, p99)
    c, q = normalize_quantize(torch.from_numpy(sig), p1, p99)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert quantized_to_string(q) == jax_to_string(np.asarray(jq))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(1)
    sigs, texts = [], []
    for i in range(5):
        sig = make_signal(rng, i % 2 == 0, 120)
        sigs.append(str(root / f"ecg_{i}_0.npy"))
        np.save(sigs[-1], sig)
        texts.append(str(root / f"text_{i}_0.json"))
        with open(texts[-1], "w") as f:
            json.dump("The heart rate is fast." if i % 2 else "Sinus rhythm.", f)
    allsig = np.stack([np.load(p) for p in sigs])
    stats = {"percentile_1": float(np.percentile(allsig, 1)),
             "percentile_99": float(np.percentile(allsig, 99))}
    _, q = normalize_quantize(torch.from_numpy(allsig), stats["percentile_1"],
                              stats["percentile_99"])
    bpe = BpeTokenizer.train(quantized_to_string(q), 60)
    return sigs, texts, bpe.vocab, bpe.merges, stats


def _datasets(records, **cfg):
    sigs, texts, vocab, merges, stats = records
    jtok, tok = JaxTokenizer(), ByteTextTokenizer()
    jax_register(jtok, vocab)
    register_ecg_tokens(tok, vocab)
    jds = JaxDataset(sigs, texts, vocab, merges, tokenizer=jtok,
                     args=JaxDataConfig(percentiles=stats, **cfg))
    ds = ECGTokenDataset(sigs, texts, vocab, merges, tokenizer=tok,
                         args=DataConfig(percentiles=stats, **cfg))
    return jds, ds


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize(
    "cfg",
    [dict(inference=True), dict(pad_to_max=600), dict(pad_to_max=150)],
    ids=["inference", "training-left-pad", "training-truncate"],
)
def test_dataset_items_identical(records, cfg):
    jds, ds = _datasets(records, **cfg)
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        _assert_items_equal(jds[i], ds[i])
    # the signal region is left-padded at 600 and truncated at 150
    padded = (ds[0]["tokenized_signal"] == ds.pad_id).any()
    assert padded == (cfg.get("pad_to_max") == 600)


def test_loader_batches_identical(records):
    jds, ds = _datasets(records, inference=True)
    pad_id = ds.pad_id
    jbatches = list(JaxDataLoader(jds, batch_size=2, pad_id=pad_id))
    batches = list(DataLoader(ds, batch_size=2, pad_id=pad_id))
    assert len(batches) == len(jbatches) == 3
    for jb, b in zip(jbatches, batches):
        _assert_items_equal(jb, b)


def test_token_cache_not_ported(records, monkeypatch):
    """The token cache (``cache_tokens=True``) is ported: it encodes every
    record once on the device the caller names (here the CPU, so the
    kernels' plain versions), and its items equal the port's host-encoded
    items and the JAX package's cached items, in batches of 64 or of 2.
    With no device named it needs the CUDA card: no fall back to the CPU."""
    sigs, texts, vocab, merges, stats = records
    for cfg in (dict(pad_to_max=600), dict(inference=True)):
        jds, online = _datasets(records, **cfg)
        jcached = JaxDataset(sigs, texts, vocab, merges, tokenizer=jds.tokenizer,
                             args=JaxDataConfig(percentiles=stats, **cfg), cache_tokens=True)
        cached = ECGTokenDataset(sigs, texts, vocab, merges, tokenizer=online.tokenizer,
                                 args=DataConfig(percentiles=stats, **cfg), cache_tokens=True,
                                 device="cpu")
        assert cached._build_token_cache(torch.device("cpu"), batch=2) == cached._token_cache
        assert len(cached._token_cache) == len(sigs)
        for i in range(len(sigs)):
            _assert_items_equal(cached[i], online[i])
            _assert_items_equal(cached[i], jcached[i])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ECGTokenDataset(sigs, texts, vocab, merges, tokenizer=online.tokenizer,
                        args=DataConfig(percentiles=stats), cache_tokens=True)


def test_bpe_tokenizer_identical_to_jax(tmp_path):
    """The port's copy trains the same merges and vocab, encodes to the same
    ids (host C++ trie on both sides), decodes back to the same string, and
    its pickle loads in both packages and the JAX one's in the port."""
    rng = np.random.default_rng(5)
    sigs = np.stack([make_signal(rng, i % 2 == 0, 400) for i in range(6)])
    p1, p99 = float(np.percentile(sigs, 1)), float(np.percentile(sigs, 99))
    corpus = quantized_to_string(normalize_quantize(torch.from_numpy(sigs), p1, p99)[1])
    port, ref = BpeTokenizer.train(corpus, 120), JaxBpeTokenizer.train(corpus, 120)
    assert port.merges == ref.merges and port.vocab == ref.vocab
    for text in (corpus[:5000], corpus[-777:], "abcxyz", ""):
        ids = port.encode(text)
        assert ids == ref.encode(text) == jax_encode_text(text, ref.merges)
        assert ids == encode_text(text, port.merges)
        assert port.decode(ids) == text
    port.save(str(tmp_path / "port.pkl"))
    ref.save(str(tmp_path / "jax.pkl"))
    assert jax_load(str(tmp_path / "port.pkl")) == (ref.vocab, ref.merges)
    assert load_vocab_and_merges(str(tmp_path / "jax.pkl")) == (port.vocab, port.merges)
    assert pickle.load(open(tmp_path / "port.pkl", "rb")) == (port.vocab, port.merges)


def test_make_synthetic_byte_identical(tmp_path, monkeypatch):
    """For the same arguments the port's generator writes the same files,
    byte for byte, as the JAX package's."""
    args = ["--n_train", "3", "--n_val", "2", "--n_test", "2", "--seg_len", "80", "--seed", "4"]
    make_synthetic.main(["--data_root", str(tmp_path / "port")] + args)
    monkeypatch.setattr(sys, "argv", ["make_synthetic", "--data_root", str(tmp_path / "jax")] + args)
    jax_make_synthetic.main()
    files = []
    for root, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(root, n), tmp_path / "jax") for n in names]
    assert len(files) == 2 + 2 * 7  # stats, file list, and 7 records x (ecg, text)
    for rel in files:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.startswith("sampled_ecg_files"):  # lists paths under each root
            assert a.read_text().replace("/port/", "/jax/") == b.read_text()
        else:
            assert filecmp.cmp(a, b, shallow=False), rel
