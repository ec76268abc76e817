"""The port's HF checkpoint path against the JAX package, ``safetensors`` and
``transformers``, on tiny checkpoints written into ``tmp_path``:

- the port's safetensors reader equals ``safetensors.numpy`` (F32, BF16,
  F16, I64, I32, U8 across two shards), and ``safetensors`` reads the
  port's writer's files back equal;
- ``load_hf_checkpoint`` equals ``params_from_jax`` of the JAX loader's
  tree bit for bit (Llama with llama3 rope scaling and an untied head,
  GPT-2 with and without the ``transformer.`` prefix, Gemma), in bf16 and
  f32, and so does ``resize_embeddings`` after it in bf16; in f32 the new
  mean rows are within one f32 ulp of their column's largest |w| (the two
  packages sum the mean in different orders);
- the port's logits match ``transformers``' own models on the same
  directory (1e-3, the JAX tests' tolerance);
- ``make_flagship_fixture --tiny`` writes the JAX fixture's files: the
  weights bit for bit, the same config and tokenizer files, a
  ``tokenizer.json`` that ``tokenizers`` loads and encodes with.
"""

import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import transformers
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from tokenizers import Tokenizer

from ecg_byte_tpu.cli import make_flagship_fixture as jax_fixture
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu.models.hf_loader import load_hf_checkpoint as jax_load
from ecg_byte_tpu.tokenizer.hf_text import HFTextTokenizer as JaxHFTextTokenizer
from ecg_byte_tpu_torch.cli import make_flagship_fixture
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import params_from_jax
from ecg_byte_tpu_torch.models.hf_loader import (
    config_from_hf,
    load_hf_checkpoint,
    load_safetensors,
    save_safetensors,
)
from ecg_byte_tpu_torch.models.lora import leaves
from ecg_byte_tpu_torch.tokenizer.hf_text import HFTextTokenizer

CPU = torch.device("cpu")
TOL = 1e-3


def _np_equal(got: torch.Tensor, want: np.ndarray) -> bool:
    if want.dtype == ml_dtypes.bfloat16:
        return got.dtype == torch.bfloat16 and np.array_equal(
            got.view(torch.int16).numpy(), want.view(np.int16))
    return np.array_equal(got.numpy(), want) and got.numpy().dtype == want.dtype


def test_reader_matches_safetensors_across_shards(tmp_path):
    rng = np.random.default_rng(0)
    shard1 = {
        "a.f32": rng.standard_normal((3, 5), dtype=np.float32),
        "b.bf16": rng.standard_normal((7, 4), dtype=np.float32).astype(ml_dtypes.bfloat16),
        "c.f16": rng.standard_normal((2, 3, 4)).astype(np.float16),
        "shared": np.arange(4, dtype=np.int64),
    }
    shard2 = {
        "d.i64": rng.integers(-2**40, 2**40, (6,), dtype=np.int64),
        "e.i32": rng.integers(-9, 9, (2, 2), dtype=np.int32),
        "f.u8": rng.integers(0, 255, (5,), dtype=np.uint8),
        "g.scalar": np.array(3.5, np.float32),
        "shared": np.arange(4, 8, dtype=np.int64),  # the later shard wins
    }
    np_save_file(shard1, str(tmp_path / "model-00001-of-00002.safetensors"))
    np_save_file(shard2, str(tmp_path / "model-00002-of-00002.safetensors"))
    want = {**np_load_file(str(tmp_path / "model-00001-of-00002.safetensors")),
            **np_load_file(str(tmp_path / "model-00002-of-00002.safetensors"))}
    got = load_safetensors(str(tmp_path))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert _np_equal(got[name], w), name
    assert got["shared"].tolist() == [4, 5, 6, 7]


def test_writer_read_back_by_safetensors(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "w.bf16": torch.randn(9, 5, generator=gen).to(torch.bfloat16),
        "w.f32": torch.randn(4, 3, generator=gen),
        "w.f16": torch.randn(3, generator=gen).half(),
        "ids.i64": torch.arange(-3, 7),
        "u8": torch.arange(6, dtype=torch.uint8),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(1.25),
        "strided": torch.randn(6, 4, generator=gen).t(),  # not contiguous
    }
    path = str(tmp_path / "model.safetensors")
    n = save_safetensors(tensors, path)
    assert n == sum(t.numel() * t.element_size() for t in tensors.values())
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
    assert header_len % 8 == 0
    back = torch_load_file(path)
    assert sorted(back) == sorted(tensors)
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
    mine = load_safetensors(str(tmp_path))
    assert all(torch.equal(mine[k], t) for k, t in tensors.items())


def _llama(tmp_path):
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=500.0, tie_word_embeddings=False, attn_implementation="eager",
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 16},
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg)


def _gpt2(tmp_path):
    cfg = transformers.GPT2Config(vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=4,
                                  attn_implementation="eager")
    torch.manual_seed(2)
    return transformers.GPT2LMHeadModel(cfg)


def _gemma(tmp_path):
    cfg = transformers.GemmaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=8, max_position_embeddings=64,
        attn_implementation="eager")
    torch.manual_seed(3)
    return transformers.GemmaForCausalLM(cfg)


MODELS = {"llama": _llama, "gpt2": _gpt2, "gemma": _gemma}


def _save(model, tmp_path, strip_prefix=False):
    """``save_pretrained`` with random norms and biases (ones and zeros
    would hide a layout fault); ``strip_prefix`` rewrites GPT-2's keys
    without ``transformer.``, as older GPT-2 files store them."""
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "ln" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    model.eval()
    d = tmp_path / "hf_model"
    model.save_pretrained(str(d), safe_serialization=True)
    if strip_prefix:
        path = str(d / "model.safetensors")
        # copies: the file is rewritten while safetensors maps it
        t = {k.removeprefix("transformer."): v.clone() for k, v in torch_load_file(path).items()}
        save_safetensors(t, path)
    return str(d)


CASES = [("llama", False), ("gpt2", False), ("gpt2", True), ("gemma", False)]
IDS = ["llama3-rope-untied", "gpt2", "gpt2-no-prefix", "gemma"]


@pytest.mark.parametrize("arch,strip", CASES, ids=IDS)
def test_loader_matches_jax_bit_for_bit(arch, strip, tmp_path):
    d = _save(MODELS[arch](tmp_path), tmp_path, strip)
    jc = jax_load(d, "float32")[1]
    pc = config_from_hf(d)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc.replace(dtype="bfloat16"))
    for dtype in ("bfloat16", "float32"):
        jparams, jc = jax_load(d, dtype)
        params, config = load_hf_checkpoint(d, dtype, CPU)
        assert config.dtype == dtype and config.vocab_size == jc.vocab_size
        ref = params_from_jax(jax.tree.map(np.asarray, jparams), config, CPU)
        assert sorted(params) == sorted(ref)
        got, exp = leaves(params), leaves(ref)
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        # the ECG tokens grow the vocabulary by mean rows
        new = config.vocab_size + 37
        jr, jrc = JT.resize_embeddings(jparams, jc, new)
        pr, prc = T.resize_embeddings(params, config, new)
        assert prc.vocab_size == jrc.vocab_size == new
        ref = params_from_jax(jax.tree.map(np.asarray, jr), prc, CPU)
        for name in ("embed", "lm_head"):
            if name not in ref:
                continue
            old = params[name]
            assert torch.equal(pr[name][: old.shape[0]], old)
            if dtype == "bfloat16":
                assert torch.equal(pr[name], ref[name]), name
            else:  # one f32 ulp of the column's largest |w|: summation order
                ulp = torch.from_numpy(np.spacing(old.abs().amax(0).numpy()))
                assert ((pr[name] - ref[name]).abs() <= ulp).all(), name


def _hf_logits(model, ids, mask=None, pos=None):
    with torch.no_grad():
        return model(input_ids=torch.as_tensor(ids), attention_mask=None if mask is None else
                     torch.as_tensor(mask), position_ids=None if pos is None else
                     torch.as_tensor(pos)).logits.float().numpy()


def _port_logits(d, ids, mask=None, pos=None):
    params, config = load_hf_checkpoint(d, "float32", CPU)
    with torch.no_grad():
        return T.forward(params, config, torch.as_tensor(ids),
                         None if mask is None else torch.as_tensor(mask),
                         None if pos is None else torch.as_tensor(pos)).numpy()


@pytest.mark.parametrize("arch", ["llama", "gpt2", "gemma"])
def test_logits_match_transformers(arch, tmp_path):
    """Llama-3.2's rope scaling, GPT-2 and Gemma, as
    tests/test_hf_parity.py holds the JAX package."""
    model = MODELS[arch](tmp_path)
    d = _save(model, tmp_path)
    vocab = model.config.vocab_size
    ids = np.random.default_rng(0).integers(0, vocab, (2, 12))
    np.testing.assert_allclose(_port_logits(d, ids), _hf_logits(model, ids), atol=TOL, rtol=TOL)
    if arch == "llama":  # the scaling is there: without it the logits move
        params, config = load_hf_checkpoint(d, "float32", CPU)
        assert config.rope_scaling_type == "llama3"
        plain = T.forward(params, config.replace(rope_scaling_type=None), torch.as_tensor(ids))
        assert np.abs(plain.detach().numpy() - _port_logits(d, ids)).max() > 1e-3


def test_left_padded_logits_match_transformers(tmp_path):
    """Left padding with explicit position ids, as the datasets pack."""
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(1)
    model = transformers.LlamaForCausalLM(cfg)
    d = _save(model, tmp_path)
    ids = np.random.default_rng(1).integers(0, 64, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[0, :3] = 0
    mask[1, :1] = 0
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0)
    ours, hf = _port_logits(d, ids, mask, pos), _hf_logits(model, ids, mask, pos)
    for b in range(2):
        valid = mask[b] == 1
        np.testing.assert_allclose(ours[b][valid], hf[b][valid], atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    jax_fixture.make_fixture(str(root / "jax"), tiny=True)
    stats = make_flagship_fixture.make_fixture(str(root / "port"), tiny=True)
    return root / "jax", root / "port", stats


def test_tiny_fixture_equals_jax(fixtures):
    jdir, pdir, stats = fixtures
    want, got = np_load_file(str(jdir / "model.safetensors")), load_safetensors(str(pdir))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert _np_equal(got[name], w), name
    assert stats["weight_bytes"] == sum(w.nbytes for w in want.values())
    for name in ("config.json", "tokenizer.json", "tokenizer_config.json",
                 "special_tokens_map.json"):
        with open(jdir / name, encoding="utf-8") as a, open(pdir / name, encoding="utf-8") as b:
            assert json.load(a) == json.load(b), name
    # the stamp makes a second call a no-op
    assert make_flagship_fixture.make_fixture(str(pdir), tiny=True) == stats
    assert os.path.exists(pdir / ".fixture_complete.json")


def test_tiny_fixture_tokenizer_loads_in_tokenizers(fixtures):
    jdir, pdir, stats = fixtures
    oracle = Tokenizer.from_file(str(pdir / "tokenizer.json"))
    assert oracle.get_vocab_size(with_added_tokens=True) == stats["tokenizer_vocab"] == 1280
    jax_tok = JaxHFTextTokenizer.from_pretrained(str(jdir))
    port_tok = HFTextTokenizer.from_pretrained(str(pdir))
    for text in ["Could you please help me explain my ECG?", "The heart rate is 72 bpm.",
                 "Ünïcödé — straße 🫀 1234567", "  tabs\tand\nnewlines  ", ""]:
        ids = oracle.encode(text).ids
        assert jax_tok.encode(text) == ids == port_tok.encode(text), text
        assert port_tok.decode(ids, skip_special_tokens=True) == text
