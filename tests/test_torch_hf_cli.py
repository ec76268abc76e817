"""``--hf_weights`` end to end on the CPU against the JAX package, on the
tiny size-exact Llama-3.2-1B directory (``make_flagship_fixture --tiny``)
and a tiny synthetic dataset:

- ``ECGTokenDataset`` items built with the checkpoint's tokenizer equal the
  JAX package's: ids, labels and masks, training and inference items;
- ``build_model(hf_weights=)`` equals the JAX ``build_model`` after
  conversion: the ECG tokens registered on the HF tokenizer, the
  embedding grown by mean rows, bit for bit in bf16;
- one ``cli.main --hf_weights --peft --dev`` train-and-serve pair of each
  package on the same directory gives the same losses (within 1e-4
  relative) and the same generated answers.  For the comparison both
  processes load the checkpoint in f32, turn LoRA dropout off and draw
  LoRA A from one numpy stream (the packages' own random streams differ
  by design); everything else is each CLI as a user runs it.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ecg_byte_tpu.cli import common as jax_common
from ecg_byte_tpu.data import datasets as jax_datasets
from ecg_byte_tpu.data.text_tokenizer import load_text_tokenizer as jax_load_text_tokenizer
from ecg_byte_tpu.data.text_tokenizer import register_ecg_tokens as jax_register
from ecg_byte_tpu_torch.cli import common, make_flagship_fixture
from ecg_byte_tpu_torch.data import DataConfig, ECGTokenDataset, load_text_tokenizer
from ecg_byte_tpu_torch.data.text_tokenizer import register_ecg_tokens
from ecg_byte_tpu_torch.models.convert import params_from_jax
from ecg_byte_tpu_torch.models.lora import leaves
from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
from ecg_byte_tpu_torch.tokenizer import BpeTokenizer
from ecg_byte_tpu_torch.utils.file_utils import align_signal_text_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DATA_ARGS = ["--dev", "--model", "fixture", "--dataset", "ptb_500", "--tokenizer_check",
             "tokenizer_60", "--num_merges", "60", "--percentiles",
             "data/ptb_500_dataset_stats.npy"]
TRAIN = ["--peft", "--online_encode", "--batch_size", "2", "--pad_to_max", "300"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The tiny fixture, a synthetic dataset (6/2/3 records of 12 x 60) and
    a 60-merge ECG tokenizer."""
    root = tmp_path_factory.mktemp("hf_cli")
    make_flagship_fixture.make_fixture(str(root / "fixture"), tiny=True)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "ecg_byte_tpu_torch.cli.make_synthetic",
                        "--n_train", "6", "--n_val", "2", "--n_test", "3", "--seg_len", "60"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    stats = np.load(root / "data/ptb_500_dataset_stats.npy", allow_pickle=True).item()
    with open(root / "data/sampled_ecg_files_6.txt") as f:
        sigs = np.stack([np.load(root / p) for p in f.read().split()])
    _, q = normalize_quantize(torch.from_numpy(sigs), stats["percentile_1"],
                              stats["percentile_99"])
    BpeTokenizer.train(quantized_to_string(q), 60).save(str(root / "data/tokenizer_60.pkl"))
    return root


def _bpe(root):
    bpe = BpeTokenizer.load(str(root / "data/tokenizer_60.pkl"))
    return bpe.vocab, bpe.merges


@pytest.mark.parametrize("inference", [False, True], ids=["train", "inference"])
def test_dataset_items_match_jax(workdir, inference):
    vocab, merges = _bpe(workdir)
    mine = load_text_tokenizer(str(workdir / "fixture"))
    theirs = jax_load_text_tokenizer(str(workdir / "fixture"))
    assert register_ecg_tokens(mine, vocab) == jax_register(theirs, vocab)
    split = "test" if inference else "train"
    sigs, texts = align_signal_text_files(str(workdir / f"data/ptb_500/ecg/{split}"),
                                          str(workdir / f"data/ptb_500/text/{split}"))
    stats = str(workdir / "data/ptb_500_dataset_stats.npy")
    ds = ECGTokenDataset(sigs, texts, vocab, merges, tokenizer=mine,
                         args=DataConfig(percentiles=stats, pad_to_max=300, inference=inference))
    ref = jax_datasets.ECGTokenDataset(
        sigs, texts, vocab, merges, tokenizer=theirs,
        args=jax_datasets.DataConfig(percentiles=stats, pad_to_max=300, inference=inference))
    assert len(ds) == len(ref) > 0
    for i in range(len(ds)):
        got, want = ds[i], ref[i]
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if isinstance(w, np.ndarray):
                assert np.array_equal(np.asarray(got[key]), w), (i, key)
            else:
                assert got[key] == w, (i, key)
    # the signal tokens are added tokens of the HF tokenizer, past its vocabulary
    assert max(ds[0]["tokenized_signal"]) >= 1280


def test_build_model_matches_jax(workdir):
    vocab, _ = _bpe(workdir)
    d = str(workdir / "fixture")
    params, config, tok = common.build_model(None, vocab, CPU, hf_weights=d)
    jparams, jconfig, jtok = jax_common.build_model(None, vocab, hf_weights=d)
    assert config.vocab_size == jconfig.vocab_size == len(tok) == len(jtok)
    assert config.vocab_size == 1280 + len(vocab) + 3
    assert config.dtype == "bfloat16"
    ref = params_from_jax(jax.tree.map(np.asarray, jparams), config, CPU)
    got, want = leaves(params), leaves(ref)
    assert len(got) == len(want)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert tok.pad_token == "<pad>" and tok.pad_token_id == jtok.pad_token_id


# Runs a CLI's main() once per argv of a JSON list with the checkpoint
# loaded in f32, LoRA dropout off and LoRA A drawn from one numpy stream.
_SPY = r"""
import importlib, json, sys
import numpy as np
pkg = sys.argv[1]
cli = importlib.import_module(pkg + ".cli.main")
lora = importlib.import_module(pkg + ".models.lora")
real_build = cli.build_model

def build(*args, **kw):
    params, config, tok = real_build(*args, **dict(kw, dtype="float32"))
    return params, config.replace(lora_dropout=0.0), tok

def init_lora(config, *rest):
    rng = np.random.default_rng(0)
    names = [n for n in config.lora_targets if n in lora._PROJ_DIMS
             and not (n == "gate_proj" and config.hidden_act not in ("silu", "gelu_tanh"))]
    draws = {}
    for n in names:
        d_in, d_out = lora._PROJ_DIMS[n](config)
        bound = (1.0 / d_in) ** 0.5
        a = rng.uniform(-bound, bound, (config.num_layers, d_in, config.lora_rank))
        draws[n] = (a.astype(np.float32), np.zeros((config.num_layers, config.lora_rank, d_out),
                                                   np.float32))
    if pkg == "ecg_byte_tpu":
        import jax.numpy as jnp
        return {"layers": {n: {"a": jnp.asarray(a), "b": jnp.asarray(b)}
                           for n, (a, b) in draws.items()}}
    import torch
    return {"layers": [{n: {"a": torch.from_numpy(a[i].copy()), "b": torch.from_numpy(b[i].copy())}
                        for n, (a, b) in draws.items()} for i in range(config.num_layers)]}

cli.build_model = build
lora.init_lora = init_lora
for argv in json.loads(sys.argv[2]):
    sys.argv = [sys.argv[0]] + argv
    cli.main()
"""


def _start(pkg, runs, cwd, env):
    with open(cwd / "cli.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", _SPY, pkg, json.dumps(runs)], cwd=cwd,
                                env=env, stdout=log, stderr=subprocess.STDOUT)


def _losses(log):
    lines = log.splitlines()
    train = [float(lines[i + 1].split(": ")[1]) for i, ln in enumerate(lines)
             if ln.startswith("Training - Epoch")]
    val = [float(lines[i + 1].split(": ")[1]) for i, ln in enumerate(lines)
           if ln.startswith("Validating - Epoch")]
    return train, val


def test_cli_train_and_serve_match_jax(workdir, tmp_path):
    fixture = str(workdir / "fixture")
    train = DATA_ARGS + TRAIN + ["--hf_weights", fixture]
    ckpt = "fixture_ptb_500_0.0001_0.9_0.99_1e-08_0.01_500_2_2_60_300_False"
    serve = DATA_ARGS + ["--inference", "--peft", "--hf_weights", fixture, "--checkpoint", ckpt]
    procs = {}
    for pkg, extra in (("ecg_byte_tpu", []), ("ecg_byte_tpu_torch", ["--device", "cpu"])):
        cwd = tmp_path / pkg
        cwd.mkdir()
        os.symlink(workdir / "data", cwd / "data")
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        env.pop("ECG_BYTE_BERTSCORE_MODEL", None)
        procs[pkg] = (_start(pkg, [train + extra, serve + extra], cwd, env), cwd)
    out = {}
    for pkg, (proc, cwd) in procs.items():
        proc.wait(timeout=600)
        log = (cwd / "cli.log").read_text()
        assert proc.returncode == 0, log[-6000:]
        assert "Inference Complete" in log
        train_loss, val_loss = _losses(log)
        answers = []
        for seed in (0, 42, 123, 456, 789):
            with open(cwd / "runs/0" / ckpt / f"seed_{seed}_results_ptb_500.json") as f:
                answers.append(json.load(f)["qa_results"]["gen_answers"])
        out[pkg] = (train_loss, val_loss, answers)
    (jt, jv, ja), (pt, pv, pa) = out["ecg_byte_tpu"], out["ecg_byte_tpu_torch"]
    assert len(jt) == len(pt) == 2 and len(jv) == len(pv) == 2
    np.testing.assert_allclose(pt, jt, rtol=1e-4)
    np.testing.assert_allclose(pv, jv, rtol=1e-4)
    assert all(len(a) == 3 for a in ja)
    assert pa == ja
