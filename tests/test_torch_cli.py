"""The port's CLI end to end on the CPU, in subprocesses: a tiny synthetic
dataset and BPE tokenizer made by the port's own ``make_synthetic`` and
tokenizer, then ``ecg_byte_tpu_torch.cli.main`` serving a random tiny-llama
checkpoint, training with LoRA, serving what it trained, resuming, and
refusing what is not ported."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecg_byte_tpu_torch.cli.common import build_model
from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
from ecg_byte_tpu_torch.tokenizer import BpeTokenizer
from ecg_byte_tpu_torch.train.checkpoint import save_checkpoint
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_ARGS = [
    "--dev", "--model", "tiny-llama", "--dataset", "ptb_500",
    "--tokenizer_check", "tokenizer_60", "--num_merges", "60",
    "--percentiles", "data/ptb_500_dataset_stats.npy",
]
ARGS = ["--inference"] + DATA_ARGS + ["--checkpoint", "ckpt"]
TRAIN = DATA_ARGS + ["--device", "cpu", "--peft", "--online_encode", "--batch_size", "2",
                     "--pad_to_max", "300"]


def _run(args, cwd, module="ecg_byte_tpu_torch.cli.main"):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    r = _run(["--n_train", "6", "--n_val", "2", "--n_test", "3", "--seg_len", "60"],
             root, module="ecg_byte_tpu_torch.cli.make_synthetic")
    assert r.returncode == 0, r.stderr
    stats = np.load(root / "data/ptb_500_dataset_stats.npy", allow_pickle=True).item()
    with open(root / "data/sampled_ecg_files_6.txt") as f:
        sigs = np.stack([np.load(root / p) for p in f.read().split()])
    _, q = normalize_quantize(torch.from_numpy(sigs), stats["percentile_1"],
                              stats["percentile_99"])
    bpe = BpeTokenizer.train(quantized_to_string(q), 60)
    bpe.save(str(root / "data/tokenizer_60.pkl"))
    params, config, _ = build_model("tiny-llama", bpe.vocab, torch.device("cpu"))
    state = create_train_state(config, make_optimizer(config.hidden_size, 500),
                               torch.Generator().manual_seed(0), peft=False, params=params)
    save_checkpoint(str(root / "runs/0/ckpt"), "best_model", state)
    return root


def _summary(stdout, prefix):
    line = [ln for ln in stdout.splitlines() if ln.startswith(prefix)][-1]
    return json.loads(line.split(": ", 1)[1])


def test_inference_cli_on_cpu(workdir):
    r = _run(ARGS + ["--device", "cpu"], workdir)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "Inference Complete" in r.stdout
    ckpt = workdir / "runs/0/ckpt"
    res = json.load(open(ckpt / "seed_42_results_ptb_500.json"))
    assert len(res["qa_results"]["gen_answers"]) == 3
    stats = json.load(open(ckpt / "statistical_analysis_ptb_500.json"))
    assert len(stats["BLEU"]["raw_values"]) == 5
    summary = _summary(r.stdout, "Serving on cpu")
    assert summary["records"] == 15 and summary["prompt_lens"][0] % 128 == 0


@pytest.mark.parametrize(
    "extra,message",
    [
        ([], "no CUDA device"),  # no --device and no card: no CPU fallback
        (["--device", "cpu", "--int8_decode"], "ROADMAP.md queue 1, item 10"),
        (["--device", "cpu", "--dis"], "ROADMAP.md queue 1, item 12"),
    ],
    ids=["no-device", "int8", "dis"],
)
def test_cli_refuses(workdir, extra, message):
    r = _run(ARGS + extra, workdir)
    assert r.returncode != 0
    assert message in r.stderr


def test_training_branch_refused(workdir):
    """Training without --online_encode needs the device token cache (the
    BPE kernels, item 9): refused, with the item named."""
    args = [a for a in TRAIN if a != "--online_encode"]
    r = _run(args, workdir)
    assert r.returncode != 0 and "ROADMAP.md queue 1, item 9" in r.stderr
    r = _run([a for a in TRAIN if a not in ("--device", "cpu")], workdir)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


@pytest.fixture(scope="module")
def trained(workdir):
    r = _run(TRAIN, workdir)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return _summary(r.stdout, "Training on cpu")


def test_train_cli_then_serve(workdir, trained):
    """--peft --online_encode --dev trains 2 epochs of 3 steps, writes the
    checkpoint roles and the loss record; --inference --peft serves it."""
    assert trained["steps"] == 6 and trained["tokens"] == 6 * 2 * 304
    assert len(trained["train_loss"]) == len(trained["val_loss"]) == 2
    assert all(np.isfinite(trained["train_loss"] + trained["val_loss"]))
    run_dir = workdir / trained["directory"]
    for name in ("best_model.pt", "crash_model.pt", "train_val_loss.json"):
        assert (run_dir / name).exists(), name
    record = json.load(open(run_dir / "train_val_loss.json"))
    assert record == {"train_loss": trained["train_loss"], "val_loss": trained["val_loss"]}
    best = torch.load(run_dir / "best_model.pt", weights_only=True)
    assert not best["mutable_only"] and best["state"]["base"] is not None
    assert all(layer[n]["b"].abs().max() > 0
               for layer in best["state"]["trainable"]["layers"] for n in layer)
    crash = torch.load(run_dir / "crash_model.pt", weights_only=True)
    assert crash["mutable_only"] and crash["epoch"] == 1 and "base" not in crash["state"]
    r = _run(["--inference", "--peft", "--device", "cpu", "--checkpoint",
              os.path.basename(trained["directory"])] + DATA_ARGS, workdir)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert _summary(r.stdout, "Serving on cpu")["records"] == 15


def test_resume_crash_model(workdir, trained):
    """--resume crash_model continues at the epoch after the saved one, from
    the saved step (here a crash after epoch 0 is simulated by rewriting
    the saved epoch)."""
    path = workdir / trained["directory"] / "crash_model.pt"
    ckpt = torch.load(path, weights_only=True)
    ckpt["epoch"] = 0
    torch.save(ckpt, path)
    r = _run(TRAIN + ["--resume", "crash_model"], workdir)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert f"Resumed crash_model at epoch 1 (step {ckpt['state']['step']})" in r.stdout
    summary = _summary(r.stdout, "Training on cpu")
    assert summary["start_epoch"] == 1 and summary["steps"] == 3
    assert len(summary["train_loss"]) == 1
