"""``--dis`` through the port's CLIs on the CPU: two gloo ranks (``--device
cpu --gpus 0,0``) against one process.

- ``cli.main``: 7 training records at a global batch of 4 (the second batch
  of each epoch is short: 2 rows on rank 0, 1 on rank 1), LoRA dropout on.
  The per-epoch losses within rtol 1e-6 and the same on both ranks;
  ``best_model``'s adapters within 1e-6 of the largest; every checkpoint
  written by rank 0 alone, as often as one process writes it;
- a record that fails to load (``python -m ecg_byte_tpu_torch.cli.main``,
  a subprocess): the batch it leaves empty is skipped by both ranks, the
  batch it shares trains the rest, and the losses are one process's;
- a rank that raises at its second step ends the run with an error within
  60 s (the others are ended, not left waiting in a collective);
- a ``--tp`` that does not divide the KV heads, an ``--fsdp`` that does not
  divide the ranks, and a global batch the ranks cannot split, are refused
  with their messages;
- ``cli.pretrain --model resnet`` (synced BatchNorm, gathered MERL losses)
  and ``cli.finetune`` (the fusion LLM): the saved trees within 1e-5 of
  their largest, the losses within rtol 1e-5.

The ranks run one torch thread each (``OMP_NUM_THREADS=1``); each test
fails past ``TIME_LIMIT_S``, its ranks killed.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch_ddp_ranks as ranks

from ecg_byte_tpu_torch.cli import dist
from ecg_byte_tpu_torch.cli import finetune as cli_finetune
from ecg_byte_tpu_torch.cli import main as cli_main
from ecg_byte_tpu_torch.cli import pretrain as cli_pretrain
from ecg_byte_tpu_torch.models.lora import leaves
from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
from ecg_byte_tpu_torch.tokenizer import BpeTokenizer
from ecg_byte_tpu_torch.train import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = ["--device", "cpu", "--peft", "--dev", "--model", "tiny-llama", "--dataset", "ptb_500",
        "--tokenizer_check", "tokenizer_60", "--num_merges", "60", "--percentiles",
        "data/ptb_500_dataset_stats.npy", "--batch_size", "4", "--pad_to_max", "300"]
PRETRAIN = ["--device", "cpu", "--model", "resnet", "--dataset", "ptb_500", "--batch_size", "4",
            "--dev", "--tiny", "--image_size", "32"]
FINETUNE = ["--device", "cpu", "--model", "resnet_model", "--llm", "tiny-llama", "--dataset",
            "ptb_500", "--batch_size", "4", "--dev", "--tiny", "--image_size", "32",
            "--pad_to_max", "120"]
DIS = ["--dis", "--gpus", "0,0", "--ports", "0"]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """7 training, 3 validation and 3 test records and a 60-merge tokenizer."""
    root = tmp_path_factory.mktemp("ddp_cli")
    r = subprocess.run([sys.executable, "-m", "ecg_byte_tpu_torch.cli.make_synthetic",
                        "--n_train", "7", "--n_val", "3", "--n_test", "3", "--seg_len", "60"],
                       cwd=root, env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    stats = np.load(root / "data/ptb_500_dataset_stats.npy", allow_pickle=True).item()
    with open(root / "data/sampled_ecg_files_7.txt") as f:
        sigs = np.stack([np.load(root / p) for p in f.read().split()])
    _, q = normalize_quantize(torch.from_numpy(sigs), stats["percentile_1"],
                              stats["percentile_99"])
    BpeTokenizer.train(quantized_to_string(q), 60).save(str(root / "data/tokenizer_60.pkl"))
    return root


TIME_LIMIT_S = 240  # each test's, past which it fails and its ranks are killed


def _over_time(signum, frame):
    raise TimeoutError(f"over the test's {TIME_LIMIT_S} s")


@pytest.fixture
def run_in(tmp_path, data, monkeypatch):
    """A fresh working directory holding ``data/``; one torch thread here and
    in the ranks this process spawns; the test's time limit."""
    shutil.copytree(data / "data", tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads, sigterm = torch.get_num_threads(), signal.getsignal(signal.SIGTERM)
    alarm = signal.signal(signal.SIGALRM, _over_time)
    signal.alarm(TIME_LIMIT_S)
    torch.set_num_threads(1)
    try:
        yield tmp_path
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, alarm)
        torch.set_num_threads(threads)
        signal.signal(signal.SIGTERM, sigterm)  # cli.main turns SIGTERM into an exception


def _tree(path):
    return torch.load(path, map_location="cpu", weights_only=True)["state"]


def _close_trees(got, want, tol):
    """Every tensor of ``got`` within ``tol`` of the largest of ``want``."""
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= tol * top


def test_cli_main_dis_matches_one_process(run_in):
    before = len(checkpoint.written)
    one = cli_main.main(MAIN)["training"]
    roles = checkpoint.written[before:]
    one_best = _tree(os.path.join(one["directory"], "best_model.pt"))["trainable"]
    shutil.rmtree("runs")
    out = cli_main.main(MAIN + DIS + ["--profile", "trace"])
    r0, r1 = out["ranks"]
    assert (r0["rank"], r1["rank"], r0["backend"]) == (0, 1, "gloo")
    # --profile: one trace file a rank, the rank in its name
    assert sorted(p.split(".")[0] for p in os.listdir("trace")) == ["rank0", "rank1"]
    for r in (r0, r1):
        got = r["training"]
        assert got["steps"] == one["steps"] == 4 and got["tokens"] == one["tokens"]
        np.testing.assert_allclose(got["train_loss"], one["train_loss"], rtol=1e-6)
        np.testing.assert_allclose(got["val_loss"], one["val_loss"], rtol=1e-6)
    assert r0["training"]["train_loss"] == r1["training"]["train_loss"]
    assert r0["training"]["val_loss"] == r1["training"]["val_loss"]
    # rank 0 wrote every checkpoint one process writes, rank 1 none
    assert r0["written"] == roles and "crash_model" in roles and r1["written"] == []
    best = _tree(os.path.join(out["training"]["directory"], "best_model.pt"))["trainable"]
    _close_trees(best, one_best, 1e-6)


def test_cli_main_dis_skips_a_bad_batch_on_every_rank(run_in, capsys):
    """Global batch 2: one record a rank.  Record 1's text fails to load.
    In epoch 0 it is the short last batch, on rank 0 alone: both ranks skip
    that step, as one process does.  In epoch 1 it shares a batch with
    record 4 (rank 1's): the step trains record 4 alone, rank 0 holding no
    row, as one process trains it.  So the ranks' steps and losses are one
    process's."""
    texts = sorted((run_in / "data/ptb_500/text/train").iterdir())
    texts[1].write_text("{not json")
    argv = [a if a != "4" else "2" for a in MAIN]
    capsys.readouterr()
    one = cli_main.main(argv)["training"]
    assert capsys.readouterr().out.count("Skipping invalid batch") == 1
    assert one["steps"] == 3 + 4
    shutil.rmtree("runs")
    r = subprocess.run([sys.executable, "-m", "ecg_byte_tpu_torch.cli.main", *argv, *DIS],
                       cwd=run_in, env=_env(), capture_output=True, text=True,
                       timeout=TIME_LIMIT_S - 60)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    # two ranks and the data loader's thread share stdout: count what was
    # printed, wherever a line of another writer put it
    summaries = [json.loads(m) for m in
                 re.findall(r"Training on cpu: (\{[^{}]*\})", r.stdout)]
    assert len(summaries) == 2 and summaries[0] == {**summaries[1],
                                                    "seconds": summaries[0]["seconds"]}
    assert summaries[0]["steps"] == one["steps"] and summaries[0]["tokens"] == one["tokens"]
    np.testing.assert_allclose(summaries[0]["train_loss"], one["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(summaries[0]["val_loss"], one["val_loss"], rtol=1e-6)
    assert r.stdout.count("Skipping invalid batch") == 2 * 1


def test_cli_dis_rank_that_raises_ends_the_run(run_in):
    args = cli_main.get_args(MAIN + DIS)
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails at step 2"):
        dist.launch(ranks.failing_main_run, args)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("extra,message", [
    (["--tp", "3"], r"--tp 3 must divide the model's num_kv_heads \(2\)"),
    (["--fsdp", "3"], "--tp 1 x --fsdp 3 = 3 must divide the 2 ranks of --dis"),
    (["--batch_size", "3"], "--batch_size 3 is the global batch; --dis over 2 ranks needs a "
                            "multiple of 2"),
], ids=["tp", "fsdp", "indivisible-batch"])
def test_cli_main_dis_refuses(run_in, extra, message):
    with pytest.raises(SystemExit, match=message):
        cli_main.main(MAIN + DIS + extra)


def test_cli_pretrain_dis_matches_one_process(run_in):
    one = cli_pretrain.main(PRETRAIN)
    want = _tree(os.path.join(one["directory"], "best_model.pt"))
    shutil.rmtree("runs")
    out = cli_pretrain.main(PRETRAIN + DIS)
    for r in out["ranks"]:
        np.testing.assert_allclose(r["train_loss"], one["train_loss"], rtol=1e-5)
        assert r["steps"] == one["steps"] == 4
    got = _tree(os.path.join(out["directory"], "best_model.pt"))
    _close_trees(got["trainable"], want["trainable"], 1e-5)
    _close_trees(got["bn_state"], want["bn_state"], 1e-5)
    assert out["ranks"][1]["written"] == [] and out["ranks"][0]["written"] == ["best_model"] * 2


def test_cli_finetune_dis_matches_one_process(run_in):
    one = cli_finetune.main(FINETUNE)["training"]
    want = _tree(os.path.join(one["directory"], "best_model.pt"))
    shutil.rmtree("runs")
    out = cli_finetune.main(FINETUNE + DIS)
    for r in out["ranks"]:
        got = r["training"]
        np.testing.assert_allclose(got["train_loss"], one["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["val_loss"], one["val_loss"], rtol=1e-5)
    _close_trees(_tree(os.path.join(out["training"]["directory"], "best_model.pt")), want, 1e-5)
    assert out["ranks"][1]["written"] == [] and "crash_model" in out["ranks"][0]["written"]
