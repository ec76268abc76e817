"""The port's serving CLI end to end on the CPU: a tiny synthetic dataset, a
BPE tokenizer, a random tiny-llama checkpoint, then
``ecg_byte_tpu_torch.cli.main --inference`` in a subprocess."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecg_byte_tpu.tokenizer import BpeTokenizer
from ecg_byte_tpu_torch.cli.common import build_model
from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
from ecg_byte_tpu_torch.train.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = [
    "--inference", "--dev", "--model", "tiny-llama", "--dataset", "ptb_500",
    "--tokenizer_check", "tokenizer_60", "--num_merges", "60",
    "--percentiles", "data/ptb_500_dataset_stats.npy", "--checkpoint", "ckpt",
]


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
             root, module="ecg_byte_tpu.cli.make_synthetic")
    assert r.returncode == 0, r.stderr
    stats = np.load(root / "data/ptb_500_dataset_stats.npy", allow_pickle=True).item()
    with open(root / "data/sampled_ecg_files_6.txt") as f:
        sigs = np.stack([np.load(root / p) for p in f.read().split()])
    _, q = normalize_quantize(torch.from_numpy(sigs), stats["percentile_1"],
                              stats["percentile_99"])
    bpe = BpeTokenizer.train(quantized_to_string(q), 60)
    bpe.save(str(root / "data/tokenizer_60.pkl"))
    params, _, _ = build_model("tiny-llama", bpe.vocab, torch.device("cpu"))
    save_checkpoint(str(root / "runs/0/ckpt"), "best_model", params)
    return root


def test_inference_cli_on_cpu(workdir):
    r = _run(ARGS + ["--device", "cpu"], workdir)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "Inference Complete" in r.stdout
    ckpt = workdir / "runs/0/ckpt"
    res = json.load(open(ckpt / "seed_42_results_ptb_500.json"))
    assert len(res["qa_results"]["gen_answers"]) == 3
    stats = json.load(open(ckpt / "statistical_analysis_ptb_500.json"))
    assert len(stats["BLEU"]["raw_values"]) == 5
    serving = [ln for ln in r.stdout.splitlines() if ln.startswith("Serving on cpu")]
    summary = json.loads(serving[0].split(": ", 1)[1])
    assert summary["records"] == 15 and summary["prompt_lens"][0] % 128 == 0


@pytest.mark.parametrize(
    "extra,message",
    [
        ([], "no CUDA device"),  # no --device and no card: no CPU fallback
        (["--device", "cpu", "--int8_decode"], "ROADMAP.md queue 1, item 10"),
        (["--device", "cpu", "--peft"], "ROADMAP.md queue 1, item 3"),
    ],
    ids=["no-device", "int8", "peft"],
)
def test_cli_refuses(workdir, extra, message):
    r = _run(ARGS + extra, workdir)
    assert r.returncode != 0
    assert message in r.stderr


def test_training_branch_refused(workdir):
    args = [a for a in ARGS if a != "--inference"] + ["--device", "cpu"]
    r = _run(args, workdir)
    assert r.returncode != 0 and "training is not ported yet" in r.stderr
