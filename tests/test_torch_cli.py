"""The port's CLI end to end on the CPU, in subprocesses: a tiny synthetic
dataset and BPE tokenizer made by the port's own ``make_synthetic`` and
tokenizer, then ``ecg_byte_tpu_torch.cli.main`` serving a random tiny-llama
checkpoint, training with LoRA (from the token cache and with
``--online_encode``), serving what it trained, resuming, and refusing what is
not ported or not allowed."""

import json
import os
import shutil
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


def _run(args, cwd, module="ecg_byte_tpu_torch.cli.main", **env_vars):
    # one thread: the tiny models gain nothing from more, and the test
    # workers already share the cores
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", **env_vars)
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
    lora_state = create_train_state(config, make_optimizer(config.hidden_size, 500),
                                    torch.Generator().manual_seed(0), peft=True, params=params)
    save_checkpoint(str(root / "runs/0/ckpt_lora"), "best_model", lora_state)
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
    "argv,message",
    [
        (ARGS, "no CUDA device"),  # no --device and no card: no CPU fallback
        # int8 serving quantizes merged weights only (the JAX CLI's rule)
        (ARGS + ["--device", "cpu", "--peft", "--checkpoint", "ckpt_lora", "--int8_decode",
                 "--no_merge_lora"],
         "--int8_decode requires merged adapters; drop --no_merge_lora"),
        # training under --dis --tp: T must divide the KV heads (tiny-llama's 2),
        # refused before any rank starts (serving ignores --dis)
        (TRAIN + ["--dis", "--gpus", "0,0,0,0", "--tp", "4"],
         "--tp 4 must divide the model's num_kv_heads (2)"),
    ],
    ids=["no-device", "int8", "dis"],
)
def test_cli_refuses(workdir, argv, message):
    r = _run(argv, workdir)
    assert r.returncode != 0
    assert message in r.stderr


def test_training_branch_refused(workdir, trained, tmp_path):
    """Training without --online_encode, the default, builds the device
    token cache (on --device cpu, the BPE kernels' plain versions) and
    trains to the same train and val losses as --online_encode; without
    --device and without a card it is refused, as every run is."""
    os.symlink(workdir / "data", tmp_path / "data")  # its own runs/ beside the same data
    r = _run([a for a in TRAIN if a != "--online_encode"], tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    cached = _summary(r.stdout, "Training on cpu")
    assert cached["steps"] == trained["steps"] and cached["tokens"] == trained["tokens"]
    assert cached["train_loss"] == trained["train_loss"]
    assert cached["val_loss"] == trained["val_loss"]
    r = _run([a for a in TRAIN if a not in ("--device", "cpu")], workdir)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


# runs a CLI's main() once per argv of its JSON list, printing the epochs
# each run hands save_crash_checkpoint
_CRASH_SPY = """
import importlib, json, sys
cli = importlib.import_module(sys.argv[1])
real = cli.save_crash_checkpoint
def spy(*args, **kw):
    source = real(*args, **kw)
    print("CRASH_SAVE " + json.dumps(dict(epoch=kw["epoch"], fallback_epoch=kw["fallback_epoch"],
                                          source=source)), flush=True)
    return source
cli.save_crash_checkpoint = spy
for argv in json.loads(sys.argv[2]):
    sys.argv = [sys.argv[0]] + argv
    cli.main()
"""


def _start_crash_spy(module, runs, cwd, env):
    # the output goes to a file, since nothing reads it while the run goes on
    with open(cwd / "crash_spy.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", _CRASH_SPY, module, json.dumps(runs)],
                                cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT)
    proc.log = cwd / "crash_spy.log"
    return proc


def _crash_saves(proc):
    proc.wait(timeout=300)
    out = proc.log.read_text()
    assert proc.returncode == 0, out[-6000:]
    return [json.loads(ln.split(" ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("CRASH_SAVE ")]


@pytest.fixture(scope="module")
def jax_crash_run(workdir, tmp_path_factory):
    """The JAX CLI, as tests/test_cli_e2e.py runs it, on the port's data:
    the same 2-epoch run as ``trained``, then a --resume crash_model that
    finds no epoch left, in one process under the crash-save spy.  It is
    started before the port's run and read by test_crash_epoch_matches_jax,
    so that its imports and compiles run beside the port's training."""
    cwd = tmp_path_factory.mktemp("jax_crash")
    os.symlink(workdir / "data", cwd / "data")
    train = [a for a in TRAIN if a not in ("--device", "cpu")]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = _start_crash_spy("ecg_byte_tpu.cli.main",
                            [train, train + ["--resume", "crash_model"]], cwd, env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def trained(workdir, jax_crash_run):
    """The training run, traced (``--profile``) and with its memory readings
    (``ECG_BYTE_LOG_MEMORY=1``); its output is kept in ``trained.log``."""
    r = _run(TRAIN + ["--profile", "trace"], workdir, ECG_BYTE_LOG_MEMORY="1")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    (workdir / "trained.log").write_text(r.stdout)
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
    assert crash["mutable_only"] and crash["epoch"] == 2 and "base" not in crash["state"]
    r = _run(["--inference", "--peft", "--device", "cpu", "--checkpoint",
              os.path.basename(trained["directory"])] + DATA_ARGS, workdir)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert _summary(r.stdout, "Serving on cpu")["records"] == 15


def test_train_cli_profile_and_memory_lines(workdir, trained):
    """--profile wrote one Chrome trace of the epoch loop (the six steps'
    forwards and backwards among its CPU events), and ECG_BYTE_LOG_MEMORY=1
    printed the JAX CLI's three readings, each a positive byte count."""
    out = (workdir / "trained.log").read_text()
    assert "Profiler trace written to trace" in out
    (path,) = (workdir / "trace").glob("rank0.*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert len(events) > 1000
    assert sum(n == "autograd::engine::evaluate_function: RMSNormBackward" for n in names) > 0
    lines = [ln for ln in out.splitlines() if ln.startswith("[memory] ")]
    tags = [ln.split(": ", 1)[0][len("[memory] "):] for ln in lines]
    assert tags == ["after model build + ECG-token resize",
                    "after train-state creation (params + opt state)",
                    "after first training epoch"], lines
    for ln in lines:
        assert ln.endswith(" bytes)") and "live on cpu" in ln
        assert int(ln.rsplit("(", 1)[1].split()[0]) > 0


def test_crash_epoch_matches_jax(workdir, trained, jax_crash_run, tmp_path):
    """F3: the port's crash_model records the epoch the JAX CLI records.
    After the same 2-epoch --dev run on the same data both save this run's
    count of epochs, 2; a --resume crash_model that finds no epoch left
    hands save_crash_checkpoint the same live epoch (0) and snapshot
    fallback (start_epoch, 3) in both CLIs."""
    os.symlink(workdir / "data", tmp_path / "data")
    # the port: the module's trained run, resumed from a copy of its run dir
    crash = torch.load(workdir / trained["directory"] / "crash_model.pt", weights_only=True)
    shutil.copytree(workdir / trained["directory"], tmp_path / trained["directory"])
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    port = _start_crash_spy("ecg_byte_tpu_torch.cli.main",
                            [TRAIN + ["--resume", "crash_model"]], tmp_path, env)
    port, ref = _crash_saves(port), _crash_saves(jax_crash_run)
    assert ref[0] == {"epoch": 2, "fallback_epoch": 1, "source": "live"}
    assert crash["epoch"] == ref[0]["epoch"]
    assert ref[1] == {"epoch": 0, "fallback_epoch": 3, "source": "live"}
    assert port == ref[1:]


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
