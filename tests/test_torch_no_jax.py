"""The port stands alone: in a process where importing ``jax`` or anything of
``ecg_byte_tpu`` fails, every module of ``ecg_byte_tpu_torch`` and
``chip_smoke`` imports, ``chip_smoke``'s data helper builds the synthetic
dataset and tokenizer on the CPU, a tiny-llama decodes and takes a LoRA
train step, and no source line imports either package."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["ecg_byte_tpu"] = None  # and so does any `import ecg_byte_tpu...`
import torch
import ecg_byte_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ecg_byte_tpu_torch.__path__, "ecg_byte_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from ecg_byte_tpu_torch.cli.common import build_model
from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step
with tempfile.TemporaryDirectory() as root:
    vocab, merges = chip_smoke.make_data(root, n_train=4, n_val=1, n_test=1, seg_len=60,
                                         num_merges=30)
    assert os.path.exists(os.path.join(root, "data", "tokenizer_30.pkl"))
cpu = torch.device("cpu")
params, config, tok = build_model("tiny-llama", vocab, cpu)
out = greedy_generate(params, config, torch.tensor([[tok.bos_token_id, 65, 66, 67]]), max_new_tokens=4)
assert out.shape == (1, 4)
opt = make_optimizer(config.hidden_size, 2)
state = create_train_state(config, opt, torch.Generator().manual_seed(0), peft=True, params=params)
ids = torch.randint(0, config.vocab_size, (2, 16))
batch = {"input_ids": ids, "attn_mask": torch.ones(2, 16, dtype=torch.int32), "labels": ids}
state, loss = make_train_step(config, opt)(state, batch, torch.Generator().manual_seed(1))
assert state.step == 1 and torch.isfinite(loss)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "ecg_byte_tpu"))
assert loaded == ["ecg_byte_tpu", "jax"], loaded
assert sys.modules["jax"] is None and sys.modules["ecg_byte_tpu"] is None
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 30


def test_no_jax_import_statements():
    """No source line of the port or chip_smoke imports JAX or the JAX
    package (``ecg_byte_tpu_torch`` itself does not match)."""
    pattern = re.compile(r"^\s*(import jax|from jax|(import|from) ecg_byte_tpu(\.|\s))", re.M)
    assert not pattern.search("import ecg_byte_tpu_torch.ops\nfrom ecg_byte_tpu_torch import x\n")
    assert pattern.search("from ecg_byte_tpu.tokenizer import x\n")
    assert pattern.search("  import ecg_byte_tpu\n")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ecg_byte_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders
