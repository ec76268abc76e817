"""The port runs where JAX is absent: every module of ``ecg_byte_tpu_torch``
imports, and a tiny-llama builds and decodes, in a process where importing
``jax`` fails."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import torch
import ecg_byte_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ecg_byte_tpu_torch.__path__, "ecg_byte_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from ecg_byte_tpu_torch.cli.common import build_model
from ecg_byte_tpu_torch.infer import greedy_generate
params, config, tok = build_model("tiny-llama", {i: chr(i) for i in range(256)}, torch.device("cpu"))
out = greedy_generate(params, config, torch.tensor([[tok.bos_token_id, 65, 66, 67]]), max_new_tokens=4)
assert out.shape == (1, 4)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 20


def test_no_jax_import_statements():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ecg_byte_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders
