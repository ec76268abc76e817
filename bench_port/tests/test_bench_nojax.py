"""The check for JAX and the JAX package compares whole top-level names,
and the plain reference imports nothing of the program."""

import subprocess
import sys

import pytest

from bench_port import harness


@pytest.mark.parametrize("modules, found", [
    (["ecg_byte_tpu_torch", "ecg_byte_tpu_torch.x", "torch", "numpy"], []),
    (["ecg_byte_tpu.x"], ["ecg_byte_tpu"]),
    (["ecg_byte_tpu"], ["ecg_byte_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "ecg_byte_tpu_x"], []),
])
def test_foreign_modules(modules, found):
    assert harness.foreign_modules(modules) == found


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import bench_port.reference.model, bench_port.reference.train\n"
            "import bench_port.reference.serve, bench_port.reference.precision\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}"
            " & {'ecg_byte_tpu_torch', 'ecg_byte_tpu', 'jax', 'jaxlib', 'flax'})\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    root = harness.ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_harness_run_loads_no_jax(tmp_path):
    """A whole toy run in a fresh process loads neither JAX nor the JAX
    package."""
    code = ("import sys, time; sys.path.insert(0, '.'); sys.path.insert(0, 'bench_port/tests')\n"
            "from tiny import make_here, TINY_BENCH\n"
            "from bench_port import harness\n"
            f"here = make_here({str(tmp_path / 'b')!r})\n"
            "r = harness.run('tiny-llama.serve', 3, 0.1, False, device='cpu',"
            " t0=time.perf_counter(), bench=TINY_BENCH, here=here)\n"
            "print(r['correct'], harness.foreign_modules())\n"
            "sys.exit(0 if r['correct'] and not harness.foreign_modules() else 1)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
