"""Parity of the port's 1-D ResNet with the JAX package's.

Both packages run the JAX-initialized ResNet18 (BatchNorm scales, biases
and running statistics perturbed, so layout faults show), carried across
by ``resnet_from_jax``, on the same numpy signals, in f32 on the CPU.

Tolerances: features within 1e-4 relative to their max (f32 convolutions
summed in another order through 20 layers); the BatchNorm running mean and
variance after two training steps within 1e-5 relative, which the unbiased
variance of ``F.batch_norm`` misses by far more (a factor n / (n - 1) on
the batch variance, 1/511 at the stem here, 2e-4 of the running one); the bf16-operand path no further from
the f32 features than 1.25x JAX's bf16 path is (each rounds every conv
output to bf16 after its own f32 sum, so the two differ by about their
own error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.models import resnet1d as JR
from ecg_byte_tpu_torch.models import resnet1d as R
from ecg_byte_tpu_torch.models.convert import resnet_from_jax

CPU = torch.device("cpu")


def _models(variant="resnet18", seed=0):
    jp, js, meta = JR.init_resnet(jax.random.PRNGKey(seed), variant)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "bn" in name:
            if "var" in name:
                return (x + 0.2 * rng.random(x.shape)).astype(np.float32)
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    jp = jax.tree_util.tree_map_with_path(perturb, jax.tree.map(np.asarray, jp))
    js = jax.tree_util.tree_map_with_path(perturb, jax.tree.map(np.asarray, js))
    p, s = resnet_from_jax(jp, js, CPU)
    return jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, js), meta, p, s


def _signals(b=4, length=256, seed=1):
    return np.random.default_rng(seed).normal(size=(b, 12, length)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(train):
    jp, js, meta, p, s = _models()
    x = _signals()
    want, _ = JR.resnet_forward(jp, js, meta, jnp.asarray(x), train=train)
    got, _ = R.resnet_forward(p, s, meta, torch.from_numpy(x), train=train)
    assert got.shape == want.shape == (4, 512, 16)
    assert _rel(got.numpy(), want) < 1e-4


def test_bn_state_after_two_steps_matches_jax():
    """The running statistics after two training forwards, each on the
    state the last returned: the JAX package's biased-variance update."""
    jp, js, meta, p, s = _models(seed=2)
    for step in range(2):
        x = _signals(seed=10 + step)
        _, js = JR.resnet_forward(jp, js, meta, jnp.asarray(x), train=True)
        _, s = R.resnet_forward(p, s, meta, torch.from_numpy(x), train=True)
    want = jax.tree_util.tree_leaves_with_path(js)
    for path, w in want:
        node = s
        for key in path:
            node = node[key.key]
        got = node.numpy()
        w = np.asarray(w)
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), jax.tree_util.keystr(path)


def test_bf16_operands_match_jax(monkeypatch):
    """ECG_BYTE_RESNET_BF16=1 in both packages: bf16 conv operands, f32
    output, statistics and residual sums."""
    jp, js, meta, p, s = _models(seed=3)
    x = _signals(seed=4)
    f32, _ = JR.resnet_forward(jp, js, meta, jnp.asarray(x), train=True)
    monkeypatch.setenv("ECG_BYTE_RESNET_BF16", "1")
    want, _ = JR.resnet_forward(jp, js, meta, jnp.asarray(x), train=True)
    got, _ = R.resnet_forward(p, s, meta, torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32
    own = _rel(want, f32)
    assert 1e-4 < own < 5e-2  # the path rounds: it is not the f32 one
    assert _rel(got.numpy(), f32) <= 1.25 * own


def test_gradients_match_jax():
    jp, js, meta, p, s = _models(seed=5)
    x = _signals(b=2, length=128, seed=6)

    def jloss(jp):
        y, _ = JR.resnet_forward(jp, js, meta, jnp.asarray(x), train=True)
        return jnp.mean(jnp.square(y))

    want = jax.grad(jloss)(jp)
    p = jax.tree.map(lambda t: t.requires_grad_(True), p)
    y, _ = R.resnet_forward(p, s, meta, torch.from_numpy(x), train=True)
    y.square().mean().backward()
    for name in ("stem_conv", "s0b0", "s3b1"):
        for path, w in jax.tree_util.tree_leaves_with_path(want[name]):
            node = p[name]
            for key in path:
                node = node[key.key]
            assert _rel(node.grad.numpy(), w) < 1e-3, (name, jax.tree_util.keystr(path))


_FLAGS = r"""
import sys, torch
from ecg_byte_tpu_torch.models import resnet1d as R
legacy = sys.argv[1] == "legacy"
cudnn = torch.backends.cudnn
read = (lambda: cudnn.allow_tf32) if legacy else (lambda: cudnn.conv.fp32_precision)
if legacy:
    cudnn.allow_tf32 = True
else:
    cudnn.conv.fp32_precision = "tf32"
before, seen, conv1d = read(), [], R.F.conv1d

def spy(*args, **kwargs):
    seen.append((cudnn.allow_tf32, cudnn.conv.fp32_precision))
    return conv1d(*args, **kwargs)

R.F.conv1d = spy
R.conv1d(torch.ones(1, 2, 8), torch.ones(3, 2, 3))
assert len(seen) == 1 and seen[0][0] is False and seen[0][1] != "tf32", seen
assert read() == before, read()
print("ok")
"""


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_f32_conv_runs_with_tf32_off_and_restores_the_flags(api):
    """The f32 conv runs with cuDNN's TF32 off whichever API the process
    used to allow it, and the process's setting is back after the call (a
    fresh process for each API: torch refuses a process that mixes them)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _FLAGS, api], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


_BACKWARD_FLAGS = r"""
import sys, torch
from ecg_byte_tpu_torch.models import resnet1d as R
legacy = sys.argv[1] == "legacy"
cudnn = torch.backends.cudnn
read = (lambda: cudnn.allow_tf32) if legacy else (lambda: cudnn.conv.fp32_precision)
if legacy:
    cudnn.allow_tf32 = True
else:
    cudnn.conv.fp32_precision = "tf32"
before, seen = read(), []

def spying(fn):
    def spy(*args, **kwargs):
        seen.append((fn.__name__, cudnn.allow_tf32, cudnn.conv.fp32_precision))
        return fn(*args, **kwargs)
    return spy

for name in ("conv1d_input", "conv1d_weight", "conv2d_input", "conv2d_weight"):
    setattr(torch.nn.grad, name, spying(getattr(torch.nn.grad, name)))
x = torch.ones(1, 2, 8, requires_grad=True)
w = torch.ones(3, 2, 3, requires_grad=True)
R.conv1d(x, w, padding=1).sum().backward()
img = torch.ones(1, 3, 8, 8, requires_grad=True)
k = torch.ones(4, 3, 4, 4, requires_grad=True)
R.conv_f32(img, k, stride=4).sum().backward()
assert sorted(n for n, _, _ in seen) == ["conv1d_input", "conv1d_weight", "conv2d_input",
                                         "conv2d_weight"], seen
assert all(a is False and p != "tf32" for _, a, p in seen), seen
assert read() == before, read()
# the products are the convolution's own gradients
x2 = x.detach().requires_grad_(True)
w2 = w.detach().requires_grad_(True)
torch.nn.functional.conv1d(x2, w2, padding=1).sum().backward()
assert torch.equal(x.grad, x2.grad) and torch.equal(w.grad, w2.grad)
print("ok")
"""


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_f32_conv_backward_runs_with_tf32_off(api):
    """Both products of the conv's backward (the ResNet's and the ViT
    patch embedding's) run with cuDNN's TF32 off too, and give the
    convolution's own gradients: autograd runs the backward after the
    forward restored the process's setting."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _BACKWARD_FLAGS, api], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr
