"""Tracing and timing utilities: the counterpart of
``ecg_byte_tpu/utils/profiling.py`` in PyTorch's idiom.

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  writes one Chrome trace file (``*.pt.trace.json``: Perfetto,
  ``chrome://tracing`` or TensorBoard's profiler plugin open it) into a
  directory; ``cli.main --profile DIR`` traces its epoch loop with it;
- :func:`hard_sync`: block until a result is computed by reading one
  element back to the host;
- :class:`StepTimer`: steady-state step times, the first step dropped;
- :func:`log_compile_time`: the wall clock of a first call (on the card the
  one that builds the CUDA kernels);
- :func:`log_live_bytes`: the bytes live on a device, which ``cli.main``
  prints under ``ECG_BYTE_LOG_MEMORY=1``.
"""

from __future__ import annotations

import contextlib
import gc
import os
import re
import time
from typing import Callable, Optional

import numpy as np
import torch

# a kernel's event in the Chrome trace that torch.profiler exports
_KERNEL_EVENT = re.compile(rb'"cat"\s*:\s*"kernel"')


def _device(device) -> torch.device:
    return torch.device(device if device is not None else "cpu")


@contextlib.contextmanager
def trace(log_dir: str, device=None, rank: int = 0):
    """Record the block with ``torch.profiler``: CPU activity, and CUDA
    activity when ``device`` is the card.  Yields the path of the trace
    file, ``<log_dir>/rank<rank>.<pid>.<ms>.pt.trace.json``, which is written
    when the block ends, also when it raises.  On the card a profiler that
    cannot record CUDA activity raises ``RuntimeError`` (before the block,
    or after it where the trace holds no kernel), rather than leave a trace
    of the host alone."""
    from torch.profiler import ProfilerActivity, profile

    device = _device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity here: no trace of "
                               "the card")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"rank{rank}.{os.getpid()}.{time.time_ns() // 10**6}"
                                 ".pt.trace.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(path)
    if device.type == "cuda":
        with open(path, "rb") as f:
            if not _KERNEL_EVENT.search(f.read()):
                raise RuntimeError(f"{path} holds no CUDA kernel: the profiler recorded no "
                                   "activity of the card")


def _first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor leaf of nested dicts (by sorted key, as the JAX
    package's ``jax.tree.leaves``), lists and tuples."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def hard_sync(x) -> float:
    """Block until ``x`` is computed by reading one element of its first
    tensor leaf back to the host."""
    leaf = _first_tensor(x)
    if leaf is None:
        raise ValueError(f"no tensor in {type(x).__name__}")
    return float(leaf.detach().reshape(-1)[0].item())


class StepTimer:
    """Accumulates steady-state step timings.

    Usage::

        timer = StepTimer()
        for batch in loader:
            with timer.step():
                out = step_fn(state, batch)
                timer.sync(out)
        print(timer.summary())
    """

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def sync(self, out) -> None:
        hard_sync(out)

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times[1:] or self.times)  # the first step builds and warms
        return {
            "steps": len(self.times),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }


def log_compile_time(fn: Callable, *args, label: str = "fn") -> float:
    """Time the first call of ``fn`` (on the card the one that builds the
    CUDA kernels it launches), its result read back."""
    t0 = time.perf_counter()
    out = fn(*args)
    hard_sync(out)
    dt = time.perf_counter() - t0
    print(f"[profiling] {label} first call: {dt:.1f}s")
    return dt


def _cpu_tensor_bytes() -> int:
    """The bytes of the CPU tensors that ``gc`` finds alive, each storage
    once (views share theirs)."""
    seen, total = set(), 0
    for obj in gc.get_objects():
        try:
            # type(), not isinstance(): the latter reads __class__, which some
            # objects serve through a deprecated attribute
            if not issubclass(type(obj), torch.Tensor) or obj.device.type != "cpu":
                continue
            storage = obj.untyped_storage()
        except (ReferenceError, RuntimeError, NotImplementedError):
            continue  # a dead weak proxy, or a tensor without a plain storage
        ptr = storage.data_ptr()
        if ptr and ptr not in seen:
            seen.add(ptr)
            total += storage.nbytes()
    return total


def log_live_bytes(tag: str, device=None) -> int:
    """Print and return the bytes live on ``device``: on the card
    ``torch.cuda.memory_allocated`` (with the peak beside it), on the CPU
    the bytes of the live tensors that ``gc`` finds, as ``jax.live_arrays()``
    counts a JAX device's.  ``cli.main`` calls it under
    ``ECG_BYTE_LOG_MEMORY=1``."""
    device = _device(device)
    if device.type == "cuda":
        n = torch.cuda.memory_allocated(device)
        peak = torch.cuda.max_memory_allocated(device)
        print(f"[memory] {tag}: {n / 1e9:.2f} GB live on {device} ({n} bytes; peak {peak} "
              "bytes)", flush=True)
        return n
    n = _cpu_tensor_bytes()
    print(f"[memory] {tag}: {n / 1e9:.2f} GB live on {device} ({n} bytes)", flush=True)
    return n
