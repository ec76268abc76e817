"""Tracing utilities: the counterpart of ``ecg_byte_tpu/utils/profiling.py``
in PyTorch's idiom.

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  writes one Chrome trace file (``*.pt.trace.json``: Perfetto,
  ``chrome://tracing`` or TensorBoard's profiler plugin open it) into a
  directory; ``cli.main --profile DIR`` traces its epoch loop with it;
- :func:`span`: the program's own named ranges (``ecg.*``), which land in
  a trace as ``user_annotation`` events on the kernels' clock while a
  profiler records, and cost one flag read when none does;
- :func:`record` and :func:`records`: a bounded in-memory log of host-clock
  readings by kind (``greedy_generate`` logs each call under ``"decode"``);
- :func:`log_live_bytes`: the bytes live on a device, which ``cli.main``
  prints under ``ECG_BYTE_LOG_MEMORY=1``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import os
import re
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

# a kernel's event in the Chrome trace that torch.profiler exports
_KERNEL_EVENT = re.compile(rb'"cat"\s*:\s*"kernel"')

# the calls of each kind that record() keeps, the newest last
RECORDS_KEPT = 1024

_OFF = contextlib.nullcontext()
_RECORDS: Dict[str, collections.deque] = {}


def span(name: str):
    """A context manager that marks its block as ``name`` in a trace.

    While a profiler records (``torch.profiler``, :func:`trace`) it is
    ``torch.profiler.record_function(name)``, so the block shows as a
    ``user_annotation`` on the thread that ran it, nested in the spans
    open there, and the kernels it launched correlate to it.  Otherwise it
    is one shared no-op object: no allocation and no call into the
    profiler, which costs several microseconds a range even when off."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def record(kind: str, values: dict) -> None:
    """Append a copy of ``values`` to the log of ``kind``, which keeps the
    last :data:`RECORDS_KEPT`."""
    _RECORDS.setdefault(kind, collections.deque(maxlen=RECORDS_KEPT)).append(dict(values))


def records(kind: str) -> List[dict]:
    """The logged values of ``kind``, oldest first (copies of the log's)."""
    return [dict(v) for v in _RECORDS.get(kind, ())]


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
