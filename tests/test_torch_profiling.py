"""``ecg_byte_tpu_torch/utils/profiling.py`` on the CPU: the twin of
``tests/test_env.py::test_profiling_utilities`` (a step timer's summary,
the first call's time, a trace written and read back), the summary against
the JAX package's ``StepTimer`` on the same step times, the bytes of live
CPU tensors, and the refusals of a trace of the card that holds none of
its activity."""

import json
import os

import pytest
import torch

from ecg_byte_tpu.utils import profiling as jax_profiling
from ecg_byte_tpu_torch.utils import profiling


def _matmul_sum(a):
    return (a @ a).sum()


def test_profiling_utilities(tmp_path):
    timer = profiling.StepTimer()
    x = torch.ones(64, 64)
    for _ in range(3):
        with timer.step():
            out = _matmul_sum(x)
            timer.sync(out)
    s = timer.summary()
    assert s["steps"] == 3 and s["mean_s"] > 0

    dt = profiling.log_compile_time(_matmul_sum, x, label="matmul")
    assert dt > 0

    with profiling.trace(str(tmp_path / "trace")) as path:
        _matmul_sum(x)
    assert os.path.dirname(path) == str(tmp_path / "trace") and path.endswith(".pt.trace.json")
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]]
    assert "aten::matmul" in names and "aten::sum" in names


def test_step_timer_summary_matches_jax():
    """The same step times give the JAX package's summary: the first step
    dropped, mean, p50 and p95."""
    times = [2.5, 0.125, 0.25, 0.5, 0.0625]
    ours, theirs = profiling.StepTimer(), jax_profiling.StepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    one = profiling.StepTimer()
    one.times = [0.5]  # a single step is kept
    assert one.summary()["mean_s"] == 0.5 and profiling.StepTimer().summary() == {}


def test_hard_sync_reads_the_first_leaf():
    tree = {"b": [torch.tensor([7.0, 8.0])], "a": (None, torch.tensor([[3, 4]]))}
    assert profiling.hard_sync(tree) == 3.0  # sorted keys, as jax.tree.leaves
    with pytest.raises(ValueError):
        profiling.hard_sync({"a": None})


def test_log_live_bytes_counts_a_tensor_made_for_it(capsys):
    before = profiling.log_live_bytes("before", "cpu")
    t = torch.zeros(1 << 20)  # 4 MiB
    view = t[1:]  # shares t's storage: counted once
    after = profiling.log_live_bytes("after", "cpu")
    assert after - before >= t.untyped_storage().nbytes()
    assert after - before < 2 * t.untyped_storage().nbytes()
    del t, view
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"[memory] before: {before / 1e9:.2f} GB live on cpu ({before} bytes)"
    assert out[1].startswith("[memory] after: ") and out[1].endswith(f"({after} bytes)")


def test_trace_of_the_card_refuses_a_profiler_without_it(tmp_path, monkeypatch):
    """On the card: a profiler that cannot record CUDA activity raises before
    the block, and a trace that holds no kernel raises after it."""
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.profiler, "supported_activities", lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot record CUDA"):
        with profiling.trace(str(tmp_path / "none"), "cuda"):
            pass

    class HostOnly:  # records the host, as a CPU-only trace would
        def __init__(self, activities):
            assert ProfilerActivity.CUDA in activities

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            json.dump({"traceEvents": [{"cat": "cpu_op", "name": "aten::mm"}]}, open(path, "w"))

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU, ProfilerActivity.CUDA})
    monkeypatch.setattr(torch.profiler, "profile", HostOnly)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        with profiling.trace(str(tmp_path / "host"), "cuda"):
            pass
    (written,) = os.listdir(tmp_path / "host")  # the host's trace is kept, and named
    assert written.startswith("rank0.") and written.endswith(".pt.trace.json")
