"""The readers of the program's own spans and counters: the decode loop's
host launch and wait times from ``profiling.records("decode")``, and the
update phase's launches from ``ecg.train.update`` spans in a small
synthetic Chrome trace."""

import json
import types

import pytest

from bench_port import harness, tracing
from ecg_byte_tpu_torch.utils import profiling


def _reader(name):
    return harness.load_module(harness.metric_file(name), "t_" + name.replace(".", "_"))


def _decode(steps, decode_s, wait_s):
    return {"rows": 4, "prompt_len": 16, "prefill_s": 0.5, "prefill_wait_s": 0.1,
            "decode_s": decode_s, "decode_wait_s": wait_s, "decode_steps": steps}


@pytest.fixture
def served(monkeypatch):
    """Set-up's batch, two window batches, then the traced batch."""
    monkeypatch.setattr(profiling, "_RECORDS", {})
    for r in (_decode(7, 9.0, 8.0), _decode(10, 0.25, 0.05), _decode(6, 0.125, 0.025),
              _decode(5, 3.0, 0.0)):
        profiling.record("decode", r)
    window = {"batches": 2, "decode_steps": 16, "decode_s": 0.375}
    return types.SimpleNamespace(window=window, traced={"batches": 1}, trace=None)


def test_decode_issue_and_wait_read_the_window_calls(served):
    issue = _reader("decode_issue_ms.serve").read(served)
    wait = _reader("decode_wait_ms.serve").read(served)
    assert issue == pytest.approx(1e3 * (0.2 + 0.1) / 16)
    assert wait == pytest.approx(1e3 * (0.05 + 0.025) / 16)
    # the two make up the window's mean step
    step = _reader("decode_step_ms.serve").read(served)
    assert issue + wait == pytest.approx(step)


@pytest.mark.parametrize("change", [
    {"decode_steps": 17},           # the steps disagree
    {"decode_s": 0.376},            # the seconds disagree
    {"batches": 4},                 # more window batches than the log holds
    {"batches": 0},
])
def test_decode_readers_none_where_the_sums_disagree(served, change):
    served.window.update(change)
    assert _reader("decode_issue_ms.serve").read(served) is None
    assert _reader("decode_wait_ms.serve").read(served) is None


def test_decode_readers_none_without_the_log(served, monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDS", {})
    assert _reader("decode_issue_ms.serve").read(served) is None
    monkeypatch.delattr(profiling, "records")  # a program that keeps no log
    assert _reader("decode_wait_ms.serve").read(served) is None


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def test_update_launches_count_the_main_thread_inside_the_spans(tmp_path):
    """Two steps' update spans on the main thread: three launches in the
    first (runtime and driver calls), one in the second; launches outside
    the spans, on another thread, or other runtime calls are left out."""
    events = [
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("user_annotation", "ecg.train.step", 10, 400),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),       # forward
        _ev("user_annotation", "ecg.train.update", 300, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 310, 5, correlation=2),
        _ev("cuda_driver", "cuLaunchKernelEx", 320, 5, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 330, 5, correlation=4),
        _ev("cuda_runtime", "cudaMemcpyAsync", 340, 5, correlation=5),
        _ev("cuda_runtime", "cudaLaunchKernel", 350, 5, tid=2, correlation=6),  # engine thread
        _ev("user_annotation", "ecg.train.update", 700, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 720, 5, correlation=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 900, 5, correlation=8),      # after the span
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = tracing.parse(str(path))
    reader = _reader("update_launches.train")
    assert reader.read(types.SimpleNamespace(trace=tr, traced={"steps": 2})) == 2.0
    assert reader.read(types.SimpleNamespace(trace=None, traced={})) is None
    events = [e for e in events if e["name"] != "ecg.train.update"]  # the parent: no span
    path.write_text(json.dumps({"traceEvents": events}))
    assert reader.read(types.SimpleNamespace(trace=tracing.parse(str(path)), traced={})) is None
