"""Idle share, launches, marks and the NCCL share read from a small
synthetic Chrome trace in ``torch.profiler``'s format."""

import json
import types

import pytest

from bench_port import harness, tracing


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _trace(tmp_path):
    """Window 0-1000 us on thread 1; four kernels and one copy; the attention
    mark on thread 1 and its backward's on thread 2."""
    events = [
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("cpu_op", "aten::mm", 10, 80),
        _ev("user_annotation", "bench.attn", 100, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=3),
        _ev("cpu_op", "aten::item", 400, 300),
        _ev("user_annotation", "bench.attn.bwd", 500, 100, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 510, 5, tid=2, correlation=4),
        _ev("cuda_runtime", "cudaMemcpyAsync", 700, 5, correlation=5),
        _ev("kernel", "gemm", 30, 100, tid=7, correlation=1),          # 30-130
        _ev("kernel", "attn_fwd", 130, 50, tid=7, correlation=2),      # 130-180
        _ev("kernel", "attn_fwd_2", 170, 30, tid=7, correlation=3),    # overlaps: busy to 200
        _ev("kernel", "ncclKernel_AllReduce", 520, 200, tid=7, correlation=4),  # 520-720
        _ev("gpu_memcpy", "Memcpy HtoD", 900, 50, tid=8, correlation=5),  # 900-950
        _ev("kernel", "outside", 1100, 50, tid=7),                      # after the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.parse(str(path))


def test_busy_idle_and_launches(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window_s == pytest.approx(1e-3)
    # busy: 30-200, 520-720, 900-950 = 170 + 200 + 50 us
    assert tr.busy_s == pytest.approx(420e-6)
    assert len(tr.kernels()) == 5  # the copy is no launch; the one past the window counts
    idle = harness.load_module(harness.metric_file("idle_share.train"), "t_idle")
    # the untraced window: 4 steps in 4 ms, so 1 ms a step; 420 us busy in the traced step
    run = types.SimpleNamespace(trace=tr, traced={"steps": 1}, window={"seconds": 4e-3, "steps": 4})
    assert idle.read(run) == pytest.approx(58.0)
    # the traced stretch's own length does not enter: 3 traced steps at 1.4 ms a step
    run = types.SimpleNamespace(trace=tr, traced={"steps": 3}, window={"seconds": 2e-3, "steps": 1})
    assert idle.read(run) == pytest.approx(100 * (1 - 140e-6 / 2e-3))
    serve = harness.load_module(harness.metric_file("idle_share.serve"), "t_idle_serve")
    run = types.SimpleNamespace(trace=tr, traced={"batches": 1},
                                window={"seconds": 3e-3, "batches": 2})
    assert serve.read(run) == pytest.approx(100 * (1 - 420e-6 / 1.5e-3))
    assert serve.read(types.SimpleNamespace(trace=None, traced={}, window={})) is None


def test_marks_own_what_they_launched(tmp_path):
    tr = _trace(tmp_path)
    assert tr.mark_counts == {"bench.attn": 1, "bench.attn.bwd": 1}
    assert [k[0] for k in tr.kernels("bench.attn")] == ["attn_fwd", "attn_fwd_2"]
    assert [k[0] for k in tr.kernels("bench.attn.bwd")] == ["ncclKernel_AllReduce"]
    assert tr.device_seconds("bench.attn") == pytest.approx(80e-6)
    # the NCCL share of the window: 200 of 1000 us
    assert tr.device_seconds(name_has="nccl") / tr.window_s == pytest.approx(0.2)


def test_idle_gaps_by_what_the_host_did(tmp_path):
    tr = _trace(tmp_path)
    gaps = dict(tr.idle_gaps())
    # 0-30 in aten::mm (mid 15), 200-520 (mid 360) the host idle on thread 1,
    # 720-900 (mid 810) idle, 950-1000 (mid 975) idle
    assert gaps["aten::mm"] == pytest.approx(30e-6)
    assert gaps["(host idle)"] == pytest.approx(320e-6 + 180e-6 + 50e-6)
    assert tr.top_ops(2)[0][0] == "ncclKernel_AllReduce"


def test_roofline_reader(tmp_path):
    tr = _trace(tmp_path)
    reader = harness.load_module(harness.metric_file("attn_roofline.train"), "t_roof")
    # forward bound 40 us by operations, backward 80 us by bytes; spent 80 + 200 us
    run = types.SimpleNamespace(trace=tr, traced={"attn_fwd": (989e12 * 40e-6, 1.0),
                                                  "attn_bwd": (1.0, 3.35e12 * 80e-6)})
    assert reader.read(run) == pytest.approx(100 * 120 / 280)


def test_launches_per_token_reader(tmp_path):
    tr = _trace(tmp_path)
    reader = harness.load_module(harness.metric_file("launches_per_token.serve"), "t_lpt")
    assert reader.read(types.SimpleNamespace(trace=tr)) is None  # no decode step marked
    tr.mark_counts["bench.decode_step"] = 2
    tr.owner = [own + ["bench.decode_step"] for own in tr.owner]
    assert reader.read(types.SimpleNamespace(trace=tr)) == pytest.approx(2.5)


@pytest.mark.parametrize("cell, metrics", [
    ("tiny-llama.lora", ["idle_share.train", "launches_per_step.train", "mfu.train"]),
    ("tiny-llama.serve", ["idle_share.serve", "decode_step_ms.serve", "mfu.serve"]),
])
def test_a_traced_run_reads_its_metrics(cell, metrics, tiny_here, tmp_path, monkeypatch):
    """``--trace 1``'s path on the CPU: the profiler stands in with the
    synthetic trace above, the readers read it and the window's facts."""
    import contextlib
    import time

    fake = _trace(tmp_path)

    @contextlib.contextmanager
    def profiled(directory, device):
        yield {"trace": fake}

    monkeypatch.setattr(tracing, "profiled", profiled)
    bench = {"end_to_end": [{"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": m, "unit": "x"} for m in metrics]}
    r = harness.run(cell, 4, 0.2, True, device="cpu", t0=time.perf_counter(), bench=bench,
                    here=tiny_here)
    assert r["correct"]
    assert set(r["metrics"]) == set(metrics)
    assert r["device"]["busy_s"] == pytest.approx(420e-6)
    assert r["device"]["window_s"] == pytest.approx(1e-3)
    assert len(r["breakdown"]["device_ops"]) <= 10 and r["breakdown"]["idle_gaps"]
    assert list(r)[-1] == "check"
