"""``ecg_byte_tpu_torch/utils/profiling.py`` on the CPU: a trace written and
read back (the twin of ``tests/test_env.py::test_profiling_utilities``'s
trace), the program's ``ecg.*`` spans (off: one shared no-op; under a
trace: nested ``user_annotation`` ranges in a train step and in the decode
loop), ``greedy_generate``'s log of host-clock readings, the bytes of live
CPU tensors, and the refusals of a trace of the card that holds none of
its activity."""

import json
import os

import numpy as np
import pytest
import torch

from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step
from ecg_byte_tpu_torch.utils import profiling


def _matmul_sum(a):
    return (a @ a).sum()


def _spans(path):
    """The trace's ``user_annotation`` ranges: (name, start, end) in us."""
    events = json.load(open(path))["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(spans, child, parent):
    """Every ``child`` range lies inside some ``parent`` range."""
    outer = [(s, e) for n, s, e in spans if n == parent]
    kids = [(s, e) for n, s, e in spans if n == child]
    return bool(kids) and all(any(ps <= s and e <= pe for ps, pe in outer) for s, e in kids)


def test_profiling_utilities(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as path:
        _matmul_sum(x)
    assert os.path.dirname(path) == str(tmp_path / "trace") and path.endswith(".pt.trace.json")
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]]
    assert "aten::matmul" in names and "aten::sum" in names


def test_span_is_a_shared_no_op_off_and_an_annotation_under_trace(tmp_path):
    off = profiling.span("ecg.test.off")
    assert off is profiling.span("ecg.test.other")  # one object, nothing allocated
    assert not isinstance(off, torch.profiler.record_function)
    with off:
        pass
    with profiling.trace(str(tmp_path / "trace")) as path:
        on = profiling.span("ecg.test.outer")
        assert isinstance(on, torch.profiler.record_function)
        with on:
            with profiling.span("ecg.test.inner"):
                _matmul_sum(torch.ones(8, 8))
    assert profiling.span("ecg.test.after") is off
    spans = _spans(path)
    assert _inside(spans, "ecg.test.inner", "ecg.test.outer")
    assert not any(n in ("ecg.test.off", "ecg.test.other") for n, _, _ in spans)


def _train_batch(vocab, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :5] = 0
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0) * mask
    return {"input_ids": ids, "attn_mask": mask, "labels": labels,
            "position_ids": pos.astype(np.int32)}


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_train_step_spans_nest_under_trace(tmp_path, arch):
    """A tiny LoRA step: ``ecg.train.step`` holds the batch, forward,
    backward, reduce and update phases; the forward holds the attention
    forward and the loss head, the backward their backward."""
    config = tiny_test_config(arch)
    optimizer = make_optimizer(config.hidden_size, 2)
    state = create_train_state(config, optimizer, torch.Generator().manual_seed(0), peft=True)
    step_fn = make_train_step(config, optimizer)
    batch = _train_batch(config.vocab_size)
    state, _ = step_fn(state, batch, torch.Generator().manual_seed(1))
    with profiling.trace(str(tmp_path / "trace")) as path:
        state, loss = step_fn(state, batch, torch.Generator().manual_seed(2))
    assert torch.isfinite(loss)
    spans = _spans(path)
    assert sum(n == "ecg.train.step" for n, _, _ in spans) == 1
    for phase in ("batch", "forward", "backward", "reduce", "update"):
        assert _inside(spans, f"ecg.train.{phase}", "ecg.train.step"), phase
    assert _inside(spans, "ecg.attn.fwd", "ecg.train.forward")
    assert _inside(spans, "ecg.model.head", "ecg.train.forward")
    assert _inside(spans, "ecg.attn.bwd", "ecg.train.backward")
    assert _inside(spans, "ecg.model.head.bwd", "ecg.train.backward")
    assert sum(n == "ecg.attn.fwd" for n, _, _ in spans) == config.num_layers
    assert sum(n == "ecg.attn.bwd" for n, _, _ in spans) == config.num_layers


def _generate(config, params, rows=2, prompt=10, new=6, stats=None):
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, config.vocab_size, (rows, prompt), generator=gen)
    mask = torch.ones((rows, prompt), dtype=torch.int32)
    mask[0, :3] = 0
    return greedy_generate(params, config, ids, mask, max_new_tokens=new, eos_token_id=-1,
                           pad_token_id=0, stats=stats)


def test_greedy_generate_logs_a_copy_of_each_call(monkeypatch):
    """One record a call, with or without ``stats``; the record is a copy
    (a key the caller hangs on ``stats`` later stays out of the log); the
    waits lie inside the times they are part of."""
    monkeypatch.setattr(profiling, "_RECORDS", {})
    config = tiny_test_config("llama")
    params = T.init_params(config, torch.Generator().manual_seed(0), torch.device("cpu"))
    stats = {}
    _generate(config, params, stats=stats)
    stats["tokens"] = "kept by the caller"
    _generate(config, params, rows=3, new=4)
    first, second = profiling.records("decode")
    assert "tokens" not in first and first == {k: v for k, v in stats.items() if k != "tokens"}
    assert set(first) == {"rows", "prompt_len", "prefill_s", "prefill_wait_s", "decode_s",
                          "decode_wait_s", "decode_steps"}
    assert (first["rows"], first["prompt_len"], first["decode_steps"]) == (2, 10, 5)
    assert (second["rows"], second["decode_steps"]) == (3, 3)
    for r in (first, second):
        assert 0 <= r["decode_wait_s"] <= r["decode_s"]
        assert 0 <= r["prefill_wait_s"] <= r["prefill_s"]
    profiling.records("decode")[0]["rows"] = 99  # readers get copies
    assert profiling.records("decode")[0]["rows"] == 2


def test_record_log_keeps_the_last_calls(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDS", {})
    values = {"i": 0}
    for i in range(profiling.RECORDS_KEPT + 6):
        values["i"] = i
        profiling.record("test", values)
    kept = profiling.records("test")
    assert len(kept) == profiling.RECORDS_KEPT == 1024
    assert [r["i"] for r in kept] == list(range(6, profiling.RECORDS_KEPT + 6))
    assert profiling.records("nothing logged") == []


def test_decode_loop_spans_nest_under_trace(tmp_path):
    """The prefill and each decode step, each with its done-check; the
    prefill's attention and each step's decode attention inside them."""
    config = tiny_test_config("llama")
    params = T.init_params(config, torch.Generator().manual_seed(0), torch.device("cpu"))
    stats = {}
    with profiling.trace(str(tmp_path / "trace")) as path:
        _generate(config, params, stats=stats)
    spans = _spans(path)
    count = lambda name: sum(n == name for n, _, _ in spans)  # noqa: E731
    assert count("ecg.decode.prefill") == 1
    assert count("ecg.decode.step") == stats["decode_steps"] == 5
    assert count("ecg.decode.sync") == 1 + stats["decode_steps"]
    assert _inside(spans, "ecg.attn.fwd", "ecg.decode.prefill")
    assert _inside(spans, "ecg.attn.decode", "ecg.decode.step")
    assert count("ecg.attn.decode") == config.num_layers * stats["decode_steps"]
    steps_and_prefill = [(s, e) for n, s, e in spans
                         if n in ("ecg.decode.prefill", "ecg.decode.step")]
    assert all(any(a <= s and e <= b for a, b in steps_and_prefill)
               for n, s, e in spans if n == "ecg.decode.sync")


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
