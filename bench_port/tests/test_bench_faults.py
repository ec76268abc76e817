"""The harness's run, its look for a card skipped, with the timed path
broken underneath: ``correct`` comes out false for each fault a cell can
have, and true for the sound program.  Toy cells on the CPU."""

import json
import time

import numpy as np
import pytest

from bench_port import calibrate, harness
from tiny import TINY_BENCH


def _run(cell, here, seed=21):
    return harness.run(cell, seed, 0.2, False, device="cpu", t0=time.perf_counter(),
                       bench=TINY_BENCH, here=here)


@pytest.mark.parametrize("cell", ["tiny-gpt2.lora", "tiny-llama.lora", "tiny-llama.serve"])
def test_sound_program_is_correct(cell, tiny_here):
    r = _run(cell, tiny_here)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("cell", ["tiny-gpt2.lora", "tiny-llama.lora"])
def test_state_left_unchanged_fails(cell, tiny_here, monkeypatch):
    from ecg_byte_tpu_torch.train import step

    def unchanged(trainable, loss_fn, optimizer, scheduler, clip_norm):
        return step.gradients(trainable, loss_fn)  # no update

    monkeypatch.setattr(step, "apply_step", unchanged)
    r = _run(cell, tiny_here)
    assert not r["correct"]
    assert r["check"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["tiny-gpt2.lora", "tiny-llama.lora"])
def test_half_batch_fails(cell, tiny_here):
    from ecg_byte_tpu_torch.train import step

    undo = calibrate.half_batch(step)
    try:
        r = _run(cell, tiny_here)
    finally:
        undo()
    assert not r["correct"], r["check"]


def test_served_token_altered_fails(tiny_here, monkeypatch):
    from ecg_byte_tpu_torch.infer import decode

    orig = decode.greedy_generate

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs).clone()
        out[:, out.shape[1] // 2] = (out[:, out.shape[1] // 2] + 1) % 300
        return out

    monkeypatch.setattr(decode, "greedy_generate", altered)
    r = _run("tiny-llama.serve", tiny_here)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("cell", ["tiny-gpt2.lora", "tiny-llama.lora"])
def test_control_reads_over_the_limits(cell, tiny_here):
    """The reference in fp8 in the program's place fails the check."""
    rows = calibrate.readings(cell, 31, True, "cpu", tiny_here)
    limits = harness.load_json(harness.workload_file(cell, tiny_here))["limits"]
    control = next(r for r in rows if r["kind"] == "control")
    program = next(r for r in rows if r["kind"] == "program")
    assert not harness.judge({k: control[k] for k in limits}, limits)[0]
    assert harness.judge({k: program[k] for k in limits}, limits)[0]
    assert np.isfinite([control[k] for k in limits]).all()


def _dp_cell(here):
    work = harness.load_json(harness.workload_file("tiny-gpt2.lora", here))
    work["chips"] = 2
    with open(harness.workload_file("tiny-gpt2.dp", here), "w") as f:
        json.dump(work, f)
    return "tiny-gpt2.dp"


def _dp_run(here, cell, fault=None):
    return harness.with_ranks(2, "cpu", _faulty_rank_run, (cell, here, fault))


def _faulty_rank_run(rank, world, cell, here, fault):
    undo = None
    if fault == "no_exchange":
        from ecg_byte_tpu_torch.parallel import distributed

        undo = calibrate.no_exchange(distributed)
    try:
        return harness.rank_run(rank, world, cell, 23, 0.3, False, time.perf_counter(), "cpu",
                                TINY_BENCH_DP, here)
    finally:
        if undo is not None:
            undo()


TINY_BENCH_DP = {"end_to_end": [{"name": "setup_s", "unit": "s"},
                                {"name": "train_tokens_per_s", "unit": "tokens/s"}],
                 "per_layer": []}


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_two_ranks_and_the_exchange_left_out(fault, tiny_here, monkeypatch):
    """Two gloo ranks share the global batch: sound, the run is correct and
    counts both ranks' tokens; with the gradients' exchange left out it is
    not."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    r = _dp_run(tiny_here, _dp_cell(tiny_here), fault)
    assert r["device"]["count"] == 2
    assert r["correct"] == (fault is None), r["check"]
