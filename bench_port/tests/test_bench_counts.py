"""The operations, bytes and shares of ``counts.py`` and the metric readers
against counts made by hand."""

import json
import os
import types

import numpy as np
import pytest

from bench_port import counts, harness, traffic
from bench_port.spec import spec

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def _spec(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return spec(json.load(f))


def test_gpt2_xl_matmul_weights_by_hand():
    s = _spec("gpt2-xl")
    per_layer = 1600 * 1600 * 4 + 1600 * 6400 * 2  # q k v o, up down
    assert counts.base_matmul_params(s, head=False) == 48 * per_layer
    assert counts.base_matmul_params(s) == 48 * per_layer + 53786 * 1600
    assert counts.lora_params(s) == 48 * 2 * 16 * (1600 + 1600)


def test_smollm2_matmul_weights_by_hand():
    s = _spec("smollm2-1.7b")
    per_layer = 2048 * 2048 * 4 + 2048 * 8192 * 3  # q k v o, gate up down
    assert counts.base_matmul_params(s) == 24 * per_layer + 52681 * 2048
    lora = 16 * ((2048 + 2048) * 4 + (2048 + 8192) * 3)
    assert counts.lora_params(s) == 24 * lora


def test_causal_pairs_by_hand():
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]])
    assert traffic.causal_pairs(mask) == (1 + 2 + 3) + (1 + 2 + 3 + 4 + 5)


def test_train_step_and_attention_counts_by_hand():
    s = _spec("gpt2-xl")
    pairs, positions = 1000, 4096
    fwd = 4 * 64 * 25 * pairs
    assert counts.attention_flops(s, pairs) == fwd
    assert counts.attention_bwd_flops(s, pairs) == 2 * fwd
    base, lora = counts.base_matmul_params(s), counts.lora_params(s)
    assert counts.train_step_flops(s, positions, pairs) == (
        4 * base * positions + 6 * lora * positions + 48 * 3 * fwd)  # 48 layers
    q = 2 * 1024 * 25 * 64 * 2  # B 2, S 1024, bf16
    assert counts.attention_bytes(s, 2, 1024) == 2 * q + 2 * q + 2 * 1024 * 4
    assert counts.attention_bwd_bytes(s, 2, 1024) == 4 * q + 4 * q + 2 * 1024 * 4


def test_decode_counts_by_hand():
    s = _spec("smollm2-1.7b")
    row = 32 * 64 * 2
    assert counts.decode_attention_bytes(s, 4, 100) == 2 * 100 * row + 2 * 4 * row + 2 * 4 * row
    assert counts.decode_step_flops(s, 4, 100) == (2 * counts.base_matmul_params(s) * 4
                                                   + 24 * 4 * 64 * 32 * 100)
    prefill = counts.prefill_flops(s, 10, 2, 30)
    assert prefill == (2 * counts.base_matmul_params(s, head=False) * 10
                       + 2 * 52681 * 2048 * 2 + 24 * 4 * 64 * 32 * 30)  # 24 layers


@pytest.mark.parametrize("flops, nbytes, want", [
    (989e12, 1.0, 1.0), (1.0, 3.35e12, 1.0), (989e9, 3.35e12, 1.0), (989e12, 6.7e12, 2.0)])
def test_bound_is_the_larger_of_the_two(flops, nbytes, want):
    assert counts.bound_seconds(flops, nbytes) == pytest.approx(want)


def _reader(name):
    return harness.load_module(harness.metric_file(name), "t_" + name.replace(".", "_"))


def test_mfu_readers_by_hand():
    run = types.SimpleNamespace(chips=1, window={"train_flops": 989e12 * 3, "seconds": 10.0},
                                trace=None, traced={})
    assert _reader("mfu.train").read(run) == pytest.approx(30.0)
    run.chips = 4
    assert _reader("mfu.train").read(run) == pytest.approx(7.5)
    run = types.SimpleNamespace(chips=1, window={"serve_flops": 989e12, "seconds": 20.0})
    assert _reader("mfu.serve").read(run) == pytest.approx(5.0)
    assert _reader("mfu.train").read(run) is None


def test_window_span_readers_by_hand():
    run = types.SimpleNamespace(window={"decode_s": 2.0, "decode_steps": 100,
                                        "prefill_s": 1.5, "batches": 3})
    assert _reader("decode_step_ms.serve").read(run) == pytest.approx(20.0)
    assert _reader("prefill_ms.serve").read(run) == pytest.approx(500.0)
    assert _reader("prefill_ms.serve").read(types.SimpleNamespace(window={})) is None
