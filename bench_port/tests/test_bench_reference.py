"""The plain reference against the program at toy sizes on the CPU, in
float32: the forward with adapters, the loss with the dropout masks'
rule, the adapters' gradients, and prefill and decode through the cache
against the reference's full forward."""

import json
import os

import numpy as np
import pytest
import torch

from bench_port import traffic
from bench_port.arch import gpt2 as arch_gpt2
from bench_port.arch import llama as arch_llama
from bench_port.reference import model as M
from bench_port.reference import serve as RS
from bench_port.reference import train as RT
from bench_port.spec import spec
from bench_port.weights import make_lora, make_weights

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
ARCH = {"gpt2": arch_gpt2, "llama": arch_llama}


def _setup(name, seed=3):
    with open(os.path.join(FIX, "configs", f"{name}.json")) as f:
        s = spec(json.load(f))
    w = make_weights(s, seed, "cpu", torch.float32)
    lora = make_lora(s, seed, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed + 2)
    for layer in lora["layers"]:
        for ab in layer.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g) * 0.05
    return s, w, lora, ARCH[s.model_type].port_config(s)


def _batch(s, seed=5):
    work = {"batch": 3, "pad_to_max": 44, "lengths": {"min": 24, "max": 44},
            "question": [2, 4], "answer": [3, 6]}
    b = traffic.train_batches(s, work, seed, 1)[0]
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.mark.parametrize("name", ["tiny-gpt2", "tiny-llama"])
def test_forward_matches_program(name):
    from ecg_byte_tpu_torch.models import transformer as T

    s, w, lora, cfg = _setup(name)
    b = _batch(s)
    got = T.forward(w, cfg, b["input_ids"], b["attn_mask"], b["position_ids"], lora=lora)
    want = M.logits(w, s, M.hidden_states(w, s, b["input_ids"], b["attn_mask"], lora))
    valid = b["attn_mask"].bool()
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["tiny-gpt2", "tiny-llama"])
def test_loss_and_gradients_with_dropout_match_program(name):
    from ecg_byte_tpu_torch.models import transformer as T

    s, w, lora, cfg = _setup(name)
    b = _batch(s)
    count = int((b["labels"][:, 1:] != -100).sum())
    leaves = [ab[k] for layer in lora["layers"] for ab in layer.values() for k in ("a", "b")]
    for t in leaves:
        t.requires_grad_(True)
    hid = T.forward(w, cfg, b["input_ids"], b["attn_mask"], b["position_ids"], lora=lora,
                    dropout_generator=torch.Generator().manual_seed(9), return_hidden=True)
    got = T.lm_loss_from_hidden(w, cfg, hid, b["labels"])
    got_grads = torch.autograd.grad(got, leaves)
    masks = RT.dropout_masks(s, torch.Generator().manual_seed(9), *b["input_ids"].shape, "cpu")
    want = M.loss_sum(w, s, b, lora, masks) / count
    want_grads = torch.autograd.grad(want, leaves)
    assert abs(got.item() - want.item()) < 1e-5 * want.item()
    for g, r in zip(got_grads, want_grads):
        # the program's cross entropy keeps its backward residual in bf16
        assert float((g - r).norm()) <= 2e-2 * float(r.norm()) + 1e-7


@pytest.mark.parametrize("name", ["tiny-gpt2", "tiny-llama"])
def test_prefill_and_decode_match_full_forward(name):
    from ecg_byte_tpu_torch.infer.decode import greedy_generate
    from ecg_byte_tpu_torch.models import transformer as T

    s, w, _, cfg = _setup(name)
    work = {"batch": 3, "lengths": {"min": 20, "max": 40}, "question": [2, 4], "bucket": 16}
    batch = traffic.serve_batches(s, work, 4, 1)[0]
    ids, mask = (torch.from_numpy(batch[k]) for k in ("input_ids", "attn_mask"))
    cache = T.init_kv_cache(cfg, 3, ids.shape[1] + 1, "cpu")
    last, _, _ = T.prefill(w, cfg, ids, mask, cache)
    out = greedy_generate(w, cfg, ids, mask, max_new_tokens=6, pad_token_id=s.pad).numpy()
    requests = []
    for row, n in enumerate(batch["lengths"]):
        prompt = torch.from_numpy(batch["input_ids"][row, -n:].astype(np.int64))
        served = torch.from_numpy(out[row].astype(np.int64))
        ref = RS.served_logits(w, s, prompt, served)
        torch.testing.assert_close(last[row], ref[0], rtol=1e-4, atol=1e-4)
        requests.append({"prompt": prompt, "served": served})
    assert RS.widest_gap(w, s, requests) < 1e-4
