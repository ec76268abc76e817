"""Shared CLI plumbing: model construction, seeding, run directories."""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from ecg_byte_tpu_torch.data.text_tokenizer import ByteTextTokenizer, register_ecg_tokens
from ecg_byte_tpu_torch.models import (
    gemma_2b,
    gpt2_xl,
    llama_3_2_1b,
    tiny_test_config,
)
from ecg_byte_tpu_torch.models import transformer as T

_PRESETS = {
    "meta-llama/Llama-3.2-1B": llama_3_2_1b,
    "llama-3.2-1b": llama_3_2_1b,
    "google/gemma-2b": gemma_2b,
    "gemma-2b": gemma_2b,
    "openai-community/gpt2-xl": gpt2_xl,
    "gpt2-xl": gpt2_xl,
    "tiny-llama": lambda: tiny_test_config("llama", vocab_size=512),
    "small-llama": lambda: tiny_test_config(
        "llama", vocab_size=512, hidden_size=256, num_layers=4, num_heads=8,
        num_kv_heads=4, head_dim=32, intermediate_size=1024,
    ),
    "tiny-gpt2": lambda: tiny_test_config("gpt2", vocab_size=512),
    "tiny-gemma": lambda: tiny_test_config("gemma", vocab_size=512),
}


def set_seed(seed: int) -> None:
    """Seed Python, numpy and torch (reference main.py:92-95)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_model(model_name: str, vocab, device: torch.device):
    """Construct (params, config, text_tokenizer) with ECG tokens registered.

    A preset config at full width with random weights (a ``torch.Generator``
    seeded with 0 on ``device``) and the byte tokenizer; the vocabulary
    grows to hold the ECG tokens.  Real checkpoints (``--hf_weights``) are
    ROADMAP.md queue 1, item 6.
    """
    if model_name not in _PRESETS:
        raise ValueError(f"unknown model {model_name!r}; options: {sorted(_PRESETS)}")
    config = _PRESETS[model_name]()
    tokenizer = ByteTextTokenizer()
    new_size = register_ecg_tokens(tokenizer, vocab)
    config = config.replace(vocab_size=max(config.vocab_size, new_size))
    generator = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(config, generator, device)
    return params, config, tokenizer


def make_run_dir(args) -> str:
    """Reference run-directory fingerprint (main.py:99): runs/<seed>/<cfg>."""
    cfg = (
        f"{args.model.replace('/', '-')}_{args.dataset}_{args.lr}_{args.beta1}_"
        f"{args.beta2}_{args.eps}_{args.weight_decay}_{args.warmup}_"
        f"{args.batch_size}_{args.epochs}_{args.num_merges}_{args.pad_to_max}_"
        f"{args.toy}"
    )
    return os.path.join("./runs", str(args.seed), cfg)
