"""Shared CLI plumbing: model construction, seeding, logging, run directories."""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch

from ecg_byte_tpu_torch.data.text_tokenizer import (
    ByteTextTokenizer,
    load_text_tokenizer,
    register_ecg_tokens,
)
from ecg_byte_tpu_torch.models import (
    gemma_2b,
    gpt2_xl,
    llama_3_2_1b,
    tiny_test_config,
)
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.parallel import distributed

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


def model_config(model_name: Optional[str], hf_weights: Optional[str] = None):
    """The config ``build_model`` builds, without its weights (before the
    ECG tokens grow the vocabulary)."""
    if hf_weights:
        from ecg_byte_tpu_torch.models.hf_loader import config_from_hf

        return config_from_hf(hf_weights)
    if model_name not in _PRESETS:
        raise ValueError(f"unknown model {model_name!r}; options: {sorted(_PRESETS)} "
                         "or pass --hf_weights for a local checkpoint")
    return _PRESETS[model_name]()


def check_tp(config, tp: int) -> None:
    """Exit unless ``tp`` divides the KV heads, the query heads and the MLP
    width: the attention kernels take whole KV groups a rank
    (``ecg_byte_tpu/ops/flash_attention.py:404-408`` keeps whole groups per
    shard; ``resident_attention_sharded`` shards KH over tp)."""
    for what, n in (("num_kv_heads", config.num_kv_heads), ("num_heads", config.num_heads),
                    ("intermediate_size", config.intermediate_size)):
        if n % tp:
            raise SystemExit(f"--tp {tp} must divide the model's {what} ({n})")


def set_seed(seed: int) -> None:
    """Seed Python, numpy and torch (reference main.py:92-95)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_model(
    model_name: str,
    vocab,
    device: torch.device,
    *,
    hf_weights: Optional[str] = None,
    dtype: Optional[str] = None,
):
    """Construct (params, config, text_tokenizer) with ECG tokens registered.

    With ``hf_weights`` (a local HF model directory) the checkpoint loads on
    ``device`` in ``dtype`` (default bf16) with its own tokenizer, and the
    embedding grows by mean rows to hold the ECG tokens.  Otherwise a
    preset config at full width with random weights (a ``torch.Generator``
    seeded with 0 on ``device``) and the byte tokenizer; the vocabulary
    grows to hold the ECG tokens.
    """
    if hf_weights:
        from ecg_byte_tpu_torch.models.hf_loader import load_hf_checkpoint

        params, config = load_hf_checkpoint(hf_weights, dtype or "bfloat16", device)
        tokenizer = load_text_tokenizer(hf_weights)
        new_size = register_ecg_tokens(tokenizer, vocab)
        params, config = T.resize_embeddings(params, config, new_size)
        return params, config, tokenizer
    if model_name not in _PRESETS:
        raise ValueError(f"unknown model {model_name!r}; options: {sorted(_PRESETS)} "
                         "or pass --hf_weights for a local checkpoint")
    config = _PRESETS[model_name]()
    if dtype:
        config = config.replace(dtype=dtype)
    tokenizer = ByteTextTokenizer()
    new_size = register_ecg_tokens(tokenizer, vocab)
    config = config.replace(vocab_size=max(config.vocab_size, new_size))
    generator = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(config, generator, device)
    return params, config, tokenizer


def make_log_fn(args):
    """wandb logger gated on ``--log`` (project 'bpe-trans'); None when off,
    on a ``--dis`` rank other than 0, or when wandb is missing or cannot
    start offline."""
    if not getattr(args, "log", False) or not distributed.is_primary():
        return None
    try:
        import wandb

        wandb.init(project="bpe-trans", config=vars(args))
        return wandb.log
    except Exception as e:  # wandb missing or no network
        print(f"--log disabled ({e})")
        return None


def make_run_dir(args) -> str:
    """Reference run-directory fingerprint (main.py:99): runs/<seed>/<cfg>."""
    cfg = (
        f"{args.model.replace('/', '-')}_{args.dataset}_{args.lr}_{args.beta1}_"
        f"{args.beta2}_{args.eps}_{args.weight_decay}_{args.warmup}_"
        f"{args.batch_size}_{args.epochs}_{args.num_merges}_{args.pad_to_max}_"
        f"{args.toy}"
    )
    return os.path.join("./runs", str(args.seed), cfg)
