"""Transformer configuration and presets for the three LLM families.

A copy of ``ecg_byte_tpu/models/config.py``: importing that module runs
``ecg_byte_tpu/models/__init__.py``, which imports JAX, and the machine with
the card has no JAX.  The fields and presets are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    arch: str  # 'llama' | 'gemma' | 'gpt2'
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    max_position_embeddings: int
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # RoPE frequency rescaling (HF config.json "rope_scaling"):
    # None | 'linear' | 'llama3' — Llama-3.1/3.2 checkpoints require 'llama3'
    # (reference transformers modeling_rope_utils.py:310-350 applies the
    # rescale at ALL positions, so dropping it changes every logit).
    rope_scaling_type: str | None = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    tie_word_embeddings: bool = False
    # gpt2 uses learned absolute position embeddings + biases + LayerNorm
    learned_pos_embeddings: bool = False
    use_bias: bool = False
    # gemma scales embeddings by sqrt(hidden) and uses (1 + w) RMSNorm weight
    embed_scale: bool = False
    rmsnorm_unit_offset: bool = False
    hidden_act: str = "silu"  # 'silu' (swiglu), 'gelu' (gpt2), 'gelu_tanh' (gemma)
    dtype: str = "bfloat16"
    # Set by transformer.fold_norm_scales: the per-feature RMSNorm weights
    # are folded into the frozen projection weights, so blocks apply only
    # the per-row rsqrt scale, after each projection (it commutes through
    # the contraction).  RMSNorm archs only.
    norm_folded: bool = False

    # LoRA defaults mirroring the reference (main.py:131-138)
    lora_rank: int = 16
    lora_alpha: float = 32.0
    lora_dropout: float = 0.05
    # where the LoRA dropout mask lands:
    #   "rank"  (default) — mask the (B, S, r) adapter activations after
    #           the A-projection.  Same expected update magnitude
    #           (inverted scaling), ~300x fewer random bits than masking
    #           the (B, S, D)/(B, S, I) inputs, and the A-dot reads the
    #           raw layer input so it fuses with the base projections.
    #   "input" — HF PEFT semantics: mask the adapter INPUT rows
    #           (lora.Linear applies nn.Dropout to x before A).  Use for
    #           strict training-dynamics parity with the reference.
    lora_dropout_style: str = "rank"
    lora_targets: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "down_proj", "up_proj",
    )

    @property
    def qkv_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


def llama_3_2_1b(vocab_size: int = 128256) -> TransformerConfig:
    """Llama-3.2-1B: the reference's flagship end-to-end model
    (scripts/train_model.sh:5)."""
    return TransformerConfig(
        arch="llama",
        vocab_size=vocab_size,
        hidden_size=2048,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        intermediate_size=8192,
        max_position_embeddings=131072,
        norm_eps=1e-5,
        rope_theta=500000.0,
        # Llama-3.2 ships rope_scaling rope_type="llama3" in its config.json
        rope_scaling_type="llama3",
        rope_scaling_factor=32.0,
        rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0,
        rope_original_max_position=8192,
        tie_word_embeddings=True,
        hidden_act="silu",
    )


def gemma_2b(vocab_size: int = 256000) -> TransformerConfig:
    return TransformerConfig(
        arch="gemma",
        vocab_size=vocab_size,
        hidden_size=2048,
        num_layers=18,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        intermediate_size=16384,
        max_position_embeddings=8192,
        norm_eps=1e-6,
        rope_theta=10000.0,
        tie_word_embeddings=True,
        embed_scale=True,
        rmsnorm_unit_offset=True,
        hidden_act="gelu_tanh",
    )


def gpt2_xl(vocab_size: int = 50257) -> TransformerConfig:
    return TransformerConfig(
        arch="gpt2",
        vocab_size=vocab_size,
        hidden_size=1600,
        num_layers=48,
        num_heads=25,
        num_kv_heads=25,
        head_dim=64,
        intermediate_size=6400,
        max_position_embeddings=1024,
        norm_eps=1e-5,
        tie_word_embeddings=True,
        learned_pos_embeddings=True,
        use_bias=True,
        hidden_act="gelu",
        lora_targets=("q_proj", "v_proj"),  # HF PEFT default modules for GPT-2
    )


def tiny_test_config(
    arch: str = "llama", vocab_size: int = 512, **kw
) -> TransformerConfig:
    """Small config for unit tests: same code paths, toy sizes."""
    base = dict(
        arch=arch,
        vocab_size=vocab_size,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2 if arch == "llama" else 4,
        head_dim=16,
        intermediate_size=128,
        max_position_embeddings=512,
        tie_word_embeddings=True,
        dtype="float32",
    )
    if arch == "gemma":
        base.update(embed_scale=True, rmsnorm_unit_offset=True, hidden_act="gelu_tanh")
    if arch == "gpt2":
        base.update(learned_pos_embeddings=True, use_bias=True, hidden_act="gelu")
    base.update(kw)
    return TransformerConfig(**base)
