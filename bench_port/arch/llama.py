"""The program's configuration of a Llama-architecture configuration file:
its ``arch="llama"`` block (RMSNorm, RoPE without rescaling, SwiGLU)."""

from bench_port.spec import Spec


def port_config(s: Spec):
    from ecg_byte_tpu_torch.models.config import TransformerConfig

    return TransformerConfig(
        arch="llama", vocab_size=s.vocab, hidden_size=s.hidden, num_layers=s.layers,
        num_heads=s.heads, num_kv_heads=s.kv_heads, head_dim=s.head_dim,
        intermediate_size=s.inner, max_position_embeddings=s.max_positions, norm_eps=s.eps,
        rope_theta=s.rope_theta, rope_scaling_type=None, tie_word_embeddings=s.tie,
        hidden_act="silu", dtype=s.dtype, lora_rank=s.lora_rank, lora_alpha=s.lora_alpha,
        lora_dropout=s.lora_dropout, lora_targets=s.lora_targets)
