"""Model stack: configuration, the causal-LM transformer, JAX weight import."""

from ecg_byte_tpu_torch.models.config import (  # noqa: F401
    TransformerConfig,
    gemma_2b,
    gpt2_xl,
    llama_3_2_1b,
    tiny_test_config,
)
