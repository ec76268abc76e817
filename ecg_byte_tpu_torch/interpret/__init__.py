"""Attention-based interpretability: token -> signal-region attribution."""

from ecg_byte_tpu_torch.interpret.attention_maps import (  # noqa: F401
    expand_attention,
    get_component_indices,
    interpreter,
)
