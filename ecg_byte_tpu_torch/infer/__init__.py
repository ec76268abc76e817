"""Inference: greedy KV-cache decoding and the evaluation runner."""

from ecg_byte_tpu_torch.infer.decode import greedy_generate  # noqa: F401
