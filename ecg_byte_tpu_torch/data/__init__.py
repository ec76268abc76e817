"""Data: ECG-token datasets, the host loader and the byte text tokenizer."""

from ecg_byte_tpu_torch.data.datasets import DataConfig, ECGTokenDataset  # noqa: F401
from ecg_byte_tpu_torch.data.loader import DataLoader, collate  # noqa: F401
from ecg_byte_tpu_torch.data.text_tokenizer import (  # noqa: F401
    ByteTextTokenizer,
    register_ecg_tokens,
)
