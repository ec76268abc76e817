"""Data: ECG-token datasets, the host loader and the text tokenizers."""

from ecg_byte_tpu_torch.data.datasets import DataConfig, ECGTokenDataset  # noqa: F401
from ecg_byte_tpu_torch.data.loader import DataLoader, collate  # noqa: F401
from ecg_byte_tpu_torch.data.text_tokenizer import (  # noqa: F401
    ByteTextTokenizer,
    load_text_tokenizer,
    register_ecg_tokens,
)
