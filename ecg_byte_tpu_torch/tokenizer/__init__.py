"""ECG BPE tokenizer on the host: the port's copy of ``ecg_byte_tpu.tokenizer``
(BPE only), backed by the C++ core in ``csrc/host/``."""

from ecg_byte_tpu_torch.tokenizer.bpe import (  # noqa: F401
    BpeTokenizer,
    build_vocab,
    byte_pair_encoding,
    decode_text,
    encode_text,
    load_vocab_and_merges,
    save_vocab_and_merges,
)
