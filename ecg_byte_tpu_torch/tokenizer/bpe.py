"""BPE training and encoding, pickle-compatible with the reference.

The port's copy of ``ecg_byte_tpu/tokenizer/bpe.py``: the same call
signatures and the same ``(vocab, merges)`` pickle, so a tokenizer file
written by either package loads in both.  Every call goes to the native C++
core (``tokenizer/native.py``); the JAX package's pure-Python fallback is
left out, so a core that cannot be built raises.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Sequence, Tuple

from ecg_byte_tpu_torch.tokenizer import native

Merges = List[Tuple[List[int], int]]


def byte_to_string(b: int) -> str:
    """Base-vocab rendering: ASCII char for b <= 127 else ``<b>``."""
    return chr(b) if b <= 127 else f"<{b}>"


def build_vocab(merges: Sequence[Tuple[Sequence[int], int]]) -> Dict[int, str]:
    """The id -> string vocab: each merge token renders as the
    concatenation of its base bytes' renderings."""
    vocab = {i: byte_to_string(i) for i in range(256)}
    for seq, new_id in merges:
        vocab[int(new_id)] = "".join(byte_to_string(int(b)) for b in seq)
    return vocab


def _to_bytes(text) -> bytes:
    return text if isinstance(text, bytes) else text.encode("utf-8")


def byte_pair_encoding(text, num_merges: int, verbose: bool = False):
    """Train BPE merges over ``text``; returns ``(ids, vocab, merges)``."""
    ids, merges = native.train(_to_bytes(text), num_merges, verbose=verbose)
    return ids.tolist(), build_vocab(merges), merges


_encoders: Dict[int, Tuple[object, native.NativeEncoder]] = {}


def encode_text(text, merges) -> List[int]:
    """Greedy longest-match encode (``rust_bpe.encode_text``); one native
    encoder is cached per merges object."""
    cached = _encoders.get(id(merges))
    if cached is None or cached[0] is not merges:
        _encoders.clear()
        cached = _encoders[id(merges)] = (merges, native.NativeEncoder(merges))
    return cached[1].encode(_to_bytes(text)).tolist()


def decode_text(encoded_ids, vocab) -> str:
    return "".join(vocab[int(i)] for i in encoded_ids)


def save_vocab_and_merges(vocab, merges, filename: str) -> None:
    with open(filename, "wb") as f:
        pickle.dump((vocab, merges), f)


def load_vocab_and_merges(filename: str):
    with open(filename, "rb") as f:
        vocab, merges = pickle.load(f)
    return vocab, merges


class BpeTokenizer:
    """``(vocab, merges)`` with encode and decode."""

    def __init__(self, vocab: Dict[int, str], merges: Merges):
        self.vocab = vocab
        self.merges = merges
        self._encoder = native.NativeEncoder(merges)

    @classmethod
    def train(cls, text, num_merges: int, verbose: bool = False) -> "BpeTokenizer":
        _, vocab, merges = byte_pair_encoding(text, num_merges, verbose=verbose)
        return cls(vocab, merges)

    @classmethod
    def load(cls, filename: str) -> "BpeTokenizer":
        return cls(*load_vocab_and_merges(filename))

    def save(self, filename: str) -> None:
        save_vocab_and_merges(self.vocab, self.merges, filename)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text) -> List[int]:
        return self._encoder.encode(_to_bytes(text)).tolist()

    def decode(self, ids) -> str:
        return decode_text(ids, self.vocab)
