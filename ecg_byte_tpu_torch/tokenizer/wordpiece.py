"""WordPiece tokenizer for local BERT checkpoints (BERTScore).

The port's copy of ``ecg_byte_tpu/tokenizer/wordpiece.py`` (pure Python):
the BERT tokenization pipeline (basic tokenization + greedy
longest-match-first WordPiece) over any local checkpoint's ``vocab.txt``,
with no HF package.  Semantics follow the original BERT tokenizer: text
cleanup, optional lower-casing with accent stripping, punctuation
splitting, CJK spacing, then per-word WordPiece with ``##`` continuation
pieces and ``[UNK]`` for unmatchable words.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (BERT convention:
    # includes chars like ``$`` and ``^`` that Unicode does not class P*)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lower_case: bool = True) -> List[str]:
    """Cleanup + whitespace/punctuation/CJK splitting (BERT BasicTokenizer)."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        cleaned.append(" " if _is_whitespace(ch) else ch)
    spaced = []
    for ch in "".join(cleaned):
        if _is_cjk(ord(ch)):
            spaced.extend((" ", ch, " "))
        else:
            spaced.append(ch)
    tokens: List[str] = []
    for word in "".join(spaced).split():
        if lower_case:
            word = word.lower()
            word = "".join(
                ch
                for ch in unicodedata.normalize("NFD", word)
                if unicodedata.category(ch) != "Mn"
            )
        current = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


def wordpiece_tokenize(
    word: str, vocab: Dict[str, int], unk_token: str = "[UNK]",
    max_chars: int = 100,
) -> List[str]:
    """Greedy longest-match-first WordPiece of a single word."""
    if len(word) > max_chars:
        return [unk_token]
    pieces: List[str] = []
    start = 0
    while start < len(word):
        end = len(word)
        piece = None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [unk_token]
        pieces.append(piece)
        start = end
    return pieces


class WordPieceTokenizer:
    """BERT-style tokenizer over a local ``vocab.txt``."""

    def __init__(self, vocab_file: str, lower_case: bool = True):
        self.vocab = load_vocab(vocab_file)
        self.lower_case = lower_case
        self.unk_id = self.vocab.get("[UNK]", 0)
        self.cls_id = self.vocab.get("[CLS]", 0)
        self.sep_id = self.vocab.get("[SEP]", 0)
        self.pad_id = self.vocab.get("[PAD]", 0)

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in basic_tokenize(text, self.lower_case):
            pieces.extend(wordpiece_tokenize(word, self.vocab))
        return pieces

    def encode(self, text: str, max_len: int = 512) -> List[int]:
        """[CLS] pieces [SEP] as ids, truncated to ``max_len`` total."""
        ids = [self.vocab.get(p, self.unk_id) for p in self.tokenize(text)]
        ids = ids[: max_len - 2]
        return [self.cls_id] + ids + [self.sep_id]

    # BERT inputs are meaningful only with the [CLS]..[SEP] template (the
    # encoder pools the [CLS] position); datasets check this flag to
    # request specials (the MedCPT tokenizer default, merl.py:197-201)
    bert_specials = True

    def __call__(
        self,
        text,
        return_tensors=None,
        add_special_tokens: bool = True,
        padding=None,
        max_length=None,
        truncation: bool = False,
    ):
        """HF-surface batch encode (the subset the datasets consume)."""
        import numpy as np

        texts = [text] if isinstance(text, str) else list(text)
        seqs = []
        for t in texts:
            ids = [self.vocab.get(p, self.unk_id) for p in self.tokenize(t)]
            if add_special_tokens:
                if truncation and max_length is not None:
                    ids = ids[: max_length - 2]
                ids = [self.cls_id] + ids + [self.sep_id]
            elif truncation and max_length is not None:
                ids = ids[:max_length]
            seqs.append(ids)
        if padding == "max_length" and max_length is not None:
            width = max_length
        elif padding in ("longest", True) or return_tensors is not None:
            width = max((len(s) for s in seqs), default=0)
        else:
            width = None
        if width is not None:
            mask = [[1] * len(s) + [0] * (width - len(s)) for s in seqs]
            seqs = [s + [self.pad_id] * (width - len(s)) for s in seqs]
        else:
            mask = [[1] * len(s) for s in seqs]

        class _Batch(dict):
            def __getattr__(self, name):
                try:
                    return self[name]
                except KeyError:
                    raise AttributeError(name)

        if return_tensors == "np":
            return _Batch(
                input_ids=np.asarray(seqs, dtype=np.int64),
                attention_mask=np.asarray(mask, dtype=np.int64),
            )
        return _Batch(input_ids=seqs, attention_mask=mask)
