"""Text tokenizers with the HF surface the pipeline consumes.

A copy of ``ecg_byte_tpu/data/text_tokenizer.py`` (importing that module
runs ``ecg_byte_tpu/data/__init__.py``, which imports JAX).  Two tokenizers
serve the pipeline: the self-contained ``ByteTextTokenizer`` of the preset
models (ids 0..255 are raw UTF-8 bytes; specials and ECG tokens are
appended), and a checkpoint's own tokenizer for ``--hf_weights``
(``load_text_tokenizer``: ``tokenizer/hf_text.py``).
"""

from __future__ import annotations

import os

from typing import Dict, Iterable, List, Optional, Union

import numpy as np

_BYTE_VOCAB = 256


class _Batch(dict):
    """Minimal BatchEncoding: attribute access over the result dict."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)


class ByteTextTokenizer:
    """Byte-level tokenizer with HF-compatible added/special token handling."""

    def __init__(self):
        self._added: Dict[str, int] = {}
        self._added_rev: Dict[int, str] = {}
        self._special_ids: set = set()
        self._trie: Optional[dict] = None
        self.bos_token = "<s>"
        self.eos_token = "</s>"
        self.pad_token = "<pad>"
        for tok in (self.bos_token, self.eos_token, self.pad_token):
            self._register(tok, special=True)

    # -- registration -------------------------------------------------------

    def _register(self, token: str, special: bool) -> int:
        if token in self._added:
            tid = self._added[token]
        else:
            tid = _BYTE_VOCAB + len(self._added)
            self._added[token] = tid
            self._added_rev[tid] = token
            self._trie = None
        if special:
            self._special_ids.add(tid)
        return tid

    def add_tokens(self, tokens: Iterable[str], special_tokens: bool = False) -> int:
        """Append new tokens; returns the number actually added."""
        before = len(self._added)
        for t in tokens:
            self._register(t, special=special_tokens)
        return len(self._added) - before

    def add_special_tokens(self, mapping: Dict[str, str]) -> int:
        """HF-style: {'pad_token': '<pad>'} registers and pins the attribute."""
        added = 0
        for role, token in mapping.items():
            if role == "additional_special_tokens":
                added += self.add_tokens(token, special_tokens=True)
                continue
            before = token in self._added
            self._register(token, special=True)
            setattr(self, role, token)
            added += 0 if before else 1
        return added

    # -- vocab lookups ------------------------------------------------------

    def __len__(self) -> int:
        return _BYTE_VOCAB + len(self._added)

    @property
    def pad_token_id(self) -> int:
        return self._added[self.pad_token]

    @property
    def bos_token_id(self) -> int:
        return self._added[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self._added[self.eos_token]

    def convert_tokens_to_ids(self, tokens: Union[str, List[str]]):
        if isinstance(tokens, str):
            return self._token_to_id(tokens)
        return [self._token_to_id(t) for t in tokens]

    def _token_to_id(self, token: str) -> int:
        if token in self._added:
            return self._added[token]
        b = token.encode("utf-8")
        if len(b) == 1:
            return b[0]
        return -1  # unknown multi-byte token (HF returns unk; we have none)

    def convert_ids_to_tokens(self, ids: Union[int, List[int]]):
        if isinstance(ids, (int, np.integer)):
            return self._id_to_token(int(ids))
        return [self._id_to_token(int(i)) for i in ids]

    def _id_to_token(self, tid: int) -> str:
        if tid < _BYTE_VOCAB:
            return chr(tid) if tid < 128 else f"<0x{tid:02X}>"
        return self._added_rev.get(tid, "")

    # -- encode -------------------------------------------------------------

    def _build_trie(self) -> dict:
        root: dict = {}
        for token, tid in self._added.items():
            node = root
            for ch in token:
                node = node.setdefault(ch, {})
            node[None] = tid
        return root

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """Longest-match added tokens first, UTF-8 bytes otherwise."""
        if self._trie is None:
            self._trie = self._build_trie()
        root = self._trie
        ids: List[int] = []
        i, n = 0, len(text)
        while i < n:
            node = root.get(text[i])
            best_id, best_len = None, 0
            j = i
            while node is not None:
                j += 1
                if None in node:
                    best_id, best_len = node[None], j - i
                node = node.get(text[j]) if j < n else None
            if best_id is not None:
                ids.append(best_id)
                i += best_len
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(
        self,
        text: Union[str, List[str]],
        return_tensors: Optional[str] = None,
        add_special_tokens: bool = True,
        padding: Optional[str] = None,
        max_length: Optional[int] = None,
        truncation: bool = False,
    ) -> _Batch:
        texts = [text] if isinstance(text, str) else list(text)
        seqs = [self.encode(t, add_special_tokens=add_special_tokens) for t in texts]
        if truncation and max_length is not None:
            seqs = [s[:max_length] for s in seqs]
        if padding == "max_length" and max_length is not None:
            width = max_length
        elif padding in ("longest", True) or return_tensors is not None:
            width = max((len(s) for s in seqs), default=0)
        else:
            width = None
        if width is not None:
            pad = self.pad_token_id
            mask = [[1] * len(s) + [0] * (width - len(s)) for s in seqs]
            seqs = [s + [pad] * (width - len(s)) for s in seqs]
        else:
            mask = [[1] * len(s) for s in seqs]
        if return_tensors == "np":
            return _Batch(
                input_ids=np.asarray(seqs, dtype=np.int64),
                attention_mask=np.asarray(mask, dtype=np.int64),
            )
        return _Batch(input_ids=seqs, attention_mask=mask)

    # -- decode -------------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        parts: List[str] = []
        byte_buf = bytearray()
        prev_added = False

        def flush():
            nonlocal prev_added
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()
                prev_added = False

        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        for tid in ids:
            tid = int(tid)
            if tid < 0:
                continue
            if tid < _BYTE_VOCAB:
                byte_buf.append(tid)
                continue
            flush()
            if skip_special_tokens and tid in self._special_ids:
                continue
            token = self._added_rev.get(tid)
            if token is None:
                continue
            # space-separate consecutive added tokens (HF decode convention)
            if prev_added:
                parts.append(" ")
            parts.append(token)
            prev_added = True
        flush()
        return "".join(parts)


def register_ecg_tokens(tokenizer, vocab) -> int:
    """Register the ECG-BPE vocabulary on a text tokenizer (main.py:144-151).

    ``signal_{id}`` tokens are plain added tokens (they must survive
    ``skip_special_tokens=True`` decoding for the interpreter's regex,
    runners/interpret.py:79-81); the span markers and pad are specials.
    Returns the new tokenizer length.
    """
    ids = sorted(int(k) for k in vocab)
    tokenizer.add_tokens([f"signal_{i}" for i in ids])
    tokenizer.add_tokens(["<sig_start>"], special_tokens=True)
    tokenizer.add_tokens(["<sig_end>"], special_tokens=True)
    tokenizer.add_special_tokens({"pad_token": "<pad>"})
    return len(tokenizer)


def load_text_tokenizer(hf_dir: str):
    """The checkpoint's own tokenizer from a local HF directory.

    By default the port's reader (``tokenizer/hf_text.py``): merge-rank BPE
    from ``tokenizer.json`` (or GPT-2's ``vocab.json`` + ``merges.txt``),
    with ``tokenizers``' ids and no HF package.  With
    ``ECG_BYTE_TEXT_TOKENIZER=transformers`` it is ``AutoTokenizer``
    instead, a cross-check that imports ``transformers`` only then.
    """
    if os.environ.get("ECG_BYTE_TEXT_TOKENIZER") == "transformers":
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(hf_dir, local_files_only=True)
    from ecg_byte_tpu_torch.tokenizer.hf_text import HFTextTokenizer

    return HFTextTokenizer.from_pretrained(hf_dir)
