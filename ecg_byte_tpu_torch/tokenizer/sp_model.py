"""SentencePiece ``.spm`` reader and segmenter without the sentencepiece
package: the port's own copy of ``ecg_byte_tpu/tokenizer/sp_model.py``
(pure Python and numpy; the machine with the card has no sentencepiece,
transformers or tokenizers).

The translation step tokenizes German reports as ``MarianTokenizer`` does,
from ``source.spm`` and ``vocab.json``.  This module parses the ``.spm``
protobuf directly (a ModelProto is plain varint-delimited proto2: repeated
SentencePiece{piece=1, score=2, type=3} in field 1, TrainerSpec in field 2,
NormalizerSpec in field 3) and implements both segmentation algorithms
sentencepiece ships:

  - **unigram** (model_type=1, the opus-mt default): Viterbi best-path
    over piece log-probs, unknown characters at ``min_score - 10``
    (sentencepiece's kUnkPenalty);
  - **BPE** (model_type=2): iterative best-scored adjacent pair merge.

Normalization: when the model ships a ``precompiled_charsmap`` (the
darts-trie rewrite table real ``nmt_nfkc`` models carry), it is decoded
and applied verbatim (:class:`DartsCharsMap`); models without one fall
back to NFKC + whitespace collapse.  ``write_spm`` writes valid minimal
models (optionally with a real charsmap blob), for test fixtures and for
the random translation model of ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPACE = "▁"

_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# Minimal proto2 wire-format codec (varint + length-delimited only)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _scan_fields(buf: bytes):
    """Yield (field_no, wire_type, value) over a proto2 message body."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            val, i = buf[i : i + 8], i + 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        elif wt == 5:  # 32-bit
            val, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(no: int, wt: int, payload: bytes) -> bytes:
    return _varint((no << 3) | wt) + payload


def write_spm(path: str, pieces: Sequence[Tuple[str, float]],
              model_type: int = 1, unk_piece: str = "<unk>",
              charsmap_rules: Optional[Dict[str, str]] = None) -> None:
    """Write a minimal valid ModelProto (test fixtures / exports).

    ``charsmap_rules`` (str -> str rewrite rules) are encoded as a real
    precompiled_charsmap blob (darts double-array trie), exercising the
    exact normalizer path the way shipped ``.spm`` files do."""
    body = bytearray()
    for piece, score in pieces:
        typ = _UNKNOWN if piece == unk_piece else _NORMAL
        sub = (
            _field(1, 2, _varint(len(piece.encode())) + piece.encode())
            + _field(2, 5, struct.pack("<f", score))
            + _field(3, 0, _varint(typ))
        )
        body += _field(1, 2, _varint(len(sub)) + sub)
    trainer = _field(3, 0, _varint(model_type))
    body += _field(2, 2, _varint(len(trainer)) + trainer)
    norm = _field(3, 0, _varint(1))  # add_dummy_prefix = true
    if charsmap_rules:
        blob = DartsCharsMap.build(charsmap_rules)
        norm += _field(2, 2, _varint(len(blob)) + blob)
    body += _field(3, 2, _varint(len(norm)) + norm)
    with open(path, "wb") as f:
        f.write(bytes(body))


class DartsCharsMap:
    """The NormalizerSpec ``precompiled_charsmap`` blob, decoded.

    Real ``.spm`` files carry their normalization rules (e.g. ``nmt_nfkc``)
    as a precompiled longest-match rewrite table: a darts-clone double-array
    trie over UTF-8 keys plus a '\\0'-separated replacement-string blob
    (sentencepiece normalizer.cc::DecodePrecompiledCharsMap /
    NormalizePrefix).  Blob layout: ``uint32le trie_size | trie units
    (uint32le each) | normalized strings``.  Unit encoding is the public
    darts-clone ``DoubleArrayUnit``: label = bits 0-7 (bit 31 set marks a
    value unit, so value units never match a byte), has_leaf = bit 8,
    offset = bits 10-30 left-shifted by 8 when bit 9 is set; child slot of
    node at ``pos`` with offset ``o`` and byte ``c`` is ``pos ^ o ^ c`` and
    a terminal's value unit sits at ``pos ^ o``.

    Applying this table IS sentencepiece's normalization — when a model
    carries one we use it verbatim instead of the NFKC approximation.
    """

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap too short")
        (trie_bytes,) = struct.unpack("<I", blob[:4])
        if 4 + trie_bytes > len(blob) or trie_bytes % 4:
            raise ValueError("precompiled_charsmap trie size out of range")
        self.units = np.frombuffer(blob, np.uint32, trie_bytes // 4, 4)
        self.normalized = blob[4 + trie_bytes:]

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def longest_match(self, data: bytes, start: int) -> Tuple[int, bytes]:
        """Longest rewrite rule matching ``data[start:]``.

        Returns ``(consumed_bytes, replacement)``; ``(0, b"")`` when no
        rule matches (caller copies one character through unchanged)."""
        units = self.units
        if not len(units):
            return 0, b""
        node_pos = self._offset(int(units[0]))
        best_len, best_val = 0, -1
        for i in range(start, len(data)):
            c = data[i]
            pos = node_pos ^ c
            if pos >= len(units):
                break
            unit = int(units[pos])
            if (unit & 0x800000FF) != c:
                break
            node_pos = pos ^ self._offset(unit)
            if (unit >> 8) & 1:  # has_leaf
                best_len = i - start + 1
                best_val = int(units[node_pos]) & 0x7FFFFFFF
        if best_len == 0:
            return 0, b""
        end = self.normalized.index(b"\0", best_val)
        return best_len, self.normalized[best_val:end]

    def normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        out = bytearray()
        i = 0
        while i < len(data):
            n, rep = self.longest_match(data, i)
            if n:
                out += rep
                i += n
            else:  # copy one full UTF-8 character through
                step = 1
                while i + step < len(data) and (data[i + step] & 0xC0) == 0x80:
                    step += 1
                out += data[i : i + step]
                i += step
        return out.decode("utf-8")

    @staticmethod
    def build(rules: Dict[str, str]) -> bytes:
        """Encode rewrite rules as a precompiled_charsmap blob (tests /
        fixture generation; same unit encoding the decoder consumes)."""
        normalized = bytearray()
        values: Dict[str, int] = {}
        for rep in rules.values():
            if rep not in values:
                values[rep] = len(normalized)
                normalized += rep.encode("utf-8") + b"\0"

        trie: Dict = {"children": {}, "value": None}
        for key, rep in sorted(rules.items()):
            kb = key.encode("utf-8")
            if not kb or 0 in kb:
                raise ValueError(f"unsupported charsmap key {key!r}")
            node = trie
            for c in kb:
                node = node["children"].setdefault(
                    c, {"children": {}, "value": None}
                )
            node["value"] = values[rep]

        units: Dict[int, int] = {}
        used = {0}

        def encode_offset(off: int) -> int:
            if off < (1 << 21):
                return off << 10
            if off % 256 == 0 and off < (1 << 29):
                return ((off >> 8) << 10) | 0x200
            raise ValueError("offset not encodable")

        def place(node, pos: int) -> None:
            labels = sorted(node["children"])
            want = ([0] if node["value"] is not None else []) + labels
            off = 1
            while True:
                if off % 256 and off >= (1 << 21):
                    off = ((off >> 8) + 1) << 8
                if all((pos ^ off ^ c) not in used for c in want):
                    encode_offset(off)
                    break
                off += 1
            for c in want:
                used.add(pos ^ off ^ c)
            units[pos] = units.get(pos, 0) | encode_offset(off) | (
                0x100 if node["value"] is not None else 0
            )
            if node["value"] is not None:
                units[pos ^ off] = 0x80000000 | node["value"]
            for c in labels:
                units[pos ^ off ^ c] = c
            for c in labels:
                place(node["children"][c], pos ^ off ^ c)

        place(trie, 0)
        n_units = max(units) + 1
        arr = np.zeros(n_units, np.uint32)
        for pos, unit in units.items():
            arr[pos] = unit
        trie_blob = arr.tobytes()
        return struct.pack("<I", len(trie_blob)) + trie_blob + bytes(normalized)


class SentencePieceModel:
    """Parsed ``.spm``: pieces, scores, model type, segmentation."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            buf = f.read()
        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        self.model_type = 1
        self.add_dummy_prefix = True
        self.remove_extra_whitespaces = True
        self.normalizer_name = ""
        self.charsmap: Optional[DartsCharsMap] = None
        for field, _wt, val in _scan_fields(buf):
            if field == 1:  # SentencePiece
                piece, score, typ = "", 0.0, _NORMAL
                for f2, _w2, v2 in _scan_fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        typ = v2
                self.pieces.append(piece)
                self.scores.append(score)
                self.types.append(typ)
            elif field == 2:  # TrainerSpec
                for f2, _w2, v2 in _scan_fields(val):
                    if f2 == 3:  # model_type
                        self.model_type = v2
            elif field == 3:  # NormalizerSpec
                for f2, _w2, v2 in _scan_fields(val):
                    if f2 == 1:
                        self.normalizer_name = v2.decode("utf-8")
                    elif f2 == 2 and v2:  # precompiled_charsmap
                        self.charsmap = DartsCharsMap(v2)
                    elif f2 == 3:
                        self.add_dummy_prefix = bool(v2)
                    elif f2 == 4:
                        self.remove_extra_whitespaces = bool(v2)
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        scorable = [
            s for s, t in zip(self.scores, self.types) if t == _NORMAL
        ]
        self._min_score = min(scorable) if scorable else 0.0
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)
        self.unk_piece = next(
            (p for p, t in zip(self.pieces, self.types) if t == _UNKNOWN),
            "<unk>",
        )
        if self.model_type not in (1, 2):
            raise NotImplementedError(
                f"sentencepiece model_type {self.model_type} "
                "(only unigram=1 / bpe=2)"
            )

    # -- normalization --------------------------------------------------------
    # Exact when the model ships a precompiled_charsmap (the rules blob IS
    # the normalizer, e.g. nmt_nfkc); NFKC approximation otherwise —
    # fixtures written by write_spm carry no charsmap, and NFKC matches
    # nmt_nfkc on the ASCII/Latin medical-report text this pipeline feeds.

    def normalize(self, text: str) -> str:
        if self.charsmap is not None:
            text = self.charsmap.normalize(text)
        else:
            text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        text = text.replace(" ", SPACE)
        if self.add_dummy_prefix and text:
            text = SPACE + text
        return text

    # -- segmentation ---------------------------------------------------------

    def encode_pieces(self, text: str) -> List[str]:
        s = self.normalize(text)
        if not s:
            return []
        if self.model_type == 2:
            return self._bpe_segment(s)
        return self._viterbi_segment(s)

    def _viterbi_segment(self, s: str) -> List[str]:
        n = len(s)
        unk_score = self._min_score - 10.0
        best = np.full(n + 1, -np.inf)
        best[0] = 0.0
        back: List[Optional[Tuple[int, str]]] = [None] * (n + 1)
        p2i = self.piece_to_id
        scores = self.scores
        types = self.types
        for i in range(n):
            if best[i] == -np.inf:
                continue
            # unknown single char is always available
            cand = best[i] + unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, s[i])
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                pid = p2i.get(s[i:j])
                if pid is None or types[pid] in (_CONTROL, _UNUSED):
                    continue
                cand = best[i] + scores[pid]
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, s[i:j])
        out: List[str] = []
        i = n
        while i > 0:
            prev, piece = back[i]
            out.append(piece)
            i = prev
        return out[::-1]

    def _bpe_segment(self, s: str) -> List[str]:
        parts = list(s)
        p2i = self.piece_to_id
        scores = self.scores
        while len(parts) > 1:
            best_score, best_i = None, -1
            for i in range(len(parts) - 1):
                pid = p2i.get(parts[i] + parts[i + 1])
                if pid is None:
                    continue
                sc = scores[pid]
                if best_score is None or sc > best_score:
                    best_score, best_i = sc, i
            if best_score is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts


class MarianSpTokenizer:
    """MarianTokenizer equivalent: source.spm segmentation + vocab.json ids.

    Surface limited to what translate_reports consumes: ``__call__`` with
    padding/truncation -> numpy ids/mask (eos appended, right padding),
    ``batch_decode(skip_special_tokens=True)``.
    """

    def __init__(self, model_dir: str):
        self.sp = SentencePieceModel(os.path.join(model_dir, "source.spm"))
        with open(os.path.join(model_dir, "vocab.json"), encoding="utf-8") as f:
            self.vocab: Dict[str, int] = json.load(f)
        self.rev = {v: k for k, v in self.vocab.items()}
        self.pad_token, self.eos_token, self.unk_token = "<pad>", "</s>", "<unk>"
        self.pad_token_id = self.vocab[self.pad_token]
        self.eos_token_id = self.vocab[self.eos_token]
        self.unk_token_id = self.vocab.get(self.unk_token, 0)

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [
            self.vocab.get(p, self.unk_token_id)
            for p in self.sp.encode_pieces(text)
        ]
        if max_length is not None:
            ids = ids[: max_length - 1]
        return ids + [self.eos_token_id]

    def __call__(self, texts, max_length: Optional[int] = 512,
                 truncation: bool = True, padding: bool = True):
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.encode(t, max_length if truncation else None)
                for t in texts]
        width = max((len(s) for s in seqs), default=0)
        ids = np.full((len(seqs), width), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        out = []
        specials = {self.pad_token_id, self.eos_token_id}
        for row in np.asarray(batch):
            pieces = []
            for tid in row:
                tid = int(tid)
                if skip_special_tokens and tid in specials:
                    continue
                pieces.append(self.rev.get(tid, self.unk_token))
            text = "".join(pieces).replace(SPACE, " ").strip()
            out.append(text)
        return out
