"""HuggingFace text tokenizer from a checkpoint's own files, with no
``tokenizers``, ``transformers`` or ``regex`` package.

The port's copy of ``ecg_byte_tpu/tokenizer/hf_text.py``: it reads
``tokenizer.json`` (or GPT-2's ``vocab.json`` + ``merges.txt``) and runs
the fast tokenizer's pipeline

  added-token split -> normalize -> pre-tokenize -> BPE -> post-process

with the same ids as ``tokenizers``.  Text BPE is merge-rank driven: within
each pre-token the lowest-rank adjacent pair merges first, repeatedly, as
GPT-2 and Llama tokenizers do.  Merges may be stored as ``"a b"`` (older
files) or ``["a", "b"]`` (``tokenizers`` 0.22).

Supported components (those of the three backbones and of Llama-2/Gemma
style sentencepiece-BPE exports):

  model:          BPE (vocab + merges, ``ignore_merges``, ``byte_fallback``,
                  ``unk_token``, ``fuse_unk``)
  normalizers:    Sequence, Prepend, Replace(String|Regex), NFC, NFKC,
                  Lowercase
  pre-tokenizers: Sequence, ByteLevel(add_prefix_space, use_regex),
                  Split(Regex|String; isolated/removed), Metaspace
  post-processors: ByteLevel (no-op on ids), TemplateProcessing (single),
                  Sequence of those
  decoders:       ByteLevel, Metaspace, Sequence of
                  Replace/ByteFallback/Fuse/Strip

Anything else raises at load time rather than mis-tokenizing.

The one change from the JAX package's module: its patterns (``\\p{L}``,
``\\p{N}`` and the like) compile with the standard library's ``re``
(:func:`compile_pattern`) instead of the ``regex`` package.  Each
``\\p{..}`` / ``\\P{..}`` of a general category becomes a character class
built once from ``unicodedata``, and ``\\s`` / ``\\S`` become Unicode's
White_Space set, which ``regex`` and ``tokenizers`` match (``re``'s own
``\\s`` also takes U+001C-U+001F).  Python 3.12 carries Unicode 15.0 and
``regex`` its own tables, so the two can differ only on code points
assigned after the Python build's Unicode version.  Other properties
(scripts, binary properties) and POSIX classes raise at load.  ``\\w``
and ``\\d`` keep ``re``'s meaning; none of the supported pipelines'
patterns uses ``\\w``.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

__all__ = ["HFTextTokenizer", "bytes_to_unicode", "compile_pattern"]


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte <-> printable-unicode table (openai/gpt-2 encoder.py).

    Printable bytes map to themselves; the rest shift into U+0100.. so BPE
    operates on visible characters with no whitespace/control ambiguity.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


# -- patterns: Unicode property classes for the stdlib ``re`` ----------------

# Unicode's White_Space property (PropList.txt; unchanged since Unicode 6.3)
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))

# general-category long names (PropertyValueAliases.txt) -> short names
_CATEGORY_ALIASES = {
    "letter": "L", "casedletter": "LC", "uppercaseletter": "Lu",
    "lowercaseletter": "Ll", "titlecaseletter": "Lt", "modifierletter": "Lm",
    "otherletter": "Lo", "mark": "M", "combiningmark": "M",
    "nonspacingmark": "Mn", "spacingmark": "Mc", "enclosingmark": "Me",
    "number": "N", "decimalnumber": "Nd", "digit": "Nd", "letternumber": "Nl",
    "othernumber": "No", "punctuation": "P", "punct": "P",
    "connectorpunctuation": "Pc", "dashpunctuation": "Pd",
    "openpunctuation": "Ps", "closepunctuation": "Pe",
    "initialpunctuation": "Pi", "finalpunctuation": "Pf",
    "otherpunctuation": "Po", "symbol": "S", "mathsymbol": "Sm",
    "currencysymbol": "Sc", "modifiersymbol": "Sk", "othersymbol": "So",
    "separator": "Z", "spaceseparator": "Zs", "lineseparator": "Zl",
    "paragraphseparator": "Zp", "other": "C", "control": "Cc", "cntrl": "Cc",
    "format": "Cf", "surrogate": "Cs", "privateuse": "Co", "unassigned": "Cn",
    "l&": "L",  # as the regex package reads it (not Cased_Letter)
}


@functools.lru_cache(maxsize=1)
def _category_ranges() -> Dict[str, Tuple[Tuple[int, int], ...]]:
    """Every two-letter general category -> its code point ranges, from one
    pass over ``unicodedata``."""
    runs: Dict[str, List[List[int]]] = {}
    category = unicodedata.category
    prev, start = category("\x00"), 0
    for cp in range(1, sys.maxunicode + 2):
        cat = category(chr(cp)) if cp <= sys.maxunicode else None
        if cat != prev:
            runs.setdefault(prev, []).append([start, cp - 1])
            prev, start = cat, cp
    return {k: tuple(map(tuple, v)) for k, v in runs.items()}


def _merge(ranges) -> Tuple[Tuple[int, int], ...]:
    out: List[List[int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return tuple(map(tuple, out))


def _complement(ranges) -> Tuple[Tuple[int, int], ...]:
    out, nxt = [], 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= sys.maxunicode:
        out.append((nxt, sys.maxunicode))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _property_ranges(name: str) -> Tuple[Tuple[int, int], ...]:
    """The code point ranges of a ``\\p{name}`` property; raises
    ``NotImplementedError`` for what unicodedata cannot give."""
    key = re.sub(r"[\s_\-]", "", name).lower()
    for prefix in ("generalcategory=", "gc="):
        if key.startswith(prefix):
            key = key[len(prefix):]
    if key in ("whitespace", "space"):
        return _WHITE_SPACE
    short = _CATEGORY_ALIASES.get(key)
    if short is None:
        short = next((c for c in ("L", "LC", "M", "N", "P", "S", "Z", "C")
                      if c.lower() == key), None)
    if short is None and len(key) == 2:
        short = key[0].upper() + key[1]
    cats = _category_ranges()
    if short == "LC":
        members = ("Lu", "Ll", "Lt")
    elif short is not None and len(short) == 1:
        members = tuple(c for c in cats if c[0] == short)
    elif short in cats:
        members = (short,)
    else:
        raise NotImplementedError(
            f"Unicode property \\p{{{name}}}: only general categories and "
            "White_Space compile without the 'regex' package"
        )
    return _merge(r for c in members for r in cats[c])


def _class_body(ranges) -> str:
    def esc(cp):
        return f"\\u{cp:04x}" if cp <= 0xFFFF else f"\\U{cp:08x}"

    return "".join(esc(lo) if lo == hi else f"{esc(lo)}-{esc(hi)}" for lo, hi in ranges)


def _translate(pattern: str) -> str:
    """A ``regex``-package pattern -> the same pattern for ``re``."""
    out: List[str] = []
    in_class = False
    i, n = 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    end = pattern.index("}", i + 3)
                    name, i = pattern[i + 3:end], end + 1
                else:
                    name, i = pattern[i + 2], i + 3
                negate = nxt == "P"
                if name.startswith("^"):
                    name, negate = name[1:], not negate
                ranges = _property_ranges(name)
            elif nxt in "sS":
                ranges, negate, i = _WHITE_SPACE, nxt == "S", i + 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:  # a class inside a class: inline it, complemented
                out.append(_class_body(_complement(ranges) if negate else ranges))
            else:
                out.append(("[^" if negate else "[") + _class_body(ranges) + "]")
            continue
        if in_class:
            if ch == "[" and pattern[i + 1:i + 2] == ":":
                raise NotImplementedError(f"POSIX class in pattern {pattern!r}")
            if ch == "]":
                in_class = False
            out.append(ch)
            i += 1
            continue
        if ch == "[":
            in_class = True
            j = i + 1
            if pattern[j:j + 1] == "^":
                j += 1
            if pattern[j:j + 1] == "]":  # a leading ']' is a literal
                j += 1
            out.append(pattern[i:j])
            i = j
            continue
        out.append(ch)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=32)
def compile_pattern(pattern: str) -> "re.Pattern":
    """Compile a ``tokenizers``/``regex`` pattern with the stdlib ``re``:
    ``\\p{..}`` / ``\\P{..}`` general categories and ``\\s`` / ``\\S``
    become explicit character classes (see the module docstring)."""
    return re.compile(_translate(pattern))


# The ByteLevel pre-tokenizer's built-in pattern (GPT-2's).
_BYTELEVEL_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)|\s+"
)


class _AddedToken:
    __slots__ = ("content", "id", "special", "lstrip", "rstrip",
                 "normalized", "single_word")

    def __init__(self, content, id, special=False, lstrip=False,
                 rstrip=False, normalized=None, single_word=False):
        self.content = content
        self.id = id
        self.special = bool(special)
        self.lstrip = bool(lstrip)
        self.rstrip = bool(rstrip)
        self.normalized = (not special) if normalized is None else bool(normalized)
        self.single_word = bool(single_word)


class _Batch(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)


def _pattern_of(spec) -> Tuple[str, bool]:
    """tokenizer.json pattern object -> (pattern, is_regex)."""
    if isinstance(spec, dict):
        if "Regex" in spec:
            return spec["Regex"], True
        if "String" in spec:
            return spec["String"], False
    raise NotImplementedError(f"unsupported pattern spec {spec!r}")


class HFTextTokenizer:
    """HF-surface tokenizer over a parsed ``tokenizer.json`` spec.

    Implements exactly the methods the datasets/CLIs consume (the same
    surface as data/text_tokenizer.py's ``ByteTextTokenizer``): ``__call__``
    with numpy tensors, ``encode``/``decode``/``batch_decode``,
    ``convert_tokens_to_ids``/``convert_ids_to_tokens``,
    ``add_tokens``/``add_special_tokens``, ``len()``, and the
    bos/eos/pad token attributes.
    """

    def __init__(self, spec: dict, tokenizer_config: Optional[dict] = None,
                 special_map: Optional[dict] = None):
        model = spec.get("model") or {}
        if model.get("type") not in ("BPE",):
            raise NotImplementedError(
                f"model type {model.get('type')!r}; only BPE tokenizer.json "
                "files are supported (GPT-2 / Llama / Gemma class)"
            )
        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._vocab_rev: Dict[int, str] = {v: k for k, v in self._vocab.items()}
        self._ranks: Dict[Tuple[str, str], int] = {}
        for i, merge in enumerate(model.get("merges") or []):
            if isinstance(merge, str):
                a, b = merge.split(" ", 1)
            else:
                a, b = merge
            self._ranks[(a, b)] = i
        self._ignore_merges = bool(model.get("ignore_merges"))
        self._byte_fallback = bool(model.get("byte_fallback"))
        self._fuse_unk = bool(model.get("fuse_unk"))
        self._unk_token = model.get("unk_token")
        if model.get("continuing_subword_prefix") or model.get("end_of_word_suffix"):
            raise NotImplementedError(
                "continuing_subword_prefix / end_of_word_suffix BPE options"
            )
        self._dropout = model.get("dropout")
        if self._dropout:
            raise NotImplementedError("BPE dropout")

        self._normalizers = self._compile_normalizer(spec.get("normalizer"))
        self._pretokenizers = self._compile_pretokenizer(spec.get("pre_tokenizer"))
        self._post_single = self._compile_post(spec.get("post_processor"))
        self._decoders = self._compile_decoder(spec.get("decoder"))

        self._added: Dict[str, _AddedToken] = {}
        self._added_by_id: Dict[int, _AddedToken] = {}
        for at in spec.get("added_tokens") or []:
            tok = _AddedToken(
                at["content"], at["id"], special=at.get("special", False),
                lstrip=at.get("lstrip", False), rstrip=at.get("rstrip", False),
                normalized=at.get("normalized", False),
                single_word=at.get("single_word", False),
            )
            self._added[tok.content] = tok
            self._added_by_id[tok.id] = tok
        self._trie: Optional[dict] = None
        self._bpe_cache: Dict[str, Tuple[int, ...]] = {}

        # bos/eos/pad roles from tokenizer_config.json / special_tokens_map
        cfg = dict(tokenizer_config or {})
        for role_map in (special_map or {},):
            for k, v in role_map.items():
                cfg.setdefault(k, v)
        self.bos_token = _token_content(cfg.get("bos_token"))
        self.eos_token = _token_content(cfg.get("eos_token"))
        self.pad_token = _token_content(cfg.get("pad_token"))
        self.unk_token = _token_content(cfg.get("unk_token")) or self._unk_token
        # transformers-level template flags (slow-config escape hatch):
        # when tokenizer.json carries no post_processor but the config
        # says add_bos_token, synthesize the template
        if self._post_single is None and cfg.get("add_bos_token") and self.bos_token:
            self._post_single = [("special", self.bos_token)]
        if cfg.get("add_eos_token"):
            self._post_single = (self._post_single or [("sequence", "A")]) + [
                ("special", self.eos_token)
            ]

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str) -> "HFTextTokenizer":
        """Load from a local HF checkpoint directory (or a tokenizer.json)."""
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                return cls(json.load(f))
        tj = os.path.join(path, "tokenizer.json")
        cfg = _read_json(os.path.join(path, "tokenizer_config.json"))
        smap = _read_json(os.path.join(path, "special_tokens_map.json"))
        if os.path.exists(tj):
            with open(tj, encoding="utf-8") as f:
                return cls(json.load(f), cfg, smap)
        vj = os.path.join(path, "vocab.json")
        mt = os.path.join(path, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mt):
            return cls(_slow_gpt2_spec(vj, mt), cfg, smap)
        raise FileNotFoundError(
            f"no tokenizer.json or vocab.json+merges.txt under {path!r} "
            "(sentencepiece .model files: use tokenizer/sp_model.py)"
        )

    # -- pipeline compilation -------------------------------------------------

    def _compile_normalizer(self, spec):
        if spec is None:
            return []
        t = spec.get("type")
        if t == "Sequence":
            out = []
            for sub in spec["normalizers"]:
                out.extend(self._compile_normalizer(sub))
            return out
        if t == "Prepend":
            prefix = spec["prepend"]
            return [lambda s, prefix=prefix: (prefix + s) if s else s]
        if t == "Replace":
            pat, is_regex = _pattern_of(spec["pattern"])
            content = spec["content"]
            if is_regex:
                rx = compile_pattern(pat)
                return [lambda s, rx=rx, c=content: rx.sub(c, s)]
            return [lambda s, p=pat, c=content: s.replace(p, c)]
        if t == "NFC":
            import unicodedata

            return [lambda s: unicodedata.normalize("NFC", s)]
        if t == "NFKC":
            import unicodedata

            return [lambda s: unicodedata.normalize("NFKC", s)]
        if t == "Lowercase":
            return [lambda s: s.lower()]
        raise NotImplementedError(f"normalizer {t!r}")

    def _compile_pretokenizer(self, spec):
        """-> list of (splitter fn: str -> List[str]) applied in sequence."""
        if spec is None:
            return []
        t = spec.get("type")
        if t == "Sequence":
            out = []
            for sub in spec["pretokenizers"]:
                out.extend(self._compile_pretokenizer(sub))
            return out
        if t == "ByteLevel":
            fns = []
            if spec.get("add_prefix_space"):
                # applies to the first piece of the section
                fns.append(("prefix_space", None))
            if spec.get("use_regex", True):
                rx = compile_pattern(_BYTELEVEL_PATTERN)
                fns.append(("split_iso", rx))
            fns.append(("bytelevel_map", None))
            return fns
        if t == "Split":
            pat, is_regex = _pattern_of(spec["pattern"])
            if spec.get("invert"):
                raise NotImplementedError("Split(invert=True)")
            behavior = spec.get("behavior", "Isolated").lower()
            rx = compile_pattern(pat) if is_regex else re.compile(re.escape(pat))
            if behavior == "isolated":
                return [("split_iso", rx)]
            if behavior == "removed":
                return [("split_rm", rx)]
            raise NotImplementedError(f"Split behavior {behavior!r}")
        if t == "Metaspace":
            rep = spec.get("replacement", "▁")
            prepend = spec.get("prepend_scheme", "always")
            if spec.get("split", True):
                return [("metaspace", (rep, prepend))]
            return [("metaspace_nosplit", (rep, prepend))]
        raise NotImplementedError(f"pre-tokenizer {t!r}")

    def _compile_post(self, spec):
        """-> template: list of ("special", token) / ("sequence", "A")."""
        if spec is None:
            return None
        t = spec.get("type")
        if t == "ByteLevel":
            return None  # affects offsets only, not ids
        if t == "Sequence":
            template = None
            for sub in spec["processors"]:
                tpl = self._compile_post(sub)
                if tpl is not None:
                    if template is not None:
                        raise NotImplementedError(
                            "multiple id-changing post-processors"
                        )
                    template = tpl
            return template
        if t == "TemplateProcessing":
            out = []
            for item in spec["single"]:
                if "SpecialToken" in item:
                    out.append(("special", item["SpecialToken"]["id"]))
                elif "Sequence" in item:
                    out.append(("sequence", item["Sequence"]["id"]))
                else:
                    raise NotImplementedError(f"template item {item!r}")
            return out
        if t in ("RobertaProcessing", "BertProcessing"):
            raise NotImplementedError(f"post-processor {t!r}")
        raise NotImplementedError(f"post-processor {t!r}")

    def _compile_decoder(self, spec):
        """-> list of steps applied to the token-string list / text."""
        if spec is None:
            return []
        t = spec.get("type")
        if t == "Sequence":
            out = []
            for sub in spec["decoders"]:
                out.extend(self._compile_decoder(sub))
            return out
        if t == "ByteLevel":
            return [("bytelevel", None)]
        if t == "Replace":
            pat, is_regex = _pattern_of(spec["pattern"])
            if is_regex:
                raise NotImplementedError("regex Replace decoder")
            return [("replace", (pat, spec["content"]))]
        if t == "ByteFallback":
            return [("byte_fallback", None)]
        if t == "Fuse":
            return [("fuse", None)]
        if t == "Strip":
            return [("strip", (spec.get("content", " "),
                               spec.get("start", 0), spec.get("stop", 0)))]
        if t == "Metaspace":
            return [("metaspace", spec.get("replacement", "▁"))]
        raise NotImplementedError(f"decoder {t!r}")

    # -- vocab / registration -------------------------------------------------

    def __len__(self) -> int:
        extra = sum(1 for c in self._added if c not in self._vocab)
        return len(self._vocab) + extra

    def _next_id(self) -> int:
        top = max(self._vocab_rev) if self._vocab_rev else -1
        if self._added_by_id:
            top = max(top, max(self._added_by_id))
        return top + 1

    def add_tokens(self, tokens: Iterable[Union[str, dict]],
                   special_tokens: bool = False) -> int:
        added = 0
        for t in tokens:
            content = t if isinstance(t, str) else t["content"]
            if content in self._added:
                if special_tokens:
                    self._added[content].special = True
                continue
            if content in self._vocab and not special_tokens:
                continue  # HF: existing non-special vocab entries are no-ops
            tid = self._vocab.get(content, self._next_id())
            tok = _AddedToken(content, tid, special=special_tokens)
            self._added[content] = tok
            self._added_by_id[tid] = tok
            if content not in self._vocab:
                added += 1
            self._trie = None
        return added

    def add_special_tokens(self, mapping: Dict[str, Union[str, List[str]]]) -> int:
        n = 0
        for role, token in mapping.items():
            if role == "additional_special_tokens":
                n += self.add_tokens(token, special_tokens=True)
                continue
            content = _token_content(token)
            n += self.add_tokens([content], special_tokens=True)
            setattr(self, role, content)
        return n

    def convert_tokens_to_ids(self, tokens: Union[str, List[str]]):
        if isinstance(tokens, str):
            return self._token_to_id(tokens)
        return [self._token_to_id(t) for t in tokens]

    def _token_to_id(self, token: str) -> int:
        at = self._added.get(token)
        if at is not None:
            return at.id
        if token in self._vocab:
            return self._vocab[token]
        if self._unk_token is not None and self._unk_token in self._vocab:
            return self._vocab[self._unk_token]
        return -1

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, (int, np.integer)):
            return self._id_to_token(int(ids))
        return [self._id_to_token(int(i)) for i in ids]

    def _id_to_token(self, tid: int) -> Optional[str]:
        at = self._added_by_id.get(tid)
        if at is not None:
            return at.content
        return self._vocab_rev.get(tid)

    @property
    def bos_token_id(self):
        return None if self.bos_token is None else self._token_to_id(self.bos_token)

    @property
    def eos_token_id(self):
        return None if self.eos_token is None else self._token_to_id(self.eos_token)

    @property
    def pad_token_id(self):
        return None if self.pad_token is None else self._token_to_id(self.pad_token)

    # -- added-token splitting -------------------------------------------------

    def _build_trie(self, normalized: bool):
        root: dict = {}
        for content, tok in self._added.items():
            if tok.normalized != normalized:
                continue
            if normalized:
                # tokenizers normalizes the PATTERN of normalized added
                # tokens (AddedVocabulary::add_tokens): under a Prepend("▁")
                # normalizer, "signal_0" only matches where the normalized
                # text carries "▁signal_0" (i.e. section starts / after a
                # space) — oracle-verified behavior, reproduced exactly.
                for fn in self._normalizers:
                    content = fn(content)
            node = root
            for ch in content:
                node = node.setdefault(ch, {})
            node[None] = tok
        return root

    def _split_added(self, text: str, normalized: bool) -> List[Tuple[bool, object]]:
        """-> [(is_added, _AddedToken | text-segment)]; leftmost-longest.

        Mirrors ``tokenizers``' AddedVocabulary two-pass extraction: the
        ``normalized=False`` pass runs on raw text (specials), the
        ``normalized=True`` pass runs on each normalized section (plain
        added tokens like ``signal_*``)."""
        if self._trie is None:
            self._trie = (self._build_trie(False), self._build_trie(True))
        root = self._trie[int(normalized)]
        if not root:
            return [(False, text)] if text else []
        out: List[Tuple[bool, object]] = []
        buf: List[str] = []
        i, n = 0, len(text)
        while i < n:
            node = root.get(text[i])
            best: Optional[_AddedToken] = None
            best_end = i
            j = i
            while node is not None:
                j += 1
                if None in node:
                    best, best_end = node[None], j
                node = node.get(text[j]) if j < n else None
            if best is None:
                buf.append(text[i])
                i += 1
                continue
            end = best_end
            start = i
            if best.single_word:
                prev_ok = start == 0 or not _is_word_char(text[start - 1])
                next_ok = end == n or not _is_word_char(text[end])
                if not (prev_ok and next_ok):
                    buf.append(text[i])
                    i += 1
                    continue
            if best.lstrip:
                while buf and buf[-1].isspace():
                    buf.pop()
            if buf:
                out.append((False, "".join(buf)))
                buf = []
            if best.rstrip:
                while end < n and text[end].isspace():
                    end += 1
            out.append((True, best))
            i = end
        if buf:
            out.append((False, "".join(buf)))
        return out

    # -- encoding ---------------------------------------------------------------

    def _pretokenize(self, text: str) -> List[str]:
        pieces = [text]
        for kind, arg in self._pretokenizers:
            if kind == "prefix_space":
                if pieces and pieces[0] and not pieces[0][0].isspace():
                    pieces[0] = " " + pieces[0]
            elif kind == "split_iso":
                pieces = [m for p in pieces for m in arg.findall(p)]
            elif kind == "split_rm":
                pieces = [m for p in pieces for m in arg.split(p) if m]
            elif kind == "bytelevel_map":
                table = bytes_to_unicode()
                pieces = [
                    "".join(table[b] for b in p.encode("utf-8")) for p in pieces
                ]
            elif kind in ("metaspace", "metaspace_nosplit"):
                rep, prepend = arg
                out = []
                for p in pieces:
                    p = p.replace(" ", rep)
                    if prepend == "always" and not p.startswith(rep):
                        p = rep + p
                    if kind == "metaspace":
                        out.extend(_metaspace_split(p, rep))
                    else:
                        out.append(p)
                pieces = out
        return [p for p in pieces if p]

    def _bpe(self, piece: str) -> Tuple[int, ...]:
        cached = self._bpe_cache.get(piece)
        if cached is not None:
            return cached
        if self._ignore_merges and piece in self._vocab:
            out = (self._vocab[piece],)
            self._bpe_cache[piece] = out
            return out
        parts = list(piece)
        ranks = self._ranks
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out: List[int] = []
        unk_run = False
        for p in parts:
            tid = self._vocab.get(p)
            if tid is not None:
                out.append(tid)
                unk_run = False
                continue
            if self._byte_fallback:
                fell = [
                    self._vocab.get(f"<0x{b:02X}>") for b in p.encode("utf-8")
                ]
                if all(f is not None for f in fell):
                    out.extend(fell)
                    unk_run = False
                    continue
            if self._unk_token is not None:
                if not (self._fuse_unk and unk_run):
                    out.append(self._vocab[self._unk_token])
                unk_run = True
            # no unk token: drop the piece (tokenizers' behavior)
        result = tuple(out)
        if len(self._bpe_cache) < 65536:
            self._bpe_cache[piece] = result
        return result

    def _encode_normalized(self, text: str) -> List[int]:
        """Pre-tokenize + BPE an already-normalized text span."""
        ids: List[int] = []
        if not self._pretokenizers:
            # no pre-tokenizer (Llama-2/Gemma class): the whole span is one
            # BPE piece over the normalized string
            return list(self._bpe(text)) if text else ids
        for piece in self._pretokenize(text):
            ids.extend(self._bpe(piece))
        return ids

    def _encode_section(self, text: str) -> List[int]:
        for fn in self._normalizers:
            text = fn(text)
        ids: List[int] = []
        for is_added, seg in self._split_added(text, normalized=True):
            if is_added:
                ids.append(seg.id)
            else:
                ids.extend(self._encode_normalized(seg))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for is_added, seg in self._split_added(text, normalized=False):
            if is_added:
                ids.append(seg.id)
            else:
                ids.extend(self._encode_section(seg))
        if add_special_tokens and self._post_single:
            out: List[int] = []
            for kind, val in self._post_single:
                if kind == "special":
                    out.append(self._token_to_id(val))
                else:
                    out.extend(ids)
            return out
        return ids

    def __call__(
        self,
        text: Union[str, List[str]],
        return_tensors: Optional[str] = None,
        add_special_tokens: bool = True,
        padding: Optional[Union[str, bool]] = None,
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
            if pad is None or pad < 0:
                pad = 0
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

    # -- decoding ---------------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        tokens: List[str] = []
        for tid in ids:
            tid = int(tid)
            at = self._added_by_id.get(tid)
            if at is not None:
                if skip_special_tokens and at.special:
                    continue
                tokens.append(at.content)
                continue
            tok = self._vocab_rev.get(tid)
            if tok is not None:
                tokens.append(tok)
        return self._run_decoder(tokens)

    def batch_decode(self, batch, skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(row, skip_special_tokens=skip_special_tokens)
                for row in batch]

    def _run_decoder(self, tokens: List[str]) -> str:
        if not self._decoders:
            return "".join(tokens)
        for kind, arg in self._decoders:
            if kind == "bytelevel":
                table = _unicode_to_bytes()
                buf = bytearray()
                for tok in tokens:
                    for ch in tok:
                        b = table.get(ch)
                        if b is not None:
                            buf.append(b)
                        else:  # added tokens may carry non-table chars
                            buf.extend(ch.encode("utf-8"))
                tokens = [buf.decode("utf-8", errors="replace")]
            elif kind == "replace":
                pat, content = arg
                tokens = [t.replace(pat, content) for t in tokens]
            elif kind == "byte_fallback":
                out: List[str] = []
                pend: List[int] = []

                def flush():
                    if pend:
                        out.append(bytes(pend).decode("utf-8", errors="replace"))
                        pend.clear()

                for t in tokens:
                    if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                        try:
                            pend.append(int(t[3:5], 16))
                            continue
                        except ValueError:
                            pass
                    flush()
                    out.append(t)
                flush()
                tokens = out
            elif kind == "fuse":
                tokens = ["".join(tokens)]
            elif kind == "strip":
                content, start, stop = arg
                out = []
                for t in tokens:
                    s = t
                    for _ in range(start):
                        if s.startswith(content):
                            s = s[len(content):]
                    for _ in range(stop):
                        if s.endswith(content):
                            s = s[: -len(content)]
                    out.append(s)
                tokens = out
            elif kind == "metaspace":
                tokens = [t.replace(arg, " ") for t in tokens]
                if tokens and tokens[0].startswith(" "):
                    tokens[0] = tokens[0][1:]
        return "".join(tokens)


# -- helpers ---------------------------------------------------------------


def _token_content(t):
    if t is None:
        return None
    if isinstance(t, dict):  # AddedToken serialization in configs
        return t.get("content")
    return t


def _is_word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


def _metaspace_split(p: str, rep: str) -> List[str]:
    """Metaspace 'split' behavior: split at replacement chars, keeping the
    replacement attached to the following piece (MergedWithNext)."""
    out: List[str] = []
    cur = ""
    for ch in p:
        if ch == rep and cur:
            out.append(cur)
            cur = ch
        else:
            cur += ch
    if cur:
        out.append(cur)
    return out


def _read_json(path):
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    return None


def _slow_gpt2_spec(vocab_json: str, merges_txt: str) -> dict:
    """Synthesize a fast-format spec from GPT-2 slow files."""
    with open(vocab_json, encoding="utf-8") as f:
        vocab = json.load(f)
    merges = []
    with open(merges_txt, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#version"):
                continue
            merges.append(line)
    return {
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "pre_tokenizer": {
            "type": "ByteLevel", "add_prefix_space": False, "use_regex": True,
        },
        "decoder": {"type": "ByteLevel"},
        "post_processor": None,
        "added_tokens": [],
        "normalizer": None,
    }
