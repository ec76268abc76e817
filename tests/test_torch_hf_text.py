"""The port's HF text tokenizer (``tokenizer/hf_text.py``) against
``tokenizers`` and the JAX package's ``HFTextTokenizer``, with the ``regex``
package blocked while the port's tokenizer loads and runs: its patterns
compile with the stdlib ``re``.

The oracle pipelines are those of ``tests/test_hf_text_tokenizer.py``:
GPT-2 byte-level, Llama-3 (Split on its pattern + ByteLevel, ignore_merges,
a bos template) and Llama-2/Gemma sentencepiece-BPE (Prepend/Replace
normalizer, byte_fallback), on texts with non-ASCII letters, digits of
other scripts, CJK, emoji and whitespace runs; the ECG tokens registered by
``register_ecg_tokens``; GPT-2's slow ``vocab.json`` + ``merges.txt``
format.  Ids and decodes must be equal.
"""

import json
import re
import sys

import pytest
import regex
from tokenizers import (
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    processors,
    trainers,
)

from ecg_byte_tpu.data.text_tokenizer import register_ecg_tokens as jax_register
from ecg_byte_tpu.tokenizer.hf_text import HFTextTokenizer as JaxHFTextTokenizer
from ecg_byte_tpu_torch.cli.make_flagship_fixture import LLAMA3_PATTERN
from ecg_byte_tpu_torch.data.text_tokenizer import load_text_tokenizer, register_ecg_tokens
from ecg_byte_tpu_torch.tokenizer import hf_text
from ecg_byte_tpu_torch.tokenizer.hf_text import HFTextTokenizer, compile_pattern

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "Hello World!",
    "  leading and trailing  ",
    "don't stop, it's 1234 tokens (really 56789)...",
    "What is the heart rate?   Answer: 72 bpm.",
    "Ünïcödé — ßtraße 🫀 ecg",
    "Ελληνικά ΚΕΦΑΛΑΙΑ, кириллица; ١٢٣٤٥ ٣٤٥٦ ૧૨૩",
    "漢字かなカナ 한국어 中文12",
    "line\nbreaks\r\n\ttabs sep nbsp　ideo",
    "info\x1cseparators\x1f here",
    "I'LL DON'T We'Re",
    "",
    "a",
    "signal_12 is plain text here",
]


@pytest.fixture
def no_regex(monkeypatch):
    """Any ``import regex`` raises while the port's tokenizer works."""
    monkeypatch.setitem(sys.modules, "regex", None)
    hf_text.compile_pattern.cache_clear()
    yield
    hf_text.compile_pattern.cache_clear()


@pytest.fixture(scope="module")
def corpus():
    return [
        "the quick brown fox jumps over the lazy dog",
        "hello world, Hello World!",
        "ecg signals 123 456 heart rate rhythm",
        "aaabdaaabac the theme thesis",
        "don't it's we've I'll wasn't",
        "What is the answer? The answer is 42.",
    ] * 20


def _train_bpe(corpus, vocab_size=400):
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=["<|endoftext|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(corpus, trainer)
    return tok


@pytest.fixture(scope="module")
def styles(tmp_path_factory, corpus):
    """name -> (tokenizer.json path, the ``tokenizers`` oracle)."""
    out = {}
    d = tmp_path_factory.mktemp("tok")

    gpt2 = _train_bpe(corpus)
    gpt2.decoder = decoders.ByteLevel()
    gpt2.post_processor = processors.ByteLevel(trim_offsets=True)
    out["gpt2"] = gpt2

    spec = json.loads(_train_bpe(corpus).to_str())
    llama3 = Tokenizer(models.BPE(vocab=spec["model"]["vocab"],
                                  merges=[tuple(m) for m in spec["model"]["merges"]],
                                  ignore_merges=True))
    llama3.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    llama3.decoder = decoders.ByteLevel()
    llama3.add_special_tokens([AddedToken("<|begin_of_text|>", special=True),
                               AddedToken("<|end_of_text|>", special=True)])
    llama3.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A",
        special_tokens=[("<|begin_of_text|>", llama3.token_to_id("<|begin_of_text|>"))])
    out["llama3"] = llama3

    words = sorted({w for line in corpus for w in line.split()})
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for c in sorted({c for w in words for c in w} | {"▁"}):
        vocab.setdefault(c, len(vocab))
    merges = []
    for a, b in [("▁", "t"), ("t", "h"), ("▁t", "he"), ("h", "e"), ("e", "r"), ("a", "n"),
                 ("▁", "a"), ("i", "s"), ("▁a", "n"), ("▁", "is"), ("r", "s")]:
        if a in vocab and b in vocab:
            vocab.setdefault(a + b, len(vocab))
            merges.append((a, b))
    llama2 = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>",
                                  byte_fallback=True, fuse_unk=True))
    llama2.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                              normalizers.Replace(" ", "▁")])
    llama2.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                        decoders.Fuse(), decoders.Strip(content=" ", left=1)])
    llama2.add_special_tokens([AddedToken("<s>", special=True), AddedToken("</s>", special=True)])
    llama2.post_processor = processors.TemplateProcessing(single="<s> $A",
                                                          special_tokens=[("<s>", 1)])
    out["llama2"] = llama2

    # a regex Replace normalizer and a removed Split with \P{..} classes
    other = _train_bpe(corpus)
    other.normalizer = normalizers.Replace(Regex(r"\p{Nd}+"), "#")
    other.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(r"[\s\p{P}]+"), behavior="removed"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True),
    ])
    other.decoder = decoders.ByteLevel()
    out["regex_normalizer"] = other

    paths = {}
    for name, tok in out.items():
        paths[name] = d / f"{name}.json"
        tok.save(str(paths[name]))
    return {name: (paths[name], tok) for name, tok in out.items()}


BACKBONES = ["gpt2", "llama3", "llama2"]
STYLES = BACKBONES + ["regex_normalizer"]


@pytest.mark.parametrize("style", STYLES)
def test_ids_and_decodes_match_oracles(style, styles, no_regex):
    path, oracle = styles[style]
    mine = HFTextTokenizer.from_pretrained(str(path))
    for text in TEXTS:
        for specials in (False, True):
            assert mine.encode(text, add_special_tokens=specials) == oracle.encode(
                text, add_special_tokens=specials).ids, (style, specials, text)
        ids = oracle.encode(text).ids
        for skip in (False, True):
            assert mine.decode(ids, skip_special_tokens=skip) == oracle.decode(
                ids, skip_special_tokens=skip), (style, skip, text)


@pytest.mark.parametrize("style", STYLES)
def test_ids_match_jax_tokenizer(style, styles):
    path, _ = styles[style]
    jax_tok = JaxHFTextTokenizer.from_pretrained(str(path))
    want = [jax_tok.encode(t) for t in TEXTS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "regex", None)
        mine = HFTextTokenizer.from_pretrained(str(path))
        assert [mine.encode(t) for t in TEXTS] == want


@pytest.mark.parametrize("style", BACKBONES)
def test_ecg_token_registration_matches_oracle(style, styles, no_regex):
    """``register_ecg_tokens`` unchanged on an HF tokenizer: ``signal_*``
    plain added tokens, ``<sig_start>``, ``<sig_end>`` and ``<pad>``
    specials; mixed text encodes and decodes as ``tokenizers`` does."""
    path, _ = styles[style]
    mine = HFTextTokenizer.from_pretrained(str(path))
    oracle = Tokenizer.from_file(str(path))
    vocab = {str(i): "x" for i in range(40)}
    n = register_ecg_tokens(mine, vocab)
    oracle.add_tokens([f"signal_{i}" for i in range(40)])
    oracle.add_special_tokens([AddedToken(t, special=True)
                               for t in ("<sig_start>", "<sig_end>", "<pad>")])
    assert n == oracle.get_vocab_size(with_added_tokens=True)
    assert mine.pad_token == "<pad>" and mine.pad_token_id == oracle.token_to_id("<pad>")
    assert mine.convert_tokens_to_ids(["<sig_start>", "signal_7"]) == [
        oracle.token_to_id("<sig_start>"), oracle.token_to_id("signal_7")]
    for text in ["<sig_start>signal_0signal_12signal_39<sig_end>What rhythm is shown?",
                 "plain text then signal_7 inline", "signal_1signal_1signal_1",
                 "<pad><pad>answer", "Ünïcödé signal_3 ١٢٣"]:
        want = oracle.encode(text, add_special_tokens=False).ids
        assert mine.encode(text, add_special_tokens=False) == want, text
        for skip in (False, True):
            assert mine.decode(want, skip_special_tokens=skip) == oracle.decode(
                want, skip_special_tokens=skip), (text, skip)


def test_registration_matches_jax(styles):
    path, _ = styles["llama3"]
    vocab = {str(i): "x" for i in range(25)}
    jax_tok = JaxHFTextTokenizer.from_pretrained(str(path))
    n = jax_register(jax_tok, vocab)
    mine = HFTextTokenizer.from_pretrained(str(path))
    assert register_ecg_tokens(mine, vocab) == n
    text = "<sig_start>signal_3signal_24<sig_end>Could you please help me explain my ECG?"
    assert mine.encode(text) == jax_tok.encode(text)
    assert mine.pad_token_id == jax_tok.pad_token_id


def test_slow_gpt2_format(tmp_path, styles, no_regex):
    """``vocab.json`` + ``merges.txt`` load into the same pipeline."""
    _, oracle = styles["gpt2"]
    spec = json.loads(oracle.to_str())
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump(spec["model"]["vocab"], f)
    with open(tmp_path / "merges.txt", "w") as f:
        f.write("#version: 0.2\n")
        for a, b in spec["model"]["merges"]:
            f.write(f"{a} {b}\n")
    with open(tmp_path / "tokenizer_config.json", "w") as f:
        json.dump({"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>"}, f)
    mine = load_text_tokenizer(str(tmp_path))
    for text in TEXTS:
        assert mine.encode(text, add_special_tokens=False) == oracle.encode(
            text, add_special_tokens=False).ids, text
    assert mine.eos_token == "<|endoftext|>"


def test_patterns_match_regex_on_assigned_code_points(no_regex):
    """``compile_pattern``'s ``findall`` equals the ``regex`` package's (the
    module was imported before it was blocked) on random text of code
    points assigned in Python's Unicode version, ``\\s`` and ``\\P{..}``
    inside classes included; an unsupported property raises."""
    import random
    import unicodedata

    rnd = random.Random(0)

    def char():
        while True:
            c = chr(rnd.choice([rnd.randrange(0x20, 0x7F), rnd.randrange(0, 0x3000),
                                rnd.randrange(0, 0x30000), 0x20, 0x0A, 0x1C, 0x27]))
            if unicodedata.category(c) != "Cn":
                return c

    patterns = [LLAMA3_PATTERN, hf_text._BYTELEVEL_PATTERN, r"\P{L}+", r"[\P{N}x]+",
                r"\p{Lu}\p{Nd}*", r"[^\S\n]+", r"\p{L&}+|\p{Letter}", r"\pN\p{^L}"]
    pairs = [(compile_pattern(p), regex.compile(p)) for p in patterns]
    for _ in range(400):
        text = "".join(char() for _ in range(40))
        for mine, theirs in pairs:
            assert mine.findall(text) == theirs.findall(text), (mine.pattern[:60], text)
    with pytest.raises(NotImplementedError):
        compile_pattern(r"\p{Han}+")
    assert isinstance(compile_pattern(r"\p{N}"), re.Pattern)


def test_unsupported_component_raises_at_load():
    spec = {"model": {"type": "BPE", "vocab": {"a": 0}, "merges": []},
            "pre_tokenizer": {"type": "Digits", "individual_digits": True}}
    with pytest.raises(NotImplementedError):
        HFTextTokenizer(spec)
    with pytest.raises(NotImplementedError):
        HFTextTokenizer({"model": {"type": "WordPiece", "vocab": {"a": 0}}})


def test_transformers_cross_check_switch(tmp_path, styles, monkeypatch):
    """``ECG_BYTE_TEXT_TOKENIZER=transformers`` loads ``AutoTokenizer``
    instead; both give the same ids and the same registration."""
    import shutil

    path, _ = styles["llama3"]
    shutil.copy(path, tmp_path / "tokenizer.json")
    with open(tmp_path / "tokenizer_config.json", "w") as f:
        json.dump({"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
                   "tokenizer_class": "PreTrainedTokenizerFast"}, f)
    monkeypatch.delenv("ECG_BYTE_TEXT_TOKENIZER", raising=False)
    mine = load_text_tokenizer(str(tmp_path))
    assert isinstance(mine, HFTextTokenizer)
    monkeypatch.setenv("ECG_BYTE_TEXT_TOKENIZER", "transformers")
    hf = load_text_tokenizer(str(tmp_path))
    assert not isinstance(hf, HFTextTokenizer)
    vocab = {str(i): "x" for i in range(12)}
    assert register_ecg_tokens(mine, vocab) == register_ecg_tokens(hf, vocab)
    for text in TEXTS + ["<sig_start>signal_3signal_11<sig_end>Could you explain my ECG?"]:
        assert mine.encode(text) == hf.encode(text), text
    assert mine.pad_token_id == hf.pad_token_id and mine.bos_token_id == hf.bos_token_id
