"""Size-exact stand-in for a Llama-3.2-1B checkpoint directory.

The port of ``ecg_byte_tpu/cli/make_flagship_fixture.py``, with no
``safetensors``, ``tokenizers`` or ``ml_dtypes``.  Published Llama-3.2-1B
weights are not on disk here, so ``cli.main --hf_weights <dir>`` (2.47 GB
safetensors read, a 128,256-row ``tokenizer.json``, the ECG tokens added,
the embedding resized, LoRA training, serving) is driven on a directory of
the same format: Llama-3.2-1B's ``config.json`` values, its safetensors
keys and bf16 dtype in one ``model.safetensors`` (tied embeddings, no
``lm_head``), and a ``tokenizer.json`` of the Llama-3 pipeline at the full
vocabulary, with random weights and a synthetic BPE.

Weights: numpy's ``default_rng(seed).standard_normal(shape, float32) *
0.02`` in the JAX fixture's order, cast to bf16 by torch's
round-to-nearest-even, so the file holds the JAX fixture's tensors bit for
bit at either size (1.24 G values at full size, drawn on the host).
Written by the port's safetensors writer (``models/hf_loader.py``).

Tokenizer: ``tokenizer.json`` as the ``tokenizers`` library serializes it:
BPE with ``ignore_merges`` over the byte-level alphabet (256 characters,
``bytes_to_unicode``), all 2-character pairs and 3-character extensions;
the pre-tokenizers Split on the Llama-3 pattern then ByteLevel without its
own pattern; the bos template post-processor; the ByteLevel decoder; 256
special tokens at full size, 2 with ``--tiny``.  Also
``tokenizer_config.json``, ``special_tokens_map.json`` and a stamp that
makes a second call with the same directory a no-op.

Usage:
  python -m ecg_byte_tpu_torch.cli.make_flagship_fixture --out <dir>
  python -m ecg_byte_tpu_torch.cli.make_flagship_fixture --out <dir> --tiny
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ecg_byte_tpu_torch.models.hf_loader import save_safetensors
from ecg_byte_tpu_torch.tokenizer.hf_text import bytes_to_unicode

# Llama-3.2-1B's config.json values (what models/hf_loader.config_from_hf
# reads)
_FLAGSHIP_CONFIG = {
    "architectures": ["LlamaForCausalLM"],
    "model_type": "llama",
    "hidden_size": 2048,
    "intermediate_size": 8192,
    "num_hidden_layers": 16,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": 64,
    "vocab_size": 128256,
    "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-05,
    "rope_theta": 500000.0,
    "rope_scaling": {
        "factor": 32.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    "tie_word_embeddings": True,
    "torch_dtype": "bfloat16",
    "bos_token_id": 128000,
    "eos_token_id": 128001,
}

_TINY_CONFIG = {
    **_FLAGSHIP_CONFIG,
    "hidden_size": 64,
    "intermediate_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "head_dim": 16,
    "vocab_size": 1280,
    # 1278 base tokens + the bos/eos specials (2 specials under 100k)
    "bos_token_id": 1278,
    "eos_token_id": 1279,
}

# the Llama-3 pre-tokenizer's split pattern, as every converted Llama-3
# tokenizer.json ships it
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def weight_stream(cfg: dict, seed: int = 0):
    """Yield (name, random bf16 tensor) in the HF single-shard key layout of
    Llama-3.2-1B, drawn in order: the first k items need only k draws."""
    rng = np.random.default_rng(seed)
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    KV = cfg["num_key_value_heads"] * cfg["head_dim"]
    Q = cfg["num_attention_heads"] * cfg["head_dim"]

    def w(*shape, std=0.02):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * std).to(
            torch.bfloat16)

    def ones():
        return torch.ones(H, dtype=torch.bfloat16)

    yield "model.embed_tokens.weight", w(cfg["vocab_size"], H)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        yield p + "input_layernorm.weight", ones()
        yield p + "self_attn.q_proj.weight", w(Q, H)
        yield p + "self_attn.k_proj.weight", w(KV, H)
        yield p + "self_attn.v_proj.weight", w(KV, H)
        yield p + "self_attn.o_proj.weight", w(H, Q)
        yield p + "post_attention_layernorm.weight", ones()
        yield p + "mlp.gate_proj.weight", w(I, H)
        yield p + "mlp.up_proj.weight", w(I, H)
        yield p + "mlp.down_proj.weight", w(H, I)
    yield "model.norm.weight", ones()


def synthetic_bpe(n_vocab: int) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """A deterministic byte-level BPE of ``n_vocab`` rows: the 256-character
    alphabet, then every 2-character pair, then 3-character extensions, each
    made by exactly one merge."""
    alphabet = sorted(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(alphabet)}
    merges: List[Tuple[str, str]] = []
    two_char: List[str] = []
    n_more = n_vocab - len(alphabet)
    for a in alphabet:
        for b in alphabet:
            if len(merges) >= n_more:
                break
            vocab[a + b] = len(vocab)
            merges.append((a, b))
            two_char.append(a + b)
        if len(merges) >= n_more:
            break
    idx = 0
    while len(merges) < n_more:
        m, c = divmod(idx, len(alphabet))
        vocab[two_char[m] + alphabet[c]] = len(vocab)
        merges.append((two_char[m], alphabet[c]))
        idx += 1
    return vocab, merges


def _special_tokens(n: int) -> List[str]:
    specials = ["<|begin_of_text|>", "<|end_of_text|>"]
    named = ["<|finetune_right_pad_id|>", "<|start_header_id|>", "<|end_header_id|>",
             "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
    while len(specials) < n:
        specials.append(named.pop(0) if named
                        else f"<|reserved_special_token_{len(specials) - 2}|>")
    return specials


def tokenizer_spec(cfg: dict) -> dict:
    """The ``tokenizer.json`` object of the fixture's tokenizer."""
    n_specials = 256 if cfg["vocab_size"] > 100000 else 2
    vocab, merges = synthetic_bpe(cfg["vocab_size"] - n_specials)
    specials = _special_tokens(n_specials)
    added = [{"id": len(vocab) + i, "content": s, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, s in enumerate(specials)]
    bos = specials[0]

    def special(type_id):
        return {"SpecialToken": {"id": bos, "type_id": type_id}}

    def seq(name, type_id):
        return {"Sequence": {"id": name, "type_id": type_id}}

    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False},
        ]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [special(0), seq("A", 0)],
            "pair": [special(0), seq("A", 0), special(0), seq("B", 1)],
            "special_tokens": {bos: {"id": bos, "ids": [len(vocab)], "tokens": [bos]}},
        },
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }


def write_tokenizer(out_dir: str, cfg: dict) -> int:
    """Write ``tokenizer.json``, ``tokenizer_config.json`` and
    ``special_tokens_map.json``; returns the vocabulary size with specials."""
    spec = tokenizer_spec(cfg)
    with open(os.path.join(out_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False, indent=2)
    bos, eos = spec["added_tokens"][0]["content"], spec["added_tokens"][1]["content"]
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": bos, "eos_token": eos,
                   "model_max_length": cfg["max_position_embeddings"],
                   "tokenizer_class": "PreTrainedTokenizerFast"}, f)
    with open(os.path.join(out_dir, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": bos, "eos_token": eos}, f)
    return len(spec["model"]["vocab"]) + len(spec["added_tokens"])


def make_fixture(out_dir: str, tiny: bool = False, seed: int = 0, force: bool = False) -> dict:
    """Write the fixture (a no-op when its stamp is there); return its stats."""
    stamp = os.path.join(out_dir, ".fixture_complete.json")
    if os.path.exists(stamp) and not force:
        with open(stamp) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    cfg = _TINY_CONFIG if tiny else _FLAGSHIP_CONFIG
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    t0 = time.perf_counter()
    tensors = dict(weight_stream(cfg, seed))
    t_draw = time.perf_counter() - t0
    n_bytes = save_safetensors(tensors, os.path.join(out_dir, "model.safetensors"))
    t_w = time.perf_counter() - t0
    del tensors
    t0 = time.perf_counter()
    n_vocab = write_tokenizer(out_dir, cfg)
    t_t = time.perf_counter() - t0
    stats = {
        "weight_bytes": n_bytes,
        "tokenizer_vocab": n_vocab,
        "tokenizer_json_bytes": os.path.getsize(os.path.join(out_dir, "tokenizer.json")),
        "draw_weights_s": round(t_draw, 1),
        "write_weights_s": round(t_w, 1),
        "write_tokenizer_s": round(t_t, 1),
    }
    with open(stamp, "w") as f:
        json.dump(stats, f)
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--tiny", action="store_true",
                   help="small shapes, the same layout (for CPU tests)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    stats = make_fixture(args.out, tiny=args.tiny, seed=args.seed, force=args.force)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
