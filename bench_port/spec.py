"""The shapes of a configuration file, read into one plain record.

A configuration file (``configs/<name>.json``) keeps the keys of the
model's published ``config.json`` (GPT-2's ``n_embd`` ..., Llama's
``hidden_size`` ...).  :func:`spec` reads either family into the same
fields, which the weight maker, the traffic generator, the counts and the
plain reference share.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Spec:
    model_type: str  # "gpt2" | "llama"
    vocab: int  # the vocabulary as run: the text vocabulary and the ECG tokens
    text_vocab: int  # the published text vocabulary
    signal_tokens: int  # the ECG-BPE vocabulary (alphabet + merges)
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    inner: int
    max_positions: int
    eps: float
    rope_theta: float
    tie: bool
    bos: int
    eos: int
    dtype: str
    lora_rank: int
    lora_alpha: float
    lora_dropout: float
    lora_targets: Tuple[str, ...]

    @property
    def gated(self) -> bool:
        return self.model_type == "llama"

    @property
    def bias(self) -> bool:
        return self.model_type == "gpt2"

    @property
    def sig_start(self) -> int:
        return self.text_vocab + self.signal_tokens

    @property
    def sig_end(self) -> int:
        return self.sig_start + 1

    @property
    def pad(self) -> int:
        return self.sig_start + 2

    def proj_dims(self):
        """name -> (d_in, d_out) of every projection of a block, in order."""
        q, kv = self.heads * self.head_dim, self.kv_heads * self.head_dim
        dims = {"q_proj": (self.hidden, q), "k_proj": (self.hidden, kv),
                "v_proj": (self.hidden, kv), "o_proj": (q, self.hidden)}
        if self.gated:
            dims["gate_proj"] = (self.hidden, self.inner)
        dims["up_proj"] = (self.hidden, self.inner)
        dims["down_proj"] = (self.inner, self.hidden)
        return dims

    def targets(self):
        """The projections that carry adapters, in block order."""
        return [n for n in self.proj_dims() if n in self.lora_targets]


def spec(cfg: dict) -> Spec:
    """The :class:`Spec` of a configuration file's dict."""
    lora = cfg["lora"]
    common = dict(
        vocab=cfg["vocab_size"], text_vocab=cfg["text_vocab_size"],
        signal_tokens=cfg["signal_tokens"], tie=cfg["tie_word_embeddings"],
        bos=cfg["bos_token_id"], eos=cfg["eos_token_id"], dtype=cfg["dtype"],
        lora_rank=lora["r"], lora_alpha=float(lora["alpha"]), lora_dropout=float(lora["dropout"]),
        lora_targets=tuple(lora["targets"]),
    )
    if cfg["vocab_size"] != cfg["text_vocab_size"] + cfg["signal_tokens"] + 3:
        raise ValueError("vocab_size must be the text vocabulary, the signal tokens and "
                         "<sig_start>, <sig_end>, <pad>")
    if cfg["model_type"] == "gpt2":
        d, h = cfg["n_embd"], cfg["n_head"]
        return Spec(model_type="gpt2", hidden=d, layers=cfg["n_layer"], heads=h, kv_heads=h,
                    head_dim=d // h, inner=cfg.get("n_inner") or 4 * d,
                    max_positions=cfg["n_positions"], eps=cfg["layer_norm_epsilon"],
                    rope_theta=0.0, **common)
    if cfg["model_type"] == "llama":
        if cfg.get("rope_scaling"):
            raise ValueError("rope_scaling is not read by the reference")
        h = cfg["num_attention_heads"]
        return Spec(model_type="llama", hidden=cfg["hidden_size"],
                    layers=cfg["num_hidden_layers"], heads=h,
                    kv_heads=cfg["num_key_value_heads"],
                    head_dim=cfg.get("head_dim") or cfg["hidden_size"] // h,
                    inner=cfg["intermediate_size"],
                    max_positions=cfg["max_position_embeddings"], eps=cfg["rms_norm_eps"],
                    rope_theta=float(cfg["rope_theta"]), **common)
    raise ValueError(f"unknown model_type {cfg['model_type']!r}")
