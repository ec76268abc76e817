"""Read local HuggingFace checkpoints into the port's parameter layout.

The port of ``ecg_byte_tpu/models/hf_loader.py`` for ``--hf_weights``: a
local HF model directory (``config.json`` + ``*.safetensors``) becomes the
port's parameter dict (``models/transformer.py``): one dict per layer, and
every projection in PyTorch's ``(out, in)`` layout.  No network: point
``--hf_weights`` at a directory already on disk.

Safetensors is read and written here, without the ``safetensors`` package
(the card's machine has none): an 8-byte little-endian header length, a
JSON header of ``{name: {"dtype", "shape", "data_offsets"}}`` and the raw
little-endian bytes.  The reader maps each file and takes every tensor with
``torch.frombuffer`` at its offsets, so bf16 never passes through a numpy
float.

Layout:
  - Llama and Gemma store ``nn.Linear`` weights ``(out, in)``: taken as
    stored.
  - GPT-2 stores ``Conv1D`` weights ``(in, out)``: transposed, and the fused
    ``c_attn`` split into q, k, v along dim 0 after the transpose.  Its keys
    may carry a ``transformer.`` prefix.
  - An untied ``lm_head.weight`` is ``(V, D)``, as the port keeps it.
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Any, Dict, Mapping, Tuple

import torch

from ecg_byte_tpu_torch.models.config import TransformerConfig

# safetensors dtype names <-> torch dtypes: those of HF LM and BERT
# checkpoints and their token ids
_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors that share
    the file's (copy-on-write) mapping; copy what must outlive it."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        # ACCESS_COPY: a writable view for torch.frombuffer that never
        # writes back to the file
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(meta["dtype"])
        if dtype is None:
            raise NotImplementedError(f"{path}: tensor {name!r} has dtype {meta['dtype']}")
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        numel = 1
        for d in shape:
            numel *= d
        if count != numel or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} {shape} does not fit its data_offsets")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(mm, dtype=dtype, count=count, offset=base + begin).view(shape)
    return out


def load_safetensors(model_dir: str) -> Dict[str, torch.Tensor]:
    """The tensors of every ``*.safetensors`` under ``model_dir``, shards in
    sorted order (a later shard's key replaces an earlier one's)."""
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors_file(os.path.join(model_dir, fname)))
    return tensors


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> int:
    """Write ``tensors`` (any device; copied to the host one at a time) as
    one safetensors file; returns the bytes of tensor data written.  The
    header is padded with spaces to a multiple of 8 bytes and carries
    ``{"format": "pt"}``, which ``transformers`` asks of a PyTorch file."""
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise NotImplementedError(f"tensor {name!r}: dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().view(-1).view(torch.uint8).numpy())
    return offset


def config_from_hf(model_dir: str) -> TransformerConfig:
    """The port's TransformerConfig from an HF ``config.json``."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "llama")
    if mt == "gpt2":
        return TransformerConfig(
            arch="gpt2",
            vocab_size=hf["vocab_size"],
            hidden_size=hf["n_embd"],
            num_layers=hf["n_layer"],
            num_heads=hf["n_head"],
            num_kv_heads=hf["n_head"],
            head_dim=hf["n_embd"] // hf["n_head"],
            intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
            max_position_embeddings=hf["n_positions"],
            norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=True,
            learned_pos_embeddings=True,
            use_bias=True,
            hidden_act="gelu",
            lora_targets=("q_proj", "v_proj"),
        )
    arch = "gemma" if mt.startswith("gemma") else "llama"
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    # Llama-3.1/3.2 ship {"rope_type": "llama3", ...}: HF rescales inv_freq
    # at every position, so the config must carry it
    rope_kw = {}
    rs = hf.get("rope_scaling") or {}
    if rs:
        rope_kw = dict(
            rope_scaling_type=rs.get("rope_type", rs.get("type")),
            rope_scaling_factor=float(rs.get("factor", 1.0)),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_original_max_position=int(rs.get("original_max_position_embeddings", 8192)),
        )
    return TransformerConfig(
        arch=arch,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", arch == "gemma"),
        embed_scale=arch == "gemma",
        rmsnorm_unit_offset=arch == "gemma",
        hidden_act="gelu_tanh" if arch == "gemma" else "silu",
        **rope_kw,
    )


def load_hf_checkpoint(model_dir: str, dtype: str = "bfloat16",
                       device=None) -> Tuple[Dict[str, Any], TransformerConfig]:
    """A local HF model directory -> (params, config), params in ``dtype``
    on ``device`` (default the CUDA card)."""
    device = torch.device("cuda" if device is None else device)
    config = config_from_hf(model_dir).replace(dtype=dtype)
    t = load_safetensors(model_dir)
    dt = getattr(torch, dtype)

    def take(w: torch.Tensor) -> torch.Tensor:
        # a copy, in the model's dtype and on its device, that no longer
        # shares the file's mapping
        return w.to(device=device, dtype=dt, copy=True).contiguous()

    layers = []
    if config.arch in ("llama", "gemma"):
        projs = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
                 "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp",
                 "down_proj": "mlp"}
        for i in range(config.num_layers):
            p = f"model.layers.{i}."
            layer: Dict[str, Any] = {
                "attn_norm": take(t[p + "input_layernorm.weight"]),
                "mlp_norm": take(t[p + "post_attention_layernorm.weight"]),
            }
            for name, block in projs.items():
                layer[name] = {"weight": take(t[f"{p}{block}.{name}.weight"])}
            layers.append(layer)
        params: Dict[str, Any] = {
            "embed": take(t["model.embed_tokens.weight"]),
            "layers": layers,
            "final_norm": take(t["model.norm.weight"]),
        }
        if not config.tie_word_embeddings:
            params["lm_head"] = take(t["lm_head.weight"])
        return params, config

    def g(key):
        return t[key] if key in t else t[f"transformer.{key}"]

    for i in range(config.num_layers):
        p = f"h.{i}."
        qkv_w = g(p + "attn.c_attn.weight").t()  # (in, 3D) -> (3D, in)
        qkv_b = g(p + "attn.c_attn.bias")
        layer = {
            "attn_norm": take(g(p + "ln_1.weight")),
            "attn_norm_bias": take(g(p + "ln_1.bias")),
            "mlp_norm": take(g(p + "ln_2.weight")),
            "mlp_norm_bias": take(g(p + "ln_2.bias")),
        }
        for name, w, b in zip(("q_proj", "k_proj", "v_proj"), qkv_w.chunk(3, 0), qkv_b.chunk(3, 0)):
            layer[name] = {"weight": take(w), "bias": take(b)}
        for name, key in (("o_proj", "attn.c_proj"), ("up_proj", "mlp.c_fc"),
                          ("down_proj", "mlp.c_proj")):
            layer[name] = {"weight": take(g(f"{p}{key}.weight").t()),
                           "bias": take(g(f"{p}{key}.bias"))}
        layers.append(layer)
    params = {
        "embed": take(g("wte.weight")),
        "pos_embed": take(g("wpe.weight")),
        "layers": layers,
        "final_norm": take(g("ln_f.weight")),
        "final_norm_bias": take(g("ln_f.bias")),
    }
    return params, config
