"""Random weights from a seed, made on the device in a few large calls.

The benchmark makes the weights itself and hands the same values to the
program and to the plain reference: one ``torch.Generator`` on the device,
seeded with ``--seed``, draws every dense matrix in one ``randn`` call in
the served dtype, every norm weight in one ``rand`` call and every bias in
one ``randn`` call; each tensor is a contiguous view of its block.  The
tree has the program's layout (``embed``, ``pos_embed``, ``final_norm``,
``layers[i][name]["weight"]`` ...), which the reference reads as well.

Scales: dense N(0, 0.02) (``initializer_range``), norm weights U[0.8, 1.2)
and biases N(0, 0.02), so no norm weight is exactly 1 and no bias is 0.
LoRA: A uniform in +-d_in^-0.5, B zero, as PEFT and the program start.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench_port.spec import Spec

Shape = Tuple[int, ...]


def _layout(s: Spec):
    """(path, shape, kind) of every tensor, in a fixed order; kind is
    "dense", "norm" or "bias"."""
    out: List[Tuple[tuple, Shape, str]] = [(("embed",), (s.vocab, s.hidden), "dense")]
    if s.model_type == "gpt2":
        out.append((("pos_embed",), (s.max_positions, s.hidden), "dense"))
    out.append((("final_norm",), (s.hidden,), "norm"))
    if s.bias:
        out.append((("final_norm_bias",), (s.hidden,), "bias"))
    if not s.tie:
        out.append((("lm_head",), (s.vocab, s.hidden), "dense"))
    for i in range(s.layers):
        for norm in ("attn_norm", "mlp_norm"):
            out.append((("layers", i, norm), (s.hidden,), "norm"))
            if s.bias:
                out.append((("layers", i, norm + "_bias"), (s.hidden,), "bias"))
        for name, (d_in, d_out) in s.proj_dims().items():
            out.append((("layers", i, name, "weight"), (d_out, d_in), "dense"))
            if s.bias:
                out.append((("layers", i, name, "bias"), (d_out,), "bias"))
    return out


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def _numel(shape: Shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


def make_weights(s: Spec, seed: int, device, dtype: torch.dtype) -> Dict:
    """The base weights of ``s`` from ``seed``, on ``device`` in ``dtype``.
    The same seed, device and dtype give the same values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    layout = _layout(s)
    sizes = {k: sum(_numel(sh) for _, sh, kind in layout if kind == k)
             for k in ("dense", "norm", "bias")}
    blocks = {
        "dense": torch.randn(sizes["dense"], generator=gen, device=device, dtype=dtype).mul_(0.02),
        "norm": torch.rand(sizes["norm"], generator=gen, device=device, dtype=dtype
                           ).mul_(0.4).add_(0.8),
        "bias": torch.randn(sizes["bias"], generator=gen, device=device, dtype=dtype).mul_(0.02),
    }
    tree: Dict = {"layers": [{name: {} for name in s.proj_dims()} for _ in range(s.layers)]}
    offset = dict.fromkeys(blocks, 0)
    for path, shape, kind in layout:
        n = _numel(shape)
        _put(tree, path, blocks[kind][offset[kind]:offset[kind] + n].view(shape))
        offset[kind] += n
    return tree


def make_lora(s: Spec, seed: int, device, dtype: torch.dtype) -> Dict:
    """The adapters ``{"layers": [{name: {"a": (in, r), "b": (r, out)}}]}``
    on ``s.targets()``: A from one ``rand`` call (a generator seeded with
    ``seed + 1``), B zero."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dims = s.proj_dims()
    targets = s.targets()
    r = s.lora_rank
    total = s.layers * sum(dims[n][0] * r for n in targets)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    layers, off = [], 0
    for _ in range(s.layers):
        layer = {}
        for name in targets:
            d_in, d_out = dims[name]
            bound = d_in ** -0.5
            a = u[off:off + d_in * r].view(d_in, r)
            off += d_in * r
            layer[name] = {"a": (a * (2 * bound) - bound).to(dtype),
                           "b": torch.zeros(r, d_out, device=device, dtype=dtype)}
        layers.append(layer)
    return {"layers": layers}


def lora_leaves(lora: Dict):
    """``((layer, name, "a" | "b"), tensor)`` of every adapter tensor."""
    for i, layer in enumerate(lora["layers"]):
        for name in sorted(layer):
            for ab in ("a", "b"):
                yield (i, name, ab), layer[name][ab]


def to_f32(tree):
    """A float32 copy of a tree of tensors (the reference's weights)."""
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    return [to_f32(v) for v in tree]
