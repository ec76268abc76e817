"""The rank's shard of a one-process tree under ``--tp`` and ``--fsdp``, and
its inverse: the port of ``ecg_byte_tpu/parallel/sharding.py`` and of
``train/step.shard_state``'s placement.

The JAX specs, in the port's ``(out, in)`` layout:

- q/k/v, gate and up (column-parallel): the output (head or I) dimension
  over tp, the input over fsdp (ZeRO-3); their biases over tp;
- o and down (row-parallel): the input over tp, the output over fsdp;
  their biases over fsdp;
- the embedding and an untied head (V, D): V over tp, D over fsdp; learned
  positions: D over fsdp; the norms whole on every rank;
- LoRA follows its base projection on tp only (``lora_specs``): in a
  column group A whole and B split on its output; in o/down A split on its
  input and B whole.

:func:`shard_tree` takes this rank's block of each tensor (tp first, then
fsdp), as contiguous tensors: the heads of a rank are adjacent, so its q,
k and v products make its heads directly.  A dimension that the group does
not divide is padded at its end to ``ceil(N / n)`` a rank with zeros; the
padded rows never reach a result (the vocabulary's are sliced off before
the logits and masked out of the lookup, ``models/transformer.py``) and
their gradient is 0, so Adam leaves them at 0.  Each shard carries its :class:`Split` and the
whole tensor's shape (:func:`split_of`), which the step reads to pick the
group its gradient sums over and the clip reads to count it once;
:func:`gather_tree` is the whole tree again, on every rank.

A norm-folded tree (``transformer.fold_norm_scales``) is refused: the JAX
specs have no entry for its ``attn_norm_w`` / ``mlp_norm_w``, so the JAX
package cannot shard one, and the port does not shard it some other way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ecg_byte_tpu_torch.parallel import distributed, mesh

COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")
_ATTR = "_ecg_byte_split"
FOLDED_UNSHARDED = (
    "a norm-folded tree (fold_norm_scales) cannot be sharded under --tp or --fsdp: the JAX "
    "package's sharding specs have no entry for its attn_norm_w / mlp_norm_w "
    "(ecg_byte_tpu/parallel/sharding.py:25-51); run it with --tp 1 --fsdp 1, or unfolded")


@dataclasses.dataclass(frozen=True)
class Split:
    """The dimension split over the tp group and the one split over the
    fsdp group (None: whole)."""

    tp: Optional[int] = None
    fsdp: Optional[int] = None


WHOLE = Split()


def _proj_splits(name: str, proj) -> Any:
    if name in COLUMN:
        w, b = Split(tp=0, fsdp=1), Split(tp=0)
    else:
        w, b = Split(tp=1, fsdp=0), Split(fsdp=0)
    return {k: (w if k == "weight" else b) for k in proj}


def param_splits(params) -> Any:
    """The :class:`Split` tree of a ``transformer.init_params`` tree; a
    norm-folded tree raises ``ValueError``."""
    if any("attn_norm_w" in layer for layer in params.get("layers", ())):
        raise ValueError(FOLDED_UNSHARDED)
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = [{n: _proj_splits(n, p) if n in COLUMN + ROW else WHOLE
                       for n, p in layer.items()} for layer in v]
        elif k in ("embed", "lm_head"):
            out[k] = Split(tp=0, fsdp=1)
        elif k == "pos_embed":
            out[k] = Split(fsdp=1)
        else:
            out[k] = WHOLE
    return out


def lora_splits(lora) -> Any:
    """The :class:`Split` tree of a ``lora.init_lora`` tree."""
    layers = []
    for layer in lora["layers"]:
        layers.append({n: ({"a": WHOLE, "b": Split(tp=1)} if n in COLUMN
                           else {"a": Split(tp=0), "b": WHOLE}) for n in layer})
    return {"layers": layers}


def _map(fn, tree, splits):
    if isinstance(tree, dict):
        return {k: _map(fn, v, splits[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, splits))
    return fn(tree, splits) if isinstance(tree, torch.Tensor) else tree


def block(t: torch.Tensor, dim: Optional[int], n: int, i: int) -> torch.Tensor:
    """Block ``i`` of ``n`` of ``t`` along ``dim``, ``ceil(N / n)`` long,
    zero-padded at the end where ``n`` does not divide N."""
    if dim is None or n == 1:
        return t
    size = t.shape[dim]
    c = -(-size // n)
    lo = min(i * c, size)
    part = t.narrow(dim, lo, min(c, size - lo))
    if part.shape[dim] < c:
        pad = list(part.shape)
        pad[dim] = c - part.shape[dim]
        part = torch.cat([part, part.new_zeros(pad)], dim)
    return part


def shard(t: torch.Tensor, split: Split, grid: Optional[mesh.Grid] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``t``: contiguous, marked with
    its split and ``t``'s shape."""
    g = grid or mesh.grid()
    out = block(block(t, split.tp, g.tp, g.t), split.fsdp, g.fsdp, g.f)
    # a copy, so the whole tensor's storage is freed with it
    out = out.detach().clone(memory_format=torch.contiguous_format)
    setattr(out, _ATTR, (split, tuple(t.shape)))
    return out


def split_of(t: torch.Tensor) -> Tuple[Split, Optional[Tuple[int, ...]]]:
    """The split of a shard and its whole tensor's shape (WHOLE, None for a
    tensor :func:`shard` did not make)."""
    return getattr(t, _ATTR, (WHOLE, None))


def mark(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a shard-shaped tensor, as Adam's moments) marked as ``like``."""
    if hasattr(like, _ATTR):
        setattr(t, _ATTR, getattr(like, _ATTR))
    return t


def shard_tree(tree, splits, grid: Optional[mesh.Grid] = None):
    """The shards of a whole tree (the tree itself where T = F = 1)."""
    g = grid or mesh.grid()
    if not g.sharded or tree is None:
        return tree
    return _map(lambda t, s: shard(t, s, g), tree, splits)


def _unblock(parts: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    return torch.cat(parts.unbind(0), dim).narrow(dim, 0, size)


def gather(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a shard, gathered over fsdp then tp (every rank
    of both groups takes part; no gradient)."""
    split, shape = split_of(t)
    g = mesh.grid()
    if shape is None:
        return t
    whole = t
    with torch.no_grad():
        if split.fsdp is not None and g.fsdp > 1:
            whole = _unblock(distributed.all_gather(whole, g.fsdp_group), split.fsdp,
                             shape[split.fsdp])
        if split.tp is not None and g.tp > 1:
            whole = _unblock(distributed.all_gather(whole, g.tp_group), split.tp,
                             shape[split.tp])
    # a new tensor without the mark, which a checkpoint would otherwise pickle
    return whole.detach().clone() if whole is t else whole.contiguous()


def gather_tree(tree):
    """The whole tree of a tree of shards, on every rank."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return gather(tree) if isinstance(tree, torch.Tensor) else tree


# --- ZeRO-3: a layer's weights gathered for its forward ----------------------

class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, dim, size, group):
        ctx.dim, ctx.group, ctx.c = dim, group, part.shape[dim]
        return _unblock(distributed.all_gather(part, group), dim, size)

    @staticmethod
    def backward(ctx, g):
        n = distributed.group_size(ctx.group)
        extra = n * ctx.c - g.shape[ctx.dim]
        if extra:
            pad = list(g.shape)
            pad[ctx.dim] = extra
            g = torch.cat([g, g.new_zeros(pad)], ctx.dim)
        parts = torch.stack(g.split(ctx.c, ctx.dim))
        return distributed.reduce_scatter(parts, ctx.group), None, None, None


def gather_fsdp(t: torch.Tensor) -> torch.Tensor:
    """A shard's tp block, gathered over the fsdp group for one use; the
    gradient is reduce-scattered back over the group onto the shard.  The
    tensor itself where it is not split over fsdp."""
    split, shape = split_of(t)
    g = mesh.grid()
    if shape is None or split.fsdp is None or g.fsdp == 1:
        return t
    return _GatherFsdp.apply(t, split.fsdp, shape[split.fsdp], g.fsdp_group)


def gather_layer(tree):
    """:func:`gather_fsdp` of every tensor of a layer's tree (the tree
    itself where F = 1)."""
    if mesh.fsdp_size() == 1:
        return tree
    if isinstance(tree, dict):
        return {k: gather_layer(v) for k, v in tree.items()}
    return gather_fsdp(tree) if isinstance(tree, torch.Tensor) else tree


# --- what the step reads -------------------------------------------------------

def grad_group(t: torch.Tensor):
    """The group a trainable's gradient sums over after the backward: the dp
    group for an fsdp shard (its gather's backward reduce-scattered it over
    the fsdp group), the data group otherwise.  Never the tp group: the
    operators of ``parallel/distributed.py`` already give every tp rank the
    whole gradient of a tensor it holds whole."""
    split, shape = split_of(t)
    g = mesh.grid()
    if shape is not None and split.fsdp is not None and g.fsdp > 1:
        return g.dp_group
    return g.data_group


def norm_groups(t: torch.Tensor):
    """The groups over which a gradient's squared norm sums: the tp group
    where it is a tp block, the fsdp group where an fsdp block; none where
    the rank holds it whole (counted once)."""
    split, shape = split_of(t)
    g = mesh.grid()
    if shape is None:
        return ()
    out = []
    if split.tp is not None and g.tp > 1:
        out.append("tp")
    if split.fsdp is not None and g.fsdp > 1:
        out.append("fsdp")
    return tuple(out)


def vocab_range(v_local: int, vocab: int) -> Tuple[int, int]:
    """[lo, hi): the rows of the vocabulary this rank's block of ``v_local``
    rows holds (hi - lo < v_local in a padded last block)."""
    lo = mesh.tp_rank() * v_local
    return lo, max(lo, min(lo + v_local, vocab))
