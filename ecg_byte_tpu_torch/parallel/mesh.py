"""The (dp, fsdp, tp) grid over the ranks of ``--dis``: the port of
``ecg_byte_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``("dp", "fsdp", "tp")`` mesh with
tp innermost, so a tensor-parallel group is adjacent devices.  Here the
ranks of the process group take the same places: rank ``(d * F + f) * T +
t`` sits at ``(d, f, t)``, and :func:`init` makes the groups its
collectives run on:

- the **tp** group: the T ranks of one ``(d, f)``, which hold different
  heads, MLP columns and vocabulary rows of the same layers and take the
  same rows of each batch;
- the **data** group: the dp * F ranks of one ``t``, which hold different
  rows of each global batch (``parallel/batches.py`` shards over it);
- the **fsdp** group: the F ranks of one ``(d, t)``, which hold different
  ZeRO-3 shards of the weights and gather them for each layer;
- the **dp** group: the dp ranks of one ``(f, t)``, which hold the same
  shards and sum their gradients.

Without :func:`init` (one process, or ``--dis`` with ``--tp 1 --fsdp 1``)
T = F = 1 and the data group is every rank.  ``torch.distributed.new_group``
is collective: every rank makes every group, in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from ecg_byte_tpu_torch.parallel import distributed

AXES = ("dp", "fsdp", "tp")


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on the grid and its groups (None: the group of
    every rank, or of this rank alone where the size is 1)."""

    dp: int
    fsdp: int
    tp: int
    d: int
    f: int
    t: int
    tp_group: Optional[object] = None
    data_group: Optional[object] = None
    fsdp_group: Optional[object] = None
    dp_group: Optional[object] = None

    @property
    def data_world(self) -> int:
        return self.dp * self.fsdp

    @property
    def data_rank(self) -> int:
        return self.d * self.fsdp + self.f

    @property
    def sharded(self) -> bool:
        return self.tp > 1 or self.fsdp > 1


_grid: Optional[Grid] = None


def check_grid(world: int, tp: int, fsdp: int) -> int:
    """dp for ``world`` ranks at ``tp`` x ``fsdp``; exits where T * F does
    not divide the world (a rank cannot sit outside the collectives, where
    the JAX CLI leaves remainder devices idle)."""
    if tp < 1 or fsdp < 1:
        raise SystemExit(f"--tp {tp} and --fsdp {fsdp} must be at least 1")
    if world % (tp * fsdp):
        raise SystemExit(f"--tp {tp} x --fsdp {fsdp} = {tp * fsdp} must divide the {world} "
                         "ranks of --dis")
    return world // (tp * fsdp)


def place(rank: int, dp: int, fsdp: int, tp: int):
    """(d, f, t) of ``rank``: tp innermost."""
    return rank // (fsdp * tp), (rank // tp) % fsdp, rank % tp


def ranks_of(dp: int, fsdp: int, tp: int, axes, at) -> list:
    """The ranks that share ``at`` = (d, f, t) on every axis but ``axes``."""
    out = []
    for r in range(dp * fsdp * tp):
        p = place(r, dp, fsdp, tp)
        if all(p[i] == at[i] for i, a in enumerate(AXES) if a not in axes):
            out.append(r)
    return out


def init(tp: int = 1, fsdp: int = 1) -> Grid:
    """Lay the ranks of the process group out as (dp, fsdp, tp) and make the
    groups.  Every rank calls it after ``distributed.init``."""
    global _grid
    world, rank = distributed.world(), distributed.rank()
    dp = check_grid(world, tp, fsdp)
    d, f, t = place(rank, dp, fsdp, tp)
    groups = {}
    for name, axes in (("tp", ("tp",)), ("data", ("dp", "fsdp")), ("fsdp", ("fsdp",)),
                       ("dp", ("dp",))):
        mine = None
        # every rank makes every group of this kind, in one order
        seen = []
        for r in range(world):
            members = ranks_of(dp, fsdp, tp, axes, place(r, dp, fsdp, tp))
            if members in seen:
                continue
            seen.append(members)
            if len(members) == world:
                g = dist.group.WORLD
            else:
                g = dist.new_group(members)
            if rank in members:
                mine = g
        groups[name] = mine
    _grid = Grid(dp, fsdp, tp, d, f, t, groups["tp"], groups["data"], groups["fsdp"],
                 groups["dp"])
    return _grid


def reset() -> None:
    global _grid
    _grid = None


def grid() -> Grid:
    """The grid of this rank: one of T = F = 1 over every rank without
    :func:`init`."""
    if _grid is not None:
        return _grid
    w = distributed.world()
    return Grid(w, 1, 1, distributed.rank(), 0, 0)


def tp_size() -> int:
    return grid().tp


def tp_rank() -> int:
    return grid().t


def fsdp_size() -> int:
    return grid().fsdp


def data_world() -> int:
    return grid().data_world


def data_rank() -> int:
    return grid().data_rank
