"""The global batches of a training run, as steps every rank agrees on.

``--batch_size`` is the global batch: each rank's loader
(:func:`make_loader`) takes ``batch_size / world`` rows of it, its rows ``j
* world + rank`` (``data/loader.py`` shards by stride).  :func:`steps` turns
a rank's batches into the steps one process takes on the global batches:

- the items that failed to load are dropped from the global batch, as one
  process's ``collate`` drops them, and the survivors renumbered
  (``Rows.index``); a global batch that lost every item is skipped on every
  rank;
- the labelled tokens and the tokens are counted over the global batch;
- the short last batch: a rank whose shard has ended takes a batch of no
  rows.

One process runs the same code with ``world == 1`` (``Rows.whole``).
Under ``--tp`` and ``--fsdp`` the rows shard over the data group
(``parallel/mesh.py``, the JAX ``batch_spec`` over dp x fsdp): ``world``
and ``rank`` here are the data world and this rank's place in it, and the
ranks of one tp group take the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from ecg_byte_tpu_torch.data.loader import DataLoader, collate
from ecg_byte_tpu_torch.parallel import distributed, mesh
from ecg_byte_tpu_torch.parallel.distributed import Rows


def check_batch(batch_size: int, world: int, tp: int = 1) -> int:
    """The rows of a rank: ``--batch_size`` is the global batch, split over
    the data world (``world`` ranks, ``world / tp`` of them holding
    different rows)."""
    data = world // tp
    if batch_size % data:
        if tp == 1:
            raise SystemExit(f"--batch_size {batch_size} is the global batch; --dis over "
                             f"{world} ranks needs a multiple of {world}")
        raise SystemExit(f"--batch_size {batch_size} is the global batch; --dis over {world} "
                         f"ranks at --tp {tp} splits it over dp x fsdp = {data} ranks and "
                         f"needs a multiple of {data}")
    return batch_size // data


def make_loader(dataset, batch_size: int, **kw) -> DataLoader:
    """This rank's loader of a global batch ``batch_size``: its stride
    shard of each (shuffled) epoch, ``batch_size / data world`` rows a
    batch."""
    world = mesh.data_world()
    return DataLoader(dataset, batch_size=check_batch(batch_size, world),
                      num_shards=world, shard_index=mesh.data_rank(), with_kept=True, **kw)


@dataclasses.dataclass
class Step:
    """One agreed step: this rank's rows of the global batch (possibly
    none), where they sit in it, the global count of labelled tokens and
    the global tokens."""

    batch: Dict
    rows: Rows
    n_valid: int
    tokens: int


def _empty(batch: Dict) -> Dict:
    return {k: (v[:0] if not isinstance(v, list) else []) for k, v in batch.items()}


def _first_batch(dataset) -> Optional[Dict]:
    for i in range(len(dataset)):
        item = dataset[i]
        if item is not None:
            return collate([item])
    return None


def steps(loader: DataLoader, measure: Callable[[Dict], Tuple[int, int]]
          ) -> Iterator[Optional[Step]]:
    """The batches of ``loader`` (from :func:`make_loader`) as steps; None
    for a global batch that lost every item.

    ``measure(batch) -> (labelled tokens, tokens)`` of a batch.  Every rank
    runs ``ceil(N / global batch)`` steps.  The items each rank lost, its
    labelled tokens and its tokens are summed over the ranks in one host
    all-reduce over every rank, to which the first rank of each tp group
    alone brings its counts (the others hold the same rows)."""
    world, rank = mesh.data_world(), mesh.data_rank()
    counts = int(mesh.tp_rank() == 0)
    n, per = len(loader.dataset), loader.batch_size * world
    template = None
    it = iter(loader)
    for k in range(-(-n // per)):
        size = min(per, n - k * per)  # the global batch before its losses
        mine = range(rank, size, world)  # the global rows of this rank's items
        batch, kept = next(it) if len(mine) else (None, [])
        lost = [0] * size
        for j, g in enumerate(mine):
            lost[g] = int(j not in kept)
        valid, tokens = measure(batch) if batch is not None else (0, 0)
        *lost, valid, tokens = distributed.agree([counts * x for x in lost + [valid, tokens]])
        total = size - sum(lost)
        if total == 0:
            yield None
            continue
        place = np.cumsum([not x for x in lost]) - 1  # a survivor's row in the global batch
        rows = Rows(total, tuple(int(place[mine[j]]) for j in kept))
        if batch is not None:
            template = template or _empty(batch)  # the caller may change the batch it is given
        else:
            template = template or _first_batch(loader.dataset)
            batch = _empty(template)
        yield Step(batch, rows, valid, tokens)


def shard_rows(batch: Dict, rows: Rows) -> Dict:
    """This rank's rows of a whole global batch (arrays, tensors or
    lists)."""
    pick = list(rows.index)
    return {k: [v[i] for i in pick] if isinstance(v, list) else v[pick]
            for k, v in batch.items()}
