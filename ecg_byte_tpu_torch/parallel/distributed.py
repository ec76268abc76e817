"""Data parallelism across processes: the port of
``ecg_byte_tpu/parallel/distributed.py`` for ``--dis``.

The JAX package runs ``--dis`` as GSPMD over a ``dp`` mesh axis: one
program computes the single-device function on the global batch.  Here
each rank is a process on its own device (or a share of one) that holds
its rows of every global batch (:class:`Rows`), and the collectives below
make its step compute that same function:

- :func:`reduce_gradients_`: a sum all-reduce of every gradient in one
  flat f32 buffer.  Each loss that is a mean over the batch is taken as
  the rank's sum over the global count, so the sum is the global gradient;
- :func:`all_reduce_sum`: a sum all-reduce whose gradient is the sum of
  every rank's gradient (BatchNorm's global batch statistics);
- :func:`gather_rows`: a tensor's rows of the whole global batch, in
  global order, whose gradient gives this rank the sum over the ranks of
  its own rows' share (the contrastive losses, each rank computing its
  rows of the loss);
- :func:`agree`: host integers summed over the ranks on a CPU (gloo)
  group, so a decision taken on the host (skip a batch, stop early) is the
  same on every rank without a device sync.

Under ``--tp`` and ``--fsdp`` (``parallel/mesh.py``) the collectives take a
group: Megatron's two operators :func:`copy_to_tp` (the identity forward,
an all-reduce of the gradient over the tp group) and :func:`reduce_from_tp`
(an all-reduce forward, the identity backward), and :func:`all_gather` and
:func:`reduce_scatter` over a group, each chosen by the group's backend
before the call (:func:`_gathers_natively`).

Without :func:`init`, ``world() == 1`` and every collective is the
identity, so one process runs the same code on ``Rows.whole(batch)``; a
group of one rank runs the collectives (``--dis`` at W = 1).  The backend rule is :func:`choose_backend`.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# seconds a collective may wait for its peers before it raises
TIMEOUT_S = 600
# the most f32 elements one all-reduce of gradients takes
BUCKET_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's rows of a global batch of ``total`` rows: ``index`` holds
    the global row of each of its local rows, in order.  Without lost items
    rank r's local row j is global row ``j * world + r`` (:meth:`stride`;
    ``data/loader.py`` shards by stride); a batch that lost items holds the
    survivors, renumbered as one process's collate renumbers them."""

    total: int
    index: Tuple[int, ...]

    @classmethod
    def whole(cls, total: int) -> "Rows":
        """Every row of a batch of ``total``: one process's rows."""
        return cls(total, tuple(range(total)))

    @classmethod
    def stride(cls, total: int, world: int, rank: int) -> "Rows":
        return cls(total, tuple(range(rank, total, world)))

    def positions(self, device) -> torch.Tensor:
        """``index`` on ``device``.  A stride of rows (no item lost) is made
        there; only a renumbered batch copies from the host, which waits
        for the device's queue."""
        idx = self.index
        step = idx[1] - idx[0] if len(idx) > 1 else 1
        if idx and step > 0 and tuple(idx) == tuple(range(idx[0], idx[-1] + 1, step)):
            return torch.arange(idx[0], idx[-1] + 1, step, device=device)
        return torch.tensor(idx, dtype=torch.long, device=device)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t``, a tensor over the global batch."""
        if len(self.index) == self.total:  # every row, in order
            return t
        return t[self.positions(t.device)]


@dataclasses.dataclass
class _Context:
    rank: int
    world: int
    control: object  # the gloo group of agree() and barrier()


_ctx: Optional[_Context] = None


def choose_backend(device_type: str, devices: Sequence[int]) -> str:
    """NCCL where each rank has a GPU of its own; gloo on the CPU, or where
    two ranks name the same GPU (NCCL refuses two ranks on one device)."""
    if device_type != "cuda" or len(set(devices)) < len(devices):
        return "gloo"
    return "nccl"


def init(rank: int, world: int, backend: str, init_method: str) -> None:
    """Join the process group of ``world`` ranks as ``rank``.  A CUDA rank
    sets its device before calling this."""
    global _ctx
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    control = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    _ctx = _Context(rank, world, control)


def shutdown() -> None:
    global _ctx
    from ecg_byte_tpu_torch.parallel import mesh

    mesh.reset()
    if _ctx is not None:
        _ctx = None
        dist.destroy_process_group()


def initialized() -> bool:
    return _ctx is not None


def rank() -> int:
    return _ctx.rank if _ctx is not None else 0


def world() -> int:
    return _ctx.world if _ctx is not None else 1


def is_primary() -> bool:
    """Rank 0 writes the checkpoints (reference main.py:311-316)."""
    return rank() == 0


def barrier() -> None:
    if _ctx is not None:
        dist.barrier(group=_ctx.control)


def agree(values: Sequence[int]) -> List[int]:
    """``values`` summed over the ranks, on the host."""
    if _ctx is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(t, group=_ctx.control)
    return t.tolist()


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any."""
    return agree([int(bool(flag))])[0] > 0


def sum_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """A copy of ``x`` summed over the ranks of ``group`` (default every
    rank; no gradient)."""
    if _ctx is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` summed over the data group (the ranks that hold
    different rows: under ``--tp`` the ranks of one tp group hold the same
    rows and the same share of a loss)."""
    from ecg_byte_tpu_torch.parallel import mesh

    return sum_over_ranks(x, mesh.grid().data_group)


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite ``tensors`` with rank 0's values, in place."""
    if _ctx is None:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks.  Every rank's loss reads the sum, so the
    gradient of the total loss with respect to this rank's ``x`` is the sum
    over the ranks of their gradients with respect to the sum."""
    return x if _ctx is None else _AllReduceSum.apply(x)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows: Rows):
        # each rank writes its rows into their places of a zero buffer; the
        # sum is the global batch (an all-reduce, which gloo also runs on CUDA)
        ctx.positions = rows.positions(x.device)
        buf = x.new_zeros((rows.total,) + tuple(x.shape[1:]))
        buf[ctx.positions] = x
        dist.all_reduce(buf)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)  # every rank's share of the loss reads every row
        return g[ctx.positions], None


def gather_rows(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """The global batch of ``x`` (this rank's rows) in global row order.

    Each rank computes its rows' share of a loss over the global batch;
    the gradient of this rank's rows is the sum of every rank's share, as
    ``torch.distributed.all_gather`` (which drops the gradient of the rows
    it receives) would not give it.  Without a process group, ``x``
    itself."""
    return x if _ctx is None else _GatherRows.apply(x, rows)


def reduce_gradients_(params: Sequence[torch.Tensor], *scalars: torch.Tensor,
                      groups: Optional[Sequence[object]] = None) -> List[torch.Tensor]:
    """Sum every ``.grad`` of ``params`` over the ranks, in place, in flat
    f32 buffers of at most ``BUCKET_ELEMENTS``, and return ``scalars``
    summed with them.  ``groups``: the group each gradient sums over
    (default the data group: ``parallel/mesh.py``); the scalars sum over
    the data group.  A gradient that is None on every rank (a parameter no
    loss reads) stays None, so the optimizer skips it as in one process; a
    rank without rows sends zeros for the others."""
    if _ctx is None:
        return list(scalars)
    from ecg_byte_tpu_torch.parallel import mesh

    data = mesh.grid().data_group
    groups = list(groups) if groups is not None else [data] * len(params)
    present = agree([int(p.grad is not None) for p in params])
    by_group = {id(data): (data, [])}  # the data group first: it carries the scalars
    for p, g, n in zip(params, groups, present):
        if n:
            by_group.setdefault(id(g), (g, []))[1].append(p)
    out = []
    for key, (group, held) in by_group.items():
        buckets, cur, size = [], [], 0
        for p in held:
            if cur and size + p.numel() > BUCKET_ELEMENTS:
                buckets.append(cur)
                cur, size = [], 0
            cur.append(p)
            size += p.numel()
        buckets.append(cur)
        for i, bucket in enumerate(buckets):
            parts = [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                     for p in bucket]
            last = key == id(data) and i == len(buckets) - 1
            if last:
                dev = bucket[0].device if bucket else scalars[0].device
                parts += [s.detach().float().reshape(1).to(dev) for s in scalars]
            flat = torch.cat(parts)
            dist.all_reduce(flat, group=group)
            offset = 0
            for p in bucket:
                g = flat[offset:offset + p.numel()].view(p.shape).to(p.dtype)
                offset += p.numel()
                if p.grad is None:
                    p.grad = g
                else:
                    p.grad.copy_(g)
            if last:
                out = [flat[offset + j] for j in range(len(scalars))]
    for p, n in zip(params, present):
        if not n:
            p.grad = None
    return out


# --- collectives on a group (--tp, --fsdp) ----------------------------------

def group_size(group) -> int:
    return 1 if _ctx is None else dist.get_world_size(group)


def _gathers_natively(group) -> bool:
    """NCCL has the all-gather and reduce-scatter into one tensor; gloo runs
    them as an all-reduce of a zero-filled buffer, the form it also runs on
    CUDA tensors."""
    return dist.get_backend(group) == "nccl"


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` of ``group`` in group-rank order (no
    gradient)."""
    n = group_size(group)
    if n == 1:
        return x[None]
    x = x.contiguous()
    if _gathers_natively(group):
        out = x.new_empty((n,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = x.new_zeros((n,) + tuple(x.shape))
    out[dist.get_rank(group)] = x
    dist.all_reduce(out, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's slot of ``x`` (n, ...) summed over ``group`` (no
    gradient)."""
    n = group_size(group)
    if n == 1:
        return x[0]
    x = x.contiguous()
    if _gathers_natively(group):
        out = x.new_empty(tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y[dist.get_rank(group)]


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"``, ``"max"``, ``"min"``) over ``group`` in
    place (no gradient); returns it."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=_OPS[op], group=group)
    return x


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_group():
    from ecg_byte_tpu_torch.parallel import mesh

    g = mesh.grid()
    return g.tp_group if g.tp > 1 else None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every rank of the tp group) as the input of this
    rank's part of a product: the identity forward; its gradient, the sum
    of the parts' gradients, all-reduced over the tp group.  The identity
    without ``--tp``."""
    g = _tp_group()
    return x if g is None else _CopyToTp.apply(x, g)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The sum over the tp group of this rank's partial ``x``; the gradient
    of a loss that every rank of the group computes alike passes through
    unchanged (not summed: ``all_reduce_sum`` would scale it by T).  The
    identity without ``--tp``."""
    g = _tp_group()
    return x if g is None else _ReduceFromTp.apply(x, g)
