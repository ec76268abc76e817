"""``--dis`` for the training CLIs: the port of ``ecg_byte_tpu/cli/dist.py``.

The JAX CLIs place each global batch sharded over a ``dp`` mesh axis and
let GSPMD partition the step.  Here ``--dis`` is data parallelism over
processes:

- :func:`launch` starts the ranks: from ``torchrun``'s environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) when it is set, this process being one rank; else one
  process per device of ``--gpus`` on ``tcp://localhost:<--ports>``, as the
  reference spawns them (main.py:356-364);
- ``--batch_size`` stays the global batch: each rank takes ``batch_size /
  world`` rows of it, and the training loops take the steps every rank
  agrees on (``parallel/batches.py``);
- ``--tp T`` and ``--fsdp F`` (``cli.main``) lay the ranks out as the JAX
  mesh (``parallel/mesh.py``): each rank then takes ``batch_size / (dp *
  F)`` rows, the ranks of a tp group the same ones.  :func:`launch`
  refuses, before any rank starts, a T that does not divide the model's
  KV heads, heads and MLP width, a T * F that does not divide the world,
  and a global batch that dp * F does not divide.

Serving ignores ``--dis``, as the JAX CLI uses its mesh only for training.
"""

from __future__ import annotations

import os
import socket
from typing import Callable

import torch

from ecg_byte_tpu_torch.parallel import distributed, mesh
from ecg_byte_tpu_torch.parallel.batches import check_batch
from ecg_byte_tpu_torch.parallel.spawn import spawn


def _gpus(args):
    return [int(g) for g in str(args.gpus).split(",") if g.strip() != ""]


def world_size(args) -> int:
    """The ranks of a ``--dis`` run: torchrun's ``WORLD_SIZE``, else the
    devices listed in ``--gpus``."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return len(_gpus(args))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def grid_sizes(args):
    """(T, F) of ``args`` (1, 1 for a CLI without the flags)."""
    return getattr(args, "tp", 1) or 1, getattr(args, "fsdp", 1) or 1


def launch(entry: Callable, args, config=None):
    """Run ``entry(args)`` on every rank of ``--dis`` and return rank 0's
    result with ``"ranks"``: every rank's result, each with its ``rank``,
    ``device``, ``backend``, ``launches`` (the kernels its run launched,
    ``ops.launch_counts``) and ``written`` (the checkpoint roles it
    wrote).  A rank that raises ends the run (``parallel/spawn.py``).
    ``config``: the model's, checked against ``--tp``."""
    from ecg_byte_tpu_torch.cli.common import check_tp

    world = world_size(args)
    tp, fsdp = grid_sizes(args)
    if config is not None:
        check_tp(config, tp)
    mesh.check_grid(world, tp, fsdp)
    check_batch(args.batch_size, world, tp)
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    gpus = _gpus(args)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        devices = gpus if len(gpus) == world else list(range(world))
        backend = distributed.choose_backend("cpu" if cpu else "cuda", devices)
        if not cpu:
            _cuda_or_exit()
            torch.cuda.set_device(devices[local])
        distributed.init(int(os.environ["RANK"]), world, backend, "env://")
        mesh.init(tp, fsdp)
        try:
            result = _rank(entry, args, devices[local], backend)
        finally:
            distributed.shutdown()
        return {**result, "ranks": [result]}
    backend = distributed.choose_backend("cpu" if cpu else "cuda", gpus)
    if not cpu:
        _cuda_or_exit()
    port = int(str(args.ports).split(",")[0]) or _free_port()
    results = spawn(_spawned, (entry, args, gpus, backend), world=world, backend=backend,
                    devices=None if cpu else gpus, init_method=f"tcp://localhost:{port}")
    return {**results[0], "ranks": results}


def _cuda_or_exit():
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device is available; pass --device cpu to run the "
                         "plain PyTorch path on the CPU")


def _spawned(entry, args, gpus, backend):
    mesh.init(*grid_sizes(args))
    return _rank(entry, args, gpus[distributed.rank()], backend)


def _rank(entry, args, gpu: int, backend: str):
    from ecg_byte_tpu_torch.ops import launch_counts
    from ecg_byte_tpu_torch.train import checkpoint

    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if not cpu:
        args.device = f"cuda:{gpu}"
    world, g = distributed.world(), mesh.grid()
    if distributed.is_primary():
        print(f"--dis: {world} ranks as dp {g.dp} x fsdp {g.fsdp} x tp {g.tp}, backend "
              f"{backend} (NCCL where each rank has a GPU of its own, else gloo), global batch "
              f"{args.batch_size} = {g.data_world} x {args.batch_size // g.data_world}, "
              f"collective timeout {distributed.TIMEOUT_S} s")
    print(f"--dis: rank {distributed.rank()} on {args.device or 'cuda'}")
    launched, written = launch_counts(), len(checkpoint.written)
    result = entry(args)
    return {**result, "rank": distributed.rank(), "device": str(args.device),
            "backend": backend,
            "launches": {k: n - launched[k] for k, n in launch_counts().items()},
            "written": checkpoint.written[written:]}
