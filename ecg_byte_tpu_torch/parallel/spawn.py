"""Start the ranks of a process group as local processes.

``spawn(fn, args, world=W)`` runs ``fn(*args)`` in W new processes (the
``spawn`` start method), each a rank of one process group
(``parallel.distributed.init``), and returns their results in rank order.
``cli/dist.launch`` starts ``--dis`` runs with it; the tests and
``chip_smoke.py`` start their two-rank checks with it.  A rank that raises
ends the run: the others get ``GRACE_S`` seconds to end, then SIGTERM, then
SIGKILL, and ``spawn`` raises the failed rank's error.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from ecg_byte_tpu_torch.parallel import distributed

GRACE_S = 5.0


def spawn(fn: Callable, args: Sequence[Any] = (), *, world: int, backend: str = "gloo",
          devices: Optional[Sequence[int]] = None, init_method: Optional[str] = None,
          timeout_s: Optional[float] = None) -> List[Any]:
    """``fn(*args)`` on each of ``world`` ranks; returns their results.

    ``devices``: the CUDA device of each rank (None: the CPU).
    ``init_method``: the process group's rendezvous (default a file in a
    new temporary directory, so no port is needed).  ``timeout_s``: the
    whole run's limit, past which every rank is killed and this raises
    ``TimeoutError``; an exception raised here while the ranks run (an
    interrupt) kills them too."""
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="ecg_byte_ranks_")
    try:
        init = init_method or f"file://{os.path.join(out, 'store')}"
        ctx = mp.start_processes(_rank, args=(fn, tuple(args), world, backend, devices, init, out),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0, grace_period=GRACE_S):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout_s} s")
        except BaseException:  # a time limit or an interrupt here: no rank outlives it
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            raise
        results = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _rank(rank, fn, args, world, backend, devices, init_method, out):
    # the ranks share the parent's stdout: whole lines, never a block that
    # ends inside one
    sys.stdout.reconfigure(line_buffering=True)
    if devices is not None:
        torch.cuda.set_device(devices[rank])
    distributed.init(rank, world, backend, init_method)
    try:
        result = fn(*args)
    finally:
        distributed.shutdown()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
