"""The harness: one run of one cell, found by name.

Everything that belongs to one configuration, traffic mix, window loop or
per-layer metric lives in a file of its own that the harness finds by the
name ``BENCHMARK.json`` gives it, so a later change adds files and edits
none:

- ``configs/<config>.json``: the configuration (published keys, as run);
- ``workloads/<cell>.json``: the cell's traffic parameters, its window
  loop (``driver``) and the limits of its correctness check;
- ``drivers/<driver>.py``: a window loop (``prepare``, ``measure``,
  ``traced``, ``outputs``, ``reference``, ``compare``);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns the number or None where the run holds nothing to read;
- ``arch/<model_type>.py``: the program's configuration of a family.

A run: set-up (the driver's ``prepare``: weights from the seed, the
program's state, warm-up of the cell's own shapes), the timed window
(``measure``), with ``--trace 1`` a traced window after it, the device's
peak memory, then the program's outputs are kept on the host, its state
freed, and the plain reference judges them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ecg_byte_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """A module from a file path: names like ``mfu.train`` hold dots."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload_file(name: str, here: str = HERE) -> str:
    return os.path.join(here, "workloads", f"{name}.json")


def config_file(name: str, here: str = HERE) -> str:
    return os.path.join(here, "configs", f"{name}.json")


def driver_file(name: str, here: str = HERE) -> str:
    return os.path.join(here, "drivers", f"{name}.py")


def metric_file(name: str, here: str = HERE) -> str:
    return os.path.join(here, "metrics", f"{name}.py")


def metrics_for(bench: dict, cell: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def foreign_modules(modules=None):
    """Top-level names of loaded modules that must not be loaded: JAX and
    the JAX package, compared whole (``ecg_byte_tpu_torch`` is the port)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    cell: str
    work: dict
    cfg: dict
    spec: object
    seed: int
    device: object
    here: str
    t0: Optional[float] = None
    rank: int = 0
    world: int = 1

    def mark(self, what: str) -> None:
        """Print how far set-up has come, on standard error."""
        if self.t0 is not None:
            print(f"[setup] {what} at {time.perf_counter() - self.t0:.3f} s", file=sys.stderr,
                  flush=True)

    def port_config(self):
        arch = load_module(os.path.join(self.here, "arch", f"{self.spec.model_type}.py"),
                           f"bench_port_arch_{self.spec.model_type}")
        return arch.port_config(self.spec)


def context(cell: str, seed: int, device, here: str = HERE, t0: Optional[float] = None,
            rank: int = 0, world: int = 1) -> Context:
    from bench_port.spec import spec

    work = load_json(workload_file(cell, here))
    cfg = load_json(config_file(work["config"], here))
    return Context(cell=cell, work=work, cfg=cfg, spec=spec(cfg), seed=seed, device=device,
                   here=here, t0=t0 if rank == 0 else None, rank=rank, world=world)


def driver_of(ctx: Context):
    return load_module(driver_file(ctx.work["driver"], ctx.here),
                       f"bench_port_driver_{ctx.work['driver']}")


def read_metrics(entries, run, here: str = HERE) -> Dict[str, dict]:
    out = {}
    for m in entries:
        reader = load_module(metric_file(m["name"], here), "bench_port_metric_"
                             + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, check)``: every number that has a limit at or under it,
    and each such number beside its limit.  A number that is not finite
    fails; a number the cell does not compare (no limit) is left out."""
    check = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    correct = bool(check) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in check.values())
    return correct, check


def _over_ranks(ctx: Context, value):
    """``value`` of every rank, in rank order (one rank: ``[value]``)."""
    if ctx.world == 1:
        return [value]
    import torch.distributed as dist

    out = [None] * ctx.world
    dist.all_gather_object(out, value)
    return out


def run(cell: str, seed: int, seconds: float, trace: bool, *, device, t0: float,
        bench: Optional[dict] = None, here: str = HERE, tmpdir: Optional[str] = None,
        rank: int = 0, world: int = 1) -> Optional[dict]:
    """One run of ``cell``; returns the result's dict (its ``check`` key
    last), on rank 0 of a cell that several ranks run (:func:`with_ranks`)
    and None on the others.  ``t0``: the process's start on
    ``time.perf_counter``'s clock."""
    import torch

    bench = bench if bench is not None else benchmark(os.path.dirname(here))
    ctx = context(cell, seed, device, here, t0, rank, world)
    driver = driver_of(ctx)
    ctx.mark("harness loaded")
    sess = driver.prepare(ctx)
    setup_s = time.perf_counter() - t0
    window = driver.measure(sess, seconds)
    e2e = {"setup_s": setup_s, **window.pop("end_to_end")}
    result_metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                      for m in metrics_for(bench, cell, "end_to_end")}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": ctx.work["chips"]}
    breakdown = None
    if trace:
        traced = driver.traced(sess, tmpdir or tempfile.gettempdir())
        tr = traced.pop("trace")
        run_view = types.SimpleNamespace(chips=info["count"], window=window, traced=traced,
                                         trace=tr)
        result_metrics = read_metrics(metrics_for(bench, cell, "per_layer"), run_view, here)
        busy = _over_ranks(ctx, tr.busy_s)
        info["busy_s"] = sum(busy) / len(busy)
        info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    info["memory_peak_bytes"] = max(_over_ranks(ctx, int(torch.cuda.max_memory_allocated(dev))
                                                if dev.type == "cuda" else 0))
    outputs = driver.outputs(sess)
    del sess
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference(ctx, outputs)
    correct, check = judge(driver.compare(ctx, outputs, ref), ctx.work["limits"])
    if rank != 0:
        return None
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": result_metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_main(rank: int, world: int, init: str, device_type: str, fn, args):
    """One rank: its device, the program's process group (as ``cli/dist.py``
    joins it), then ``fn(rank, world, *args)``."""
    from ecg_byte_tpu_torch.parallel import distributed, mesh

    if rank:
        sys.stdout = sys.stderr  # only rank 0 prints the result
    backend = "gloo"
    if device_type == "cuda":
        import torch

        torch.cuda.set_device(rank)
        backend = "nccl"
    distributed.init(rank, world, backend, init)
    mesh.init(1, 1)
    try:
        return fn(rank, world, *args)
    finally:
        distributed.shutdown()


def with_ranks(world: int, device_type: str, fn, args=()):
    """``fn(rank, world, *args)`` on ``world`` ranks: rank 0 in this
    process, the others in processes it starts and waits for; a card a rank
    over NCCL (gloo on the CPU), on ``tcp://localhost``.  Returns rank 0's
    value; raises if another rank failed."""
    import multiprocessing as mp

    init = f"tcp://localhost:{_free_port()}"
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=_rank_main, args=(r, world, init, device_type, fn, args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        value = _rank_main(0, world, init, device_type, fn, args)
    finally:
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
                p.join()
    failed = [r for r, p in enumerate(procs, start=1) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed")
    return value


def rank_run(rank: int, world: int, cell, seed, seconds, trace, t0, device_type, bench=None,
             here: str = HERE):
    """:func:`run` on one rank of :func:`with_ranks`."""
    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    return run(cell, seed, seconds, trace, device=device,
               t0=t0 if rank == 0 else time.perf_counter(), bench=bench, here=here, rank=rank,
               world=world)
