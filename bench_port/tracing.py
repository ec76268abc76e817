"""The traced window: ``torch.profiler`` over a short stretch of the timed
path, its Chrome trace read back into kernels, marks and idle gaps.

Marks are ``torch.profiler.record_function`` ranges named ``bench.*``
that the harness puts around the program's entry points while the trace
runs (:func:`marks`); nothing of the program is changed, and the timed
window runs without them.  A device operation belongs to a mark when the
host call that launched it (the runtime event with the same
``correlation``) lies inside the mark's range on the same thread.  The
backward of a marked call is bracketed by two identity autograd nodes, one
on its output and one on its inputs: the engine reaches the first when
the call's backward starts and the second when it ends, on the thread
that runs them both.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import json
import os
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


class _Open(torch.autograd.Function):
    """On the output: its backward opens the backward's range."""

    @staticmethod
    def forward(ctx, holder, x):
        ctx.holder = holder
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rf = torch.profiler.record_function(ctx.holder["name"])
        rf.__enter__()
        ctx.holder["rf"] = rf
        return None, g


class _Close(torch.autograd.Function):
    """On the inputs: its backward closes the backward's range."""

    @staticmethod
    def forward(ctx, holder, *xs):
        ctx.holder = holder
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        rf = ctx.holder.pop("rf", None)
        if rf is not None:
            rf.__exit__(None, None, None)
        return (None, *gs)


def _marked(fn, name: str):
    # wraps copies the function's attributes (the program's launch counters)
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)
                   and a.requires_grad]
        holder = {"name": name + ".bwd"}
        if tensors and torch.is_grad_enabled():
            args = list(args)
            closed = _Close.apply(holder, *(args[i] for i in tensors))
            for i, t in zip(tensors, closed):
                args[i] = t
        with torch.profiler.record_function(name):
            out = fn(*args, **kwargs)
        if tensors and torch.is_grad_enabled() and isinstance(out, torch.Tensor):
            out = _Open.apply(holder, out)
        return out

    return wrapper


@contextlib.contextmanager
def marks(targets: Dict[str, Tuple[object, str]]):
    """Wrap ``getattr(module, attr)`` in a ``bench.<key>`` range for each
    ``key -> (module, attr)``, and restore them after."""
    saved = []
    try:
        for key, (module, attr) in targets.items():
            fn = getattr(module, attr)
            saved.append((module, attr, fn))
            setattr(module, attr, _marked(fn, f"bench.{key}"))
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


@dataclasses.dataclass
class Trace:
    """What a traced window holds.  Times in seconds."""

    window: Tuple[float, float]
    device_ops: List[Tuple[str, float, float, str]]  # name, start, end, cat
    owner: List[List[str]]  # per device op: the marks whose range launched it
    mark_counts: Dict[str, int]
    host: Dict[int, list]  # tid -> sorted host events (start, end, name)
    main_tid: int

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self):
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in self.device_ops
                       if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernels(self, mark: str = None):
        """Kernels (not copies), optionally those launched under ``mark``."""
        return [op for op, own in zip(self.device_ops, self.owner)
                if op[3] == "kernel" and (mark is None or mark in own)]

    def device_seconds(self, mark: str = None, name_has: str = None) -> float:
        return sum(e - s for (n, s, e, c), own in zip(self.device_ops, self.owner)
                   if (mark is None or mark in own) and (name_has is None or name_has in n))

    def top_ops(self, n: int = 10):
        acc = collections.Counter()
        for name, s, e, _ in self.device_ops:
            acc[name] += e - s
        return [[k, v] for k, v in acc.most_common(n)]

    def idle_gaps(self, n: int = 10):
        """The idle time inside the window, summed by what the main thread
        was doing at the middle of each gap: its innermost host event, or
        "(host idle)" where it was in none (Python between operations)."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        flat = _flatten(self.host.get(self.main_tid, []))
        starts = [f[0] for f in flat]
        acc = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            name = flat[i][2] if i >= 0 and flat[i][1] > mid else "(host idle)"
            acc[name] += b - a
        return [[k, v] for k, v in acc.most_common(n)]


def _flatten(events):
    """Nested host events -> disjoint (start, end, innermost name) pieces."""
    out, stack = [], []
    pos = None

    def emit(upto):
        nonlocal pos
        if stack and pos is not None and upto > pos:
            out.append((pos, upto, stack[-1][1]))
        pos = upto

    for s, e, name in sorted(events, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return out


def parse(path: str, window_mark: str = "bench.window") -> Trace:
    """Read a Chrome trace written by ``export_chrome_trace``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches: Dict[int, Tuple[int, float]] = {}
    host: Dict[int, list] = collections.defaultdict(list)
    ranges: Dict[int, list] = collections.defaultdict(list)
    device, window, main_tid = [], None, None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = ev["ts"] * 1e-6, ev.get("dur", 0) * 1e-6
        if cat in DEVICE_CATS:
            device.append((ev["name"], ts, ts + dur, cat, ev.get("args", {}).get("correlation")))
        elif cat in HOST_CATS:
            tid = ev["tid"]
            corr = ev.get("args", {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = (tid, ts)
            if ev["name"] == window_mark:
                window, main_tid = (ts, ts + dur), tid
                continue
            host[tid].append((ts, ts + dur, ev["name"]))
            if cat == "user_annotation" and ev["name"].startswith("bench."):
                ranges[tid].append((ts, ts + dur, ev["name"]))
    if window is None:
        raise RuntimeError(f"{path} holds no {window_mark} range")
    mark_counts = collections.Counter(name for rs in ranges.values() for _, _, name in rs)
    # per thread and mark: the ranges by start (ranges of one mark do not nest)
    index: Dict[int, Dict[str, tuple]] = {}
    for tid, rs in ranges.items():
        by_name = collections.defaultdict(list)
        for r in sorted(rs):
            by_name[r[2]].append(r)
        index[tid] = {n: ([r[0] for r in v], [r[1] for r in v]) for n, v in by_name.items()}
    owner = []
    for name, s, e, cat, corr in device:
        own = []
        if corr in launches:
            tid, ts = launches[corr]
            for mark, (starts, ends) in index.get(tid, {}).items():
                i = bisect.bisect_right(starts, ts) - 1
                if i >= 0 and ends[i] >= ts:
                    own.append(mark)
        owner.append(own)
    return Trace(window=window, device_ops=[d[:4] for d in device], owner=owner,
                 mark_counts=dict(mark_counts), host=dict(host), main_tid=main_tid)


@contextlib.contextmanager
def profiled(directory: str, device):
    """Run the block under ``torch.profiler`` (host and CUDA activity) in
    a ``bench.window`` range that starts and ends with the device idle;
    yields a dict that holds the parsed :class:`Trace` under ``"trace"``
    once the block has ended.  The trace file is written to ``directory``
    and removed after it is read."""
    from torch.profiler import ProfilerActivity, profile

    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        raise RuntimeError("torch.profiler cannot record CUDA activity here")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"bench_trace.{os.getpid()}.json")
    out = {}
    torch.cuda.synchronize(device)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with torch.profiler.record_function("bench.window"):
            yield out
            torch.cuda.synchronize(device)
    finally:
        prof.stop()
    prof.export_chrome_trace(path)
    try:
        out["trace"] = parse(path)
    finally:
        os.remove(path)
