"""LoRA training: a closed loop of the program's train step.

Set-up builds one train state (weights and adapters from the seed, the
configuration's Adam + Noam, LoRA dropout from a host generator seeded
with the seed), and drives it through ``check_steps`` steps on distinct
batches with the window's own call and feed: those steps warm up every
shape of the cell and are the ones the reference follows.  The same state
then runs the window: ``step_fn(state, batch, rng, rows, n_valid)`` as
``train/runner.trainer`` calls it, the loss kept on the device and read
once every ``loss_every`` steps.  The window ends in a synchronise.

Compared with the reference (:func:`compare`): each checked step's loss;
each adapter's first gradient as Adam took it, read from Adam's first
moment after step 1; each adapter's change over the checked steps.  The
gaps are between norms, per leaf, over the larger of the reference's
norm of that leaf and the median leaf's.  Leaves whose loss gradient in
the reference stays under a thousandth of the median leaf's through the
checked steps (the A matrices while B is still about 0) move by Adam's
round-off alone and are left out of the change.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict

import numpy as np
import torch

from bench_port import counts, traffic
from bench_port.weights import lora_leaves, make_lora, make_weights, to_f32

BETA1 = 0.9


class Session:
    pass


def _n_valid(batch) -> int:
    return int((batch["labels"][:, 1:] != -100).sum())


def prepare(ctx):
    from ecg_byte_tpu_torch.parallel.distributed import Rows
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step

    s, work, dev = ctx.spec, ctx.work, torch.device(ctx.device)
    sess = Session()
    sess.ctx = ctx
    sess.config = ctx.port_config()
    dtype = getattr(torch, s.dtype)
    weights = make_weights(s, ctx.seed, dev, dtype)
    lora = make_lora(s, ctx.seed, dev, dtype)
    optimizer = make_optimizer(sess.config.hidden_size, work["warmup"])
    ctx.mark("weights made")
    sess.state = create_train_state(sess.config, optimizer, torch.Generator(device=dev), peft=True,
                                    params=weights, lora=lora)
    sess.step_fn = make_train_step(sess.config, optimizer, remat="none")
    sess.rng = torch.Generator().manual_seed(ctx.seed)
    # the global batch is every rank's rows; this rank keeps rows rank::world
    total = work["batch"] * ctx.world
    sess.global_batches = traffic.train_batches(s, {**work, "batch": total}, ctx.seed,
                                                work["pool"])
    sess.batches = [{k: np.ascontiguousarray(v[ctx.rank::ctx.world]) for k, v in b.items()}
                    for b in sess.global_batches]
    sess.n_valid = [_n_valid(b) for b in sess.global_batches]
    sess.rows = Rows.stride(total, ctx.world, ctx.rank)
    sess.leaves = list(lora_leaves(lora))
    sess.next = 0

    ctx.mark("train state built")
    before = [t.detach().float().clone() for _, t in sess.leaves]
    losses, first = [], None
    for _ in range(work["check_steps"]):
        losses.append(_step(sess))
        if first is None:
            first = torch.stack([_first_grad_norm(sess.state.optimizer, t)
                                 for _, t in sess.leaves])
    change = torch.stack([(t.detach().float() - b).norm()
                          for (_, t), b in zip(sess.leaves, before)])
    del before
    sess.checked = {
        "losses": [float(x) for x in torch.stack(losses).tolist()],
        "first_grad": dict(zip([k for k, _ in sess.leaves], first.tolist())),
        "change": dict(zip([k for k, _ in sess.leaves], change.tolist())),
    }
    ctx.mark("checked steps done")
    return sess


def _first_grad_norm(opt, t):
    """The norm of the gradient Adam took at its first step, from its
    first moment ``(1 - beta1) * g``; 0 where it took none."""
    m = opt.state.get(t, {}).get("exp_avg")
    if m is None:
        return torch.zeros((), device=t.device)
    return (m.float() / (1 - BETA1)).norm()


def _step(sess):
    i = sess.next % len(sess.batches)
    sess.next += 1
    sess.state, loss = sess.step_fn(sess.state, sess.batches[i], sess.rng, sess.rows,
                                    sess.n_valid[i])
    return loss


def _agree_stop(sess, stop: bool) -> bool:
    """Rank 0's decision to end the window, on every rank (one host
    all-reduce a step where ranks share the window)."""
    if sess.ctx.world == 1:
        return stop
    from ecg_byte_tpu_torch.parallel import distributed

    return distributed.agree([int(stop and sess.ctx.rank == 0)])[0] > 0


def _sync(sess):
    dev = torch.device(sess.ctx.device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _work_of(sess, batches, first: int, steps: int):
    """Positions, operations and attention pairs of ``steps`` steps from
    step index ``first`` over ``batches`` (the global ones, or this
    rank's)."""
    s = sess.ctx.spec
    n = len(batches)
    flops, pairs, positions = 0.0, 0, 0
    for j in range(first, first + steps):
        b = batches[j % n]
        p = traffic.causal_pairs(b["attn_mask"])
        pos = b["input_ids"].size
        flops += counts.train_step_flops(s, pos, p)
        pairs += p
        positions += pos
    return flops, pairs, positions


def measure(sess, seconds: float) -> Dict:
    every = sess.ctx.work["loss_every"]
    first = sess.next
    steps, failed, window_sum, in_sum = 0, 0, None, 0
    _agree_stop(sess, False)  # every rank starts the window together
    t0 = time.perf_counter()
    while not _agree_stop(sess, time.perf_counter() - t0 >= seconds):
        loss = _step(sess)
        steps += 1
        window_sum = loss if window_sum is None else window_sum + loss
        in_sum += 1
        if in_sum == every:
            if not math.isfinite(window_sum.item()):
                failed += in_sum
            window_sum, in_sum = None, 0
    if window_sum is not None and not math.isfinite(window_sum.item()):
        failed += in_sum
    _sync(sess)
    elapsed = time.perf_counter() - t0
    flops, _, positions = _work_of(sess, sess.global_batches, first, steps)
    return {"end_to_end": {"train_tokens_per_s": positions / elapsed},
            "attempted": steps, "failed": failed, "seconds": elapsed, "steps": steps,
            "positions": positions, "train_flops": flops}


def traced(sess, tmpdir: str) -> Dict:
    """``trace_steps`` more steps under the profiler, the attention entry
    marked, ending in a loss read."""
    from ecg_byte_tpu_torch.ops import attention

    from bench_port import tracing

    s, work = sess.ctx.spec, sess.ctx.work
    steps = work["trace_steps"]
    first = sess.next
    with tracing.marks({"attn": (attention, "causal_attention")}):
        with tracing.profiled(tmpdir, torch.device(sess.ctx.device)) as out:
            total = None
            for _ in range(steps):
                loss = _step(sess)
                total = loss if total is None else total + loss
            total.item()
    _, pairs, _ = _work_of(sess, sess.batches, first, steps)
    b, seq = work["batch"], work["pad_to_max"] + 4
    calls = steps * s.layers
    return {"trace": out["trace"], "steps": steps,
            "attn_fwd": (counts.attention_flops(s, pairs * s.layers),
                         counts.attention_bytes(s, b, seq) * calls),
            "attn_bwd": (counts.attention_bwd_flops(s, pairs * s.layers),
                         counts.attention_bwd_bytes(s, b, seq) * calls)}


def outputs(sess) -> Dict:
    """The program's readings of the checked steps; frees its state."""
    out = sess.checked
    sess.state = sess.step_fn = None
    return out


def _sum_over_ranks(flat: torch.Tensor) -> None:
    import torch.distributed as dist

    dist.all_reduce(flat)


def _ref_inputs(ctx):
    s, dev = ctx.spec, torch.device(ctx.device)
    total = ctx.work["batch"] * ctx.world
    dtype = getattr(torch, s.dtype)
    w = make_weights(s, ctx.seed, dev, dtype)
    w = to_f32(w)
    lora = to_f32(make_lora(s, ctx.seed, dev, dtype))
    batches = [{k: torch.from_numpy(np.asarray(v)).to(dev).long() for k, v in b.items()}
               for b in traffic.train_batches(s, {**ctx.work, "batch": total}, ctx.seed,
                                              ctx.work["check_steps"])]
    return w, lora, batches


def reference(ctx, outputs=None, mm=None) -> Dict:
    """The reference's readings of the checked steps (``mm``: the product
    of the control; default float32 with TF32 off)."""
    from bench_port.reference import model as M
    from bench_port.reference import train as R

    w, lora, batches = _ref_inputs(ctx)
    before = {k: t.clone() for k, t in R._leaves(lora)}
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        got = R.run_steps(w, ctx.spec, lora, batches, torch.Generator().manual_seed(ctx.seed),
                          warmup=ctx.work["warmup"], rows=ctx.work["reference_rows"],
                          mm=mm or M.f32_mm, store=getattr(torch, ctx.spec.dtype),
                          row_ids=range(ctx.rank, batches[0]["input_ids"].shape[0], ctx.world),
                          reduce=_sum_over_ranks if ctx.world > 1 else None)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return {"losses": got["losses"],
            "first_grad": {k: float(g.norm()) for k, g in got["first_grad"].items()},
            "change": {k: float((got["params"][k] - before[k]).norm()) for k in before},
            "grad_norms": got["grad_norms"]}


def _leaf_gap(got: Dict, want: Dict, keys) -> float:
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys)


def moving_leaves(ref: Dict):
    """The leaves whose loss gradient reaches a thousandth of the median
    leaf's in some checked step."""
    peak = {k: max(step[k] for step in ref["grad_norms"]) for k in ref["grad_norms"][0]}
    med = statistics.median(peak.values())
    return [k for k, v in peak.items() if v >= 1e-3 * med]


def compare(ctx, got: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(got["first_grad"], ref["first_grad"], list(ref["first_grad"])),
            "change_gap": _leaf_gap(got["change"], ref["change"], moving_leaves(ref))}
