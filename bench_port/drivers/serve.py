"""Batched serving: a closed loop of the program's ``greedy_generate``.

The whole test set is queued at once, as ``cli.main --inference
--eval_batch_size B`` serves an evaluation set, so one batch starts as the
last ends and the end-to-end metric is the answer tokens completed per
second.  Each batch: ``batch`` prompts, left-padded and bucketed as
``cli.main`` pads them, ``new_tokens`` greedy tokens each with no eos
(random weights would stop no row early, and a row that stopped would
still decode).  A batch started in the window runs to its end.

Set-up makes the weights from the seed and serves one batch, which warms
every shape the window uses.  The check: a sample of the requests served
in the window, drawn from the seed with the longest prompt among them;
the reference reads each prompt with its served tokens, and the number is
the widest gap by which a served token's logit lies below the
reference's best (:mod:`bench_port.reference.serve`).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from bench_port import counts, traffic
from bench_port.weights import make_weights, to_f32


class Session:
    pass


def prepare(ctx):
    s, work, dev = ctx.spec, ctx.work, torch.device(ctx.device)
    sess = Session()
    sess.ctx = ctx
    sess.config = ctx.port_config()
    sess.params = make_weights(s, ctx.seed, dev, getattr(torch, s.dtype))
    sess.batches = traffic.serve_batches(s, work, ctx.seed, work["pool"])
    ctx.mark("weights made")
    sess.next = 0
    sess.served = []  # (batch index, (B, new_tokens) tokens) of the window's batches
    _serve(sess, sess.batches[0], {})
    ctx.mark("warm-up batch served")
    return sess


def _serve(sess, batch, stats):
    from ecg_byte_tpu_torch.infer.decode import greedy_generate

    dev = torch.device(sess.ctx.device)
    ids = torch.from_numpy(batch["input_ids"]).to(dev)
    mask = torch.from_numpy(batch["attn_mask"]).to(dev)
    out = greedy_generate(sess.params, sess.config, ids, mask,
                          max_new_tokens=sess.ctx.work["new_tokens"], eos_token_id=-1,
                          pad_token_id=sess.ctx.spec.pad, stats=stats)
    return out.cpu().numpy()


def _batch_work(s, batch, steps: int):
    """Operations of one batch: the prefill and ``steps`` decode steps."""
    mask = batch["attn_mask"]
    rows = mask.shape[0]
    valid = int(mask.sum())
    flops = counts.prefill_flops(s, mask.size, rows, traffic.causal_pairs(mask))
    # decode step j attends each row's valid prompt and j new slots
    for j in range(1, steps + 1):
        flops += counts.decode_step_flops(s, rows, valid + rows * j)
    return flops


def measure(sess, seconds: float) -> Dict:
    s, work = sess.ctx.spec, sess.ctx.work
    n = len(sess.batches)
    agg = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0}
    tokens, flops, batches = 0, 0.0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = sess.next % n
        sess.next += 1
        stats = {}
        out = _serve(sess, sess.batches[i], stats)
        sess.served.append((i, out))
        for k in agg:
            agg[k] += stats[k]
        tokens += out.shape[0] * (1 + stats["decode_steps"])
        flops += _batch_work(s, sess.batches[i], stats["decode_steps"])
        batches += 1
    elapsed = time.perf_counter() - t0
    return {"end_to_end": {"serve_tokens_per_s": tokens / elapsed},
            "attempted": batches * work["batch"], "failed": 0, "seconds": elapsed,
            "batches": batches, "tokens": tokens, "serve_flops": flops, **agg}


def traced(sess, tmpdir: str) -> Dict:
    """One more batch under the profiler, the prefill, each decode step and
    both attention entries marked."""
    from ecg_byte_tpu_torch.models import transformer
    from ecg_byte_tpu_torch.ops import attention, attention_decode

    from bench_port import tracing

    s = sess.ctx.spec
    batch = sess.batches[sess.next % len(sess.batches)]
    sess.next += 1
    targets = {"attn": (attention, "causal_attention"),
               "attn_decode": (attention_decode, "decode_attention_fused"),
               "prefill": (transformer, "prefill"), "decode_step": (transformer, "decode_step")}
    stats = {}
    with tracing.marks(targets):
        with tracing.profiled(tmpdir, torch.device(sess.ctx.device)) as out:
            _serve(sess, batch, stats)
    mask = batch["attn_mask"]
    rows, width = mask.shape
    valid = int(mask.sum())
    steps = stats["decode_steps"]
    keys = sum(valid + rows * j for j in range(1, steps + 1))
    return {"trace": out["trace"], "batches": 1, "decode_steps": steps,
            "attn_prefill": (counts.attention_flops(s, traffic.causal_pairs(mask) * s.layers),
                             counts.attention_bytes(s, rows, width) * s.layers),
            "attn_decode": (4 * s.head_dim * s.heads * keys * s.layers,
                            counts.decode_attention_bytes(s, rows, keys) * s.layers)}


def outputs(sess) -> Dict:
    """The sampled requests (prompt and served tokens) on the host; frees
    the program's state."""
    work = sess.ctx.work
    rng = np.random.default_rng(sess.ctx.seed)
    done = [(b, row) for b, (i, _) in enumerate(sess.served) for row in range(work["batch"])]
    length = lambda br: int(sess.batches[sess.served[br[0]][0]]["lengths"][br[1]])  # noqa: E731
    longest = max(done, key=length)
    rest = [d for d in done if d != longest]
    picks = [longest] + [rest[j] for j in rng.choice(len(rest), work["sample"] - 1,
                                                     replace=False)]
    requests = []
    for b, row in picks:
        i, toks = sess.served[b]
        batch = sess.batches[i]
        n = int(batch["lengths"][row])
        requests.append({"prompt": batch["input_ids"][row, -n:].copy(),
                         "served": toks[row].copy()})
    sess.params = None
    return {"requests": requests}


def _f32_weights(ctx):
    s = ctx.spec
    return to_f32(make_weights(s, ctx.seed, torch.device(ctx.device), getattr(torch, s.dtype)))


def _requests(ctx, outputs):
    dev = torch.device(ctx.device)
    return [{k: torch.from_numpy(v.astype(np.int64)).to(dev) for k, v in r.items()}
            for r in outputs["requests"]]


def reference(ctx, outputs, mm=None) -> Dict:
    """The reference's widest gap over the sampled requests; with ``mm``
    (the control's product) the gap of the tokens the control puts first."""
    from bench_port.reference import serve as R

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gap = R.widest_gap(_f32_weights(ctx), ctx.spec, _requests(ctx, outputs),
                           control_mm=mm)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return {"served_gap": gap}


def compare(ctx, got: Dict, ref: Dict) -> Dict[str, float]:
    return {"served_gap": ref["served_gap"]}
