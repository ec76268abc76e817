"""Readings that the limits of a cell's correctness check are set from.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 3,4,5 [--out chiprun_out/calibrate.<cell>.json]

On the card, at the cell's own size, in one process: for every seed the
program's numbers against the plain reference (the lower readings); for
each control seed the control's (the reference in fp8 in the program's
place) and each fault's, planted in the program:

- training: half of the batch left out of each step, the mean taken over
  the rest; on several ranks also the gradients' exchange left out (a
  state left unchanged reads 1 by the change's measure and needs no run);
- serving: one served token altered where it is produced.

The benchmark's own runs do not run this.  Prints one JSON line a
reading and writes them all to ``--out``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import harness  # noqa: E402


def half_batch(step_module):
    """Plant the fault: each step's loss over the first half of its rows,
    the mean taken over them."""
    orig = step_module._loss_from_batch

    def faulty(config, params, lora, batch, gen, remat="none", rows=None, n_valid=None):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(config, params, lora, half, gen, remat, None, None)

    step_module._loss_from_batch = faulty
    return lambda: setattr(step_module, "_loss_from_batch", orig)


def no_exchange(distributed_module):
    """Plant the fault: the gradients are not summed over the ranks."""
    orig = distributed_module.reduce_gradients_

    def local(params, *scalars, groups=None):
        return list(scalars)

    distributed_module.reduce_gradients_ = local
    return lambda: setattr(distributed_module, "reduce_gradients_", orig)


def program_outputs(ctx, driver):
    import torch

    sess = driver.prepare(ctx)
    if ctx.work["driver"] == "serve":
        driver.measure(sess, 1e-3)  # one batch served as the window serves it
    out = driver.outputs(sess)
    del sess
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def readings(cell, seed, control: bool, device, here=harness.HERE, rank=0, world=1):
    from bench_port.reference.precision import fp8_mm

    ctx = harness.context(cell, seed, device, here, rank=rank, world=world)
    driver = harness.driver_of(ctx)
    t0 = time.perf_counter()
    out = program_outputs(ctx, driver)
    ref = driver.reference(ctx, out)
    rows = [{"seed": seed, "kind": "program", **driver.compare(ctx, out, ref),
             "seconds": time.perf_counter() - t0, "detail": _detail(out, ref)}]
    if not control:
        return rows
    if ctx.work["driver"] == "serve":
        ctl = driver.reference(ctx, out, mm=fp8_mm)
        rows.append({"seed": seed, "kind": "control", **driver.compare(ctx, out, ctl)})
        bad = {"requests": [dict(r) for r in out["requests"]]}
        tok = bad["requests"][0]["served"].copy()
        tok[len(tok) // 2] = (int(tok[len(tok) // 2]) + 1) % ctx.spec.text_vocab
        bad["requests"][0]["served"] = tok
        rows.append({"seed": seed, "kind": "fault.token_altered",
                     **driver.compare(ctx, bad, driver.reference(ctx, bad))})
        return rows
    ctl = driver.reference(ctx, None, mm=fp8_mm)
    rows.append({"seed": seed, "kind": "control", **driver.compare(ctx, ctl, ref),
                 "detail": _detail(ctl, ref)})
    from ecg_byte_tpu_torch.parallel import distributed
    from ecg_byte_tpu_torch.train import step

    faults = {"fault.half_batch": lambda: half_batch(step)}
    if world > 1:
        faults["fault.no_exchange"] = lambda: no_exchange(distributed)
    for kind, plant in faults.items():
        undo = plant()
        try:
            bad = program_outputs(ctx, driver)
        finally:
            undo()
        rows.append({"seed": seed, "kind": kind, **driver.compare(ctx, bad, ref)})
    return rows


def _all_seeds(rank, world, cell, seeds, control, device_type, here=harness.HERE):
    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    rows = []
    for seed in seeds:
        for row in readings(cell, seed, seed in control, device, here, rank, world):
            if rank == 0:
                print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def _detail(got, ref):
    """Each step's loss on both sides, and the leaves of the widest gaps."""
    if "losses" not in got:
        return None
    out = {"losses": got["losses"], "ref_losses": ref["losses"]}
    for key in ("first_grad", "change"):
        worst = sorted(ref[key], key=lambda k: -abs(got[key][k] - ref[key][k])
                       / max(ref[key][k], 1e-30))[:3]
        out[key] = [[str(k), got[key][k], ref[key][k]] for k in worst]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py measures on a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", flush=True)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    control = {int(x) for x in args.control_seeds.split(",") if x}
    order = sorted(set(seeds) | control, key=lambda x: (x not in control, x))
    chips = harness.load_json(harness.workload_file(args.workload))["chips"]
    if chips == 1:
        torch.cuda.set_device(0)
        rows = _all_seeds(0, 1, args.workload, order, control, "cuda")
    else:
        rows = harness.with_ranks(chips, "cuda", _all_seeds,
                                  (args.workload, order, control, "cuda"))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": harness.card_line(), "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
