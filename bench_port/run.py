"""Run one cell of the benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is the result's JSON
object; the numbers the correctness check compared, each beside its
limit, are the last lines of standard error and the result's last key.
It exits with 2, printing no result, without the cards the cell needs,
and with 3 where a module of JAX or of the JAX package is loaded once the
window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]

    import torch

    print(f"[setup] torch imported at {time.perf_counter() - T0:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}; peaks 989 TFLOP/s bf16 and 3.35 TB/s at 700 W",
          flush=True)
    if chips == 1:
        torch.cuda.set_device(0)
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda:0", t0=T0, bench=bench)
    else:
        result = harness.with_ranks(chips, "cuda", harness.rank_run,
                                    (args.workload, args.seed, args.seconds, bool(args.trace),
                                     T0, "cuda"))
    found = harness.foreign_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
