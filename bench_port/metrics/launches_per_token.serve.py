"""Kernels launched on the card per decode step (one token of every row),
counted under the traced batch's ``bench.decode_step`` marks."""


def read(run):
    if run.trace is None:
        return None
    steps = run.trace.mark_counts.get("bench.decode_step", 0)
    if not steps:
        return None
    return len(run.trace.kernels("bench.decode_step")) / steps
