"""Rank 0's device time in NCCL kernels (the gradients' all-reduce) over
its traced window."""


def read(run):
    if run.trace is None or run.chips == 1 or run.trace.window_s <= 0:
        return None
    return 100.0 * run.trace.device_seconds(name_has="nccl") / run.trace.window_s
