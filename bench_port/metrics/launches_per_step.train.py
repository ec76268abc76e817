"""Kernels launched on the card per train step, from the traced steps."""


def read(run):
    if run.trace is None or not run.traced.get("steps"):
        return None
    return len(run.trace.kernels()) / run.traced["steps"]
