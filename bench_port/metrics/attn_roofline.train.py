"""Training attention's share of its roofline: the least time of the
traced steps' attention forward and backward from their shapes
(``counts.bound_seconds`` of each) over the device time of everything
launched under the attention entry's marks, forward and backward."""

from bench_port.counts import bound_seconds


def read(run):
    if run.trace is None or "attn_fwd" not in run.traced:
        return None
    spent = (run.trace.device_seconds("bench.attn")
             + run.trace.device_seconds("bench.attn.bwd"))
    if spent <= 0:
        return None
    bound = bound_seconds(*run.traced["attn_fwd"]) + bound_seconds(*run.traced["attn_bwd"])
    return 100.0 * bound / spent
