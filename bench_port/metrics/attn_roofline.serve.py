"""Serving attention's share of its roofline: the least time of the traced
batch's prefill attention and decode attention (this token's row
included) from their shapes, over the device time of everything launched
under the two attention entries' marks."""

from bench_port.counts import bound_seconds


def read(run):
    if run.trace is None or "attn_decode" not in run.traced:
        return None
    spent = (run.trace.device_seconds("bench.attn")
             + run.trace.device_seconds("bench.attn_decode"))
    if spent <= 0:
        return None
    bound = (bound_seconds(*run.traced["attn_prefill"])
             + bound_seconds(*run.traced["attn_decode"]))
    return 100.0 * bound / spent
