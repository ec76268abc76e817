"""Serving's share of the card's peak: the model operations of the
window's batches (prefill and decode steps, ``counts``) over the window's
time and the peak.  Host clock."""

from bench_port.counts import PEAK_FLOPS


def read(run):
    w = run.window
    if "serve_flops" not in w:
        return None
    return 100.0 * w["serve_flops"] / (w["seconds"] * PEAK_FLOPS * run.chips)
