"""The train step's share of the card's peak: the model operations of the
window's steps (``counts.train_step_flops``) over the window's time and
the peak of every card the cell uses.  Host clock."""

from bench_port.counts import PEAK_FLOPS


def read(run):
    w = run.window
    if "train_flops" not in w:
        return None
    return 100.0 * w["train_flops"] / (w["seconds"] * PEAK_FLOPS * run.chips)
