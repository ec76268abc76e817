"""The share of an untraced batch in which no operation ran on the card:
1 - (device-busy seconds a batch in the traced batch) / (seconds a batch
of the untraced window).  The traced batch's own length is not the
denominator, since the profiler's host cost slows the host under it."""


def read(run):
    w, t = run.window, run.traced
    if run.trace is None or not w.get("batches") or not t.get("batches"):
        return None
    return 100.0 * (1.0 - (run.trace.busy_s / t["batches"]) / (w["seconds"] / w["batches"]))
