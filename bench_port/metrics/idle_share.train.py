"""The share of an untraced step in which no operation ran on the card:
1 - (device-busy seconds a step in the traced steps) / (seconds a step of
the untraced window).  The traced stretch's own length is not the
denominator, since the profiler's host cost slows the host under it."""


def read(run):
    w, t = run.window, run.traced
    if run.trace is None or not w.get("steps") or not t.get("steps"):
        return None
    return 100.0 * (1.0 - (run.trace.busy_s / t["steps"]) / (w["seconds"] / w["steps"]))
