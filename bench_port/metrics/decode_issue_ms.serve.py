"""The host's time to launch one decode step in the untraced window:
Σ(``decode_s`` - ``decode_wait_s``) / Σ``decode_steps`` over the window's
``greedy_generate`` calls, from the program's own log
(``profiling.records("decode")``, one record a call).  A step's
``decode_wait_s`` is the time its done-check blocked on the card, so the
rest is Python and launches.  None where the program keeps no such log,
or where the records taken for the window do not sum to the window's own
readings."""

import math


def window_records(run):
    """The records of the window's calls: set-up serves first and the
    traced batch last, so the window's are the ``w`` before the last
    ``t``.  None unless their steps and decode seconds sum to the
    window's."""
    try:
        from ecg_byte_tpu_torch.utils.profiling import records
    except ImportError:  # a program without the log
        return None
    w, t = run.window.get("batches", 0), run.traced.get("batches", 0)
    log = records("decode")
    if not w or len(log) < w + t:
        return None
    recs = log[len(log) - w - t:len(log) - t]
    if sum(r["decode_steps"] for r in recs) != run.window["decode_steps"]:
        return None
    if not math.isclose(sum(r["decode_s"] for r in recs), run.window["decode_s"],
                        rel_tol=1e-9, abs_tol=0.0):
        return None
    return recs


def read(run):
    recs = window_records(run)
    if not recs:
        return None
    steps = sum(r["decode_steps"] for r in recs)
    if not steps:
        return None
    return 1e3 * sum(r["decode_s"] - r["decode_wait_s"] for r in recs) / steps
