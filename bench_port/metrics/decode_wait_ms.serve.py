"""The host's time blocked on the card in one decode step's done-check
in the untraced window: Σ``decode_wait_s`` / Σ``decode_steps`` over the
window's ``greedy_generate`` calls, taken and checked as
``decode_issue_ms.serve`` takes them.  With it, the two add up to
``decode_step_ms.serve``."""

import os

from bench_port.harness import load_module

_issue = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "decode_issue_ms.serve.py"),
                     "bench_port_metric_decode_issue_ms_serve")


def read(run):
    recs = _issue.window_records(run)
    if not recs:
        return None
    steps = sum(r["decode_steps"] for r in recs)
    if not steps:
        return None
    return 1e3 * sum(r["decode_wait_s"] for r in recs) / steps
