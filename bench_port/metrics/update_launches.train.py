"""Kernels launched per train step in the update phase (the clip, Adam
and the schedule): the host's launch calls (``cudaLaunchKernel``,
``cuLaunchKernel`` and their ``Ex`` forms) on the traced steps' main
thread that lie inside the program's ``ecg.train.update`` spans, over the
number of those spans.  A count, so the profiler's host cost does not
move it.  None where the program emits no such span."""

import bisect

SPAN = "ecg.train.update"


def read(run):
    if run.trace is None:
        return None
    events = run.trace.host.get(run.trace.main_tid, [])
    spans = [(s, e) for s, e, name in events if name == SPAN]
    if not spans:
        return None
    launches = sorted(s for s, _, name in events if "LaunchKernel" in name)
    inside = sum(bisect.bisect_right(launches, e) - bisect.bisect_left(launches, s)
                 for s, e in spans)
    return inside / len(spans)
