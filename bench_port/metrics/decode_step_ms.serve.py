"""The mean decode step of the window: the sum of ``greedy_generate``'s
``decode_s`` over its ``decode_steps`` (its own host-clock spans)."""


def read(run):
    w = run.window
    if not w.get("decode_steps"):
        return None
    return 1e3 * w["decode_s"] / w["decode_steps"]
