"""The mean prefill of the window: ``greedy_generate``'s ``prefill_s``
(cache allocation, prefill, first token) summed over the batches."""


def read(run):
    w = run.window
    if not w.get("batches"):
        return None
    return 1e3 * w["prefill_s"] / w["batches"]
