"""prefill_tokens_per_s: every prompt position of every batch completed in
the window (patch positions count), over the window's time (host clock)."""
from portbench import window


def read(run):
    return window.rate(sum(w for _, _, w in run.spans), run.window_s)
