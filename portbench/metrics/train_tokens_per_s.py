"""train_tokens_per_s: every token of every step completed in the window, over
the window's time (host clock)."""
from portbench import window


def read(run):
    return window.rate(sum(w for _, _, w in run.spans), run.window_s)
