"""ttft_p95_ms: the 95th percentile (nearest rank) over every batch of the
window of the time from the batch's start to its first token on the host."""
from portbench import window


def read(run):
    return window.nearest_rank([t1 - t0 for t0, t1, _ in run.spans], 0.95) * 1e3
