"""idle_share: the share (%) of the profiled stretch's wall time in which no
kernel, copy or memset ran on the device (one minus the union of their
intervals over the wall time)."""


def read(run):
    s = run.stretch
    if s is None:
        return None
    return (1.0 - s.busy_s / s.wall_s) * 100.0
