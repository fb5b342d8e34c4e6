"""span_idle_ms.train: device idle time per step while the host is inside
the program's span ``train.step`` (the stretches of each such span that no
kernel, copy or memset covers), in the profiled stretch."""
from portbench import spans


def read(run):
    return spans.idle_ms(run.stretch, "train.step")
