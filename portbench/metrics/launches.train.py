"""launches.train: device operations (kernels, copies, memsets) per step
launched while the program's span ``train.step`` was open, in the profiled
stretch."""
from portbench import spans


def read(run):
    return spans.launches(run.stretch, "train.step")
