"""optimizer_ms.train: device time per step of the operations launched inside
the benchmark's range around ``optim/adamw.py`` ``update``, in the profiled
stretch."""


def read(run):
    s = run.stretch
    if s is None or not s.ranges.get("portbench.optimizer"):
        return None
    return s.range_device_s("optimizer") / s.units * 1e3
