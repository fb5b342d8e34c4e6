"""attn_ms.prefill: device time per batch of the operations launched inside
the benchmark's range around ``attention`` calls, in the profiled stretch."""


def read(run):
    s = run.stretch
    if s is None or not s.ranges.get("portbench.attention"):
        return None
    return s.range_device_s("attention") / s.units * 1e3
