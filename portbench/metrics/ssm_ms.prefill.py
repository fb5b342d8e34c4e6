"""ssm_ms.prefill: device time per batch of the operations launched inside
the benchmark's range around ``ssm`` calls, in the profiled stretch."""


def read(run):
    s = run.stretch
    if s is None or not s.ranges.get("portbench.ssm"):
        return None
    return s.range_device_s("ssm") / s.units * 1e3
