"""fwd_bwd_ms.train: device time per step of the operations launched inside
the benchmark's ranges around ``registry.loss`` (the forward) and
``torch.autograd.backward`` (the backward, recomputation included), in the
profiled stretch."""


def read(run):
    s = run.stretch
    if s is None or not s.ranges.get("portbench.forward"):
        return None
    return (s.range_device_s("forward") + s.range_device_s("backward")) / s.units * 1e3
