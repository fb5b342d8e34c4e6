"""dispatch_ms.prefill: host time from the call of ``model.prefill`` to its
return, the mean per batch over the window outside the profiled stretch
(any synchronise inside the program is included)."""


def read(run):
    calls = run.outside_stretch("prefill")
    if not calls:
        return None
    return sum(t1 - t0 for t0, t1, _ in calls) / len(calls) * 1e3
