"""selective_scan_roofline: the selective scan's least time on the chip
(``counts.kernels.selective_scan`` of every call in the profiled stretch, at
the configuration's declared dtypes) over the device time of the operations
launched inside the calls (%)."""
from portbench.counts.kernels import least_seconds, selective_scan


def read(run):
    s, calls = run.stretch, run.stretch_calls("selective_scan")
    device_s = s.range_device_s("selective_scan") if s is not None else 0.0
    if not calls or not device_s:
        return None
    dtypes = run.cfg["dtypes"]
    least = 0.0
    for _, _, ((B, S, d_in), N) in calls:
        least += least_seconds(*selective_scan(B, S, d_in, N, dtypes))
    return least / device_s * 100.0
