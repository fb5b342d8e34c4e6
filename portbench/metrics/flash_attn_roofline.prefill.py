"""flash_attn_roofline.prefill: flash attention's least time on the chip
(``counts.kernels.flash_attention`` of every call in the profiled stretch:
the pairs the causal, window and prefix masks leave; q, k, v and o once, at
the configuration's declared compute dtype) over the device time of the
operations launched inside the calls (%)."""
from portbench.counts.kernels import flash_attention, least_seconds


def read(run):
    s, calls = run.stretch, run.stretch_calls("flash_attention")
    device_s = s.range_device_s("flash_attention") if s is not None else 0.0
    if not calls or not device_s:
        return None
    dtypes = run.cfg["dtypes"]
    least = sum(least_seconds(*flash_attention(q, k, causal, window, dtypes, prefix))
                for _, _, (q, k, causal, window, prefix) in calls)
    return least / device_s * 100.0
