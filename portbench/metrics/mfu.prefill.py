"""mfu.prefill: the frozen analytic forward FLOPs (``counts.flops``) of the
window's batches, over the window's time and the chip's bf16 peak (%);
the batches and time of the profiled stretch are left out."""
from portbench.counts.flops import fwd_flops
from portbench.counts.peaks import PEAK_FLOPS


def read(run):
    B = run.traffic["batch"]
    flops = sum(fwd_flops(run.cfg, B, w // B, "prefill") for _, _, w in run.steady_spans)
    return flops / (run.steady_s * PEAK_FLOPS["bfloat16"]) * 100.0
