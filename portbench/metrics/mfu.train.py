"""mfu.train: three times the frozen analytic forward FLOPs (``counts.flops``;
recomputation not counted) of the window's steps, over the window's time and
the chip's bf16 peak (%); the steps and time of the profiled stretch are
left out."""
from portbench.counts.flops import fwd_flops
from portbench.counts.peaks import PEAK_FLOPS


def read(run):
    B, S = run.traffic["batch"], run.traffic["seq"]
    flops = 3 * fwd_flops(run.cfg, B, S, "train") * len(run.steady_spans)
    return flops / (run.steady_s * PEAK_FLOPS["bfloat16"]) * 100.0
