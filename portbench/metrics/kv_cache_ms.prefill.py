"""kv_cache_ms.prefill: device time per batch of the operations launched
inside the program's span ``model.kv_cache`` (prefill's per-layer K/V kept
in the compute type and their ``torch.stack``), in the profiled stretch."""
from portbench import spans


def read(run):
    return spans.region_ms(run.stretch, "model.kv_cache")
