"""attn_ms.train: device time per step of the operations launched inside
the program's span ``model.attention`` or its backward range
``model.attention.bwd`` (forward, recomputation and backward), in the
profiled stretch (each operation put down to its innermost ``model.*``
span)."""
from portbench import spans


def read(run):
    return spans.region_ms(run.stretch, "model.attention", "model.attention.bwd")
