"""rope_ms.prefill: device time per batch of the operations launched inside
the program's span ``model.rope`` (``rotate``, q and k of every layer), in
the profiled stretch (each operation put down to its innermost ``model.*``
span)."""
from portbench import spans


def read(run):
    return spans.region_ms(run.stretch, "model.rope")
