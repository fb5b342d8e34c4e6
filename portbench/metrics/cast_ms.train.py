"""cast_ms.train: device time per step of the operations launched inside
the program's span ``model.linear.cast`` (a float32 weight's bf16 copy in
the training graph) or its backward range ``model.linear.cast.bwd``, in the
profiled stretch (each operation put down to its innermost ``model.*``
span)."""
from portbench import spans


def read(run):
    return spans.region_ms(run.stretch, "model.linear.cast", "model.linear.cast.bwd")
