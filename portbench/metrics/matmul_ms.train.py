"""matmul_ms.train: device time per step of the operations launched inside
the program's span ``model.linear.matmul`` (a ``Linear``'s bf16 product) or
its backward range ``model.linear.matmul.bwd``, in the profiled stretch
(each operation put down to its innermost ``model.*`` span)."""
from portbench import spans


def read(run):
    return spans.region_ms(run.stretch, "model.linear.matmul", "model.linear.matmul.bwd")
