"""span_idle_ms.prefill: device idle time per batch while the host is
inside the program's span ``serve.prefill`` (the stretches of each such
span that no kernel, copy or memset covers), in the profiled stretch."""
from portbench import spans


def read(run):
    return spans.idle_ms(run.stretch, "serve.prefill")
