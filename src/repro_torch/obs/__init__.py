"""Observability plane: causal tracing and the flight recorder.

Everything importable from this package root is stdlib-only, so core
modules may import ``TRACER`` without cycles.
"""
from repro_torch.obs.flight import RECORDER, FlightRecorder, strand_alarm
from repro_torch.obs.trace import NOOP_SPAN, Span, TRACER, Tracer

__all__ = [
    "TRACER", "Tracer", "Span", "NOOP_SPAN",
    "FlightRecorder", "RECORDER", "strand_alarm",
]
