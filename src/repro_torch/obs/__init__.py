"""Observability plane: causal tracing, unified metrics, flight recorder.

Everything importable from this package root is stdlib-only, so core
modules (`core/fabric.py`, `core/reconfigure.py`, ...) may import
``TRACER`` without cycles. The scenario runner (``repro_torch.obs.scenario``),
CLI (``python -m repro_torch.obs``), metrics federation (``repro_torch.obs.federate``,
imports the fleet KV plane) and trace calibration (``repro_torch.obs.calibrate``,
feeds the comm plane) import the core stack and are kept out of this root
for the same reason. The SLO engine (``repro_torch.obs.slo``) is stdlib-only and
exported here. See docs/architecture.md §10–§11.
"""
from repro_torch.obs.export import (
    PHASES,
    phase_durations,
    render_timeline,
    stitched_trace_ids,
    to_chrome,
    write_chrome,
)
from repro_torch.obs.flight import RECORDER, FlightRecorder, strand_alarm
from repro_torch.obs.metrics import MetricsRegistry, parse_prometheus
from repro_torch.obs.slo import (
    SLO,
    SLOEngine,
    availability_slo_for,
    error_ratio_slo_for,
    latency_slo_for,
)
from repro_torch.obs.trace import NOOP_SPAN, Span, TRACER, Tracer

__all__ = [
    "TRACER", "Tracer", "Span", "NOOP_SPAN",
    "MetricsRegistry", "parse_prometheus",
    "FlightRecorder", "RECORDER", "strand_alarm",
    "SLO", "SLOEngine", "latency_slo_for", "error_ratio_slo_for",
    "availability_slo_for",
    "to_chrome", "write_chrome", "render_timeline", "phase_durations",
    "stitched_trace_ids", "PHASES",
]
