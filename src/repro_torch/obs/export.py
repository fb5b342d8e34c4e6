"""Exporters: Chrome ``trace_event`` JSON + ASCII switch timeline.

Input is the normalized record list from ``Tracer.collect()`` (or a
flight-recorder dump's ``"records"``). Chrome output loads in Perfetto /
``chrome://tracing``: spans become ``ph="X"`` complete events, instants
and batch records become ``ph="i"``, threads are mapped to tids with
``ph="M"`` name metadata. Timestamps are µs relative to the earliest
record. Stdlib-only.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["to_chrome", "write_chrome", "render_timeline", "PHASES",
           "stitched_trace_ids", "phase_durations"]

#: Canonical switch phases (detect→score→negotiate→prepare→commit→swap→
#: drain) and the span names that make them up. Order matters for the
#: timeline rendering.
PHASES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("detect", ("controller.tick",)),
    ("score", ("negotiate.score",)),
    ("negotiate", ("negotiate.client", "negotiate.offer",
                   "negotiate.zero_rtt")),
    ("prepare", ("2pc.prepare", "2pc.peer.prepare")),
    ("commit", ("2pc.commit", "2pc.peer.commit", "2pc.peer.abort")),
    ("swap", ("reconfig.swap",)),
    ("drain", ("scenario.drain",)),
)


def _json_safe(val):
    try:
        json.dumps(val)
        return val
    except (TypeError, ValueError):
        return str(val)


def to_chrome(records: Iterable[dict]) -> dict:
    """Build a Chrome trace_event document from collected records."""
    records = list(records)
    if not records:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(r["ts"] for r in records)
    tids: Dict[str, int] = {}
    events: List[dict] = []

    def tid(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
            events.append({"ph": "M", "pid": 1, "tid": tids[thread],
                           "name": "thread_name",
                           "args": {"name": thread}})
        return tids[thread]

    for r in records:
        args = {k: _json_safe(v) for k, v in (r.get("attrs") or {}).items()}
        if r.get("trace_id") is not None:
            args["trace_id"] = r["trace_id"]
            args["span_id"] = r["span_id"]
            if r.get("parent_id") is not None:
                args["parent_id"] = r["parent_id"]
        if r.get("status") not in (None, "ok"):
            args["status"] = r["status"]
        base_ts = (r["ts"] - t0) * 1e6
        if r["kind"] == "span":
            events.append({
                "ph": "X", "pid": 1, "tid": tid(r.get("thread") or "?"),
                "name": r["name"], "cat": r["name"].split(".")[0],
                "ts": base_ts, "dur": max((r.get("dur") or 0.0) * 1e6, 0.01),
                "args": args,
            })
            for ev in r.get("events") or ():
                events.append({
                    "ph": "i", "s": "t", "pid": 1,
                    "tid": tid(r.get("thread") or "?"),
                    "name": f'{r["name"]}:{ev["name"]}',
                    "cat": r["name"].split(".")[0],
                    "ts": (ev["ts"] - t0) * 1e6,
                    "args": {k: _json_safe(v)
                             for k, v in (ev.get("attrs") or {}).items()},
                })
        else:  # event / batch records render as instants
            events.append({
                "ph": "i", "s": "t", "pid": 1,
                "tid": tid(r.get("thread") or "?"),
                "name": r["name"], "cat": r["name"].split(".")[0],
                "ts": base_ts, "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(records: Iterable[dict], path) -> dict:
    doc = to_chrome(records)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def stitched_trace_ids(records: Iterable[dict]) -> Dict[int, int]:
    """``{trace_id: span_count}`` over span records — the acceptance check
    asserts one trace id covers decision→negotiation→2PC→swap."""
    out: Dict[int, int] = {}
    for r in records:
        if r.get("kind") == "span" and r.get("trace_id") is not None:
            out[r["trace_id"]] = out.get(r["trace_id"], 0) + 1
    return out


def phase_durations(records: Iterable[dict]) -> Dict[str, dict]:
    """Per-phase aggregates: earliest start, wall extent, total busy, count."""
    spans = [r for r in records if r.get("kind") == "span"
             and r.get("dur") is not None]
    out: Dict[str, dict] = {}
    for phase, names in PHASES:
        sel = [s for s in spans if s["name"] in names]
        if not sel:
            continue
        start = min(s["ts"] for s in sel)
        end = max(s["ts"] + s["dur"] for s in sel)
        out[phase] = {
            "start": start,
            "extent_s": end - start,
            "busy_s": sum(s["dur"] for s in sel),
            "count": len(sel),
            "names": sorted({s["name"] for s in sel}),
        }
    return out


def render_timeline(records: Iterable[dict], width: int = 48) -> str:
    """ASCII switch timeline: one bar per phase across the trace window."""
    records = list(records)
    phases = phase_durations(records)
    if not phases:
        return "(no phase spans recorded)"
    t0 = min(p["start"] for p in phases.values())
    t1 = max(p["start"] + p["extent_s"] for p in phases.values())
    window = max(t1 - t0, 1e-9)
    traces = stitched_trace_ids(records)
    main_trace = max(traces, key=traces.get) if traces else None
    lines = [
        f"switch timeline  window={window * 1e3:.2f}ms  "
        f"trace_id={main_trace}  spans={sum(traces.values())}",
    ]
    for phase, _names in PHASES:
        p = phases.get(phase)
        if p is None:
            continue
        lo = int((p["start"] - t0) / window * width)
        ln = max(int(p["extent_s"] / window * width), 1)
        lo = min(lo, width - 1)
        ln = min(ln, width - lo)
        bar = " " * lo + "#" * ln + " " * (width - lo - ln)
        lines.append(
            f"  {phase:<9} |{bar}| {p['extent_s'] * 1e3:8.2f}ms "
            f"x{p['count']:<3} {','.join(p['names'])}")
    return "\n".join(lines)
