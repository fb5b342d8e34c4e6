"""``python -m repro_torch.obs`` — render a reconfiguration run as a trace.

Default mode runs the canonical KV-switch scenario (repro_torch.obs.scenario)
with tracing enabled, then:

  * writes a Chrome ``trace_event`` JSON (``--trace PATH``) loadable in
    Perfetto / chrome://tracing,
  * writes the unified metrics snapshot in Prometheus text format
    (``--metrics PATH``),
  * prints the ASCII switch timeline with per-phase durations
    (detect → score → negotiate → prepare → commit → swap → drain).

``--check`` re-parses both artifacts and asserts the acceptance
invariants: the Chrome doc is valid JSON with events, the metrics file
parses as exposition text, and ONE stitched trace id covers the
controller decision, the 2PC prepare/commit, and the swap on both
endpoints. ``--render FILE`` skips the scenario and renders a previously
written trace or flight-recorder dump instead.

Two standalone modes skip the scenario entirely (docs/architecture.md §11):

  * ``--fleet`` publishes two synthetic members through the KV obs plane
    and prints the federated dashboard — per-member rows, the merged
    ``_fleet`` row, and the per-region split.
  * ``--slo`` drives an ``SLOEngine`` through a scripted healthy → burning
    → recovered day on a fake clock and prints the error-budget report
    (burn rates, budget spent, breach/recovery counts).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs.export import (
    phase_durations,
    render_timeline,
    stitched_trace_ids,
    to_chrome,
    write_chrome,
)
from repro_torch.obs.metrics import parse_prometheus

#: span names the stitched acceptance trace must contain
REQUIRED_SPANS = ("controller.tick", "2pc.prepare", "2pc.commit",
                  "reconfig.swap")


def _load_records(path: Path) -> list:
    """Records from a flight-recorder dump ({"records": [...]}) or a raw
    collect() list. Chrome trace JSON is not re-importable — point --render
    at the flight-recorder dump instead."""
    doc = json.loads(path.read_text())
    if isinstance(doc, dict):
        if "records" in doc:
            return doc["records"]
        if "traceEvents" in doc:
            raise SystemExit(
                f"{path} is a Chrome trace export; --render needs the "
                f"flight-recorder dump (flightrec_*.json) or raw records")
    if not isinstance(doc, list):
        raise SystemExit(f"{path}: unrecognized trace document")
    return doc


def check_records(records: list) -> dict:
    """Assert the stitched-trace acceptance invariants; return the summary.

    One trace id must carry the whole switch story: the controller
    decision, the 2PC prepare and commit, and a ``reconfig.swap`` on BOTH
    endpoints (coordinator + peer ⇒ at least two swap spans)."""
    traces = stitched_trace_ids(records)
    if not traces:
        raise AssertionError("no spans recorded")
    main_trace = max(traces, key=traces.get)
    names = [r["name"] for r in records
             if r.get("kind") == "span" and r.get("trace_id") == main_trace]
    missing = [n for n in REQUIRED_SPANS if n not in names]
    if missing:
        raise AssertionError(
            f"trace {main_trace} is missing spans {missing}; has {sorted(set(names))}")
    n_swaps = names.count("reconfig.swap")
    if n_swaps < 2:
        raise AssertionError(
            f"expected the swap on both endpoints in one trace; "
            f"got {n_swaps} reconfig.swap span(s)")
    return {"trace_id": main_trace, "spans": len(names), "swaps": n_swaps,
            "all_traces": traces}


def fleet_demo(*, out: "Path | None" = None) -> int:
    """--fleet: two synthetic members publish through the KV obs plane; print
    the federated dashboard (per-member, merged ``_fleet`` row, per-region)."""
    from repro_torch.core.rendezvous import KVStore
    from repro_torch.obs.federate import MetricsFederator, MetricsPublisher
    from repro_torch.obs.metrics import MetricsRegistry

    store = KVStore()
    members = [("edge-1", "edge", {"ops_per_s": 300.0, "rtt_p50_s": 0.0012,
                                   "rtt_p95_s": 0.0074}),
               ("core-1", "core", {"ops_per_s": 900.0, "rtt_p50_s": 0.0003,
                                   "rtt_p95_s": 0.0009})]
    pubs = []
    for name, region, metrics in members:
        reg = MetricsRegistry()
        reg.register("conn", lambda m=metrics: dict(m), instance=f"{name}-conn")
        pub = MetricsPublisher(store, "demo-fleet", name, reg, region=region)
        pub.publish()
        pubs.append(pub)
    fed = MetricsFederator(store, "demo-fleet", ttl_s=5.0)

    view = fed.view()
    print(f"fleet demo-fleet: members={view['obs.members']} "
          f"stale={view['obs.stale_members']} "
          f"availability={view['obs.availability']:.2f}")
    print()
    print(f"  {'member':<10} {'region':<8} {'ops/s':>8} {'p50 ms':>8} "
          f"{'p95 ms':>8}")
    for (name, region, m) in members:
        print(f"  {name:<10} {region:<8} {m['ops_per_s']:>8.0f} "
              f"{m['rtt_p50_s'] * 1e3:>8.2f} {m['rtt_p95_s'] * 1e3:>8.2f}")
    merged = fed.merged()["conn"]
    print(f"  {'_fleet':<10} {'(merged)':<8} "
          f"{merged['ops_per_s']:>8.0f} "
          f"{merged['rtt_p50_s'] * 1e3:>8.2f} "
          f"{merged['rtt_p95_s'] * 1e3:>8.2f}")
    print()
    print("  per-region split (what region-scoped SLOs read):")
    for region, fams in sorted(fed.per_region().items()):
        print(f"    obs.region.{region}.conn.rtt_p95_s = "
              f"{fams['conn']['rtt_p95_s'] * 1e3:.2f} ms")
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        fed.federated_registry().write_prometheus(out)
        print(f"\nwrote {out}")
    for pub in pubs:
        pub.retire()
    return 0


def slo_demo() -> int:
    """--slo: a scripted healthy → burning → recovered day on a fake clock;
    print each phase's burn rates and the final error-budget report."""
    from repro_torch.obs.slo import SLO, SLOEngine

    engine = SLOEngine(
        [SLO("latency", "conn.rtt_p95_s", objective=0.95, threshold=0.005),
         SLO("errors", "conn.error_ratio", objective=0.999,
             kind="error_ratio")],
        fast_window_s=5.0, slow_window_s=60.0, budget_window_s=3600.0,
        recorder=None)   # a demo must not trip the real flight recorder

    phases = [("healthy", 60, {"conn.rtt_p95_s": 0.001,
                               "conn.error_ratio": 0.0}),
              ("burning", 90, {"conn.rtt_p95_s": 0.014,
                               "conn.error_ratio": 0.02}),
              ("recovered", 120, {"conn.rtt_p95_s": 0.0012,
                                  "conn.error_ratio": 0.0})]
    t = 0.0
    print("  phase      t(s)  latency.burn_fast  latency.burn_slow  alarms")
    for label, ticks, view in phases:
        for _ in range(ticks):
            t += 1.0
            sigs = engine.observe(view, now=t)
        print(f"  {label:<9} {t:>5.0f}  "
              f"{sigs['slo.latency.burn_fast']:>17.2f}  "
              f"{sigs['slo.latency.burn_slow']:>17.2f}  "
              f"{sigs['slo.alarms']:>6}")
    print()
    print("  events:")
    for ev in engine.events:
        print(f"    t={ev['t']:>5.0f}  {ev['slo']:<8} {ev['kind']:<9} "
              f"burn_fast={ev['burn_fast']:.2f}")
    print()
    print(f"  {'slo':<8} {'objective':>9} {'spent':>7} {'remaining':>9} "
          f"{'breaches':>8} {'recoveries':>10}")
    for row in engine.report(now=t):
        print(f"  {row['slo']:<8} {row['objective']:>9.3f} "
              f"{row['budget_spent']:>7.3f} {row['budget_remaining']:>9.3f} "
              f"{row['breaches']:>8} {row['recoveries']:>10}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Render a traced reconfiguration run "
                    "(Chrome trace + metrics + ASCII switch timeline).")
    ap.add_argument("--trace", type=Path, default=None,
                    help="write Chrome trace_event JSON here")
    ap.add_argument("--metrics", type=Path, default=None,
                    help="write the Prometheus metrics snapshot here")
    ap.add_argument("--check", action="store_true",
                    help="assert the stitched-trace + parseability invariants")
    ap.add_argument("--render", type=Path, default=None,
                    help="render an existing flight-recorder dump instead of "
                         "running the scenario")
    ap.add_argument("--width", type=int, default=48,
                    help="timeline bar width (default 48)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--fleet", action="store_true",
                    help="federated-dashboard demo: publish two synthetic "
                         "members over the KV obs plane and print the merged "
                         "view (skips the scenario; --metrics writes the "
                         "federated Prometheus snapshot)")
    ap.add_argument("--slo", action="store_true",
                    help="error-budget demo: drive an SLOEngine through a "
                         "scripted healthy->burning->recovered day on a fake "
                         "clock and print the burn/budget report (skips the "
                         "scenario)")
    args = ap.parse_args(argv)

    if args.fleet:
        return fleet_demo(out=args.metrics)
    if args.slo:
        return slo_demo()

    if args.render is not None:
        records = _load_records(args.render)
        registry = None
    else:
        from repro_torch.obs.scenario import run_kv_switch_scenario

        res = run_kv_switch_scenario(seed=args.seed)
        records = res["records"]
        registry = res["registry"]
        if not res["committed"]:
            print("WARNING: the scenario's multilateral switch did not commit",
                  file=sys.stderr)
        print(f"kv-switch scenario: committed={res['committed']} "
              f"active={res['client_fp']}")

    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        doc = write_chrome(records, args.trace)
        print(f"wrote {args.trace} ({len(doc['traceEvents'])} events)")
    if args.metrics is not None:
        if registry is None:
            print("--metrics needs the scenario run (not --render)",
                  file=sys.stderr)
            return 2
        args.metrics.parent.mkdir(parents=True, exist_ok=True)
        registry.write_prometheus(args.metrics)
        print(f"wrote {args.metrics}")

    print()
    print(render_timeline(records, width=args.width))
    print()
    for phase, p in phase_durations(records).items():
        print(f"  {phase:<9} extent={p['extent_s'] * 1e3:8.2f}ms "
              f"busy={p['busy_s'] * 1e3:8.2f}ms spans={p['count']}")

    if args.check:
        summary = check_records(records)
        if args.trace is not None:
            doc = json.loads(args.trace.read_text())
            assert doc.get("traceEvents"), "Chrome trace has no events"
        if args.metrics is not None:
            samples = parse_prometheus(args.metrics.read_text())
            assert samples, "metrics snapshot parsed to zero samples"
            print(f"check: metrics OK ({len(samples)} samples)")
        print(f"check: stitched trace OK (trace_id={summary['trace_id']}, "
              f"{summary['spans']} spans, {summary['swaps']} swaps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
