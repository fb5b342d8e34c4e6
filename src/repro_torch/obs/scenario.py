"""The canonical traced reconfiguration run: a KV-style load-adaptive switch.

Two host agents negotiate a multilateral stack (``Fast``: latency-optimal,
``Compact``: byte-optimal), a load rule watches the client's telemetry, and
a traffic burst drives the controller through detect → score → negotiate →
2PC prepare/commit → swap on BOTH endpoints — all under one enabled tracer,
so the collected records form a single stitched trace across the wire.

This is what ``python -m repro_torch.obs`` renders and what ``scripts/verify.sh``
asserts on; tests reuse it as the end-to-end observability fixture. Kept out
of ``repro_torch.obs.__init__`` so the obs package root stays stdlib-only.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.chunnel import FnChunnel, WireType
from repro_torch.core.controller import Rule, above, conn_controller, stack_candidates
from repro_torch.core.cost import BYTES_FIRST, LATENCY_FIRST, CostModel, ScoredTarget
from repro_torch.core.fabric import Fabric, LinkModel
from repro_torch.core.reconfigure import LockedConn
from repro_torch.core.runtime import HostAgent
from repro_torch.core.stack import Select, make_stack
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TRACER

OBJ = WireType.of("obj")
UNIT = WireType.of("unit")

#: ops/s threshold above which the byte-optimal stack wins the tick
LOAD_THRESHOLD = 500.0


def _kv_stack():
    """Select of two multilateral wire formats sharing one capability, so
    negotiation keeps both as live reconfiguration candidates."""
    from repro_torch.core.capability import CapabilitySet

    caps = CapabilitySet.exact("kv-wire")
    fast = FnChunnel(fn_name="Fast", upper=OBJ, lower=UNIT, caps=caps,
                     multilateral_=True,
                     cost=CostModel(op_latency_s=1e-5, dcn_bytes_per_byte=1.0,
                                    switch_blip_s=1e-4))
    compact = FnChunnel(fn_name="Compact", upper=OBJ, lower=UNIT, caps=caps,
                        multilateral_=True,
                        cost=CostModel(op_latency_s=3e-4,
                                       dcn_bytes_per_byte=0.25,
                                       switch_blip_s=1e-4))
    return make_stack(Select(fast, compact))


def run_kv_switch_scenario(*, seed: int = 7,
                           capacity: int = 8192) -> dict:
    """Run the traced KV switch end-to-end; return records + metrics.

    Enables the tracer for the duration (restoring the disabled state on
    exit), so callers get a self-contained record list no matter the
    ambient tracer state.

    Returns a dict with:
      records    normalized ``Tracer.collect()`` output for the whole run
      registry   a ``MetricsRegistry`` watching every counter family touched
      committed  whether the multilateral switch committed
      client_fp / server_fp  active fingerprints after the run (must match)
      decisions  the controller's decision log as JSON dicts
    """
    fabric = Fabric(default_link=LinkModel(), seed=seed)
    agent_a = HostAgent(fabric, "obs-a")
    agent_b = HostAgent(fabric, "obs-b")
    stack = _kv_stack()
    # give the server an objective so the offer is SCORED — the
    # negotiate.offer span then carries per-candidate utilities
    negotiator = agent_b.listen(stack)
    negotiator.objective = LATENCY_FIRST

    was_enabled = TRACER.enabled
    TRACER.enable(capacity=capacity)
    registry = MetricsRegistry()
    try:
        with TRACER.span("scenario.kv_switch", attrs={"seed": seed}):
            conn = agent_a.connect("obs-b", stack)
            handle_b = LockedConn(agent_b.accept_stack("obs-a"))
            agent_b.register_participant("kv0", handle_b, stack.find)

            ctl = conn_controller(
                conn, stack,
                [Rule("kv_load", above("ops_per_s", LOAD_THRESHOLD),
                      ScoredTarget(stack_candidates(stack), BYTES_FIRST),
                      hold=2)],
                agent=agent_a, peers=["obs-b"], conn_id="kv0",
                cooldown_s=0.0)

            # light phase: trickle below the threshold — the rule must not arm
            for _ in range(5):
                conn.send([b"k=v"])
                time.sleep(0.01)
            ctl.tick(conn.telemetry.snapshot())

            # heavy phase: burst well above the threshold with bulk values —
            # the byte term must dominate the score for Compact to win the
            # objective; hold=2 means the second armed tick fires the 2PC
            committed = False
            bulk = b"v" * 65536
            for _ in range(4):
                for _ in range(200):
                    conn.send([bulk] * 4)
                d = ctl.tick(conn.telemetry.snapshot())
                if d.committed:
                    committed = True
                    break

            with TRACER.span("scenario.drain", attrs={"msgs": 32}):
                for _ in range(32):
                    conn.send([b"k=v"])

        records = TRACER.collect()
        registry.watch("fabric", fabric.counters)
        registry.watch("conn", conn.telemetry, instance="obs-a")
        registry.watch("conn", handle_b.telemetry, instance="obs-b")
        registry.watch("controller", ctl)
        for peer, chan in agent_a._chans.items():
            registry.watch_fields("reliable_channel", chan,
                                  ("retransmits", "timeout", "retries"),
                                  instance=peer)
        return {
            "records": records,
            "registry": registry,
            "committed": committed,
            "client_fp": conn.stack.fingerprint(),
            "server_fp": handle_b.stack.fingerprint(),
            "decisions": [d.to_json() for d in ctl.decisions],
        }
    finally:
        if not was_enabled:
            TRACER.disable()
        agent_a.close()
        agent_b.close()
