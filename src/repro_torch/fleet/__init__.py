"""Fleet signal plane: publish → aggregate → act fleet-wide.

The missing layer between per-connection telemetry (``repro_torch.core.telemetry``)
and policy scoring (``repro_torch.core.cost``): every member publishes
heartbeat-stamped telemetry snapshots into the rendezvous KV store
(``FleetPublisher``), a ``FleetAggregator`` folds the fresh records plus
pluggable external ``SignalSource``s (carbon intensity, spot price, measured
link bandwidth) into ONE namespaced snapshot dict, and a ``fleet_controller``
runs the reconfiguration decision once over that aggregate — committing the
switch through the rendezvous epoch protocol so the whole fleet lands on the
same stack in the same epoch instead of N clients flapping independently.

See docs/architecture.md §6 for the lifecycle and the SignalSource guide.
"""
from repro_torch.fleet.aggregate import FleetAggregator
from repro_torch.fleet.controller import FleetMember, fleet_controller
from repro_torch.fleet.publish import (
    FleetPublisher,
    fleet_conn_id,
    member_key,
    roster_key,
)
from repro_torch.fleet.signals import (
    CallbackSignal,
    CarbonIntensitySignal,
    LinkBandwidthSignal,
    SignalError,
    SignalSource,
    SpotPriceSignal,
    StaticSignal,
    measure_link_bandwidth,
)

__all__ = [
    "CallbackSignal", "CarbonIntensitySignal", "FleetAggregator",
    "FleetMember", "FleetPublisher", "LinkBandwidthSignal", "SignalError",
    "SignalSource", "SpotPriceSignal", "StaticSignal", "fleet_conn_id",
    "fleet_controller", "measure_link_bandwidth", "member_key", "roster_key",
]
