"""Bertha core: reconfigurable, extensible communication stacks.

Glossary (paper Table 1):
  Chunnel          a specific piece of network functionality
  Chunnel stack    an application's specification of the chunnels it wants
  Reconfiguration  picking/changing chunnel implementations at runtime
  Negotiation      ensuring implementations are compatible across endpoints
"""
from repro_torch.core.capability import Capability, CapabilitySet
from repro_torch.core.chunnel import ANY, Chunnel, Datapath, FnChunnel, WireType
from repro_torch.core.controller import (
    Decision,
    PolicyContext,
    ReconfigController,
    Rule,
    above,
    all_of,
    any_of,
    available_policies,
    below,
    conn_controller,
    get_policy,
    option_named,
    policy_rules,
    register_policy,
    stack_candidates,
    target_label,
)
from repro_torch.core.cost import (
    BYTES_FIRST,
    DEFAULT_OBJECTIVE,
    LATENCY_FIRST,
    Candidate,
    CostModel,
    Objective,
    ScoredTarget,
    score_stack,
    stack_cost,
    utility,
)
from repro_torch.core.fabric import Fabric, LinkModel, ReliableChannel
from repro_torch.core.negotiate import (
    NegotiatedConn,
    NegotiationError,
    ServerNegotiator,
    ZeroRttCache,
    client_negotiate,
    pick_compatible,
)
from repro_torch.core.reconfigure import BarrierConn, ConnHandle, LockedConn
from repro_torch.core.rendezvous import KVStore, TxnConflict
from repro_torch.core.runtime import FabricTransport, HostAgent
from repro_torch.core.stack import ConcreteStack, Select, Stack, StackTypeError, make_stack
from repro_torch.core.telemetry import ConnTelemetry, Ewma, EwmaQuantile

__all__ = [
    "ANY", "BYTES_FIRST", "Capability", "CapabilitySet", "Candidate", "Chunnel",
    "ConcreteStack", "ConnHandle", "ConnTelemetry", "CostModel",
    "DEFAULT_OBJECTIVE", "Datapath", "Decision", "Ewma", "EwmaQuantile",
    "Fabric", "FabricTransport", "FnChunnel", "HostAgent", "KVStore",
    "LATENCY_FIRST", "LinkModel", "LockedConn", "BarrierConn", "NegotiatedConn",
    "NegotiationError", "Objective", "PolicyContext", "ReconfigController",
    "ReliableChannel", "Rule", "ScoredTarget", "Select", "ServerNegotiator",
    "Stack", "StackTypeError", "TxnConflict", "WireType", "ZeroRttCache",
    "above", "all_of",
    "any_of", "available_policies", "below", "client_negotiate",
    "conn_controller", "get_policy", "make_stack", "option_named",
    "pick_compatible", "policy_rules", "register_policy", "score_stack",
    "stack_candidates", "stack_cost", "target_label", "utility",
]
