"""Point-to-point negotiation (Bertha §5.1–§5.2) + zero-RTT resumption (§6.1).

Client sends its Chunnel-stack options over the base connection; the server
filters to capability-compatible concrete stacks (§5.2 comparison) and — when
it has scoring evidence (an Objective or live telemetry; ``ServerNegotiator``
gates on this, bare servers keep preference order) — scores them with the
multi-objective cost model (``repro_torch.core.cost``) and picks the argmax,
falling back to its own preference order on ties; both sides then instantiate
via recursive connect_wrap.
A returned nonce encodes the chosen select branches (used e.g. by the §7.3
load-balancer to inform backends).

Zero-RTT: the client caches the negotiated fingerprint per (peer, offer) and
optimistically instantiates it while the server confirms or proposes a
replacement (QUIC-0RTT-style, §6.1).

Invariants (relied on by the §7.3 load balancer and the reconfiguration
controller):
  * The client's offer carries the real ``ConcreteStack.fingerprint()`` of
    each option, and the server stores the chosen one verbatim — so a 0-RTT
    resumption of the same stack yields the SAME nonce as the original 1-RTT
    negotiation (the nonce is a pure function of the two fingerprints).
  * The 0-RTT branch validates the client's claimed fingerprint against the
    server's cached value; a stale or unknown claim falls back to 1-RTT
    instead of silently minting a nonce for a stack that was never agreed.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.capability import CapabilitySet
from repro_torch.core.cost import DEFAULT_OBJECTIVE, Objective, score_stack
from repro_torch.core.fabric import ReliableChannel
from repro_torch.core.stack import ConcreteStack, Stack, offered_capabilities
from repro_torch.obs.trace import NOOP_SPAN, TRACER


class NegotiationError(RuntimeError):
    pass


def _nonce(server_fp: str, client_fp: str) -> str:
    return hashlib.sha256(f"{server_fp}||{client_fp}".encode()).hexdigest()[:16]


def compatible_pairs(server_stack: Stack, client_offer: list) -> list:
    """All (server_option, client_option_index) pairs that pass the §5.2
    capability comparison, in server preference order; each server option is
    paired with the first (most-preferred) compatible client option."""
    client_caps = offered_capabilities(client_offer)
    out = []
    for s_opt in server_stack.options():
        s_caps = s_opt.capabilities()
        for idx, c_caps in enumerate(client_caps):
            if s_caps.compatible_with(c_caps):
                out.append((s_opt, idx))
                break
    return out


def pick_compatible(
    server_stack: Stack,
    client_offer: list,
    *,
    snapshot: Optional[dict] = None,
    objective: Optional[Objective] = None,
    mode: str = "scored",
    scores: Optional[dict] = None,
) -> Optional[Tuple[ConcreteStack, int]]:
    """Server side of §5.2, multi-objective: among ALL capability-compatible
    (server option, client option) pairs, pick the server option whose folded
    cost model (repro_torch.core.cost) maximizes ``utility`` under ``objective`` and
    the live telemetry ``snapshot``.

    Ties (including the common all-neutral-cost-model case) break toward
    server preference order, with client preference as the per-option
    tiebreak — so unannotated stacks negotiate exactly as the historical
    first-compatible rule did. ``mode="first"`` forces that rule; the
    negotiator uses it when it has no objective or telemetry to score by.

    Returns (server_choice, client_option_index) or None when no pair is
    compatible. ``scores`` (when given a dict) is filled with the
    per-candidate utilities ``{server_fp: u}`` — the negotiation span
    records them so a trace explains *which* stacks lost and by how much.
    """
    pairs = compatible_pairs(server_stack, client_offer)
    if not pairs:
        return None
    if mode == "first":
        return pairs[0]
    obj = objective or DEFAULT_OBJECTIVE
    best, best_u = None, float("-inf")
    for s_opt, idx in pairs:  # strict > keeps preference order on ties
        u = score_stack(s_opt, obj, snapshot)
        if scores is not None:
            scores[s_opt.fingerprint()] = u
        if u > best_u:
            best, best_u = (s_opt, idx), u
    return best


@dataclass
class NegotiatedConn:
    stack: ConcreteStack
    nonce: str
    zero_rtt: bool = False


class ZeroRttCache:
    """client-side: (peer, offer-digest) -> fingerprint of the agreed stack."""

    def __init__(self):
        self._cache: Dict[Tuple[str, str], str] = {}

    @staticmethod
    def _key(peer: str, stack: Stack) -> Tuple[str, str]:
        digest = hashlib.sha256(
            "||".join(s.fingerprint() for s in stack.options()).encode()
        ).hexdigest()[:16]
        return (peer, digest)

    def get(self, peer: str, stack: Stack) -> Optional[str]:
        return self._cache.get(self._key(peer, stack))

    def put(self, peer: str, stack: Stack, fp: str) -> None:
        self._cache[self._key(peer, stack)] = fp

    def invalidate(self, peer: str, stack: Stack) -> None:
        self._cache.pop(self._key(peer, stack), None)


def client_negotiate(
    chan: ReliableChannel,
    stack: Stack,
    cache: Optional[ZeroRttCache] = None,
) -> NegotiatedConn:
    peer = chan.peer
    with (TRACER.span("negotiate.client", attrs={"peer": peer})
          if TRACER.enabled else NOOP_SPAN) as sp:
        if cache is not None:
            fp = cache.get(peer, stack)
            if fp is not None and stack.find(fp) is not None:
                reply = chan.request({"type": "zero_rtt", "fp": fp})
                if reply.get("type") == "zero_rtt_ok":
                    sp.set(zero_rtt=True, fp=fp)
                    return NegotiatedConn(stack.find(fp), reply["nonce"],
                                          zero_rtt=True)
                if reply.get("type") == "negotiate_failed":
                    cache.invalidate(peer, stack)  # tear down; fall through to 1-RTT
                # else: fall through

        offer = stack.offer()
        reply = chan.request({
            "type": "offer",
            "options": offer,
            # real fingerprints, index-aligned with options: the server caches the
            # chosen one so 0-RTT resumption reproduces the 1-RTT nonce exactly
            "fps": [opt.fingerprint() for opt in stack.options()],
        })
        if reply.get("type") == "reject":
            sp.set(status="rejected", reason=reply.get("reason"))
            raise NegotiationError(f"server rejected: {reply.get('reason')}")
        if reply.get("type") != "accept":
            sp.set(status="error")
            raise NegotiationError(f"unexpected reply: {reply}")
        chosen = stack.options()[reply["client_idx"]]
        if cache is not None:
            cache.put(peer, stack, chosen.fingerprint())
        sp.set(zero_rtt=False, fp=chosen.fingerprint(), nonce=reply["nonce"])
        return NegotiatedConn(chosen, reply["nonce"])


class ServerNegotiator:
    """Server-side handler; plug into a HostAgent's message loop.

    ``objective`` sets the scoring weights ``pick_compatible`` uses over the
    compatible option set; ``telemetry`` (a ConnTelemetry) feeds the live
    workload rates into the score (read non-destructively — the negotiator
    must not consume another consumer's snapshot window).

    Scoring is EVIDENCE-GATED: with neither an objective nor telemetry
    configured, offers resolve by preference order (``mode="first"``). A bare
    server must not let static sub-millisecond annotations override the
    operator's declared Select order — e.g. ``routing_stack(prefer="server")``
    deliberately defaults to the slower-but-reprovisionable ServerRouter at
    idle, and only the load-adaptive policy (live telemetry) should move off
    it."""

    def __init__(self, stack: Stack, *, objective: Optional[Objective] = None,
                 telemetry: Optional[object] = None):
        self.stack = stack
        self.objective = objective
        self.telemetry = telemetry
        self._last: Dict[str, str] = {}  # peer -> negotiated client fp (for 0-RTT)
        self.negotiated: Dict[str, ConcreteStack] = {}  # peer -> server stack

    def _snapshot(self) -> Optional[dict]:
        if self.telemetry is None:
            return None
        return self.telemetry.snapshot(reset_window=False)

    def handle(self, src: str, msg: dict) -> dict:
        t = msg.get("type")
        if t == "offer":
            sp = (TRACER.span("negotiate.offer", attrs={"peer": src})
                  if TRACER.enabled else NOOP_SPAN)
            with sp:
                return self._handle_offer(src, msg, sp)
        if t == "zero_rtt":
            return self._handle_zero_rtt(src, msg)
        return {"type": "reject", "reason": f"unknown message {t}"}

    def _handle_offer(self, src: str, msg: dict, sp) -> dict:
        snap = self._snapshot()
        mode = ("scored" if (self.objective is not None or snap is not None)
                else "first")
        scores: Optional[dict] = {} if TRACER.enabled else None
        picked = pick_compatible(self.stack, msg["options"],
                                 snapshot=snap, objective=self.objective,
                                 mode=mode, scores=scores)
        if picked is None:
            sp.set(mode=mode, status="rejected",
                   reason="no compatible stack")
            return {"type": "reject", "reason": "no compatible stack"}
        s_opt, c_idx = picked
        # Cache the client's REAL fingerprint (sent index-aligned with the
        # offer) for 0-RTT resumption: the client caches
        # chosen.fingerprint() on its side, so both ends must derive the
        # nonce from the same string or resumption mints a different nonce
        # than the original negotiation. repr(desc) is only a last-resort
        # fallback for pre-fps clients (their 0-RTT will renegotiate).
        fps = msg.get("fps") or []
        client_fp = fps[c_idx] if c_idx < len(fps) else repr(msg["options"][c_idx])
        self._last[src] = client_fp
        self.negotiated[src] = s_opt
        # per-candidate utilities are THE evidence for why this stack
        # won — they ride the span so traces explain the choice
        sp.set(mode=mode, chosen=s_opt.fingerprint(), client_idx=c_idx,
               candidates=scores)
        return {
            "type": "accept",
            "client_idx": c_idx,
            "server_fp": s_opt.fingerprint(),
            "nonce": _nonce(s_opt.fingerprint(), client_fp),
        }

    def _handle_zero_rtt(self, src: str, msg: dict) -> dict:
        with (TRACER.span("negotiate.zero_rtt", attrs={"peer": src})
              if TRACER.enabled else NOOP_SPAN) as sp:
            cached = self._last.get(src)
            server_choice = self.negotiated.get(src)
            # Validate the client's claim against OUR cache of what was agreed
            # — resuming a stack we never negotiated must fall back to 1-RTT.
            if cached is None or server_choice is None or msg.get("fp") != cached:
                sp.set(status="fallback", reason="unknown or stale claim")
                return {"type": "negotiate_failed", "proposal": self.stack.offer()[:1]}
            # Re-validate that the previously negotiated server stack is still
            # on offer (our own Select preferences may have changed since).
            if self.stack.find(server_choice.fingerprint()) is not None:
                sp.set(fp=server_choice.fingerprint())
                return {
                    "type": "zero_rtt_ok",
                    "nonce": _nonce(server_choice.fingerprint(), cached),
                }
            sp.set(status="fallback", reason="stack no longer offered")
            return {"type": "negotiate_failed", "proposal": self.stack.offer()[:1]}
