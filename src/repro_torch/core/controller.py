"""Policy engine closing Bertha's reconfiguration loop.

The paper's pitch is that the stack changes at runtime in response to "where
applications run, the requests they serve, and the performance they need" —
the mechanisms (negotiate, 2PC, LockedConn/BarrierConn swap) live in their
own modules; this is the *policy* that drives them (cf. Morpheus-style
profile-guided re-specialization, PAPERS.md).

A ``ReconfigController`` maps a telemetry snapshot (``repro_torch.core.telemetry``)
to a target configuration — typically a ``ConcreteStack`` drawn from the
negotiated ``Stack``'s options — and drives the switch mechanism:
``ConnHandle.reconfigure`` for unilateral swaps,
``HostAgent.reconfigure_multilateral`` (2PC) for multilateral ones, or a
trainer's rendezvous transition. Two dampers prevent flapping:

  hysteresis  a rule's predicate must hold for ``hold`` consecutive ticks
              before the rule may fire
  cooldown    after a committed switch no rule may fire for ``cooldown_s``

Every tick appends a ``Decision`` (fired or not, with the snapshot that
motivated it) to ``controller.decisions`` — the audit log the benchmarks emit
as JSON.

Rule targets come in two kinds: a *concrete* target (a ConcreteStack, or a
plain label like a trainer transport name) fires as written, while a
``ScoredTarget`` (repro_torch.core.cost) names an OBJECTIVE — it is resolved each
tick to the argmax-utility candidate of the negotiated option set under the
live snapshot, so rules express "cheapest", "lowest latency", "fewest DCN
bytes" instead of hard-coding one stack per rule.

The *policy plugin registry* lets applications ship whole rule-sets without
editing core:

    @register_policy("carbon_aware")
    def carbon_aware(ctx: PolicyContext) -> list[Rule]:
        return [Rule("carbon", above("gco2_per_kwh", ctx.params["cap"]),
                     ScoredTarget(ctx.candidates, BYTES_FIRST))]

    ctl = conn_controller(handle, stack, policy="carbon_aware",
                          policy_params={"cap": 400.0})

Built-ins: ``latency_slo`` (SLO breach ⇒ lowest-latency option),
``byte_budget`` (byte-rate cap ⇒ fewest-wire-bytes option), ``cost_aware``
(track the utility argmax continuously), ``slo_guard`` (error-budget
burn-rate signals from ``repro.obs.slo`` ⇒ a safe stack before raw
thresholds trip). The trainer registers
``trainer_default`` and the KV serving plane ``kv_load_adaptive`` the same
way — through the public decorator, not by editing this module.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

from repro_torch.core.cost import (
    BYTES_FIRST,
    DEFAULT_OBJECTIVE,
    LATENCY_FIRST,
    Candidate,
    ScoredTarget,
    resolve_target,
    stack_cost,
    target_label,
)
from repro_torch.obs.trace import NOOP_SPAN, TRACER


class _SnoopDict(dict):
    """Snapshot view recording which keys a rule predicate actually read.

    Only used while tracing is enabled: the controller span's
    ``predicates`` attribute carries exactly the metric values the armed
    rule's predicate consulted — the *why it fired* evidence — without
    dumping the whole snapshot into every span."""

    def __init__(self, base: dict):
        super().__init__(base)
        self.read = set()

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def above(metric: str, threshold: float) -> Callable[[dict], bool]:
    """Predicate: snapshot[metric] is known and exceeds threshold."""
    return lambda s: s.get(metric) is not None and s[metric] > threshold


def below(metric: str, threshold: float) -> Callable[[dict], bool]:
    return lambda s: s.get(metric) is not None and s[metric] < threshold


def all_of(*preds: Callable[[dict], bool]) -> Callable[[dict], bool]:
    return lambda s: all(p(s) for p in preds)


def any_of(*preds: Callable[[dict], bool]) -> Callable[[dict], bool]:
    return lambda s: any(p(s) for p in preds)


@dataclass
class Rule:
    """One policy clause: when ``when(snapshot)`` has held for ``hold``
    consecutive ticks, propose switching to ``target``. Higher ``priority``
    wins when several rules are armed the same tick."""

    name: str
    when: Callable[[dict], bool]
    target: Any
    hold: int = 2
    priority: int = 0


@dataclass
class Decision:
    """One controller tick's outcome (appended to ``controller.decisions``)."""

    tick: int
    at: float
    rule: Optional[str]          # armed rule that was considered, if any
    target: Optional[str]        # its target's label
    fired: bool                  # switch() was invoked
    committed: bool              # switch() reported success
    reason: str                  # "switched" | "cooldown" | "refused" | "idle"
    snapshot: dict = field(repr=False, default_factory=dict)

    def to_json(self) -> dict:
        return {
            "tick": self.tick, "at": self.at, "rule": self.rule,
            "target": self.target, "fired": self.fired,
            "committed": self.committed, "reason": self.reason,
            "snapshot": self.snapshot,
        }


class ReconfigController:
    """Telemetry in, (damped) reconfigurations out.

    Args:
        rules: the policy, a sequence of ``Rule`` (names must be unique —
            build them by hand or through the policy registry via
            ``get_policy``/``conn_controller(policy=...)``).
        switch: ``switch(target) -> bool`` performs the transition and
            reports whether it committed. Dynamic (``ScoredTarget``) rule
            targets are resolved before this is called, so ``switch`` always
            receives a concrete target.
        current: ``current() -> str`` names the active configuration
            (compared against ``target_label`` so the controller never
            re-selects what is already running — which is also how a
            "recovered → default" rule stays quiet while the default is
            active).
        cooldown_s: minimum wall-clock gap after a committed switch before
            any rule may fire again.
        now: clock override for deterministic tests.
        max_history: bound on the retained ``decisions`` audit log. Lifetime
            totals survive eviction — read ``counts()`` for them; only the
            per-decision snapshots are windowed.

    Call ``tick(snapshot)`` once per control interval with a telemetry
    snapshot (``ConnTelemetry.snapshot()``); read ``decisions`` /
    ``switch_log()`` for the audit trail and ``counts()`` for lifetime
    totals.
    """

    def __init__(
        self,
        rules: Sequence[Rule],
        switch: Callable[[Any], bool],
        current: Callable[[], str],
        *,
        cooldown_s: float = 5.0,
        now: Callable[[], float] = time.monotonic,
        max_history: int = 4096,
    ):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            # duplicate names would silently share one hysteresis streak
            raise ValueError(f"duplicate rule names: {names}")
        self.rules: List[Rule] = sorted(rules, key=lambda r: -r.priority)
        self.switch = switch
        self.current = current
        self.cooldown_s = cooldown_s
        self._now = now
        self._streak: Dict[str, int] = {r.name: 0 for r in self.rules}
        self._last_switch_t: Optional[float] = None
        self._ticks = 0
        # bounded: a long-lived loop ticking every step must not grow memory
        # linearly in run length (each Decision retains a snapshot dict)
        self.decisions: Deque[Decision] = deque(maxlen=max_history)
        # lifetime totals: decisions fall off the deque, these never reset
        self.total_fired = 0
        self.total_committed = 0
        self.fired_by_rule: Dict[str, int] = {r.name: 0 for r in self.rules}

    def streak(self, rule_name: str) -> int:
        return self._streak[rule_name]

    def in_cooldown(self) -> bool:
        return (self._last_switch_t is not None
                and self._now() - self._last_switch_t < self.cooldown_s)

    def tick(self, snapshot: dict) -> Decision:
        """Evaluate every rule against ``snapshot``; fire at most one switch.

        The highest-priority armed rule CLAIMS the tick even when its target
        is already active: a satisfied high-priority rule must suppress
        lower-priority ones, or two persistently-armed rules with different
        targets would take turns re-arming each other (e.g. straggler ⇒
        localsgd and byte-budget ⇒ compressed flipping every ``hold`` ticks,
        each flip paying a renegotiation + re-jit).

        Dynamic targets (``ScoredTarget``) are resolved HERE, against this
        tick's snapshot and the active configuration — the Decision records
        the resolved target's label, and ``switch`` receives the resolved
        target."""
        self._ticks += 1
        now = self._now()
        cur = self.current()
        tracing = TRACER.enabled
        snap_view = _SnoopDict(snapshot) if tracing else snapshot
        armed: Optional[Rule] = None
        for r in self.rules:  # priority order; streaks advance for ALL rules
            if r.when(snap_view):
                self._streak[r.name] += 1
            else:
                self._streak[r.name] = 0
            if armed is None and self._streak[r.name] >= r.hold:
                armed = r
        # One span per ARMED tick (idle ticks are the steady state and would
        # drown the ring); it wraps resolve + switch so the 2PC/swap spans
        # nest under the controller decision that caused them.
        sp = NOOP_SPAN
        if tracing and armed is not None:
            sp = TRACER.span("controller.tick", attrs={
                "tick": self._ticks,
                "rule": armed.name,
                "streak": self._streak[armed.name],
                "current": cur,
                # why it fired: the metric values the predicates consulted
                "predicates": {k: snapshot.get(k)
                               for k in sorted(snap_view.read, key=str)},
            })
        with sp:
            target = label = None
            if armed is not None:
                target = resolve_target(armed.target, snapshot, cur)
                label = target_label(target)
                sp.set(target=label)
            if armed is None or label == cur:
                d = Decision(self._ticks, now,
                             armed.name if armed else None, label,
                             False, False, "idle", snapshot)
            elif self.in_cooldown():
                sp.set(reason="cooldown")
                d = Decision(self._ticks, now, armed.name, label,
                             False, False, "cooldown", snapshot)
            else:
                committed = bool(self.switch(target))
                if committed:
                    self._last_switch_t = now
                    for k in self._streak:  # re-arm from scratch after a transition
                        self._streak[k] = 0
                self.total_fired += 1
                self.total_committed += int(committed)
                self.fired_by_rule[armed.name] += 1
                d = Decision(self._ticks, now, armed.name, label,
                             True, committed, "switched" if committed else "refused",
                             snapshot)
            sp.set(reason=d.reason)
        self.decisions.append(d)
        return d

    def switch_log(self) -> List[Decision]:
        """Committed switches still in the retained ``decisions`` window —
        ``counts()["committed"]`` is the lifetime total."""
        return [d for d in self.decisions if d.fired and d.committed]

    def counts(self) -> dict:
        """Lifetime decision totals — preserved across ``max_history``
        eviction of the per-decision audit log."""
        return {"ticks": self._ticks, "fired": self.total_fired,
                "committed": self.total_committed,
                "by_rule": dict(self.fired_by_rule)}


# ---------------------------------------------------------------------------
# Policy plugin registry
# ---------------------------------------------------------------------------


@dataclass
class PolicyContext:
    """What a registered policy factory gets to work with.

    candidates  the negotiated option set as scoreable ``Candidate``s (target
                + cost model + label) — ScoredTargets draw from these
    default     the configuration to fall back to when a recovery clause
                applies (None disables recovery rules in the built-ins)
    params      free-form knobs forwarded from the caller
                (``conn_controller(policy_params=...)`` or
                ``make_controller(policy_params=...)``)
    """

    candidates: List[Candidate] = field(default_factory=list)
    default: Any = None
    params: Dict[str, Any] = field(default_factory=dict)

    def param(self, name: str, default: Any = None) -> Any:
        return self.params.get(name, default)

    def candidate_named(self, *names: str) -> Candidate:
        """First candidate whose label matches, or whose target (a
        ConcreteStack) contains a chunnel with any of the given names."""
        for c in self.candidates:
            if c.label in names:
                return c
            chs = getattr(c.target, "chunnels", None)
            if chs is not None and any(ch.name in names for ch in chs):
                return c
        raise KeyError(f"no candidate named {names}; have "
                       f"{[c.label for c in self.candidates]}")


#: name -> factory(PolicyContext) -> Sequence[Rule]
_POLICIES: Dict[str, Callable[[PolicyContext], Sequence[Rule]]] = {}


def register_policy(name: str, *, override: bool = False) -> Callable:
    """Class/function decorator registering a policy factory under ``name``.

    A policy factory takes a ``PolicyContext`` and returns the ``Rule`` list
    a controller should run — this is how applications ship cost-aware /
    SLO-aware / carbon-aware policies without editing core (ROADMAP).
    Re-registering an existing name raises unless ``override=True``.
    """
    def deco(fn: Callable[[PolicyContext], Sequence[Rule]]):
        if name in _POLICIES and not override:
            raise ValueError(
                f"policy {name!r} already registered "
                f"(pass override=True to replace it)")
        _POLICIES[name] = fn
        fn.policy_name = name
        return fn

    return deco


def get_policy(name: str) -> Callable[[PolicyContext], Sequence[Rule]]:
    try:
        return _POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{available_policies()}") from None


def available_policies() -> List[str]:
    return sorted(_POLICIES)


def policy_rules(name: str, ctx: PolicyContext) -> List[Rule]:
    """Instantiate a registered policy's rules against a context."""
    return list(get_policy(name)(ctx))


# -- built-in policies: rules name objectives, not targets -------------------


@register_policy("cost_aware")
def cost_aware_policy(ctx: PolicyContext) -> List[Rule]:
    """Track the utility argmax of the whole candidate set continuously.

    params: objective (default balanced), margin (score-space hysteresis,
    default 0.1), hold, priority. The rule is always armed; damping comes
    from hold + margin + the blip term charged to non-current candidates.
    """
    tgt = ScoredTarget(ctx.candidates,
                       ctx.param("objective", DEFAULT_OBJECTIVE),
                       margin=ctx.param("margin", 0.1))
    return [Rule("cost_aware", lambda s: True, tgt,
                 hold=ctx.param("hold", 2), priority=ctx.param("priority", 0))]


@register_policy("latency_slo")
def latency_slo_policy(ctx: PolicyContext) -> List[Rule]:
    """SLO breach ⇒ the lowest-latency compatible option.

    params: slo_s (required), metric (default ``rtt_p95_s``), hold,
    recover_s (default slo_s/2), recover_hold, priority. With a
    ``ctx.default`` a recovery rule drops back once the metric clears
    recover_s."""
    slo = ctx.params["slo_s"]
    metric = ctx.param("metric", "rtt_p95_s")
    hold = ctx.param("hold", 2)
    rules = [Rule("latency_slo:breach", above(metric, slo),
                  ScoredTarget(ctx.candidates, LATENCY_FIRST),
                  hold=hold, priority=ctx.param("priority", 2))]
    if ctx.default is not None:
        rules.append(Rule("latency_slo:recovered",
                          below(metric, ctx.param("recover_s", slo / 2)),
                          ctx.default,
                          hold=ctx.param("recover_hold", 2 * hold), priority=0))
    return rules


@register_policy("byte_budget")
def byte_budget_policy(ctx: PolicyContext) -> List[Rule]:
    """Byte-rate over budget ⇒ the fewest-wire-bytes option.

    params: bytes_per_s (required), metric (default ``bytes_per_s``), hold,
    recover_frac (default 0.7: recovery arms below recover_frac * budget),
    recover_hold, priority."""
    budget = ctx.params["bytes_per_s"]
    metric = ctx.param("metric", "bytes_per_s")
    hold = ctx.param("hold", 2)
    rules = [Rule("byte_budget:over", above(metric, budget),
                  ScoredTarget(ctx.candidates, BYTES_FIRST),
                  hold=hold, priority=ctx.param("priority", 1))]
    if ctx.default is not None:
        rules.append(Rule("byte_budget:recovered",
                          below(metric, ctx.param("recover_frac", 0.7) * budget),
                          ctx.default,
                          hold=ctx.param("recover_hold", 2 * hold), priority=0))
    return rules


@register_policy("slo_guard")
def slo_guard_policy(ctx: PolicyContext) -> List[Rule]:
    """Error-budget burn (``repro.obs.slo``) ⇒ a safe stack, *before* any
    raw-threshold rule would fire.

    Reads the ``slo.<name>.*`` signals an ``SLOEngine`` exports (merge them
    into the controller's snapshot, or ``add_source`` the engine on a fleet
    aggregator): the breach clause arms when BOTH burn windows exceed their
    thresholds — exactly the engine's alarm condition, but evaluated inside
    the controller so hold/priority/cooldown damping applies uniformly.
    Burn-rate arming is the point: a budget burns the moment the metric
    crosses the *objective's* threshold, which sits well below any "the
    service is on fire" hard threshold, so the guard moves first.

    params: slo (required — the SLO's name), fast_burn/slow_burn (default
    14.4/6.0, match the engine's), safe_names (chunnel/candidate names to
    flip to; default: ScoredTarget over all candidates under ``objective``,
    default LATENCY_FIRST), hold (default 1 — the engine's windows already
    smooth), priority (default 3), recover_hold. With a ``ctx.default`` a
    recovery clause drops back once the engine clears the alarm.
    """
    name = ctx.params["slo"]
    fast_burn = ctx.param("fast_burn", 14.4)
    slow_burn = ctx.param("slow_burn", 6.0)
    safe_names = ctx.param("safe_names")
    if safe_names:
        target: Any = ctx.candidate_named(*safe_names).target
    else:
        target = ScoredTarget(ctx.candidates,
                              ctx.param("objective", LATENCY_FIRST))
    rules = [Rule(f"slo_guard:{name}:burn",
                  all_of(above(f"slo.{name}.burn_fast", fast_burn),
                         above(f"slo.{name}.burn_slow", slow_burn)),
                  target, hold=ctx.param("hold", 1),
                  priority=ctx.param("priority", 3))]
    if ctx.default is not None:
        rules.append(Rule(f"slo_guard:{name}:recovered",
                          below(f"slo.{name}.alarm", 0.5), ctx.default,
                          hold=ctx.param("recover_hold", 2), priority=0))
    return rules


# ---------------------------------------------------------------------------
# Plumbing helpers for the common planes
# ---------------------------------------------------------------------------


def option_named(stack, *names: str):
    """First of the negotiated Stack's options containing a chunnel with any
    of the given names — how policies name targets without holding object
    references into the stack tree."""
    for opt in stack.options():
        if any(c.name in names for c in opt.chunnels):
            return opt
    raise KeyError(f"no stack option contains a chunnel named {names}")


def stack_candidates(stack) -> List[Candidate]:
    """The negotiated ``Stack``'s options as scoreable candidates (targets
    are ConcreteStacks, labels their fingerprints, costs the folded chunnel
    cost models)."""
    return [Candidate(opt, stack_cost(opt)) for opt in stack.options()]


def conn_controller(
    handle,
    stack,
    rules: Optional[Sequence[Rule]] = None,
    *,
    policy: Optional[str] = None,
    policy_params: Optional[dict] = None,
    default=None,
    agent=None,
    peers: Sequence[str] = (),
    conn_id: str = "",
    **kw,
) -> ReconfigController:
    """Close the loop over a live ``ConnHandle`` whose targets come from the
    negotiated ``Stack``'s options.

    Pass EITHER an explicit ``rules`` list OR a registered ``policy`` name
    (with ``policy_params`` / ``default``) — the policy factory then receives
    the stack's options as scoreable candidates, so its rules can name
    objectives instead of concrete stacks.

    Unilateral targets swap locally; when an ``agent`` (plus peers/conn_id)
    is given, multilateral targets go through
    ``HostAgent.reconfigure_multilateral``'s 2PC. A multilateral target
    without an agent is refused at construction — a silent one-sided swap
    would be exactly the endpoint divergence negotiation exists to prevent."""
    if (rules is None) == (policy is None):
        raise ValueError("pass exactly one of rules= or policy=")
    if policy is not None:
        ctx = PolicyContext(candidates=stack_candidates(stack),
                            default=default, params=dict(policy_params or {}))
        rules = policy_rules(policy, ctx)
    if agent is None:
        for r in rules:
            m = getattr(r.target, "multilateral", None)
            if callable(m) and m():
                raise ValueError(
                    f"rule {r.name!r} targets a multilateral stack; pass "
                    f"agent/peers/conn_id so the switch runs the 2PC")

    def switch(target) -> bool:
        if agent is not None and target.multilateral():
            return agent.reconfigure_multilateral(handle, target, list(peers), conn_id)
        return handle.reconfigure(target)

    return ReconfigController(
        rules, switch, lambda: handle.stack.fingerprint(), **kw)
