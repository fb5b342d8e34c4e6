"""Cost models and multi-objective scoring over negotiated option sets.

Bertha's promise is that the *runtime* picks the best communication stack for
where a program runs and what it needs (§5, §7) — but picking requires a cost
model (cf. Morpheus, PAPERS.md: online specialization pays off only when a
cost model drives the choice). This module is that model:

  CostModel   per-chunnel static annotations: estimated added latency per
              data-plane op, DCN/wire bytes emitted per payload byte, and the
              switch blip paid to instantiate it (re-jit, barrier, 2PC).
  Objective   the weights (and unit normalizers) that fold the three cost
              dimensions into one scalar. ``LATENCY_FIRST`` / ``BYTES_FIRST``
              are the built-in presets policies name instead of naming targets.
  utility     CostModel x Objective x live telemetry snapshot -> scalar,
              higher is better. Telemetry scales the static model to the
              actual workload: the latency term is paid once per op
              (``ops_per_s``), the byte term once per payload byte
              (``bytes_per_s``), and the blip is amortized over
              ``Objective.amortize_s`` — and only charged to options that are
              not already active, which is a natural switch damper.
  ScoredTarget a *dynamic* Rule target for ``repro_torch.core.controller``: resolved
              per tick to the argmax-utility candidate under the live
              snapshot, instead of hard-coding one target per rule.

Ties break toward the earlier candidate (server/developer preference order),
so stacks whose chunnels carry no cost annotations behave exactly like the
historical first-compatible selection.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import NOOP_SPAN, TRACER


def target_label(target: Any) -> str:
    """Stable identity of a switch target: a ConcreteStack's fingerprint, or
    str() for plain labels (e.g. trainer transport names)."""
    fp = getattr(target, "fingerprint", None)
    return fp() if callable(fp) else str(target)


@dataclass(frozen=True)
class CostModel:
    """Static cost annotations of one chunnel (or a whole concrete stack).

    op_latency_s        estimated latency this chunnel adds to each data-plane
                        op (a send batch, an RTT, a training step)
    dcn_bytes_per_byte  wire/DCN bytes emitted per payload byte: 1.0 is
                        neutral, a compressor is < 1, a replicator is > 1
    switch_blip_s       estimated cost of switching TO this chunnel (re-jit,
                        stop-the-world barrier, 2PC round-trips)

    The neutral default makes unannotated chunnels free — scoring then
    degrades gracefully to preference order.
    """

    op_latency_s: float = 0.0
    dcn_bytes_per_byte: float = 1.0
    switch_blip_s: float = 0.0


NEUTRAL = CostModel()

# -- measured overrides (trace-derived calibration) ---------------------------
# ``repro.obs.calibrate`` installs MEASURED per-chunnel cost fields (keyed by
# chunnel name, values are partial CostModel field dicts) and per-stack switch
# blips (keyed by ConcreteStack fingerprint, from reconfig.swap span
# durations). The hand-written annotations stay as priors; measured fields
# override them wherever a trace produced enough samples. Process-wide, like
# ``repro.comm.chunnels.cost_calibration`` (which funnels into this).
_MEASURED_CHUNNELS: Dict[str, Dict[str, float]] = {}
_MEASURED_BLIPS: Dict[str, float] = {}


def chunnel_name(ch: Any) -> str:
    """The name trace records/calibration key a chunnel by: ``fn_name``
    (FnChunnel), then ``name``, then the class name."""
    return (getattr(ch, "fn_name", None) or getattr(ch, "name", None)
            or type(ch).__name__)


def install_measured_costs(chunnels: Optional[Dict[str, Dict[str, float]]] = None,
                           stack_blips: Optional[Dict[str, float]] = None
                           ) -> None:
    """Merge measured cost fields into the process-wide override tables.

    ``chunnels`` maps chunnel name -> partial CostModel fields (e.g.
    ``{"op_latency_s": 2.1e-3, "dcn_bytes_per_byte": 0.4}``); ``stack_blips``
    maps stack fingerprint -> measured switch blip seconds.
    """
    for name, fields in (chunnels or {}).items():
        _MEASURED_CHUNNELS.setdefault(name, {}).update(fields)
    _MEASURED_BLIPS.update(stack_blips or {})


def measured_costs() -> Tuple[Dict[str, Dict[str, float]], Dict[str, float]]:
    """(chunnel overrides, stack blips) currently installed (copies)."""
    return ({k: dict(v) for k, v in _MEASURED_CHUNNELS.items()},
            dict(_MEASURED_BLIPS))


def reset_measured_costs() -> None:
    _MEASURED_CHUNNELS.clear()
    _MEASURED_BLIPS.clear()


def chunnel_cost(ch: Any) -> CostModel:
    """A chunnel's cost model: its static annotation (NEUTRAL when it
    carries none), with any MEASURED fields overriding the annotation."""
    fn = getattr(ch, "cost_model", None)
    out = fn() if callable(fn) else None
    out = out if isinstance(out, CostModel) else NEUTRAL
    if _MEASURED_CHUNNELS:
        m = _MEASURED_CHUNNELS.get(chunnel_name(ch))
        if m:
            out = replace(out, **m)
    return out


def stack_cost(stack: Any) -> CostModel:
    """Fold a ConcreteStack's chunnel cost models into one.

    Latencies and blips add; byte ratios multiply (a compressor below a
    replicator compresses the replicated bytes). A measured whole-stack blip
    (from ``reconfig.swap`` span durations) replaces the additive estimate —
    the swap IS the blip, measured end to end."""
    lat = blip = 0.0
    ratio = 1.0
    for ch in getattr(stack, "chunnels", ()):
        c = chunnel_cost(ch)
        lat += c.op_latency_s
        blip += c.switch_blip_s
        ratio *= c.dcn_bytes_per_byte
    if _MEASURED_BLIPS:   # keep fingerprint() off the common path
        fp = getattr(stack, "fingerprint", None)
        if callable(fp):
            measured = _MEASURED_BLIPS.get(fp())
            if measured is not None:
                blip = measured
    return CostModel(lat, ratio, blip)


@dataclass(frozen=True)
class Objective:
    """Weights + unit normalizers folding a CostModel into one scalar.

    ``dcn_s_per_byte`` converts wire bytes into seconds (1/bandwidth; default
    1 GB/s of DCN), so every term of the objective is in seconds of overhead
    per second of wall clock and the weights are comparable. ``amortize_s`` is
    the horizon over which a switch blip is written off — a short horizon
    makes the scorer switch-averse."""

    w_latency: float = 1.0
    w_bytes: float = 1.0
    w_blip: float = 1.0
    dcn_s_per_byte: float = 1e-9
    amortize_s: float = 30.0
    name: str = "balanced"


DEFAULT_OBJECTIVE = Objective()
LATENCY_FIRST = Objective(w_latency=1.0, w_bytes=0.05, name="latency_first")
BYTES_FIRST = Objective(w_latency=0.05, w_bytes=1.0, name="bytes_first")

#: workload assumed when scoring with NO telemetry at all (negotiation before
#: any traffic): 1 op/s and 1 MB/s keep both cost dimensions in play, so a
#: bytes-weighted objective still orders options by their byte annotations
NOMINAL_OPS_PER_S = 1.0
NOMINAL_BYTES_PER_S = 1e6


def utility(cost: CostModel, objective: Objective = DEFAULT_OBJECTIVE,
            snapshot: Optional[dict] = None, *, switching: bool = False) -> float:
    """Score one option under live telemetry; HIGHER is better.

    The value is the negated modeled overhead rate (seconds of communication
    overhead per second of wall clock):

      w_latency * op_latency_s      * ops_per_s
    + w_bytes   * dcn_bytes_per_byte * bytes_per_s * dcn_s_per_byte
    + w_blip    * switch_blip_s / amortize_s          (only if ``switching``)

    With no snapshot (negotiation time, before any traffic) the nominal
    workload ``NOMINAL_OPS_PER_S``/``NOMINAL_BYTES_PER_S`` applies, so BOTH
    dimensions' annotations still order the options (a bytes-weighted
    objective must not silently degrade to latency-only). Rates MEASURED as
    0.0 stay 0 — an idle connection's scores must not rank candidates by
    traffic that does not exist.
    """
    s = snapshot if snapshot is not None else {
        "ops_per_s": NOMINAL_OPS_PER_S, "bytes_per_s": NOMINAL_BYTES_PER_S}
    ops = s.get("ops_per_s")
    ops = NOMINAL_OPS_PER_S if ops is None else ops
    byte_rate = s.get("bytes_per_s") or 0.0
    c = (objective.w_latency * cost.op_latency_s * ops
         + objective.w_bytes * cost.dcn_bytes_per_byte * byte_rate
         * objective.dcn_s_per_byte)
    if switching:
        c += objective.w_blip * cost.switch_blip_s / max(objective.amortize_s, 1e-9)
    return -c


def score_stack(stack: Any, objective: Objective = DEFAULT_OBJECTIVE,
                snapshot: Optional[dict] = None, *, switching: bool = False) -> float:
    """``utility`` of a whole ConcreteStack (folds its chunnel cost models)."""
    return utility(stack_cost(stack), objective, snapshot, switching=switching)


@dataclass(frozen=True)
class Candidate:
    """One scoreable switch target: what ``switch()`` receives, its cost
    model, and a stable label compared against ``current()``."""

    target: Any
    cost: CostModel = NEUTRAL
    label: str = ""

    def __post_init__(self):
        if not self.label:
            object.__setattr__(self, "label", target_label(self.target))

    def multilateral(self) -> bool:
        m = getattr(self.target, "multilateral", None)
        return bool(m()) if callable(m) else False


def as_candidate(obj: Any) -> Candidate:
    """Coerce a Candidate / ConcreteStack / plain label into a Candidate.
    ConcreteStacks get their folded chunnel cost models; anything else is
    neutral unless wrapped in a Candidate explicitly."""
    if isinstance(obj, Candidate):
        return obj
    if hasattr(obj, "chunnels"):
        return Candidate(obj, stack_cost(obj))
    return Candidate(obj)


def rank(candidates: Sequence[Candidate], objective: Objective = DEFAULT_OBJECTIVE,
         snapshot: Optional[dict] = None,
         current_label: Optional[str] = None) -> List[Tuple[float, Candidate]]:
    """Score every candidate (blip charged only to non-current ones), best
    first; ties keep the input preference order."""
    scored = [(utility(c.cost, objective, snapshot,
                       switching=(c.label != current_label)), i, c)
              for i, c in enumerate(candidates)]
    scored.sort(key=lambda t: (-t[0], t[1]))
    return [(u, c) for u, _, c in scored]


class ScoredTarget:
    """A Rule target that is an *objective*, not a stack: resolved per
    controller tick to the argmax-utility candidate under the live snapshot.

    ``margin`` adds hysteresis in score space: the argmax must beat the
    currently-active candidate's utility by ``margin * |current utility|``
    before the resolution moves off it (on top of the switch-blip term, which
    already biases toward staying put)."""

    def __init__(self, candidates: Sequence[Any],
                 objective: Objective = DEFAULT_OBJECTIVE, *, margin: float = 0.0):
        self.candidates = [as_candidate(c) for c in candidates]
        if not self.candidates:
            raise ValueError("ScoredTarget needs at least one candidate")
        self.objective = objective
        self.margin = margin

    def multilateral(self) -> bool:
        return any(c.multilateral() for c in self.candidates)

    def resolve(self, snapshot: Optional[dict] = None,
                current_label: Optional[str] = None) -> Any:
        """The argmax-utility candidate's target under ``snapshot``."""
        sp = (TRACER.span("negotiate.score",
                          attrs={"objective": self.objective.name,
                                 "current": current_label})
              if TRACER.enabled else NOOP_SPAN)
        with sp:
            ranked = rank(self.candidates, self.objective, snapshot,
                          current_label)
            best_u, best = ranked[0]
            # per-candidate utilities: the trace's record of which stacks
            # lost the scoring round and by how much
            sp.set(scores={c.label: u for u, c in ranked},
                   chosen=best.label)
            if current_label is not None and best.label != current_label:
                cur = next(((u, c) for u, c in ranked
                            if c.label == current_label), None)
                if cur is not None and best_u <= cur[0] + self.margin * abs(cur[0]):
                    sp.set(chosen=current_label, reason="margin_hold")
                    return cur[1].target
            return best.target

    def __repr__(self):
        return (f"ScoredTarget({len(self.candidates)} candidates, "
                f"objective={self.objective.name})")


def resolve_target(target: Any, snapshot: Optional[dict] = None,
                   current_label: Optional[str] = None) -> Any:
    """Resolve a (possibly dynamic) Rule target: objects with a ``resolve``
    method (ScoredTarget) are evaluated against the snapshot; anything else is
    already concrete."""
    r = getattr(target, "resolve", None)
    return r(snapshot, current_label) if callable(r) else target
