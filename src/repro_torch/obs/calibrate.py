"""Trace-derived cost-model calibration: measured costs replace annotations.

The scorer (``repro_torch.core.cost``) ranks negotiated options by hand-written
``CostModel`` annotations — priors the developer guessed at authoring time.
But the tracer already *measures* the real quantities on every traced
run:

  * ``chunnel.send`` batch records carry the timed transform duration and
    the batch's payload bytes before/after the transform
    (``repro_torch.core.chunnel._FnDatapath``) — per-chunnel ``op_latency_s`` and
    ``dcn_bytes_per_byte``, measured;
  * ``wan.send`` spans carry the chunnel name and the full blocking send
    duration (window waits, retransmits) — the wire chunnel's real per-op
    latency;
  * ``reconfig.swap`` spans time the actual pause a switch inflicted, keyed
    by the NEW stack's fingerprint — the real ``switch_blip_s``.

:func:`calibrate_from_traces` folds a record list (``TRACER.collect()``, a
flight-recorder dump, a saved trace file) into a :class:`TraceCalibration`
and, with ``apply=True``, installs it through the existing
``calibrate_cost_models`` funnel (``repro_torch.comm.chunnels``) into the scorer's
measured-override tables — closing the ROADMAP "mesh-aware cost
calibration, full loop" carry-over: annotate → trace → measure → re-score.

Robustness: medians, not means — trace durations have a heavy right tail
(GC, scheduler preemption), and a calibration that installs a tail estimate
would poison every subsequent ranking. Chunnels with fewer than
``min_samples`` records keep their annotations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from statistics import median
from typing import Any, Dict, Iterable, List, Mapping, Optional

from repro_torch.comm.chunnels import calibrate_cost_models

__all__ = ["TraceCalibration", "calibrate_from_traces"]

#: record names whose ``dur`` measures ONE data-plane op of the named chunnel
_OP_RECORDS = ("chunnel.send", "wan.send")


@dataclass
class TraceCalibration:
    """Measured cost fields extracted from one batch of trace records.

    chunnels      chunnel name -> partial ``CostModel`` field dict (only the
                  fields the trace could measure: ``op_latency_s`` always,
                  ``dcn_bytes_per_byte`` when byte sizes were recorded)
    stack_blips   ConcreteStack fingerprint -> measured switch blip seconds
    samples       chunnel name -> latency sample count behind the estimate
    """

    chunnels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    stack_blips: Dict[str, float] = field(default_factory=dict)
    samples: Dict[str, int] = field(default_factory=dict)

    def __bool__(self) -> bool:
        return bool(self.chunnels or self.stack_blips)


def calibrate_from_traces(records: Iterable[Mapping[str, Any]], *,
                          min_samples: int = 3,
                          apply: bool = True) -> TraceCalibration:
    """Fold trace records into measured per-chunnel costs and stack blips.

    Args:
        records: normalized record dicts (``TRACER.collect()`` shape; a
            flight-recorder dump's ``records`` list works verbatim).
        min_samples: latency samples a chunnel needs before its annotation
            is overridden (swap blips apply from one sample — switches are
            rare and each one is a full end-to-end measurement).
        apply: install the result process-wide via ``calibrate_cost_models``
            so the next scored negotiation ranks with measured costs.
    """
    durs: Dict[str, List[float]] = {}
    bytes_in: Dict[str, int] = {}
    bytes_out: Dict[str, int] = {}
    blips: Dict[str, List[float]] = {}
    for r in records:
        attrs = r.get("attrs") or {}
        name = r.get("name")
        if name == "reconfig.swap":
            fp = attrs.get("new")
            dur = r.get("dur")
            if fp and dur:
                blips.setdefault(str(fp), []).append(float(dur))
            continue
        ch = attrs.get("chunnel")
        if not ch or name not in _OP_RECORDS:
            continue
        # batch records carry the timed transform in attrs["dur"]; spans
        # (wan.send) in the top-level "dur"
        dur = attrs.get("dur") if r.get("kind") == "batch" else r.get("dur")
        if dur is not None:
            durs.setdefault(ch, []).append(float(dur))
        bi, bo = attrs.get("bytes_in"), attrs.get("bytes_out")
        if bi and bo is not None:   # zero bytes_in = no byte information
            bytes_in[ch] = bytes_in.get(ch, 0) + int(bi)
            bytes_out[ch] = bytes_out.get(ch, 0) + int(bo)

    cal = TraceCalibration()
    for ch, samples in durs.items():
        if len(samples) < min_samples:
            continue
        fields: Dict[str, float] = {"op_latency_s": median(samples)}
        if bytes_in.get(ch):
            fields["dcn_bytes_per_byte"] = bytes_out[ch] / bytes_in[ch]
        cal.chunnels[ch] = fields
        cal.samples[ch] = len(samples)
    for fp, samples in blips.items():
        cal.stack_blips[fp] = median(samples)

    if apply and cal:
        _apply(cal)
    return cal


def _apply(cal: TraceCalibration) -> None:
    """Install through the documented funnel (the comm plane's
    ``calibrate_cost_models``)."""
    calibrate_cost_models(measured=cal)
