"""The numbers that decide ``correct``, and their judgement against the cell's
limits (``limits/<workload>.json``: for each number its limit and the two
readings it was set between)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64; infinite where the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp_min(1e-300))


def token_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best, over the rows (0 where every served token is the
    reference's best)."""
    ref = ref_logits.double()
    picked = torch.gather(ref, -1, served.long().view(-1, 1))[:, 0]
    return float((ref.amax(-1) - picked).max())


def worst(values) -> float:
    """The largest of ``values``, NaN where any is NaN (``max`` keeps a NaN
    only where it comes first)."""
    values = [float(v) for v in values]
    return float("nan") if any(v != v for v in values) else max(values)


def norm_gap(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """The worst leaf's gap between two norms, |got - want|, over the larger
    of the reference's norm of that leaf and of the median leaf; ``keep``
    names the leaves compared (all by default)."""
    names = [n for n in want if keep is None or n in keep]
    med = sorted(want[n] for n in names)[len(names) // 2]
    return worst(abs(got[n] - want[n]) / max(want[n], med, 1e-300) for n in names)


def judge(readings: Dict[str, float], limits: dict) -> Tuple[bool, Dict[str, dict], List[str]]:
    """(correct, {name: {"value", "limit"}}, lines): correct when every number
    is finite and at or under its limit."""
    table, lines, ok = {}, [], True
    for name, spec in limits["numbers"].items():
        value = readings.get(name)
        limit = spec["limit"]
        good = value is not None and value == value and value <= limit
        ok &= good
        table[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} {'ok' if good else 'FAILED'}")
    return ok, table, lines
