"""The program's own spans in a profiled stretch (``devtrace.Stretch``).

While a torch profiler records, the program's spans are ranges named
``repro_torch.<span>`` (``repro_torch.model.norm``,
``repro_torch.train.step``, ...), and a region's backward is the range
``<span>.bwd`` (``obs/ranges.py`` of the program). ``devtrace.parse`` keeps
them among the stretch's host events. A program without those spans leaves
no such range: every reader then returns None.

A device operation belongs to the innermost ``model.*`` range open at its
launch, so that the layer regions split the device time without counting an
operation twice: a layer's recomputation, which autograd runs inside the
backward range of the product that first unpacks one of the layer's saved
tensors, falls to its own regions and to ``model.remat``.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from portbench.devtrace import DeviceOp, Stretch, gaps, union_seconds

PROGRAM = "repro_torch."  # the program's range names: PROGRAM + span name


def ranges(s: Stretch) -> Dict[str, List[Tuple[float, float]]]:
    """The program's ranges in the stretch, (start, end) by span name."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    for a, b, name in s.host:
        if name.startswith(PROGRAM):
            out.setdefault(name[len(PROGRAM):], []).append((a, b))
    return out


def owners(s: Stretch) -> List[Tuple[DeviceOp, Optional[str]]]:
    """Each device operation with the innermost ``model.*`` range open at
    its launch (its span name), or None."""
    spans = sorted((a, b, name) for name, iv in ranges(s).items()
                   if name.startswith("model.") for a, b in iv)
    ops = sorted((o for o in s.ops if o.launched is not None), key=lambda o: o.launched)
    out, stack, i = [], [], 0
    for o in ops:
        while i < len(spans) and spans[i][0] <= o.launched:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < o.launched:
            stack.pop()
        out.append((o, stack[-1][2] if stack else None))
    return out


def _of(s: Optional[Stretch], name: str) -> List[Tuple[float, float]]:
    return [] if s is None else ranges(s).get(name, [])


def region_ms(s: Optional[Stretch], *names: str) -> Optional[float]:
    """Device ms a unit (batch or step) of the operations whose innermost
    ``model.*`` range is one of ``names``; None where the stretch holds
    none of those ranges."""
    if not any(_of(s, n) for n in names):
        return None
    want = set(names)
    mine = [(o.start, o.end) for o, owner in owners(s) if owner in want]
    return union_seconds(mine) * 1e-6 / s.units * 1e3


def idle_ms(s: Optional[Stretch], name: str) -> Optional[float]:
    """Device idle ms a unit while the host is inside the range ``name``:
    the stretches of each such range that no device operation covers."""
    spans = _of(s, name)
    if not spans:
        return None
    clipped = s.clipped()
    idle = 0.0
    for a, b in spans:
        inside = [(max(x, a), min(y, b)) for x, y in clipped if y > a and x < b]
        idle += sum(y - x for x, y in gaps(inside, a, b))
    return idle * 1e-6 / s.units * 1e3


def launches(s: Optional[Stretch], name: str) -> Optional[float]:
    """Device operations (kernels, copies, memsets) a unit launched while
    the range ``name`` was open."""
    spans = sorted(_of(s, name))
    if not spans:
        return None
    starts = [a for a, _ in spans]
    n = 0
    for o in s.ops:
        if o.launched is None:
            continue
        i = bisect.bisect_right(starts, o.launched) - 1
        n += i >= 0 and o.launched <= spans[i][1]
    return n / s.units
