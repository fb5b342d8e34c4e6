"""What a metric's reader reads: the window's host-clock spans, the profiled
stretch (``devtrace.Stretch``, in a ``--trace 1`` run) and the hooks' calls."""
from __future__ import annotations

from typing import List, Optional


class Run:
    def __init__(self, cfg: dict, traffic: dict, window: dict, hooks=None):
        self.cfg, self.traffic, self.window, self.hooks = cfg, traffic, window, hooks
        self.spans: List[tuple] = window["spans"]  # (t0, t1, work) per batch or step
        self.stretch = window.get("stretch")
        self.excluded: Optional[tuple] = window.get("excluded")  # the stretch, host clock

    @property
    def window_s(self) -> float:
        return self.spans[-1][1] - self.window["t_start"]

    def _in_stretch(self, t0: float, t1: float) -> bool:
        return self.excluded is not None and self.excluded[0] <= t0 and t1 <= self.excluded[1]

    @property
    def steady_spans(self) -> List[tuple]:
        """The spans outside the profiled stretch."""
        return [s for s in self.spans if not self._in_stretch(s[0], s[1])]

    @property
    def steady_s(self) -> float:
        """The window's time less the profiled stretch's (profiler start and
        stop included)."""
        cut = 0.0 if self.excluded is None else self.excluded[1] - self.excluded[0]
        return self.window_s - cut

    def outside_stretch(self, name: str) -> List[tuple]:
        if self.hooks is None:
            return []
        return [c for c in self.hooks.calls.get(name, []) if not self._in_stretch(c[0], c[1])]

    def stretch_calls(self, name: str) -> List[tuple]:
        if self.hooks is None or self.excluded is None:
            return []
        return [c for c in self.hooks.calls.get(name, []) if self._in_stretch(c[0], c[1])]
