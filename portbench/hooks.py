"""Ranges around calls into the program, placed from the benchmark's own files
by wrapping the module attributes that the program calls through.

Each wrapped call is timed on the host clock (every call, kept as (t0, t1,
info)) and, while the profiler runs, recorded as the range
``portbench.<name>``, so that the device operations launched inside it can be
attributed to it. ``info`` is what the wrapper's ``describe`` reads from the
arguments (shapes for the kernel counts). These are stand-ins for spans
inside the program.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional

import torch

PREFIX = "portbench."


class Hooks:
    def __init__(self):
        self.calls: Dict[str, List[tuple]] = {}
        self._undo: List[Callable[[], None]] = []

    def wrap(self, fn: Callable, name: str, describe: Optional[Callable] = None) -> Callable:
        calls = self.calls.setdefault(name, [])
        label = PREFIX + name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            info = describe(*args, **kwargs) if describe is not None else None
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            calls.append((t0, time.perf_counter(), info))
            return out

        return wrapped

    def attr(self, owner, attr: str, name: str, describe: Optional[Callable] = None) -> None:
        """Wrap ``owner.attr`` (a module or object attribute) in place."""
        old = getattr(owner, attr)
        setattr(owner, attr, self.wrap(old, name, describe))
        self._undo.append(lambda: setattr(owner, attr, old))

    def item(self, mapping: dict, key, name: str, describe: Optional[Callable] = None) -> None:
        """Wrap ``mapping[key]`` (an entry the program bound at import)."""
        old = mapping[key]
        mapping[key] = self.wrap(old, name, describe)
        self._undo.append(lambda: mapping.__setitem__(key, old))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()
