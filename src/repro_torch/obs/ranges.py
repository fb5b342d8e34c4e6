"""The port's spans on the profiler's clock.

A site, a function wrapped by :func:`spanned` or a block under
:func:`span`, is a span of ``obs.trace.TRACER`` while the tracer is
enabled (it lands in the rings, so ``obs/export.to_chrome`` works without
the profiler), and a ``torch.profiler.record_function`` range named
``repro_torch.<name>`` while a torch profiler records (range mode), so that
the device operations launched inside a site, and the device's idle gaps,
can be put down to it on the profiler's clock. With the tracer off and no
profiler recording, a site reads one attribute and asks torch one question
(``torch.autograd._profiler_enabled``), then calls through: no ``Span``, no
dict, no autograd node.

In range mode a :func:`spanned` region called with grad enabled, on an
input that requires grad, also puts its backward into the range
``repro_torch.<name>.bwd``, with markers that launch nothing and change no
value or gradient:

- the positional inputs that require grad pass through one ``_Close``, an
  identity ``autograd.Function`` whose outputs alias its inputs (detached
  in its forward: a view returned by a ``Function`` may not be modified in
  place); it saves no tensor and does not materialise a missing gradient;
- the region's output (its first tensor) gets a hook, which autograd runs
  when the output's gradient is complete, before any node of the region:
  it opens the ``.bwd`` range (``_Backward.start``), unless this backward
  does not reach ``_Close`` (a ``torch.autograd.grad`` that stops short of
  it);
- ``_Close``'s backward runs once the gradient of each of its outputs is
  complete, after every node of the region that read an input: it closes
  the range.

So the kernels autograd launches for the region fall inside a range of the
region's name, on the thread that launches them. The markers cost host
time in the profiled backward (a Python node and a hook a region), so a
profiled step's idle share counts them. A region that
``torch.utils.checkpoint`` recomputes inside the backward takes no
markers: autograd does not run the recomputed graph backward. The markers
save no tensor, so the checkpoint saves what it saves without them.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch.autograd import _profiler_enabled as recording
from torch.profiler import record_function

from repro_torch.obs.trace import TRACER

__all__ = ["PREFIX", "span", "spanned"]

#: the ranges' names are ``PREFIX + <span name>``
PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()


def open_range(name: str) -> record_function:
    """The open profiler range ``name`` (its ``__exit__`` closes it)."""
    rf = record_function(name)
    rf.__enter__()
    return rf


class _Site:
    """An open site: the tracer's span (a no-op while the tracer is off)
    and, while a profiler records, its range."""

    __slots__ = ("name", "span", "range")

    def __init__(self, name: str):
        self.name, self.span, self.range = name, TRACER.span(name), None

    def __enter__(self) -> "_Site":
        self.span.__enter__()
        if recording():
            self.range = open_range(PREFIX + self.name)
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        return self.span.__exit__(*exc)


def span(name: str):
    """The site ``name`` around a block: ``with span("train.step"): ...``."""
    if not TRACER.enabled and not recording():
        return _OFF
    return _Site(name)


def spanned(name: str) -> Callable:
    """Decorator: each call of the function is the site ``name``, and in
    range mode its backward is the range ``<name>.bwd``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not TRACER.enabled and not recording():
                return fn(*args, **kwargs)
            with _Site(name) as site:
                if site.range is None:
                    return fn(*args, **kwargs)
                return _region(PREFIX + name + ".bwd", fn, args, kwargs)
        return call
    return wrap


class _Backward:
    """The ``.bwd`` range of one call of a region."""

    __slots__ = ("name", "range")

    def __init__(self, name: str):
        self.name, self.range = name, None

    def start(self, close) -> None:
        if self.range is None and torch._C._will_engine_execute_node(close):
            self.range = open_range(self.name)

    def done(self) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None


class _Close(torch.autograd.Function):
    """Identity on a region's inputs; its backward closes the range."""

    @staticmethod
    def forward(ctx, bwd, *xs):
        ctx.set_materialize_grads(False)
        ctx.bwd = bwd
        return tuple([x.detach() for x in xs])

    @staticmethod
    def backward(ctx, *grads):
        ctx.bwd.done()
        return (None, *grads)


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, tuple):
        return next((t for t in out if isinstance(t, torch.Tensor)), None)
    return None


def _region(bwd_name: str, fn, args: tuple, kwargs: dict):
    """``fn(*args, **kwargs)``, its backward inside the range ``bwd_name``
    where grad is enabled and a positional input requires grad, outside a
    backward (a recomputation)."""
    if not torch.is_grad_enabled() or torch._C._current_graph_task_id() != -1:
        return fn(*args, **kwargs)
    at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.requires_grad]
    if not at:
        return fn(*args, **kwargs)
    bwd = _Backward(bwd_name)
    aliases = _Close.apply(bwd, *[args[i] for i in at])
    marked = list(args)
    for i, a in zip(at, aliases):
        marked[i] = a
    out = fn(*marked, **kwargs)
    y = _first_tensor(out)
    if y is not None and y.grad_fn is not None:
        close = aliases[0].grad_fn
        y.register_hook(lambda g: bwd.start(close))
    return out
