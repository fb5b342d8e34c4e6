"""Data-plane rules: keep Datapath/Fabric hot paths batched.

  span-in-hot-loop       span creation (``.span``/``.begin_span``) inside a
                         loop of a hot-path method. Tracing the data plane is
                         batch-granular by design (``TRACER.record_batch`` is
                         one tuple append); a Span per message would blow the
                         <10% enabled-tracing budget bench_overhead gates.

  per-message-hot-path   a loop (or comprehension) inside a hot-path method
                         of a Datapath/Fabric/Endpoint class performs a
                         per-element delivery call (``.send``/``.put``/
                         ``.put_nowait``/``.publish``/``.request``). The
                         batched data plane (docs/architecture.md §8) moves
                         whole batches per call — one inner ``send``, one
                         fabric ``send_batch``, one device program. A
                         per-element singleton-send loop silently reverts the
                         hot path to the per-message regime this repo
                         refactored away. Per-message transforms that truly
                         cannot vectorize go through the explicit
                         ``repro_torch.core.chunnel.per_message`` adapter (which
                         contains the one sanctioned per-element loop);
                         grouping loops that call ``.send_batch`` per
                         destination stay legal.

Hot classes: ``Fabric``/``Endpoint``/``Broker`` by name, anything named
``*DP``/``*Datapath``, anything deriving from a base so named (nested class
definitions included), plus the observability aggregation classes
(``MetricsFederator``/``SLOEngine``/``MetricsPublisher``) — their
``observe``/``view``/``merged``/``publish`` methods run once per control
tick over every member/SLO, so a per-element delivery call or a span per
loop iteration there multiplies by fleet size exactly like a per-message
loop on the data plane. Hot methods: send / recv / send_batch / recv_many /
send_many / publish_batch / observe / view / merged / publish.
"""
from __future__ import annotations

import ast
from typing import List

from .engine import Module, analyzer
from .findings import Finding

HOT_CLASS_NAMES = {"Fabric", "Endpoint", "Broker",
                   "MetricsFederator", "SLOEngine", "MetricsPublisher"}
HOT_METHODS = {"send", "recv", "send_batch", "recv_many", "send_many",
               "publish_batch", "observe", "view", "merged", "publish"}
DELIVERY_ATTRS = {"send", "put", "put_nowait", "publish", "request"}

_LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.GeneratorExp,
          ast.DictComp)


def _base_names(cls: ast.ClassDef) -> List[str]:
    names = [cls.name]
    for b in cls.bases:
        if isinstance(b, ast.Name):
            names.append(b.id)
        elif isinstance(b, ast.Attribute):
            names.append(b.attr)
    return names


def _is_hot_class(cls: ast.ClassDef) -> bool:
    return any(n in HOT_CLASS_NAMES or n.endswith("DP") or "Datapath" in n
               for n in _base_names(cls))


def _delivery_calls(loop: ast.AST) -> List[ast.Call]:
    out = []
    for sub in ast.walk(loop):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in DELIVERY_ATTRS):
            out.append(sub)
    return out


@analyzer
def check_per_message_hot_path(mod: Module) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.ClassDef) and _is_hot_class(node)):
            continue
        for item in node.body:
            if not (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and item.name in HOT_METHODS):
                continue
            seen = set()  # a call inside nested loops reports once
            for sub in ast.walk(item):
                if not isinstance(sub, _LOOPS):
                    continue
                for call in _delivery_calls(sub):
                    if (call.lineno, call.col_offset) in seen:
                        continue
                    seen.add((call.lineno, call.col_offset))
                    out.append(Finding(
                        "per-message-hot-path", mod.path, call.lineno,
                        call.col_offset,
                        f"{node.name}.{item.name} delivers per element "
                        f"(.{call.func.attr} inside a loop) — batch it: one "
                        "inner send / fabric send_batch per call, or lift a "
                        "scalar transform with repro_torch.core.chunnel.per_message"))
    return out


#: tracer calls that allocate a Span — forbidden per message on the data
#: plane; ``record_batch`` (one tuple per batch) and ``.event`` stay legal
SPAN_CTORS = {"span", "begin_span", "start_span"}


def _span_calls(loop: ast.AST) -> List[ast.Call]:
    out = []
    for sub in ast.walk(loop):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in SPAN_CTORS):
            out.append(sub)
    return out


@analyzer
def check_span_in_hot_loop(mod: Module) -> List[Finding]:
    """Observability counterpart of ``per-message-hot-path``: span objects
    (dict attrs, event lists, stack pushes) in a per-message loop would eat
    the <10% enabled-tracing budget ``bench_overhead`` gates. Batch-level
    spans (outside any loop) and ``record_batch``/``event`` are fine."""
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.ClassDef) and _is_hot_class(node)):
            continue
        for item in node.body:
            if not (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and item.name in HOT_METHODS):
                continue
            seen = set()
            for sub in ast.walk(item):
                if not isinstance(sub, _LOOPS):
                    continue
                for call in _span_calls(sub):
                    if (call.lineno, call.col_offset) in seen:
                        continue
                    seen.add((call.lineno, call.col_offset))
                    out.append(Finding(
                        "span-in-hot-loop", mod.path, call.lineno,
                        call.col_offset,
                        f"{node.name}.{item.name} creates a span per loop "
                        f"iteration (.{call.func.attr}) — record one "
                        "TRACER.record_batch per batch instead; spans are "
                        "reserved for control-plane phases"))
    return out
