"""Hygiene rules for the control-plane packages (core / fleet / comm / serving).

  silent-except    an ``except Exception:`` (or bare ``except:``) whose body
                   is only ``pass``/``continue``/``...`` erases the failure
                   entirely. In a control plane built on retries and voting,
                   a swallowed exception turns a diagnosable fault into a
                   silent hang or a stale decision. Catching broadly is fine
                   — PROVABLY DOING SOMETHING with it (log, count, re-raise,
                   fall back) is the requirement.
  mutable-default  ``def f(x, acc=[])`` shares one list across every call —
                   the classic aliasing bug. Use ``None`` + fill-in.

Scope: these rules run only over the port's control-plane packages named in
the scope list below (the reference's scope, under ``repro_torch/``).
"""
from __future__ import annotations

import ast
from typing import List

from .engine import Module, analyzer
from .findings import Finding

#: path fragments the hygiene rules apply to (control-plane packages)
HYGIENE_SCOPE = ("repro_torch/core/", "repro_torch/fleet/", "repro_torch/comm/",
                 "repro_torch/serving/", "repro_torch/lint/", "repro_torch/chaos/",
                 "repro_torch/obs/")

MUTABLE_CTORS = {"list", "dict", "set"}


def _in_scope(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(frag in norm for frag in HYGIENE_SCOPE)


def _is_swallow_body(body: List[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass) or isinstance(stmt, ast.Continue):
            continue
        if (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)):
            continue  # docstring or `...`
        return False
    return True


def _catches_broadly(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    if isinstance(t, ast.Name) and t.id in ("Exception", "BaseException"):
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name)
                   and e.id in ("Exception", "BaseException") for e in t.elts)
    return False


def _is_mutable_default(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in MUTABLE_CTORS and not node.args
            and not node.keywords)


@analyzer
def check_hygiene(mod: Module) -> List[Finding]:
    if not _in_scope(mod.path):
        return []
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler):
            if _catches_broadly(node) and _is_swallow_body(node.body):
                out.append(Finding(
                    "silent-except", mod.path, node.lineno, node.col_offset,
                    "except swallows every exception with no log/counter/"
                    "re-raise — at minimum log once at DEBUG"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if _is_mutable_default(d):
                    out.append(Finding(
                        "mutable-default", mod.path, d.lineno, d.col_offset,
                        f"{node.name}() has a mutable default argument — one "
                        "object is shared across every call; use None and "
                        "fill in"))
    return out
