"""Concurrency analyzer: lock graphs, blocking-under-lock, unguarded writes.

Everything here is per-module and per-class, driven by the repo's actual
threading idiom: locks live as ``self._lock = threading.Lock()`` attributes
(or module-level ``NAME = threading.Lock()``) and are held via ``with``.
Three rules:

  lock-order           nested ``with`` acquisitions define a directed graph
                       over locks; a cycle means two code paths can acquire
                       the same pair in opposite orders (classic deadlock).
                       Re-acquiring a held non-reentrant Lock/Condition on
                       the same path is reported immediately.
  blocking-under-lock  a call that can block — ``time.sleep``, thread
                       ``join``, ``queue.get``, fabric/RPC ``send``/``recv``/
                       ``request``, ``wait`` on events/barriers, any KV
                       ``transact*``, or a caller-supplied callable — made
                       while a lock is held turns that lock into a
                       convoy/deadlock hazard. ``cond.wait()`` on the
                       condition currently held is the sanctioned idiom and
                       is not flagged. Closures passed to a PESSIMISTIC
                       ``.transact(fn)`` are analyzed as if they held the
                       store lock, because they do (rendezvous.KVStore).
  unguarded-attr       in a class that owns a lock, a plain ``self.x = ...``
                       (or ``self.x[k] = ...``) outside any ``with lock:``
                       in a non-``__init__`` method, where other methods also
                       touch ``x``, bypasses the discipline the lock exists
                       for. In a class that spawns threads at itself
                       (``threading.Thread(target=self.m)``), writes inside
                       the thread-target methods get the same treatment even
                       without a lock attribute.

The analysis is intentionally shallow (no inter-procedural lock tracking
beyond txn closures and thread-target transitive self-calls): it is tuned to
have zero false positives on this codebase's idiom, with ``# lint: allow``
carrying the documented exceptions (pessimistic transactions, the LockedConn
switch point).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .engine import Module, analyzer
from .findings import Finding
from .rules_port import collect_import_aliases

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
QUEUE_FACTORIES = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}

#: method names that can block the calling thread (receiver-independent)
BLOCKING_METHODS = {"recv", "request", "transact", "try_transact",
                    "transact_retry", "send"}
INIT_METHODS = {"__init__", "__post_init__"}


def _resolves_to(aliases: Dict[str, str], node: ast.AST, dotted: str) -> bool:
    return _dotted(aliases, node) == dotted


def _dotted(aliases: Dict[str, str], node: ast.AST) -> Optional[str]:
    """Resolve a Name/Attribute chain through the module's import aliases."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id)
    if root is None:
        return None
    return ".".join([root] + list(reversed(parts)))


def _factory_kind(aliases: Dict[str, str], call: ast.AST,
                  factories: Set[str], module: str) -> Optional[str]:
    """'Lock' for ``threading.Lock()`` / ``Lock()`` (aliased), etc."""
    if not isinstance(call, ast.Call):
        return None
    d = _dotted(aliases, call.func)
    if d and d.startswith(module + ".") and d.split(".")[-1] in factories:
        return d.split(".")[-1]
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for ``self.x``; None otherwise."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _write_target_attr(target: ast.AST) -> Optional[str]:
    """Attr name written by an assignment target: self.x or self.x[...]."""
    a = _self_attr(target)
    if a is not None:
        return a
    if isinstance(target, ast.Subscript):
        return _self_attr(target.value)
    return None


class _ClassInfo:
    def __init__(self, node: ast.ClassDef, aliases: Dict[str, str]):
        self.node = node
        self.name = node.name
        self.methods: Dict[str, ast.FunctionDef] = {
            m.name: m for m in node.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.lock_attrs: Dict[str, str] = {}
        self.queue_attrs: Set[str] = set()
        self.thread_attrs: Set[str] = set()
        self.thread_targets: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                attr = _self_attr(sub.targets[0])
                if attr:
                    kind = _factory_kind(aliases, sub.value, LOCK_FACTORIES,
                                         "threading")
                    if kind:
                        self.lock_attrs[attr] = kind
                    elif _factory_kind(aliases, sub.value, QUEUE_FACTORIES,
                                       "queue"):
                        self.queue_attrs.add(attr)
                    elif _factory_kind(aliases, sub.value,
                                       {"Thread", "Timer"}, "threading"):
                        self.thread_attrs.add(attr)
            if isinstance(sub, ast.Call) and _factory_kind(
                    aliases, sub, {"Thread", "Timer"}, "threading"):
                for kw in sub.keywords:
                    if kw.arg == "target":
                        t = _self_attr(kw.value)
                        if t:
                            self.thread_targets.add(t)
        # transitive: self.m() called from a thread target also runs there
        work = list(self.thread_targets)
        while work:
            m = self.methods.get(work.pop())
            if m is None:
                continue
            for sub in ast.walk(m):
                if isinstance(sub, ast.Call):
                    callee = _self_attr(sub.func)
                    if callee in self.methods and callee not in self.thread_targets:
                        self.thread_targets.add(callee)
                        work.append(callee)


class _HeldVisitor(ast.NodeVisitor):
    """Walk one function tracking which locks are held; emit blocking/edge
    info. ``held`` entries are (key, kind, display) tuples."""

    def __init__(self, mod: Module, aliases: Dict[str, str],
                 cls: Optional[_ClassInfo], module_locks: Dict[str, str],
                 fn: ast.FunctionDef, edges: Dict[Tuple[str, str], int],
                 out: List[Finding], initial_held=None):
        self.mod = mod
        self.aliases = aliases
        self.cls = cls
        self.module_locks = module_locks
        self.fn = fn
        self.edges = edges
        self.out = out
        self.held: List[Tuple[str, str, str]] = list(initial_held or [])
        a = fn.args
        self.params = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                       if p.arg != "self"}
        self.local_defs: Dict[str, ast.FunctionDef] = {
            n.name: n for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn}

    # -- lock identification -------------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[Tuple[str, str, str]]:
        attr = _self_attr(expr)
        if attr and self.cls and attr in self.cls.lock_attrs:
            return (f"{self.cls.name}.{attr}", self.cls.lock_attrs[attr],
                    f"self.{attr}")
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return (f"<module>.{expr.id}", self.module_locks[expr.id], expr.id)
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            lk = self._lock_of(item.context_expr)
            if lk is None:
                continue
            for held_key, held_kind, held_disp in self.held:
                if held_key == lk[0]:
                    if lk[1] in ("Lock", "Condition"):
                        self.out.append(Finding(
                            "lock-order", self.mod.path, node.lineno,
                            node.col_offset,
                            f"{lk[2]} ({lk[1]}) re-acquired while already "
                            "held — non-reentrant: this deadlocks"))
                else:
                    self.edges.setdefault((held_key, lk[0]), node.lineno)
            acquired.append(lk)
        self.held.extend(acquired)
        self.generic_visit(node)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node) -> None:
        # nested defs do not inherit the held set at their *call* site; they
        # are analyzed separately (txn closures get the store lock injected)
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    # -- blocking calls --------------------------------------------------------
    def _flag(self, node: ast.AST, what: str) -> None:
        _, _, disp = self.held[-1]
        self.out.append(Finding(
            "blocking-under-lock", self.mod.path, node.lineno,
            node.col_offset, f"{what} while holding {disp}"))

    def visit_Call(self, node: ast.Call) -> None:
        # pessimistic txn closures: fn passed to .transact runs LOCKED
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "transact" and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in self.local_defs):
            inner = self.local_defs[node.args[0].id]
            v = _HeldVisitor(
                self.mod, self.aliases, self.cls, self.module_locks, inner,
                self.edges, self.out,
                initial_held=[("<kv-store>", "RLock",
                               "the KV store lock (pessimistic transact)")])
            for stmt in inner.body:
                v.visit(stmt)
        if self.held:
            self._check_blocking(node)
        self.generic_visit(node)

    def _check_blocking(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in self.params:
                self._flag(node, f"call to caller-supplied {f.id}()")
            elif self.aliases.get(f.id) == "time.sleep":
                self._flag(node, "time.sleep()")
            return
        if not isinstance(f, ast.Attribute):
            return
        meth, recv = f.attr, f.value
        if _resolves_to(self.aliases, f, "time.sleep"):
            self._flag(node, "time.sleep()")
        elif meth == "wait":
            lk = self._lock_of(recv)
            if lk is not None and any(h[0] == lk[0] for h in self.held):
                return  # cond.wait() on the held condition releases it
            self._flag(node, f".{meth}()")
        elif meth == "join":
            attr = _self_attr(recv)
            if self.cls and attr in self.cls.thread_attrs:
                self._flag(node, f"thread join self.{attr}.join()")
        elif meth == "get":
            attr = _self_attr(recv)
            is_queue = self.cls and attr in self.cls.queue_attrs
            has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
            if is_queue or has_timeout:
                self._flag(node, f".get() on a queue")
        elif meth in BLOCKING_METHODS:
            self._flag(node, f".{meth}()")


def _analyze_writes(mod: Module, cls: _ClassInfo,
                    out: List[Finding]) -> None:
    """unguarded-attr for one class."""
    if not cls.lock_attrs and not cls.thread_targets:
        return
    accessed_in: Dict[str, Set[str]] = {}
    for mname, fn in cls.methods.items():
        for sub in ast.walk(fn):
            attr = _self_attr(sub)
            if attr:
                accessed_in.setdefault(attr, set()).add(mname)

    for mname, fn in cls.methods.items():
        if mname in INIT_METHODS:
            continue
        writes: List[Tuple[str, int, int, bool]] = []

        def walk(node: ast.AST, locked: bool) -> None:
            if isinstance(node, ast.With):
                now_locked = locked or any(
                    _self_attr(i.context_expr) in cls.lock_attrs
                    for i in node.items)
                for child in ast.iter_child_nodes(node):
                    walk(child, now_locked)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = node.targets
            for t in targets:
                attr = _write_target_attr(t)
                if attr and attr not in cls.lock_attrs:
                    writes.append((attr, node.lineno, node.col_offset, locked))
            for child in ast.iter_child_nodes(node):
                walk(child, locked)

        for stmt in fn.body:
            walk(stmt, False)
        for attr, lineno, col, locked in writes:
            if locked:
                continue
            others = accessed_in.get(attr, set()) - {mname} - INIT_METHODS
            if not others:
                continue
            if cls.lock_attrs:
                out.append(Finding(
                    "unguarded-attr", mod.path, lineno, col,
                    f"{cls.name}.{mname} writes self.{attr} without holding "
                    f"the class lock, but {', '.join(sorted(others))} also "
                    "touches it"))
            elif mname in cls.thread_targets:
                out.append(Finding(
                    "unguarded-attr", mod.path, lineno, col,
                    f"{cls.name}.{mname} runs on a spawned thread and writes "
                    f"self.{attr} with no lock, but "
                    f"{', '.join(sorted(others))} also touches it"))


def _cycle_findings(mod: Module, edges: Dict[Tuple[str, str], int]
                    ) -> List[Finding]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    out: List[Finding] = []
    reported = set()

    def dfs(start: str, node: str, path: List[str]) -> None:
        for nxt in graph.get(node, ()):
            if nxt == start:
                cyc = tuple(sorted(path + [nxt]))
                if cyc not in reported:
                    reported.add(cyc)
                    line = edges.get((node, nxt), 0)
                    out.append(Finding(
                        "lock-order", mod.path, line, 0,
                        "lock-order inversion: "
                        + " -> ".join(path + [nxt])
                        + " closes a cycle — two paths acquire these locks "
                        "in opposite orders"))
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for n in list(graph):
        dfs(n, n, [n])
    return out


@analyzer
def check_concurrency(mod: Module) -> List[Finding]:
    aliases = collect_import_aliases(mod.tree)
    out: List[Finding] = []
    edges: Dict[Tuple[str, str], int] = {}

    module_locks: Dict[str, str] = {}
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            kind = _factory_kind(aliases, node.value, LOCK_FACTORIES,
                                 "threading")
            if kind:
                module_locks[node.targets[0].id] = kind

    def run_fn(fn, cls: Optional[_ClassInfo]) -> None:
        v = _HeldVisitor(mod, aliases, cls, module_locks, fn, edges, out)
        for stmt in fn.body:
            v.visit(stmt)

    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef):
            cls = _ClassInfo(node, aliases)
            for fn in cls.methods.values():
                run_fn(fn, cls)
            _analyze_writes(mod, cls, out)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            run_fn(node, None)

    out.extend(_cycle_findings(mod, edges))
    return out
