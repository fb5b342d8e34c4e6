"""Rule registry and file runner for ``repro_torch.lint``.

Analyzers are plain functions ``(Module) -> List[Finding]`` registered under a
family name. Rules (the finding IDs analyzers emit) are declared in ``RULES``
so pragmas can be validated against the known set — a pragma naming a rule
that does not exist is itself a finding, which keeps stale suppressions from
rotting in place after a rule is renamed.

To add a rule: declare its ID + one-line doc in ``RULES``, emit it from an
analyzer registered with ``@analyzer``, and add a good/bad fixture pair to
``tests/test_torch_lint.py``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from .findings import Finding, PragmaMap

#: rule id -> one-line description (the rule catalog; see docs/architecture.md)
RULES: Dict[str, str] = {
    # stack verifier (static half; runtime half lives in rules_stack.verify_stack)
    "stack-migrate-signature":
        "migrate_state/apply_state/restore_state has a non-standard signature",
    "stack-capability-closure":
        "stack options differ in exact capabilities on a non-multilateral chunnel",
    "stack-swap-alignment":
        "chunnel name reused across swap options with a different class, or "
        "duplicated within one option (breaks migrate_state alignment)",
    "stack-dead-option":
        "a Select combination can never instantiate (adjacent WireTypes clash)",
    "stack-semantic-order":
        "semantic classes are mis-ordered (e.g. reliability above compression)",
    # concurrency analyzer
    "lock-order":
        "lock acquisition order inverts between code paths, or a "
        "non-reentrant lock is re-acquired on the same path",
    "blocking-under-lock":
        "blocking call (sleep/join/recv/queue.get/KV transact*/RPC) while "
        "holding a lock",
    "unguarded-attr":
        "shared mutable attribute written without the class lock (or from a "
        "thread target) while other methods access it",
    # data plane
    "per-message-hot-path":
        "per-element delivery loop (.send/.put/.publish per message) inside "
        "a Datapath/Fabric/Endpoint hot-path method — batch it, or lift a "
        "scalar transform with the per_message adapter",
    "span-in-hot-loop":
        "span creation (.span/.begin_span) inside a loop of a Datapath/"
        "Fabric/Endpoint hot-path method — spans are control-plane; the data "
        "plane records one TRACER.record_batch per batch",
    # port boundary + hygiene
    "kernel-boundary":
        "ctypes, triton or a CUDA build outside src/repro_torch/backend.py "
        "and src/repro_torch/kernels/*/",
    "reference-import":
        "the port imports jax or the reference package repro",
    "silent-except":
        "except clause swallows all exceptions without logging or re-raising",
    "mutable-default":
        "mutable default argument ([], {}, set()) shared across calls",
    # pragma meta-rules (emitted by the engine itself)
    "pragma-missing-reason":
        "lint: allow pragma with no written justification",
    "pragma-unknown-rule":
        "lint: allow pragma naming a rule that does not exist",
}


@dataclass
class Module:
    """One parsed source file handed to every analyzer."""

    path: str                 # display path (repo-relative when possible)
    source: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)

    @classmethod
    def parse(cls, path: str, source: str) -> "Module":
        return cls(path=path, source=source,
                   tree=ast.parse(source, filename=path),
                   lines=source.splitlines())


Analyzer = Callable[[Module], List[Finding]]
_ANALYZERS: List[Analyzer] = []


def analyzer(fn: Analyzer) -> Analyzer:
    _ANALYZERS.append(fn)
    return fn


def _load_analyzers() -> None:
    # import for registration side effects; idempotent
    from . import (  # noqa: F401
        rules_concurrency,
        rules_dataplane,
        rules_hygiene,
        rules_port,
        rules_stack,
    )


def lint_module(mod: Module) -> List[Finding]:
    """Run every analyzer over one module and apply its pragmas.

    Suppression scope: a pragma on the offending line (or the line directly
    above) silences that line; a pragma on a ``def`` line silences the rule
    for the whole function — for documented patterns like "callers hold the
    lock" that would otherwise need one pragma per statement."""
    _load_analyzers()
    pragmas = PragmaMap(mod.source)
    spans = [(n.lineno, getattr(n, "end_lineno", n.lineno) or n.lineno)
             for n in ast.walk(mod.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    findings: List[Finding] = []
    for an in _ANALYZERS:
        findings.extend(an(mod))
    kept = []
    for f in findings:
        if pragmas.allows(f):
            continue
        if any(s <= f.line <= e and pragmas.allows_at(s, f.rule)
               for s, e in spans):
            continue
        kept.append(f)
    kept.extend(pragmas.problems(mod.path, set(RULES)))
    kept.sort(key=lambda f: (f.line, f.col, f.rule))
    return kept


def lint_sources(sources: Dict[str, str]) -> List[Finding]:
    """String-based entry point (used by the fixture tests)."""
    out: List[Finding] = []
    for path, src in sources.items():
        out.extend(lint_module(Module.parse(path, src)))
    return out


def iter_py_files(paths: List[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            files.extend(sorted(pp.rglob("*.py")))
        elif pp.suffix == ".py":
            files.append(pp)
    return files


def display_path(p: Path, root: Optional[Path]) -> str:
    try:
        return str(p.resolve().relative_to(root)) if root else str(p)
    except ValueError:
        return str(p)


def lint_paths(paths: List[str], root: Optional[Path] = None):
    """Lint every .py under ``paths``.

    Returns ``(findings, source_lines)`` where source_lines maps display path
    -> list of lines (needed for baseline fingerprints).
    """
    findings: List[Finding] = []
    source_lines: Dict[str, List[str]] = {}
    for f in iter_py_files(paths):
        disp = display_path(f, root)
        try:
            src = f.read_text()
            mod = Module.parse(disp, src)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding("syntax", disp, getattr(e, "lineno", 0) or 0,
                                    0, f"cannot parse: {e}"))
            continue
        source_lines[disp] = mod.lines
        findings.extend(lint_module(mod))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, source_lines
