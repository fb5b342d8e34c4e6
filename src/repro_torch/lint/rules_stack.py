"""Stack verifier: static + runtime checks on chunnel/stack definitions.

Static half (AST, runs over every linted file): migration-hook signatures.
``ConnHandle._do_swap`` calls ``migrate_state(old_datapath)`` and duck-types
``restore_state(state)``; ``ReconfigParticipant`` calls ``apply_state(state)``.
A hook with the wrong arity only explodes mid-swap — exactly the moment the
paper promises is safe — so we reject it at lint time.

Runtime half (``verify_stack``): instantiable checks on a real ``Stack``
object, reached via ``python -m repro_torch.lint --stacks`` and the tests:

  stack-dead-option         a Select combination the Stack silently drops
                            (Stack.options() swallows StackTypeError combos;
                            a dead alternative is almost always a typo)
  stack-capability-closure  two options differ in an exact capability carried
                            by a non-multilateral chunnel — the runtime could
                            swap unilaterally and break the wire contract
  stack-swap-alignment      one chunnel name maps to different classes across
                            options (migrate_state aligns old->new state BY
                            NAME), or is duplicated within one option
  stack-semantic-order      semantic classes out of order top-down (e.g.
                            reliability above compression re-adds redundancy
                            the compressor just removed)
  stack-migrate-signature   (runtime variant) a shipped chunnel class overrides
                            a migration hook with the wrong arity
"""
from __future__ import annotations

import ast
import inspect
from typing import Dict, List

from .engine import Module, analyzer
from .findings import Finding

_MIGRATION_HOOKS = {
    "migrate_state": "(self, old)",
    "apply_state": "(self, state)",
    "restore_state": "(self, state)",
}

#: semantic class order, TOP of the stack first. A chunnel's classes are the
#: ``<feature>:`` prefixes of its capability labels; a class earlier in this
#: list must never sit *below* a later one. Unknown features are skipped.
SEMANTIC_ORDER = [
    "serialize",
    "order",
    "compression",
    "encryption",
    "reliability",
    "route",
    "layout",
    "transport",
    "wire",
    "pubsub",
]


def _hook_arity_ok(n_pos: int, has_vararg: bool, hook: str) -> bool:
    return n_pos == 2 and not has_vararg


@analyzer
def check_migration_signatures(mod: Module) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for item in node.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            expected = _MIGRATION_HOOKS.get(item.name)
            if expected is None:
                continue
            if any(isinstance(d, ast.Name) and d.id == "staticmethod"
                   for d in item.decorator_list):
                continue
            a = item.args
            n_pos = len(a.posonlyargs) + len(a.args)
            if not _hook_arity_ok(n_pos, a.vararg is not None, item.name):
                out.append(Finding(
                    "stack-migrate-signature", mod.path, item.lineno,
                    item.col_offset,
                    f"{node.name}.{item.name} must take exactly {expected} — "
                    f"the swap machinery calls it with one argument"))
    return out


# ---------------------------------------------------------------------------
# Runtime stack verification
# ---------------------------------------------------------------------------


def _classes_of(ch) -> List[str]:
    feats = []
    for cap in ch.capabilities():
        feat = cap.label.split(":", 1)[0] if ":" in cap.label else None
        if feat in SEMANTIC_ORDER and feat not in feats:
            feats.append(feat)
    return feats


def verify_stack(stack, name: str = "stack") -> List[Finding]:
    """Verify a real ``repro_torch.core.Stack`` (or anything with ``.entries`` and
    ``.options()``). Findings use the synthetic path ``<stack:name>``."""
    from repro_torch.core.stack import ConcreteStack, StackTypeError, _expand

    path = f"<stack:{name}>"

    def finding(rule: str, msg: str) -> Finding:
        return Finding(rule, path, 0, 0, msg)

    out: List[Finding] = []

    # dead options: re-run the expansion Stack.options() silently filters
    for combo in _expand(tuple(stack.entries)):
        try:
            ConcreteStack(combo)
        except StackTypeError as e:
            out.append(finding(
                "stack-dead-option",
                "Select combination [" + " -> ".join(c.name for c in combo)
                + f"] can never instantiate: {e}"))

    options = stack.options()

    # migration hook arity on every shipped chunnel class
    seen_classes = set()
    for opt in options:
        for ch in opt.chunnels:
            cls = type(ch)
            if cls in seen_classes:
                continue
            seen_classes.add(cls)
            for hook, expected in _MIGRATION_HOOKS.items():
                fn = getattr(cls, hook, None)
                if fn is None:
                    continue
                try:
                    params = list(inspect.signature(fn).parameters.values())
                except (TypeError, ValueError):
                    continue
                pos = [p for p in params if p.kind in
                       (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
                var = any(p.kind == p.VAR_POSITIONAL for p in params)
                if not _hook_arity_ok(len(pos), var, hook):
                    out.append(finding(
                        "stack-migrate-signature",
                        f"{cls.__name__}.{hook} must take exactly {expected}"))

    # swap alignment: name -> class consistent across options, unique within
    name_class: Dict[str, type] = {}
    for i, opt in enumerate(options):
        names_here = set()
        for ch in opt.chunnels:
            if ch.name in names_here:
                out.append(finding(
                    "stack-swap-alignment",
                    f"option {i} uses chunnel name {ch.name!r} twice — "
                    "migrate_state aligns old->new state by name"))
            names_here.add(ch.name)
            prev = name_class.setdefault(ch.name, type(ch))
            if prev is not type(ch):
                out.append(finding(
                    "stack-swap-alignment",
                    f"chunnel name {ch.name!r} maps to {prev.__name__} in one "
                    f"option and {type(ch).__name__} in another — a swap "
                    "would hand one class's state to the other"))

    # capability closure: exact labels that differ between two options must
    # come from multilateral chunnels (the swap needs negotiated agreement)
    for i in range(len(options)):
        for j in range(i + 1, len(options)):
            a, b = options[i], options[j]
            diff = (a.capabilities().exact_labels()
                    ^ b.capabilities().exact_labels())
            if not diff:
                continue
            for opt, idx in ((a, i), (b, j)):
                for ch in opt.chunnels:
                    bad = [l for l in ch.capabilities().exact_labels()
                           if l in diff]
                    if bad and not ch.multilateral:
                        out.append(finding(
                            "stack-capability-closure",
                            f"options {i} and {j} differ in exact "
                            f"capabilities {sorted(bad)} carried by "
                            f"non-multilateral {ch.name!r} — swapping would "
                            "change the wire contract without agreement"))

    # semantic ordering, top-down within each option
    for i, opt in enumerate(options):
        chs = list(opt.chunnels)
        for u in range(len(chs)):
            for v in range(u + 1, len(chs)):
                for cu in _classes_of(chs[u]):
                    for cv in _classes_of(chs[v]):
                        if SEMANTIC_ORDER.index(cu) > SEMANTIC_ORDER.index(cv):
                            out.append(finding(
                                "stack-semantic-order",
                                f"option {i}: {chs[u].name!r} ({cu}) sits "
                                f"above {chs[v].name!r} ({cv}) but class "
                                f"{cu!r} belongs below {cv!r}"))
    # dedupe (the pairwise loops can repeat a message)
    seen, uniq = set(), []
    for f in out:
        if f.message not in seen:
            seen.add(f.message)
            uniq.append(f)
    return uniq


def builtin_stacks() -> Dict[str, object]:
    """The port's shipped reconfigurable stacks, built for verification.

    Imports are local: comm.chunnels pulls in torch, and the router stack
    needs a throwaway fabric endpoint. The transports whose wire runs a
    kernel take ``device=``; they get ``device="cpu"`` (the verifier reads
    names, types and capabilities, and moves no tensor), so verification
    needs no GPU.
    """
    from repro_torch.comm.chunnels import DEVICE_TRANSPORTS, TRANSPORTS
    from repro_torch.core import Fabric, Select, make_stack
    from repro_torch.serving.router import routing_stack

    fab = Fabric()
    ep = fab.register("lint-probe")
    return {
        "router": routing_stack(ep, ["b0", "b1"]),
        "trainer-transports": make_stack(
            Select(*[cls(device="cpu") if name in DEVICE_TRANSPORTS else cls()
                     for name, cls in TRANSPORTS.items()])),
    }
