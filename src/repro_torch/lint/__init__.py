"""repro_torch.lint — static verification for the reconfigurable network
stack, over the port.

The counterpart of ``src/repro/lint/``, with its engine, pragmas, baseline
and rules, scoped to ``src/repro_torch``. Three analyzer families:

  stack verifier   migration-hook signatures (AST) + capability closure,
                   swap-name alignment, dead Select options and semantic
                   ordering on real ``Stack`` objects (``verify_stack``)
  concurrency      lock graphs, blocking calls under a held lock, unguarded
                   shared-attribute writes
  port/hygiene     ctypes, triton or a CUDA build outside backend.py and
                   kernels/*/, imports of jax or the reference package,
                   silent exception swallows, mutable default args (the
                   port rules take the place of the reference's JAX-version
                   boundary, which has no counterpart here)

CLI: ``python -m repro_torch.lint [paths] [--strict] [--stacks] [--json OUT]``.
Suppress a finding in place with ``# lint: allow[rule] reason`` (the reason
is mandatory); adopt legacy debt with ``--write-baseline``/``--baseline``.
"""
from .engine import RULES, lint_module, lint_paths, lint_sources, Module
from .findings import Finding, PragmaMap, load_baseline, write_baseline
from .rules_stack import builtin_stacks, verify_stack

__all__ = [
    "RULES", "Finding", "Module", "PragmaMap", "builtin_stacks",
    "lint_module", "lint_paths", "lint_sources", "load_baseline",
    "verify_stack", "write_baseline",
]
