"""CLI: ``python -m repro_torch.lint [paths...] [options]``.

Exit status: 0 when no unsuppressed findings remain, 1 otherwise (2 on bad
usage). Default target is the repo's ``src/repro_torch`` tree. ``--stacks``
additionally builds the port's shipped reconfigurable stacks (router Select,
trainer transport Select) and runs the runtime stack verifier
over them. ``--json`` writes the full findings report for CI artifacts.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import RULES, lint_paths
from .findings import apply_baseline, load_baseline, write_baseline
from .rules_stack import builtin_stacks, verify_stack


def _default_root() -> Path:
    # src/repro_torch/lint/__main__.py -> repo root is parents[3]
    here = Path(__file__).resolve()
    root = here.parents[3]
    return root if (root / "src" / "repro_torch").is_dir() else Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="static stack/concurrency/port-boundary verification")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on any unsuppressed finding")
    ap.add_argument("--stacks", action="store_true",
                    help="also verify the shipped reconfigurable stacks")
    ap.add_argument("--json", metavar="OUT",
                    help="write a JSON findings report")
    ap.add_argument("--baseline", metavar="PATH",
                    help="drop findings recorded in this baseline file")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="record current findings as the new baseline")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, doc in sorted(RULES.items()):
            print(f"{rule:26s} {doc}")
        return 0

    root = _default_root()
    paths = args.paths or [str(root / "src" / "repro_torch")]
    findings, source_lines = lint_paths(paths, root=root)

    if args.baseline:
        findings = apply_baseline(findings, load_baseline(args.baseline),
                                  source_lines)
    if args.write_baseline:
        write_baseline(args.write_baseline, findings, source_lines)
        print(f"baseline: {len(findings)} finding(s) -> {args.write_baseline}")
        return 0

    stack_results = {}
    if args.stacks:
        for name, stack in builtin_stacks().items():
            fs = verify_stack(stack, name)
            stack_results[name] = len(fs)
            findings.extend(fs)

    for f in findings:
        print(f.format())

    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        report = {
            "n_findings": len(findings),
            "strict": bool(args.strict),
            "paths": paths,
            "stacks_verified": stack_results,
            "findings": [f.to_json() for f in findings],
        }
        out.write_text(json.dumps(report, indent=2) + "\n")

    n = len(findings)
    tail = f" over {len(source_lines)} file(s)"
    if args.stacks:
        tail += f", {len(stack_results)} stack(s) verified"
    print(f"repro_torch.lint: {n} finding(s){tail}")
    if n and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
