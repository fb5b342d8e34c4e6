"""Findings, suppression pragmas, and the baseline model for ``repro_torch.lint``.

A Finding is one rule violation at one source location. Suppression is inline
and local: a ``# lint: allow[rule] reason`` pragma on the offending line (or
the line directly above it) silences that rule there — and ONLY there. The
reason is mandatory; an empty reason is itself a finding, so every suppression
in the tree carries a written justification.

Baselines exist for adopting the linter on a codebase with pre-existing debt:
``--write-baseline`` records fingerprints of current findings, and later runs
drop any finding whose fingerprint is baselined. Fingerprints hash the rule,
the file, and the *stripped source line* — not the line number — so baselined
findings survive unrelated edits above them but resurface if the flagged code
itself changes. This repo ships with no baseline: everything the linter
surfaced was either fixed or pragma-annotated.
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set

#: matches a comment of the form "lint: allow[rule-a,rule-b] justification"
PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\[([^\]]*)\]\s*(.*)$")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int  # 1-based; 0 for whole-file / synthetic (runtime stack) findings
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def fingerprint(self, source_line: str = "") -> str:
        h = hashlib.sha1()
        h.update(self.rule.encode())
        h.update(b"\0")
        h.update(self.path.encode())
        h.update(b"\0")
        h.update(source_line.strip().encode())
        return h.hexdigest()[:16]


def _comment_lines(source: str):
    """(lineno, text) of real COMMENT tokens — a pragma quoted inside a
    docstring (e.g. documentation of the pragma syntax itself) is not a
    pragma. Falls back to raw lines if the file does not tokenize."""
    import io
    import tokenize
    try:
        return [(tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(io.StringIO(source).readline)
                if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return list(enumerate(source.splitlines(), start=1))


@dataclass
class Pragma:
    line: int
    rules: List[str]
    reason: str
    used: bool = False


class PragmaMap:
    """All ``lint: allow`` pragmas in one file, by line."""

    def __init__(self, source: str):
        self.by_line: Dict[int, Pragma] = {}
        for i, text in _comment_lines(source):
            m = PRAGMA_RE.search(text)
            if m:
                rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
                self.by_line[i] = Pragma(i, rules, m.group(2).strip())

    def _match(self, line: int, rule: str) -> Optional[Pragma]:
        # a pragma covers its own line and the line directly below it (so it
        # can sit above a long statement without fighting the line length)
        for ln in (line, line - 1):
            p = self.by_line.get(ln)
            if p and rule in p.rules:
                return p
        return None

    def allows(self, finding: Finding) -> bool:
        p = self._match(finding.line, finding.rule)
        if p is None:
            return False
        p.used = True
        return True

    def allows_at(self, line: int, rule: str) -> bool:
        """Pragma lookup at an explicit line (the engine uses this to honor a
        pragma on a ``def`` line for every finding inside that function)."""
        p = self._match(line, rule)
        if p is None:
            return False
        p.used = True
        return True

    def problems(self, path: str, known_rules: Set[str]) -> List[Finding]:
        out = []
        for p in self.by_line.values():
            if not p.reason:
                out.append(Finding(
                    "pragma-missing-reason", path, p.line, 0,
                    "lint: allow pragma must carry a written justification"))
            for r in p.rules:
                if r not in known_rules:
                    out.append(Finding(
                        "pragma-unknown-rule", path, p.line, 0,
                        f"pragma names unknown rule {r!r}"))
        return out


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path) -> Set[str]:
    with open(path) as f:
        data = json.load(f)
    return {e["fingerprint"] for e in data.get("findings", [])}


def write_baseline(path, findings: Iterable[Finding],
                   source_lines: Dict[str, List[str]]) -> None:
    entries = []
    for f in sorted(findings, key=lambda x: (x.path, x.line, x.rule)):
        lines = source_lines.get(f.path, [])
        src = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        entries.append({"fingerprint": f.fingerprint(src), "rule": f.rule,
                        "path": f.path, "line": f.line,
                        "source": src.strip()})
    with open(path, "w") as fh:
        json.dump({"findings": entries}, fh, indent=2)
        fh.write("\n")


def apply_baseline(findings: List[Finding], fingerprints: Set[str],
                   source_lines: Dict[str, List[str]]) -> List[Finding]:
    kept = []
    for f in findings:
        lines = source_lines.get(f.path, [])
        src = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        if f.fingerprint(src) not in fingerprints:
            kept.append(f)
    return kept
