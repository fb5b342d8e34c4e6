"""What the benchmark must never load: JAX, its libraries and the JAX
package that the program was ported from, compared by whole top-level
module name (the port's own name begins with the JAX package's)."""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names if top(m) in FORBIDDEN})


def imports_of(path: Path) -> Set[str]:
    """The top-level names a Python file imports (relative imports excluded)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out
