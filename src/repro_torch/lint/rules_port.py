"""Port rules: where the port may reach the card's toolchain, and what it may
not import. They take the place of the reference's JAX-version boundary
(``src/repro/lint/rules_compat.py``), which has no counterpart in the port.

  kernel-boundary   ``ctypes``, ``triton``, ``torch.utils.cpp_extension`` or
                    an ``nvcc`` build appear only in
                    ``src/repro_torch/backend.py`` (the build and the load of
                    the Hopper kernels) and ``src/repro_torch/kernels/*/``
                    (each kernel's wrapper). Anywhere else a module would
                    bind a kernel past its wrapper, whose launch counter and
                    plain-version route on the CPU the tests and
                    ``chip_smoke.py`` rely on.
  reference-import  nothing in the port imports ``jax`` or the reference
                    package ``repro``: the port runs where JAX is absent
                    (``tests/test_torch_boundary.py`` holds the same rule
                    over the installed package).

The import checks resolve aliases (``collect_import_aliases``), so ``import
ctypes as C`` and ``from triton import language`` are both caught.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from .engine import Module, analyzer
from .findings import Finding

#: module roots that reach the card past a kernel's wrapper
KERNEL_MODULES = ("ctypes", "triton", "torch.utils.cpp_extension")
#: module roots the port must not import
REFERENCE_MODULES = ("jax", "repro")


def collect_import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> fully dotted path it denotes, from import statements.

    ``import jax.lax`` binds ``jax``; ``from jax import lax as L`` binds
    ``L`` -> ``jax.lax``; relative imports are ignored.
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    aliases[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _in_port(path: str) -> bool:
    return "repro_torch/" in _norm(path)


def _kernel_home(path: str) -> bool:
    """``backend.py`` or a file inside one kernel's directory under
    ``kernels/``."""
    tail = _norm(path).split("repro_torch/", 1)[-1]
    return tail == "backend.py" or (tail.startswith("kernels/") and tail.count("/") >= 2)


def _under(module: str, roots) -> str:
    for root in roots:
        if module == root or module.startswith(root + "."):
            return root
    return ""


def _imported(tree: ast.AST):
    """(node, dotted module) of every absolute import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            for a in node.names:
                yield node, f"{node.module}.{a.name}"


def _names_nvcc(node: ast.Call) -> bool:
    """A call with a string argument naming ``nvcc`` (a command, a path to
    it, or an argument list that holds one)."""
    for arg in list(node.args) + [kw.value for kw in node.keywords]:
        for sub in ast.walk(arg):
            if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                    and sub.value.rsplit("/", 1)[-1] == "nvcc"):
                return True
    return False


@analyzer
def check_port_boundary(mod: Module) -> List[Finding]:
    if not _in_port(mod.path):
        return []
    out: List[Finding] = []
    home = _kernel_home(mod.path)
    for node, module in _imported(mod.tree):
        root = _under(module, REFERENCE_MODULES)
        if root:
            out.append(Finding(
                "reference-import", mod.path, node.lineno, node.col_offset,
                f"import of {module}: the port imports neither jax nor the "
                "reference package, and keeps its own copy of what it needs"))
        root = _under(module, KERNEL_MODULES)
        if root and not home:
            out.append(Finding(
                "kernel-boundary", mod.path, node.lineno, node.col_offset,
                f"import of {module} outside backend.py and kernels/*/ — reach "
                "a kernel through its wrapper"))
    if not home:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and _names_nvcc(node):
                out.append(Finding(
                    "kernel-boundary", mod.path, node.lineno, node.col_offset,
                    "an nvcc build outside backend.py — kernels are built by "
                    "repro_torch.backend"))
    seen, uniq = set(), []
    for f in out:
        key = (f.rule, f.line, f.message)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq
