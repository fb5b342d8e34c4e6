"""The reference's own test classes, run against the port.

``mirror("test_x.py", ["TestA", ...])`` reads ``tests/test_x.py``, applies
the stated source edits (each must match), reads every ``repro`` import as
``repro_torch``, drops ``@pytest.mark.slow`` (tier-1 runs them anyway),
executes the result as a module of its own and returns the named classes and
fixtures. A port test file binds them at its top level, so pytest collects
the reference's scenarios, with the reference's own assertions, on the port.
The reference's tests themselves run unchanged from their own files.

The port's test files define their own ``seeded_fabric`` and
``virtual_clock`` fixtures (from ``repro_torch``), which take precedence over
the reference's in ``tests/conftest.py``.
"""
from __future__ import annotations

import re
import sys
import types
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

TESTS = Path(__file__).resolve().parent

#: the port's ``device=`` in place of the reference's ``use_kernel=False``
CPU_WIRE = (('kw.setdefault("use_kernel", False)', 'kw.setdefault("device", "cpu")'),
            ("use_kernel=False", 'device="cpu"'))


def port_source(test_file: str, edits: Iterable[Tuple[str, str]] = ()) -> str:
    src = (TESTS / test_file).read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{test_file}: edit target {old!r} not found")
        src = src.replace(old, new)
    src = re.sub(r"\brepro(?=\.[A-Za-z_])", "repro_torch", src)
    src = re.sub(r"\bfrom repro import\b", "from repro_torch import", src)
    return re.sub(r"^[ \t]*@pytest\.mark\.slow\n", "", src, flags=re.M)


def mirror(test_file: str, names: Sequence[str],
           edits: Iterable[Tuple[str, str]] = ()) -> Dict[str, object]:
    """The port's copies of ``names`` (classes, fixtures, helpers) from
    ``tests/<test_file>``."""
    mod_name = f"port_mirror_{Path(test_file).stem}"
    mod = types.ModuleType(mod_name)
    mod.__file__ = str(TESTS / test_file)
    sys.modules[mod_name] = mod
    code = compile(port_source(test_file, edits), str(TESTS / test_file), "exec")
    exec(code, mod.__dict__)
    return {name: getattr(mod, name) for name in names}
