"""``repro_torch.lint`` against the reference's own lint tests.

Every class of ``tests/test_lint.py`` but ``TestCompatBoundary`` runs on the
port through ``port_mirror``: its fixtures moved under ``src/repro_torch``
(where the port's rules scope), its CI contract held over ``src/repro_torch``.
The port rules that take the JAX-version boundary's place,
``kernel-boundary`` and ``reference-import``, get their own good/bad pairs.
"""
import subprocess
import sys
from pathlib import Path

from port_mirror import mirror
from repro_torch.lint import lint_paths, lint_sources

REPO = Path(__file__).resolve().parents[1]

_CLASSES = ["TestMigrateSignature", "TestVerifyStack", "TestLockOrder",
            "TestBlockingUnderLock", "TestUnguardedAttr", "TestHygiene", "TestPragmas",
            "TestBaseline", "TestRepoIsClean", "TestCLI", "TestPerMessageHotPath",
            "TestSpanInHotLoop", "TestObsHotClasses"]
_M = mirror("test_lint.py", _CLASSES, edits=[
    ('SRC = REPO / "src" / "repro"\n', 'SRC = REPO / "src" / "repro_torch"\n'),
    ('CORE = "src/repro/core/fixture.py"', 'CORE = "src/repro_torch/core/fixture.py"'),
    ('assert lint_sources({"src/repro/models/x.py": src}) == []',
     'assert lint_sources({"src/repro_torch/models/x.py": src}) == []'),
    ('d = tmp_path / "repro" / "core"', 'd = tmp_path / "repro_torch" / "core"'),
    ('OBS = "src/repro/obs/fixture.py"', 'OBS = "src/repro_torch/obs/fixture.py"'),
    ('for rule in ("lock-order", "compat-boundary", "stack-dead-option"):',
     'for rule in ("lock-order", "kernel-boundary", "stack-dead-option"):'),
])
globals().update(_M)


def rules_of(findings):
    return {f.rule for f in findings}


class TestKernelBoundary:
    """``ctypes``, ``triton``, ``torch.utils.cpp_extension`` and ``nvcc``
    only in ``backend.py`` and ``kernels/*/``."""

    BAD = {
        "ctypes": "import ctypes\nlib = ctypes.CDLL('x.so')\n",
        "ctypes alias": "import ctypes as C\n",
        "from ctypes": "from ctypes import c_void_p\n",
        "triton": "import triton.language as tl\n",
        "cpp_extension": "from torch.utils.cpp_extension import load_inline\n",
        "nvcc": "import subprocess\nsubprocess.run(['/usr/local/cuda/bin/nvcc', '-o', 'x'])\n",
    }

    def test_flagged_outside_the_kernel_homes(self):
        for what, src in self.BAD.items():
            for path in ("src/repro_torch/comm/x.py", "src/repro_torch/models/x.py",
                         "src/repro_torch/kernels/x.py"):
                assert rules_of(lint_sources({path: src})) == {"kernel-boundary"}, (what, path)

    def test_allowed_in_backend_and_kernel_directories(self):
        for src in self.BAD.values():
            for path in ("src/repro_torch/backend.py",
                         "src/repro_torch/kernels/quantize/quantize.py",
                         "src/repro_torch/kernels/newkernel/wrapper.py"):
                assert lint_sources({path: src}) == [], path

    def test_outside_the_port_not_flagged(self):
        for src in self.BAD.values():
            assert lint_sources({"tests/x.py": src}) == []

    def test_plain_torch_and_docs_not_flagged(self):
        src = ('"""Built with nvcc by backend.py."""\nimport torch\n'
               'from repro_torch.kernels.quantize.quantize import quantize_pack\n'
               'x = torch.zeros(3)\nprint("nvcc is not called here")\n')
        assert lint_sources({"src/repro_torch/comm/x.py": src}) == []

    def test_shipped_kernel_homes_are_the_only_users(self):
        """Today exactly backend.py and the four kernel libraries' wrappers
        use ctypes or nvcc, and the rule passes them."""
        src = REPO / "src" / "repro_torch"
        # a file uses them when the rule fires on it placed outside the homes
        users = sorted(str(p.relative_to(src)) for p in src.rglob("*.py")
                       if lint_sources({"src/repro_torch/comm/probe.py": p.read_text()}))
        assert users == ["backend.py", "kernels/adamw/adamw.py",
                         "kernels/flash_attention/flash_attention.py",
                         "kernels/quantize/quantize.py", "kernels/ssm_scan/ssm_scan.py"]
        findings, _ = lint_paths([str(src / u) for u in users], root=REPO)
        assert findings == [], [f.format() for f in findings]


class TestReferenceImport:
    def test_jax_and_repro_flagged(self):
        for src in ("import jax\n", "import jax.numpy as jnp\n", "from jax import lax\n",
                    "import repro\n", "from repro.comm import wire\n",
                    "import repro.core.fabric as F\n"):
            assert rules_of(lint_sources({"src/repro_torch/comm/x.py": src})) == {
                "reference-import"}, src
        assert rules_of(lint_sources({"src/repro_torch/backend.py": "import jax\n"})) == {
            "reference-import"}

    def test_the_port_itself_not_flagged(self):
        src = "import repro_torch\nfrom repro_torch.comm import wire\nimport torch\n"
        assert lint_sources({"src/repro_torch/comm/x.py": src}) == []

    def test_reference_files_not_flagged(self):
        assert lint_sources({"src/repro/comm/x.py": "import jax\n"}) == []


def test_strict_cli_fires_on_a_ctypes_import(tmp_path):
    """``python -m repro_torch.lint --strict`` exits 1 on a ctypes import
    placed outside the kernel homes, and 0 over the shipped port."""
    bad = tmp_path / "repro_torch" / "serving" / "fast.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import ctypes\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.lint", "--strict", str(bad)],
                       capture_output=True, text=True, cwd=REPO, env=env)
    assert r.returncode == 1 and "kernel-boundary" in r.stdout, r.stdout + r.stderr
    r = subprocess.run([sys.executable, "-m", "repro_torch.lint", "--strict"],
                       capture_output=True, text=True, cwd=REPO, env=env)
    assert r.returncode == 0 and "0 finding(s)" in r.stdout, r.stdout + r.stderr
