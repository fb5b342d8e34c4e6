"""The port stands alone: nothing under ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``, and the
package imports in a process where both are blocked."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCANNED = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert FORBIDDEN.isdisjoint(imported_roots(path))


def test_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "import repro_torch.backend, repro_torch.core, repro_torch.comm.wire\n"
            "import repro_torch.comm.session, repro_torch.obs\n"
            "import repro_torch.models.transformer, repro_torch.models.convert\n"
            "import repro_torch.launch.serve, repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.flash_attention.flash_attention\n"
            "import repro_torch.kernels.ssm_scan.ssm_scan\n"
            "import repro_torch.models.ssm, repro_torch.models.hymba\n"
            "import repro_torch.comm, repro_torch.comm.chunnels, repro_torch.chaos\n"
            "import repro_torch.serving.gateway, repro_torch.serving.pubsub\n"
            "import repro_torch.serving.router, repro_torch.fleet\n"
            "import repro_torch.obs.calibrate, repro_torch.obs.federate\n"
            "import repro_torch.obs.scenario, repro_torch.obs.__main__\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_package(tmp_path, where):
    """Here (no GPU) and in a directory with nothing else of the repo,
    chip_smoke.py exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if where == "repo":
        torch = pytest.importorskip("torch")
        if torch.cuda.is_available():
            pytest.skip("a GPU is present, so chip_smoke.py runs in the repo")
    else:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
