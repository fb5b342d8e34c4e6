"""Nothing of the benchmark loads JAX or the JAX package (top-level names
compared whole: ``repro_torch`` begins with ``repro``), the references import
nothing of the program, and nothing reads the JAX benchmarks' folder."""
import pytest

from portbench import guard, spec

FILES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not guard.imports_of(path) & guard.FORBIDDEN
    assert "bench" + "marks/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    assert guard.imports_of(path) <= {"__future__", "math", "typing", "torch", "portbench"}
    text = path.read_text()
    assert "repro_torch" not in text.replace("``repro_torch", "")
    for line in text.splitlines():
        if line.startswith(("from portbench", "import portbench")):
            assert line.startswith("from portbench.reference")


def test_whole_top_level_names_are_compared():
    assert guard.loaded(["repro_torch", "repro_torch.models", "jaxtyping", "reprox"]) == []
    assert guard.loaded(["repro.models", "jax.numpy", "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "repro"]
