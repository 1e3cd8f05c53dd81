"""No module of the benchmark imports JAX or the JAX package; the plain
references and the traffic generator import nothing of the program, of
``chip_smoke`` or of the repository's tests either. Names compare by
the whole top-level name (the part before the first dot), so the port,
``data_accelerator_tpu_torch``, is not the JAX package."""

import ast
from pathlib import Path

import pytest

from streambench.harness import HERE

NEVER = {"jax", "jaxlib", "flax", "data_accelerator_tpu"}
NOT_IN_REFERENCE = NEVER | {"data_accelerator_tpu_torch", "chip_smoke", "tests", "torch"}
MODULES = sorted(p for p in HERE.rglob("*.py") if ".cache" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_modules_are_found():
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize(
    "path",
    [p for p in MODULES if p.parent.name in ("reference", "traffic")],
    ids=lambda p: str(p.relative_to(HERE)),
)
def test_references_and_generator_import_nothing_of_the_program(path):
    assert not top_level_imports(path) & NOT_IN_REFERENCE


def test_the_port_passes_the_whole_name_comparison(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import data_accelerator_tpu_torch.runtime\nfrom jax import numpy\n")
    assert top_level_imports(p) == {"data_accelerator_tpu_torch", "jax"}
    assert top_level_imports(p) & NEVER == {"jax"}
