"""No module of the benchmark imports JAX or the JAX package; the plain
references and the traffic generator import nothing of the program, of
``chip_smoke`` or of the repository's tests either. Names compare by
the whole top-level name (the part before the first dot), so the port,
``data_accelerator_tpu_torch``, is not the JAX package.

A reference may be plain NumPy or plain PyTorch on the CPU. One that
imports torch turns TF32 off for matmuls and cuDNN when it is imported,
and names the device of every tensor it builds, so that the program's
process-wide settings cannot reach it. The generator, which runs as a
process of its own, imports no torch."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from streambench.harness import HERE, ROOT

NEVER = {"jax", "jaxlib", "flax", "data_accelerator_tpu"}
NOT_IN_REFERENCE = NEVER | {"data_accelerator_tpu_torch", "chip_smoke", "tests"}
NOT_IN_TRAFFIC = NOT_IN_REFERENCE | {"torch"}
# torch's factories that take a device; torch.from_numpy is on the CPU
FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange"}
MODULES = sorted(p for p in HERE.rglob("*.py") if ".cache" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def factories_without_device(path: Path) -> list:
    """The lines of ``torch.<factory>(...)`` calls that name no device."""
    return [node.lineno for node in ast.walk(ast.parse(path.read_text(encoding="utf-8")))
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in FACTORIES and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "torch"
            and not any(k.arg == "device" for k in node.keywords)]


def tf32_after_import(root: Path, path: Path) -> dict:
    """Both TF32 flags after importing ``path`` (under the benchmark
    package at ``root``) in a fresh process that had turned them on."""
    probe = (
        "import importlib.util, json, sys, torch\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        f"spec = importlib.util.spec_from_file_location('ref', {str(path)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps({'matmul': torch.backends.cuda.matmul.allow_tf32,\n"
        "                  'cudnn': torch.backends.cudnn.allow_tf32}))\n"
    )
    p = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=120, check=True)
    return json.loads(p.stdout.splitlines()[-1])


def reference_faults(root: Path, path: Path) -> list:
    """What breaks the contract of a reference file (empty: none)."""
    imports = top_level_imports(path)
    faults = sorted(imports & NOT_IN_REFERENCE)
    if "torch" in imports:
        faults += [f"no device at line {n}" for n in factories_without_device(path)]
        faults += [f"TF32 left on for {k}"
                   for k, on in tf32_after_import(root, path).items() if on]
    return faults


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
    banned = NOT_IN_TRAFFIC if path.parent.name == "traffic" else NOT_IN_REFERENCE
    assert not top_level_imports(path) & banned


def test_every_reference_keeps_the_contract():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert reference_faults(ROOT, path) == [], path.name


BAD = {
    "jax": "import jax\n",
    "port": "from data_accelerator_tpu_torch.runtime import host\n",
    "jax_package": "import data_accelerator_tpu.runtime\n",
    "chip_smoke": "import chip_smoke\n",
    "tests": "from tests import test_torch_flow\n",
    "tf32_on": "import torch\nx = torch.zeros(3, dtype=torch.float32, device='cpu')\n",
    "no_device": ("import torch\ntorch.backends.cuda.matmul.allow_tf32 = False\n"
                  "torch.backends.cudnn.allow_tf32 = False\n"
                  "x = torch.arange(3, dtype=torch.float64)\n"),
}
GOOD = ("import numpy as np\nimport torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "x = torch.full((3,), 1.5, dtype=torch.float32, device='cpu')\n"
        "y = torch.from_numpy(np.zeros(3))\n")


@pytest.mark.parametrize("kind", sorted(BAD))
def test_the_contract_rejects_a_reference_that_breaks_it(tmp_path, kind):
    p = tmp_path / "ref.py"
    p.write_text(BAD[kind])
    assert reference_faults(tmp_path, p)


def test_the_contract_takes_a_plain_pytorch_reference(tmp_path):
    p = tmp_path / "ref.py"
    p.write_text(GOOD)
    assert reference_faults(tmp_path, p) == []


def test_the_generator_may_not_import_torch(tmp_path):
    p = tmp_path / "gen.py"
    p.write_text("import numpy\nimport torch.nn\n")
    assert top_level_imports(p) & NOT_IN_TRAFFIC == {"torch"}
    assert not top_level_imports(p) & NOT_IN_REFERENCE


def test_the_port_passes_the_whole_name_comparison(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import data_accelerator_tpu_torch.runtime\nfrom jax import numpy\n")
    assert top_level_imports(p) == {"data_accelerator_tpu_torch", "jax"}
    assert top_level_imports(p) & NEVER == {"jax"}
