"""The PyTorch port stands alone: no module of ``data_accelerator_tpu_torch``,
no UDF fixture of the port (``tests/data/udfs_torch/``) and not
``chip_smoke.py`` imports JAX or anything of the JAX package, or names a
path into the JAX package's ``native/`` decoder sources: the port builds
its own copy, ``data_accelerator_tpu_torch/csrc/decoder.cpp``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "data_accelerator_tpu_torch"
# _build/ holds what the kernels build into, never source
FIXTURE_DIR = ROOT / "tests" / "data" / "udfs_torch"
PORT_FILES = sorted(
    p for p in PORT_DIR.rglob("*.py") if "_build" not in p.relative_to(PORT_DIR).parts
) + sorted(FIXTURE_DIR.glob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "data_accelerator_tpu")
# the JAX package's decoder source and library, as a path would name them
REFERENCE_NATIVE = ("native/decoder.cpp", "libdxdecoder", '"native", "decoder.cpp"')


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_port_has_modules_and_smoke_script():
    assert len(PORT_FILES) > 20
    assert len(list(FIXTURE_DIR.glob("dx3*.py"))) == 7
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module,forbidden", [
    ("jax", True),
    ("jax.numpy", True),
    ("jaxlib.xla_client", True),
    ("data_accelerator_tpu", True),
    ("data_accelerator_tpu.udf.samples", True),
    ("data_accelerator_tpu_torch", False),
    ("data_accelerator_tpu_torch.udf.samples", False),
    ("torch", False),
])
def test_forbidden_rule(module, forbidden):
    assert _forbidden(module) is forbidden


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_no_path_into_reference_native_dir(path):
    text = path.read_text(encoding="utf-8")
    bad = [n for n in REFERENCE_NATIVE if n in text]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_decoder_source_is_the_port_copy():
    from data_accelerator_tpu_torch.kernels import build
    from data_accelerator_tpu_torch.native import decoder

    src = build.source_path(decoder.SOURCE, ".cpp")
    assert src == PORT_DIR / "csrc" / "decoder.cpp" and src.exists()


# the LiveQuery slice: the designer's kernels, the lq/ serving plane,
# schema inference and runtime storage
LIVEQUERY_MODULES = (
    "lq/__init__.py", "lq/session.py", "lq/coalescer.py", "lq/warmcache.py",
    "lq/service.py", "serve/livequery.py", "serve/storage.py",
    "serve/schemainference.py",
)


@pytest.mark.parametrize("rel", LIVEQUERY_MODULES)
def test_livequery_module_is_checked(rel):
    path = PORT_DIR / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_livequery_modules_load_no_jax():
    """Imported in a fresh interpreter, the LiveQuery modules (and all
    they import) leave JAX and the JAX package unloaded."""
    import subprocess
    import sys

    mods = ", ".join(
        "data_accelerator_tpu_torch." + rel[:-3].replace("/", ".").replace(".__init__", "")
        for rel in LIVEQUERY_MODULES
    )
    code = (
        f"import sys, importlib\n"
        f"for m in {mods!r}.split(', '): importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# the modules of the debug runtime and the device-plan tier
SLICE_7A = (
    "data_accelerator_tpu_torch.runtime.sanitizer",
    "data_accelerator_tpu_torch.runtime.debugguard",
    "data_accelerator_tpu_torch.analysis.analyzer",
    "data_accelerator_tpu_torch.analysis.typeprop",
    "data_accelerator_tpu_torch.analysis.diagnostics",
    "data_accelerator_tpu_torch.analysis.costmodel",
    "data_accelerator_tpu_torch.analysis.deviceplan",
    "data_accelerator_tpu_torch.analysis.chipcount",
    "data_accelerator_tpu_torch.analysis.__main__",
    "data_accelerator_tpu_torch.compile.codegen",
    "data_accelerator_tpu_torch.serve.flowbuilder",
)


def test_slice_7a_modules_load_without_jax():
    """Each module of the slice imports in a fresh interpreter and
    leaves neither JAX nor the JAX package loaded."""
    import subprocess
    import sys

    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_7A!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for m in SLICE_7A:
        assert (ROOT / (m.replace(".", "/") + ".py")).exists(), m


# the source-scanning tiers, the compile and fleet tiers, the chaos
# injectors and the pilot replay CLI
SLICE_7B = (
    "analysis/racecheck.py", "analysis/protocheck.py", "analysis/confcheck.py",
    "compile/flattener_schema.py", "pilot/chaos.py", "pilot/__main__.py",
    "analysis/compilecheck.py", "analysis/fleetcheck.py",
)


@pytest.mark.parametrize("rel", SLICE_7B)
def test_slice_7b_module_is_checked(rel):
    path = PORT_DIR / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_slice_7b_modules_load_without_jax():
    """Each module of the slice imports in a fresh interpreter and
    leaves neither JAX nor the JAX package loaded."""
    import subprocess
    import sys

    mods = tuple("data_accelerator_tpu_torch." + rel[:-3].replace("/", ".")
                 for rel in SLICE_7B)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
