"""The PyTorch port stands alone: no module of ``data_accelerator_tpu_torch``,
no UDF fixture of the port (``tests/data/udfs_torch/``) and not
``chip_smoke.py`` imports JAX or anything of the JAX package, or names a
path into the JAX package's ``native/`` decoder sources: the port builds
its own copy, ``data_accelerator_tpu_torch/csrc/decoder.cpp``. Nor does
any string of theirs, nor the port's shipped job template and SPA, name
a JAX-package module (a class path, a ``-m`` argument), and the port's
UDF loader refuses a conf that does, before importing anything."""

import ast
import re
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


# the scenario runner and the JobRunner probe (slice 9b), and mesh
# execution (slice 8a)
SLICE_9B_8A = (
    "serve/scenario.py", "serve/jobrunner.py", "serve/scenarios.py",
    "dist/__init__.py", "dist/mesh.py", "dist/ingest.py",
)


@pytest.mark.parametrize("rel", SLICE_9B_8A)
def test_slice_9b_8a_module_is_checked(rel):
    path = PORT_DIR / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_slice_9b_8a_modules_load_without_jax():
    """Each module of the slices imports in a fresh interpreter and
    leaves neither JAX nor the JAX package loaded."""
    import subprocess
    import sys

    mods = tuple("data_accelerator_tpu_torch." + rel[:-3].replace("/", ".")
                 .replace(".__init__", "") for rel in SLICE_9B_8A)
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


REF_DIR = ROOT / "data_accelerator_tpu"
REF_MODULES = sorted(str(p.relative_to(REF_DIR)) for p in REF_DIR.rglob("*.py"))
# public top-level functions and classes of a JAX module that its
# counterpart leaves out on purpose, each JAX's own machinery with the
# reason; the port has every other one
JAX_ONLY_NAMES = {
    "analysis/compilecheck.py": {
        "lowering_digest": "hashes an entry's lowered StableHLO; the port's "
                           "digests hash the aten ops an entry runs on meta",
    },
    "analysis/confspec.py": {
        "render_conf_md": "renders the JAX package's CONF.md from its rows",
    },
    "dist/mesh.py": {
        "collective_summary": "parses XLA's compiled HLO text; the port's "
                              "census records the collectives its step runs",
        "summarize_compiled": "the census of a jax compiled executable",
    },
    "native/decoder.py": {
        "native_available": "says whether the JAX package falls back to its "
                            "Python decoder; the port's decoder builds or raises",
    },
    "runtime/processor.py": {
        "source_raw_form": "picks the raw form a jitted step is traced with",
        "packed_raw_struct": "the packed raw matrix as a jax ShapeDtypeStruct",
        "aval_signature": "describes a pytree of jax avals (a jit cache key)",
        "compile_entries_from_avals": "manifest entries from jax avals; the "
                                      "port's come from analysis/compilecheck.py",
        "set_jit_cache_cap": "the transfer-helper jit cache, which eager "
                             "PyTorch has no counterpart for",
        "drain_jit_evictions": "the transfer-helper jit cache's evictions",
        "helper_jit_cache_size": "the transfer-helper jit cache's size",
    },
    "udf/api.py": {
        "JaxUdf": "a jax.numpy UDF; the port's is TorchUdf",
        "JaxUdaf": "a jax.numpy UDAF; the port's is TorchUdaf",
        "PallasUdf": "a Pallas kernel UDF; the port's is CudaKernelUdf",
    },
}


def test_every_module_has_a_counterpart():
    """Every module of the JAX package has a counterpart in the port at
    the same relative path (the DX7xx mesh analyzer,
    ``analysis/meshcheck.py``, was the last), and every public top-level
    function and class of it is in that counterpart, but for the listed
    JAX-only names (``test_every_public_name_has_a_counterpart``)."""
    missing = [rel for rel in REF_MODULES if not (PORT_DIR / rel).exists()]
    assert missing == []
    assert set(JAX_ONLY_NAMES) <= set(REF_MODULES)


def _public_defs(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _top_level_names(path: Path):
    """Every name a module binds at its top level."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                names |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    """Function by function: the port's counterpart binds every public
    top-level function and class of the JAX module, but for the listed
    JAX-only names, which it must still lack (a stale entry fails)."""
    missing = _public_defs(REF_DIR / rel) - _top_level_names(PORT_DIR / rel)
    assert missing == set(JAX_ONLY_NAMES.get(rel, {}))


# a refusal naming the multi-GPU slice, or a claim that something is not
# ported: the port now has every module of the JAX package
SLICE_8_REFUSAL = re.compile(r"multi-GPU slice 8|not ported")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_slice_8_refusal_is_left(path):
    text = " ".join(path.read_text(encoding="utf-8").split())
    assert not SLICE_8_REFUSAL.findall(text)


def test_slice_8b_modules_load_without_jax():
    """The mesh analyzer and its consumers import in a fresh interpreter
    and leave neither JAX nor the JAX package loaded."""
    import subprocess
    import sys

    mods = ("data_accelerator_tpu_torch.analysis.meshcheck",
            "data_accelerator_tpu_torch.analysis.__main__",
            "data_accelerator_tpu_torch.obs.conformance",
            "data_accelerator_tpu_torch.obs.calibrate",
            "data_accelerator_tpu_torch.serve.generation")
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


# -- strings that name modules ----------------------------------------------------
# A JAX-package module as a string names it ``data_accelerator_tpu``, then
# ``.`` or ``:``, then an identifier: a dotted module path, a
# ``module:attr`` class path or a ``-m`` argument. A path into the
# package's files (``data_accelerator_tpu/serve/jobs.py``, as a copy's
# docstring names its reference) has ``/`` there instead, and the port's
# own package continues with ``_torch``: neither matches.
JAX_MODULE_STRING = re.compile(r"\bdata_accelerator_tpu(?=[.:][A-Za-z_])")
# what the port ships besides Python: its job template, the SPA and its
# deployment stack (image, one-box entry, cluster provisioning)
DEPLOY_FILES = sorted(p for p in (PORT_DIR / "deploy").rglob("*") if p.is_file())
SHIPPED_TEXT = (sorted(PORT_DIR.glob("serve/k8s/*.yaml")) + [PORT_DIR / "web" / "static" / "app.js"]
                + DEPLOY_FILES)


def _module_strings(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in JAX_MODULE_STRING.finditer(node.value):
                yield node.lineno, node.value[max(0, m.start() - 30):m.end() + 30]


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_no_string_names_a_jax_package_module(path):
    bad = list(_module_strings(path))
    assert not bad, f"{path.relative_to(ROOT)} names JAX-package modules: {bad}"


@pytest.mark.parametrize(
    "path", SHIPPED_TEXT, ids=[str(p.relative_to(ROOT)) for p in SHIPPED_TEXT]
)
def test_shipped_text_names_no_jax_package_module(path):
    text = path.read_text(encoding="utf-8")
    bad = [ln for ln in text.splitlines() if JAX_MODULE_STRING.search(ln)]
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"
    assert "data_accelerator_tpu_torch" in text


@pytest.mark.parametrize("text,names", [
    ("python -m data_accelerator_tpu.runtime.host", True),
    ("data_accelerator_tpu.udf.samples:anomalyscore", True),
    ("data_accelerator_tpu:main", True),
    ("copy of data_accelerator_tpu/serve/jobs.py", False),
    ("data_accelerator_tpu_torch.udf.samples:anomalyscore", False),
    ("python -m data_accelerator_tpu_torch.serve", False),
    ("the JAX package, data_accelerator_tpu. It", False),
])
def test_module_string_rule(text, names):
    assert bool(JAX_MODULE_STRING.search(text)) is names


# -- the UDF loader never loads the JAX package ---------------------------------------
LOADER_CHECK = """
import json, sys
from data_accelerator_tpu_torch.core.config import EngineException, SettingDictionary
from data_accelerator_tpu_torch.udf.api import load_udfs_from_conf
key = "datax.job.process.jar.udf.anomalyscore.class"
before = {m for m in sys.modules if m.split(".")[0] in %r}
out = {}
try:
    load_udfs_from_conf(SettingDictionary({key: %r}))
    out["raised"] = None
except EngineException as e:
    out["raised"] = str(e)
out["loaded"] = sorted({m for m in sys.modules if m.split(".")[0] in %r} - before)
port = load_udfs_from_conf(SettingDictionary(
    {key: "data_accelerator_tpu_torch.udf.samples:anomalyscore"}))
out["port"] = type(port["anomalyscore"]).__module__
print(json.dumps(out))
"""


@pytest.mark.parametrize("path", [
    "data_accelerator_tpu.udf.samples:anomalyscore",
    "data_accelerator_tpu.udf.samples.anomalyscore",
    "jax.numpy:sin",
])
def test_udf_loader_refuses_the_jax_package(path):
    """A conf naming a UDF of the JAX package (or JAX itself) raises
    before anything is imported, naming the port's counterpart when
    there is one; the port's own path still loads. In a fresh
    interpreter: this process imports the JAX package itself."""
    import json
    import subprocess
    import sys

    code = LOADER_CHECK % (FORBIDDEN, path, FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["raised"] and path in out["raised"]
    assert out["loaded"] == []
    if path.startswith("data_accelerator_tpu."):
        assert "data_accelerator_tpu_torch.udf.samples:anomalyscore" in out["raised"] or \
            "data_accelerator_tpu_torch.udf.samples.anomalyscore" in out["raised"]
    assert out["port"] == "data_accelerator_tpu_torch.udf.api"


# the control plane (slice 9a)
SLICE_9A = (
    "compile/flattener.py", "serve/templating.py", "serve/sqlanalyzer.py",
    "serve/simulateddata.py", "serve/storage.py", "serve/generation.py",
    "serve/jobs.py", "serve/scheduler.py", "serve/flowservice.py",
    "serve/gateway.py", "serve/restapi.py", "serve/__main__.py",
    "web/__init__.py", "web/server.py",
)


def test_slice_9a_modules_load_without_jax():
    """Each module of the slice imports in a fresh interpreter and
    leaves neither JAX nor the JAX package loaded."""
    import subprocess
    import sys

    for rel in SLICE_9A:
        assert PORT_DIR / rel in PORT_FILES, rel
    mods = tuple("data_accelerator_tpu_torch." + rel[:-3].replace("/", ".")
                 .replace(".__init__", "") for rel in SLICE_9A)
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
