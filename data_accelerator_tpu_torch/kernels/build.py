"""Build hand-written CUDA kernel sources, and the host C++ sources,
at first use.

A source is named either by a bare name, for the package's own sources
(``csrc/<name>.cu``, or ``csrc/<name>.cpp`` for the host route), or by a
path to any such file, such as a ``.cu`` that sits beside a user's UDF
module. A ``.cu`` compiles with ``nvcc`` for ``sm_90a``, a ``.cpp`` (the
JSON ingest decoder) with ``g++``, each into a shared library with a
plain C interface, which ``ctypes`` loads.

A library is named by its content key: a hash of the source's bytes,
the flags and the compiler's own ``--version`` text (read once a
process), never of the source's path. So an edited source, another flag
or another compiler builds anew, and the same source in another
checkout or container names the same library, which is what lets the
kernel build cache (``compile/aotcache.py``) share libraries between
processes and machines. A library of another key is never loaded: its
name differs.

Libraries build into the build directory: ``data_accelerator_tpu_torch/
_build/`` (``BUILD_DIR``) unless a compile cache points it elsewhere,
for the whole process (``set_build_dir``) or for one thread's block
(``build_dir_scope``). A library is looked up there and then in
``BUILD_DIR``, where an image prebuilds the package's own sources. A
build writes a temporary file and renames it, so a half-written library
is never loaded. nvcc's output is kept beside the library (``.log``):
``-Xptxas -v`` makes it list each kernel's registers, shared memory and
spill bytes, which ``ptxas_usage`` reads. ``compiler_runs`` counts the
compiles of the process. Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# the host route's flags: the JAX package's own build of the decoder
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

# a shared library loads once per process; its handle serves every caller
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# the list of first loads that ``loads_recorded`` keeps for this thread
_RECORD = threading.local()
# the build directory: this thread's ``build_dir_scope``, else the
# process's ``set_build_dir``, else BUILD_DIR
_SCOPE = threading.local()
_PROCESS_DIR: Optional[Path] = None
# each compiler's --version text, and the compiles run, in this process
_STATE_LOCK = threading.Lock()
_VERSIONS: Dict[str, str] = {}
_COMPILES: Counter = Counter()

Source = Union[str, os.PathLike]


class KernelBuildError(RuntimeError):
    """The compiler or the source is missing, or the compiler refused it."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin): "
        "the CUDA kernels of data_accelerator_tpu_torch build only where "
        "the CUDA toolkit is installed"
    )


def _nvcc_or_none() -> Optional[str]:
    try:
        return nvcc_path()
    except KernelBuildError:
        return None


def _compiler_version(compiler: Optional[str]) -> str:
    """``compiler --version``'s output, read once a process: a part of
    every library's key. No compiler (``None``) gives the empty text, so
    a library's name can still be worked out where nothing can build it,
    and it matches no library a compiler built."""
    if compiler is None:
        return ""
    with _STATE_LOCK:
        text = _VERSIONS.get(compiler)
        if text is None:
            try:
                proc = subprocess.run([compiler, "--version"], capture_output=True,
                                      text=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise KernelBuildError(f"cannot run {compiler} --version: {e}") from e
            text = _VERSIONS[compiler] = proc.stdout + proc.stderr
        return text


def compiler_runs() -> Dict[str, int]:
    """The compiles this process has run, by compiler (``nvcc``,
    ``g++``); a ``--version`` query is not one."""
    with _STATE_LOCK:
        return dict(_COMPILES)


def _count_compile(compiler: str) -> None:
    with _STATE_LOCK:
        _COMPILES[compiler] += 1


def build_dir() -> Path:
    """The directory libraries build into: this thread's innermost
    ``build_dir_scope``, else the process's ``set_build_dir``, else
    ``BUILD_DIR``."""
    return getattr(_SCOPE, "dir", None) or _PROCESS_DIR or BUILD_DIR


def set_build_dir(path: Optional[Source]) -> Optional[Path]:
    """Point every later build of the process at ``path`` (``None``:
    back to ``BUILD_DIR``); returns the setting it replaced, for the
    caller to restore."""
    global _PROCESS_DIR
    with _STATE_LOCK:
        prev, _PROCESS_DIR = _PROCESS_DIR, (Path(path) if path is not None else None)
    return prev


@contextlib.contextmanager
def build_dir_scope(path: Source):
    """Within the block, this thread's builds use ``path``."""
    outer = getattr(_SCOPE, "dir", None)
    _SCOPE.dir = Path(path)
    try:
        yield
    finally:
        _SCOPE.dir = outer


def source_path(source: Source, suffix: str = ".cu") -> Path:
    """``csrc/<name><suffix>`` for a bare name; the file itself for a path."""
    text = os.fspath(source)
    if isinstance(source, os.PathLike) or text.endswith(suffix) or os.sep in text:
        path = Path(text).resolve()
        if path.suffix != suffix:
            raise KernelBuildError(f"{path}: this source must be a {suffix} file")
        return path
    return CSRC_DIR / f"{text}{suffix}"


def _library_path(src: Path, flags, compiler: Optional[str]) -> Path:
    """Where the library of ``src`` built with ``compiler`` and ``flags``
    lies: the build directory or ``BUILD_DIR``, else where it builds to."""
    try:
        text = src.read_bytes()
    except OSError as e:
        raise KernelBuildError(f"cannot read kernel source {src}: {e}") from e
    key = json.dumps([hashlib.sha256(text).hexdigest(), list(flags),
                      _compiler_version(compiler)])
    name = f"lib{src.stem}-{hashlib.sha256(key.encode()).hexdigest()[:16]}.so"
    for d in dict.fromkeys((build_dir(), BUILD_DIR)):
        if (d / name).exists():
            return d / name
    return build_dir() / name


def library_path(source: Source) -> Path:
    """The library of a kernel source, keyed on its contents, the flags
    and nvcc's version: where it lies, or where it builds to."""
    return _library_path(source_path(source), NVCC_FLAGS, _nvcc_or_none())


def build(sources: Iterable[Source]) -> List[Path]:
    """Compile every source that has no current library, all ``nvcc``
    processes started together; returns the library paths."""
    srcs = [source_path(s) for s in sources]
    outs = [library_path(s) for s in srcs]
    todo = [(src, out) for src, out in zip(srcs, outs) if not out.exists()]
    if todo:
        nvcc = nvcc_path()
        build_dir().mkdir(parents=True, exist_ok=True)
    pending = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _count_compile("nvcc")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        pending.append((src, out, tmp, proc))
    errors = []
    for src, out, tmp, proc in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(errors))
    return outs


def load(source: Source) -> ctypes.CDLL:
    """The loaded library of a kernel source, built on first use."""
    key = str(source_path(source))
    with _LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            (path,) = build([source])
            lib = ctypes.CDLL(str(path))
            _LOADED[key] = lib
            loads = getattr(_RECORD, "loads", None)
            if loads is not None:
                loads.append(key)
        return lib


@contextlib.contextmanager
def loads_recorded():
    """Within the block, the sources this thread loads for the first time
    in the process (each a build unless its library was current) are
    appended to the list it yields: a processor reads it around its step
    to count kernel loads its warm-up did not cover."""
    outer = getattr(_RECORD, "loads", None)
    _RECORD.loads = loads = []
    try:
        yield loads
    finally:
        _RECORD.loads = outer
        if outer is not None:
            outer.extend(loads)


def build_host(source: Source) -> Path:
    """Compile a host C++ source (``csrc/<name>.cpp`` or a path to a
    ``.cpp``) with ``g++`` and ``HOST_FLAGS`` unless its library is
    current; returns the library's path. A missing ``g++`` or a compile
    error raises ``KernelBuildError`` with the compiler's output."""
    src = source_path(source, ".cpp")
    gxx = shutil.which("g++")
    out = _library_path(src, HOST_FLAGS, gxx)
    if out.exists():
        return out
    if gxx is None:
        raise KernelBuildError(
            f"g++ not found on PATH: {src.name} is host C++ that builds "
            "with g++ at first use"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _count_compile("g++")
    proc = subprocess.run(
        [gxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"host build failed: {src} (g++ exit {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_host(source: Source) -> ctypes.CDLL:
    """The loaded library of a host C++ source, built on first use."""
    key = str(source_path(source, ".cpp"))
    with _LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(source)))
            _LOADED[key] = lib
        return lib


def parse_ptxas(log: str) -> List[Dict[str, Optional[int]]]:
    """Each kernel's resources from ``ptxas -v`` output, in its order:
    ``kernel`` (the mangled name), ``registers`` a thread, static
    ``smem_bytes`` a block, and the spill bytes a thread stores and
    loads."""
    kernels: Dict[str, Dict[str, Optional[int]]] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"([^'\s]+)", line)
        if m:
            current = kernels.setdefault(m.group(1), {
                "kernel": m.group(1), "registers": None, "smem_bytes": 0,
                "spill_store_bytes": None, "spill_load_bytes": None,
            })
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_store_bytes"] = int(m.group(1))
            current["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            current["smem_bytes"] = int(m.group(1))
    return list(kernels.values())


def ptxas_usage(source: Source) -> List[Dict[str, Optional[int]]]:
    """``parse_ptxas`` of the build log of ``source``'s current library."""
    log = library_path(source).with_suffix(".log")
    try:
        return parse_ptxas(log.read_text())
    except OSError as e:
        raise KernelBuildError(f"no build log for {source}: {e}") from e
