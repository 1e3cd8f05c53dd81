"""Build hand-written CUDA kernel sources, and the host C++ sources,
at first use.

A source is named either by a bare name, for the package's own sources
(``csrc/<name>.cu``, or ``csrc/<name>.cpp`` for the host route), or by a
path to any such file, such as a ``.cu`` that sits beside a user's UDF
module. A ``.cu`` compiles with ``nvcc`` for ``sm_90a``, a ``.cpp`` (the
JSON ingest decoder) with ``g++``, each into a shared library with a
plain C interface, which ``ctypes`` loads. The library lands in
``data_accelerator_tpu_torch/_build/`` under a name that carries a hash
of the source's path, its contents and the flags, so an edited source
rebuilds and an unchanged one is loaded as it is. nvcc's output is kept
beside the library (``.log``): ``-Xptxas -v`` makes it list each
kernel's registers, shared memory and spill bytes, which ``ptxas_usage``
reads. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
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


def source_path(source: Source, suffix: str = ".cu") -> Path:
    """``csrc/<name><suffix>`` for a bare name; the file itself for a path."""
    text = os.fspath(source)
    if isinstance(source, os.PathLike) or text.endswith(suffix) or os.sep in text:
        path = Path(text).resolve()
        if path.suffix != suffix:
            raise KernelBuildError(f"{path}: this source must be a {suffix} file")
        return path
    return CSRC_DIR / f"{text}{suffix}"


def _library_path(src: Path, flags) -> Path:
    try:
        text = src.read_bytes()
    except OSError as e:
        raise KernelBuildError(f"cannot read kernel source {src}: {e}") from e
    h = hashlib.sha256(str(src).encode())
    h.update(text)
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def library_path(source: Source) -> Path:
    """Where a source builds to, keyed on its path, contents and flags."""
    return _library_path(source_path(source), NVCC_FLAGS)


def build(sources: Iterable[Source]) -> List[Path]:
    """Compile every source that has no current library, all ``nvcc``
    processes started together; returns the library paths."""
    srcs = [source_path(s) for s in sources]
    outs = [library_path(s) for s in srcs]
    todo = [(src, out) for src, out in zip(srcs, outs) if not out.exists()]
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        pending.append((src, out, tmp, proc))
    errors = []
    for src, out, tmp, proc in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
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
        return lib


def build_host(source: Source) -> Path:
    """Compile a host C++ source (``csrc/<name>.cpp`` or a path to a
    ``.cpp``) with ``g++`` and ``HOST_FLAGS`` unless its library is
    current; returns the library's path. A missing ``g++`` or a compile
    error raises ``KernelBuildError`` with the compiler's output."""
    src = source_path(source, ".cpp")
    out = _library_path(src, HOST_FLAGS)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelBuildError(
            f"g++ not found on PATH: {src.name} is host C++ that builds "
            "with g++ at first use"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
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
