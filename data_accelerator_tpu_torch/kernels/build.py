"""Build the hand-written CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, which ``ctypes`` loads. The
library lands in ``data_accelerator_tpu_torch/_build/`` under a name that
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is loaded as it is. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# a shared library loads once per process; its handle serves every caller
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed on its source and flags."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> "tuple[subprocess.Popen, Path, Path]":
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named source that has no current library, all
    ``nvcc`` processes started together; returns the library paths."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for name in names:
        if not library_path(name).exists():
            pending.append((name, *_start_build(name)))
    errors = []
    for name, proc, tmp, out in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(errors))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
        return lib
