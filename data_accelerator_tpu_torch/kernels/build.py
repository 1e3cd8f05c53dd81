"""Build hand-written CUDA kernel sources at first use.

A source is named either by a bare name, for the package's own kernels
(``csrc/<name>.cu``), or by a path to any ``.cu`` file, such as one that
sits beside a user's UDF module. It compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which
``ctypes`` loads. The library lands in ``data_accelerator_tpu_torch/
_build/`` under a name that carries a hash of the source's path, its
contents and the flags, so an edited source rebuilds and an unchanged one
is loaded as it is. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Union

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

Source = Union[str, os.PathLike]


class KernelBuildError(RuntimeError):
    """nvcc is missing, the source is missing, or nvcc refused it."""


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


def source_path(source: Source) -> Path:
    """``csrc/<name>.cu`` for a bare name; the file itself for a path."""
    text = os.fspath(source)
    if isinstance(source, os.PathLike) or text.endswith(".cu") or os.sep in text:
        path = Path(text).resolve()
        if path.suffix != ".cu":
            raise KernelBuildError(f"{path}: a kernel source must be a .cu file")
        return path
    return CSRC_DIR / f"{text}.cu"


def library_path(source: Source) -> Path:
    """Where a source builds to, keyed on its path, contents and flags."""
    src = source_path(source)
    try:
        text = src.read_bytes()
    except OSError as e:
        raise KernelBuildError(f"cannot read kernel source {src}: {e}") from e
    h = hashlib.sha256(str(src).encode())
    h.update(text)
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


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
