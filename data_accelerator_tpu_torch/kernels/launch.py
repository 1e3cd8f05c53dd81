"""``cuda_call``: launch a user's hand-written CUDA kernel on tensors.

The port's counterpart of ``pl.pallas_call`` for UDFs that bring their
own kernel: the UDF names a ``.cu`` source (for example one beside its
module) and an entry symbol, passes its input tensors and says what the
output is; ``cuda_call`` builds the source at first use
(``kernels/build.py``), allocates the output, launches on the current
stream and counts the launch. It never falls back to a plain version: a
UDF's CPU path is ``CudaKernelUdf.plain``.

The entry symbol has one fixed C signature, for a 1-D elementwise
kernel over ``n`` rows::

    extern "C" int entry(const void* const* inputs, const int* dtypes,
                         int n_inputs, void* out, int out_dtype,
                         long long n, int grid, void* stream);

``inputs``/``dtypes`` hold one device pointer and one dtype code
(``DTYPE_CODES``) per input; ``grid`` is the number of blocks the caller
asks for, or 0 to let the kernel choose. The function launches on
``stream`` without synchronising and returns ``cudaGetLastError()``, or
another non-zero CUDA error code for arguments it does not take.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from collections import Counter
from types import MappingProxyType
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from . import build
from .build import KernelBuildError, Source

# dtype codes shared by every kernel's C interface; read-only
DTYPE_CODES = MappingProxyType({torch.float32: 0, torch.int32: 1})

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]

_LOCK = threading.Lock()
_ENTRIES: Dict[Tuple[str, str], object] = {}
_LAUNCHES: Counter = Counter()


def launches(entry: str) -> int:
    """Launches of ``entry`` through ``cuda_call`` since the last reset."""
    return _LAUNCHES[entry]


def reset_launches() -> None:
    with _LOCK:
        _LAUNCHES.clear()


def _static_ints(value, what: str) -> Tuple[int, ...]:
    """A shape or grid as Python ints. A tensor element is refused: its
    value lives on the device, and reading it is a host sync."""
    dims = (value,) if isinstance(value, int) else tuple(value)
    for d in dims:
        if isinstance(d, bool) or not isinstance(d, int) or d < 0:
            # the type only: printing a CUDA tensor would read it back
            raise TypeError(
                f"cuda_call: {what} must be non-negative Python ints from "
                f"static shapes, got a {type(d).__name__}"
            )
    return dims


def _entry(source: Source, entry: str):
    # keyed on the source as given: resolving the path on every launch
    # would cost file-system calls on the launch path
    key = (os.fspath(source), entry)
    with _LOCK:
        fn = _ENTRIES.get(key)
    if fn is None:
        lib = build.load(source)
        try:
            fn = getattr(lib, entry)
        except AttributeError:
            raise KernelBuildError(
                f"{build.source_path(source)} built, but exports no symbol "
                f"{entry!r} (declare it extern \"C\")"
            ) from None
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        with _LOCK:
            _ENTRIES[key] = fn
    return fn


def cuda_call(
    source: Source,
    entry: str,
    *inputs: torch.Tensor,
    out_shape: Sequence[int],
    out_dtype: torch.dtype = torch.float32,
    grid: Optional[Union[int, Sequence[int]]] = None,
) -> torch.Tensor:
    """Launch ``entry`` of ``source`` over ``inputs`` into a new tensor of
    ``out_shape``/``out_dtype``; returns it.

    Every input is a contiguous float32 or int32 CUDA tensor of the
    output's element count, all on one device; ``out_shape`` and
    ``grid`` are Python ints. Raises on anything else, before building
    or launching."""
    shape = _static_ints(out_shape, "out_shape")
    blocks = 0  # the kernel chooses
    if grid is not None:
        dims = _static_ints(grid, "grid")
        if len(dims) != 1 or not 0 < dims[0] < 2**31:
            raise ValueError(
                f"cuda_call: grid must be one positive block count, got {grid!r}"
            )
        (blocks,) = dims
    if out_dtype not in DTYPE_CODES:
        raise TypeError(
            f"cuda_call: out_dtype {out_dtype} is not one of "
            f"{list(DTYPE_CODES)}"
        )
    if not inputs:
        raise ValueError("cuda_call: needs at least one input tensor")
    n = math.prod(shape)
    device = inputs[0].device
    for i, t in enumerate(inputs):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(
                f"cuda_call {entry}: input {i} has dtype {t.dtype}; kernels "
                f"take {list(DTYPE_CODES)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"cuda_call {entry}: input {i} is not contiguous")
        if t.numel() != n:
            raise ValueError(
                f"cuda_call {entry}: input {i} has {t.numel()} elements, "
                f"out_shape {shape} has {n}"
            )
        if t.device.type != "cuda":
            raise ValueError(f"cuda_call {entry}: input {i} is not a CUDA tensor")
        if t.device != device:
            raise ValueError(
                f"cuda_call {entry}: inputs on {device} and {t.device}"
            )
    out = torch.empty(shape, dtype=out_dtype, device=device)
    if n == 0:
        return out  # nothing to launch, so nothing to count
    fn = _entry(source, entry)
    ptrs = (ctypes.c_void_p * len(inputs))(*[t.data_ptr() for t in inputs])
    codes = (ctypes.c_int * len(inputs))(*[DTYPE_CODES[t.dtype] for t in inputs])
    # the launch goes to the current device's context
    with torch.cuda.device(device):
        rc = fn(
            ptrs, codes, len(inputs), out.data_ptr(), DTYPE_CODES[out_dtype],
            n, blocks, torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cuda_call {entry}: launch failed, CUDA error {rc}")
    with _LOCK:
        _LAUNCHES[entry] += 1
    return out
