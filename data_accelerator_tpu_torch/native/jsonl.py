"""ctypes binding for the blob sink's JSON-lines renderer.

``csrc/jsonl.cpp`` writes a flat table's columns as JSON lines, the
same bytes ``json.dumps`` gives for the rows ``runtime/materialize.py``
builds from them (``render``). It builds with ``g++`` at first use into
``_build/`` (``kernels/build.py::load_host``); the hosts call ``load``
at init, so no batch pays for the build. Strings are escaped here, once
for each distinct dictionary id of a column, by ``json.dumps`` itself;
the library splices the escaped pieces in. The ctypes call releases
the interpreter lock, so a render overlaps the threads that parse.
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import Optional, Sequence

import numpy as np

from ..core.schema import StringDictionary
from ..kernels import build

SOURCE = "jsonl"  # csrc/jsonl.cpp

# the value kinds of csrc/jsonl.cpp
INT, BOOL, DOUBLE, STRING = 0, 1, 2, 3

# schema types that render as Python ints (runtime/materialize.py
# _render_value's last case)
INT_TYPES = frozenset({"long", "int", "integer", "bigint", "short", "byte"})

# the widest value of each kind, in bytes: a 128-bit sum with its sign;
# "false"; a float repr such as -2.2250738585072014e-308
_WIDTH = {INT: 41, BOOL: 5, DOUBLE: 24}

_LIB_LOCK = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The renderer library with its C signature declared, built on
    first use; raises what the build raised."""
    global _lib
    with _LIB_LOCK:
        if _lib is not None:
            return _lib
        lib = build.load_host(SOURCE)
        lib.dx_render_jsonl.restype = ctypes.c_int64
        lib.dx_render_jsonl.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def column_kind(col_type: str, dtype: np.dtype) -> Optional[int]:
    """The renderer's kind for a column of schema type ``col_type``
    held in ``dtype``, or None where only the row path renders it the
    same (say, an integer type held in floats, which ``int()``
    truncates, or unsigned 64-bit values past int64)."""
    integral = dtype.kind in "bi" or (dtype.kind == "u" and dtype.itemsize < 8)
    if col_type == "double":
        return DOUBLE if dtype.kind in "biuf" else None
    if not integral:
        return None
    if col_type == "string":
        return STRING
    if col_type == "boolean":
        return BOOL
    if col_type in ("timestamp", "tssec") or col_type in INT_TYPES:
        return INT
    return None


def render(
    names: Sequence[str], types: Sequence[str], cols: Sequence[np.ndarray],
    n_rows: int, dictionary: StringDictionary, base_ms: int,
) -> str:
    """``n_rows`` rows of the columns ``cols`` (named ``names``, of the
    schema types ``types``, each kind not None) as JSON lines, each row
    ending in a newline: what ``json.dumps`` writes for the rows
    ``materialize_rows`` makes of them under ``base_ms``."""
    lib = load()
    n_cols = len(names)
    kinds = np.empty(n_cols, np.int32)
    offsets = np.zeros(n_cols, np.int64)
    prefixes = [
        ("{" if c == 0 else ", ").encode() + json.dumps(name).encode() + b": "
        for c, name in enumerate(names)
    ]
    row_bound = sum(len(p) for p in prefixes) + 2  # and "}\n"
    data, pieces, piece_offsets = [], [], []
    for c, (t, col) in enumerate(zip(types, cols)):
        kind = kinds[c] = column_kind(t, col.dtype)
        joined, bounds = b"", None
        if kind == STRING:
            ids, index = np.unique(col, return_inverse=True)
            escaped = [json.dumps(dictionary.decode(int(i))).encode() for i in ids]
            joined = b"".join(escaped)
            lens = np.fromiter(map(len, escaped), np.int64, len(escaped))
            bounds = np.concatenate(([0], np.cumsum(lens)))
            row_bound += int(lens.max(initial=0))
            arr = np.ascontiguousarray(index.reshape(-1), np.int64)
        else:
            row_bound += _WIDTH[kind]
            if kind == INT:
                if t == "timestamp":
                    offsets[c] = base_ms
                elif t == "tssec":
                    offsets[c] = base_ms // 1000
                arr = np.ascontiguousarray(col, np.int64)
            elif kind == BOOL:
                arr = np.ascontiguousarray(col != 0, np.uint8)
            else:
                # a signalling NaN widens to a quiet one, as float() does
                with np.errstate(invalid="ignore"):
                    arr = np.ascontiguousarray(col, np.float64)
        data.append(arr)
        pieces.append(joined)
        piece_offsets.append(bounds)

    def addresses(items):
        return np.array(
            [0 if a is None else (a.ctypes.data if isinstance(a, np.ndarray)
                                  else ctypes.cast(a, ctypes.c_void_p).value)
             for a in items],
            np.uintp,
        )

    ptr_data = addresses(data)
    ptr_pieces = addresses(pieces)
    ptr_bounds = addresses(piece_offsets)
    ptr_prefixes = addresses(prefixes)
    prefix_lens = np.array([len(p) for p in prefixes], np.int64)
    cap = max(1, n_rows * row_bound)
    out = np.empty(cap, np.uint8)
    written = lib.dx_render_jsonl(
        n_rows, n_cols, kinds.ctypes.data, ptr_data.ctypes.data,
        offsets.ctypes.data, ptr_pieces.ctypes.data, ptr_bounds.ctypes.data,
        ptr_prefixes.ctypes.data, prefix_lens.ctypes.data, row_bound,
        out.ctypes.data, cap,
    )
    if written < 0:
        raise RuntimeError("jsonl render overran its bound")
    return str(memoryview(out)[:written], "ascii")
