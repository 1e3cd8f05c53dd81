"""ctypes binding for the port's native JSON->columnar ingest decoder.

The C++ library is the port's own copy of the JAX package's decoder,
``data_accelerator_tpu_torch/csrc/decoder.cpp``, with the same C ABI. It
takes the role Spark's executor-side ``from_json`` plays in the
reference (CommonProcessorFactory.scala:90-103): every event's JSON
parse happens in native code straight into numpy buffers. It builds with
``g++`` at first use into ``_build/`` (``kernels/build.py::load_host``);
a missing ``g++`` or a compile error raises ``KernelBuildError``. There
is no Python decoder to fall back to.

Three decode surfaces:

- ``decode``: newline-JSON -> per-column numpy arrays (the row layout);
- ``decode_packed``: newline-JSON straight into a persistent
  [n_cols+1, capacity] int32 matrix, the single-transfer layout of
  ``runtime/processor.py::PackedRaw``, so the hot path makes no
  per-batch column allocation and no pack copy. The matrices come from a
  :class:`PackedBufferPool`: page-locked for a CUDA processor, so the one
  host-to-device copy of a batch reads them directly;
- ``decode_kafka_packed``: native Kafka v2 record-batch walking (varint
  framing, CRC-32C verification, control-batch skip, typed rejection of
  compressed batches) feeding each record value to the same JSON column
  decoder in the same call.

The decoder owns a string dictionary (string -> int32) kept consistent
with the Python ``StringDictionary`` by push-before/pull-after syncs
around each decode call; both sides assign ids sequentially so ids stay
stable across the boundary.

Shard count: ``DATAX_DECODER_THREADS`` env (operator override) > the
conf'd ``datax.job.process.ingest.decoderthreads`` (the ``threads`` ctor
arg) > the engine default (cap 4: ingest shares the host with the
engine loop and sinks).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.schema import ColType, Schema, StringDictionary
from ..kernels import build

SOURCE = "decoder"  # csrc/decoder.cpp

_LIB_LOCK = threading.Lock()
_lib = None

_CTYPE_NAME = {
    ColType.LONG: "long",
    ColType.DOUBLE: "double",
    ColType.BOOLEAN: "boolean",
    ColType.STRING: "string",
    ColType.TIMESTAMP: "timestamp",
}

_NP_DTYPE = {
    ColType.LONG: np.int32,
    ColType.DOUBLE: np.float32,
    ColType.BOOLEAN: np.uint8,
    ColType.STRING: np.int32,
    ColType.TIMESTAMP: np.int64,
}

# Kafka v2 attribute codec ids (message format v2)
KAFKA_CODEC_NAMES = {1: "gzip", 2: "snappy", 3: "lz4", 4: "zstd"}

# dx_decode_kafka_packed stats vector layout (decoder.cpp KStat)
_KSTAT_RECORDS = 0
_KSTAT_MALFORMED = 1
_KSTAT_CORRUPT = 2
_KSTAT_CONTROL = 3
_KSTAT_OVERFLOW = 4
_KSTAT_CODEC = 5


class UnsupportedCodecError(NotImplementedError):
    """A compressed record batch reached a decoder that does not ship a
    decompressor. Typed (and naming the codec) so ingest surfaces a
    configuration error instead of mis-parsing: set broker/topic
    ``compression.type=uncompressed``."""

    def __init__(self, codec: str):
        self.codec = codec
        super().__init__(
            f"compressed kafka record batches ({codec}) are not supported "
            "by the wire client; set broker/topic "
            "compression.type=uncompressed"
        )


def _load():
    """The decoder library with its C signatures declared, built on
    first use; raises what the build raised."""
    global _lib
    with _LIB_LOCK:
        if _lib is not None:
            return _lib
        lib = build.load_host(SOURCE)
        lib.dx_decoder_create.restype = ctypes.c_void_p
        lib.dx_decoder_create.argtypes = [ctypes.c_char_p]
        lib.dx_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.dx_num_columns.restype = ctypes.c_int64
        lib.dx_num_columns.argtypes = [ctypes.c_void_p]
        lib.dx_decode_mt.restype = ctypes.c_int64
        lib.dx_decode_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ]
        packed_args = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ]
        lib.dx_decode_packed.restype = ctypes.c_int64
        lib.dx_decode_packed.argtypes = packed_args
        lib.dx_decode_kafka_packed.restype = ctypes.c_int64
        lib.dx_decode_kafka_packed.argtypes = packed_args
        lib.dx_crc32c.restype = ctypes.c_uint32
        lib.dx_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.dx_bad_timestamps.restype = ctypes.c_int64
        lib.dx_bad_timestamps.argtypes = [ctypes.c_void_p]
        lib.dx_dict_size.restype = ctypes.c_int64
        lib.dx_dict_size.argtypes = [ctypes.c_void_p]
        lib.dx_dict_push.restype = ctypes.c_int32
        lib.dx_dict_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.dx_dict_get.restype = ctypes.c_int64
        lib.dx_dict_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def native_crc32c(data: bytes) -> int:
    """CRC-32C of ``data`` through the decoder library, the checksum the
    Kafka walker verifies each record batch with."""
    return int(_load().dx_crc32c(data, len(data)))


def _decode_threads(conf_threads: Optional[int] = None) -> int:
    """Decoder shard count: DATAX_DECODER_THREADS env (operator
    override) > the conf'd ``process.ingest.decoderthreads`` > default
    (cap 4: ingest shares the host with the engine loop and sinks)."""
    env = os.environ.get("DATAX_DECODER_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    if conf_threads is not None:
        return max(1, int(conf_threads))
    return max(1, min(4, (os.cpu_count() or 1) - 1))


class PackedBufferPool:
    """Persistent, reused ingest matrices in the packed layout
    ([n_rows, capacity] int32 tensors, row stride == capacity).

    With ``pin=True`` (a CUDA processor) each matrix is page-locked host
    memory, allocated once per slot, which the decoder writes through its
    ``.numpy()`` view and one non-blocking copy ships to the card. Such a
    matrix is released with the CUDA event recorded after that copy, and
    ``acquire`` hands it out again only once the event has completed.
    Otherwise (the CPU) a matrix is a 64-byte-aligned numpy allocation
    that ``torch.from_numpy`` wraps without a copy; the step then reads
    the pool's memory itself, so the processor releases it only once its
    batch has landed. The pool grows on demand and counts every reuse for
    the ``Decode_BufferReuse_Count`` metric.

    An attached ``sanitizer`` (``process.debug.buffersanitizer``,
    ``runtime/sanitizer.py``) poisons each released matrix, but only
    once its copy event (if any) has completed: at ``release`` when it
    already has, else at a later ``release`` or ``acquire`` that finds
    it done with a non-blocking ``query``. No matrix is handed out
    unpoisoned, and none is poisoned under an in-flight copy."""

    def __init__(self, n_rows: int, capacity: int, pin: bool = False):
        self.n_rows = int(n_rows)
        self.capacity = int(capacity)
        self.pin = pin
        self.sanitizer = None
        self._lock = threading.Lock()
        # [matrix, event of its host-to-device copy or None, poisoned]
        self._free: List[list] = []
        self.alloc_count = 0
        self.reuse_count = 0
        self._reuse_drained = 0

    def _new_matrix(self) -> torch.Tensor:
        shape = (self.n_rows, self.capacity)
        if self.pin:
            return torch.empty(shape, dtype=torch.int32, pin_memory=True)
        n = self.n_rows * self.capacity
        raw = np.empty(n + 16, dtype=np.int32)
        off = (-raw.ctypes.data % 64) // 4
        return torch.from_numpy(raw[off: off + n].reshape(shape))

    @staticmethod
    def _copied(entry: list) -> bool:
        return entry[1] is None or entry[1].query()

    def _poison_copied(self) -> None:
        """Poison every free matrix whose copy has completed (under the
        lock; a no-op without a sanitizer)."""
        if self.sanitizer is None:
            return
        for entry in self._free:
            if not entry[2] and self._copied(entry):
                self.sanitizer.poison(entry[0])
                entry[2] = True

    def acquire(self) -> torch.Tensor:
        with self._lock:
            self._poison_copied()
            for i in range(len(self._free) - 1, -1, -1):
                if self._copied(self._free[i]):
                    matrix = self._free.pop(i)[0]
                    self.reuse_count += 1
                    return matrix
            self.alloc_count += 1
        return self._new_matrix()

    def release(
        self, matrix: torch.Tensor, copied: Optional[torch.cuda.Event] = None
    ) -> None:
        """Give ``matrix`` back; ``copied`` is the event recorded after
        its host-to-device copy, if one is still in flight."""
        with self._lock:
            self._free.append([matrix, copied, False])
            self._poison_copied()

    def take_reuse_count(self) -> int:
        """Reuses since the last take (the Decode_BufferReuse_Count
        delta drained at collect)."""
        with self._lock:
            n = self.reuse_count - self._reuse_drained
            self._reuse_drained = self.reuse_count
            return n


class NativeDecoder:
    """Decode newline-delimited JSON (or Kafka v2 record batches) into
    columnar output typed by the flow's input schema."""

    def __init__(
        self,
        schema: Schema,
        dictionary: StringDictionary,
        threads: Optional[int] = None,
    ):
        lib = _load()
        self._lib = lib
        self.schema = schema
        self.dictionary = dictionary
        # conf'd shard count (datax.job.process.ingest.decoderthreads);
        # None = engine default, env DATAX_DECODER_THREADS always wins
        self.threads = threads
        desc = "".join(
            f"{c.name}\t{_CTYPE_NAME[c.ctype]}\n" for c in schema.columns
        )
        self._d = lib.dx_decoder_create(desc.encode("utf-8"))
        self._cols = list(schema.columns)
        self.last_bad_timestamps = 0
        self.last_shards = 1
        self._push_python_entries()

    def close(self):
        if self._d:
            self._lib.dx_decoder_destroy(self._d)
            self._d = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def shard_count(self) -> int:
        return _decode_threads(self.threads)

    # -- dictionary sync --------------------------------------------------
    def _push_python_entries(self):
        """Push Python-side dictionary entries the native map hasn't seen
        (ids are sequential on both sides, so push in id order)."""
        native_n = self._lib.dx_dict_size(self._d)
        for i in range(native_n, len(self.dictionary)):
            s = self.dictionary.decode(i)
            got = self._lib.dx_dict_push(self._d, (s or "").encode("utf-8"))
            if got != i:
                raise RuntimeError(
                    f"dictionary desync: pushed {s!r} expecting id {i}, got {got}"
                )

    def _pull_native_entries(self):
        """Pull entries the native decode added into the Python dict."""
        native_n = self._lib.dx_dict_size(self._d)
        buf = ctypes.create_string_buffer(4096)
        for i in range(len(self.dictionary), native_n):
            n = self._lib.dx_dict_get(self._d, i, buf, len(buf))
            if n < 0:
                raise RuntimeError(f"dictionary id {i} missing on native side")
            if n >= len(buf):
                bigger = ctypes.create_string_buffer(int(n) + 1)
                self._lib.dx_dict_get(self._d, i, bigger, len(bigger))
                s = bigger.value.decode("utf-8", "replace")
            else:
                s = buf.value.decode("utf-8", "replace")
            got = self.dictionary.encode(s)
            if got != i:
                raise RuntimeError(
                    f"dictionary desync pulling {s!r}: expected id {i}, got {got}"
                )

    # -- decode -----------------------------------------------------------
    def decode(
        self, data: bytes, max_rows: int
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, int, int]:
        """Row-layout decode: returns (columns, valid, rows,
        bytes_consumed).

        ``valid`` is the ONLY authoritative row mask: on the sharded
        path malformed lines leave zeroed gap slots at chunk tails, so
        valid rows are NOT a packed prefix. ``rows`` is the decoded-row
        COUNT (== valid.sum()), for metrics."""
        self._push_python_entries()
        arrays: Dict[str, np.ndarray] = {}
        ptrs = (ctypes.c_void_p * len(self._cols))()
        for i, c in enumerate(self._cols):
            a = np.zeros(max_rows, dtype=_NP_DTYPE[c.ctype])
            arrays[c.name] = a
            ptrs[i] = a.ctypes.data_as(ctypes.c_void_p)
        valid = np.zeros(max_rows, dtype=np.uint8)
        consumed = ctypes.c_int64(0)
        n_threads = self.shard_count()
        self.last_shards = n_threads
        rows = self._lib.dx_decode_mt(
            self._d, data, len(data), max_rows, ptrs,
            valid.ctypes.data_as(ctypes.c_void_p), ctypes.byref(consumed),
            n_threads,
        )
        self.last_bad_timestamps = int(self._lib.dx_bad_timestamps(self._d))
        self._pull_native_entries()
        return arrays, valid.astype(bool), int(rows), int(consumed.value)

    def _packed_args(
        self, matrix: np.ndarray, col_rows: Sequence[int], valid_row: int,
    ):
        if (
            not isinstance(matrix, np.ndarray) or matrix.dtype != np.int32
            or matrix.ndim != 2 or not matrix.flags["C_CONTIGUOUS"]
        ):
            raise ValueError(
                "packed decode needs a C-contiguous 2-D int32 numpy matrix"
            )
        if len(col_rows) != len(self._cols) or not all(
            0 <= int(r) < matrix.shape[0] for r in (*col_rows, valid_row)
        ):
            raise ValueError(
                f"packed decode: rows {list(col_rows)} and valid row "
                f"{valid_row} do not fit a {matrix.shape[0]}-row matrix "
                f"for {len(self._cols)} columns"
            )
        cr = (ctypes.c_int64 * len(self._cols))(*[int(r) for r in col_rows])
        return (
            matrix.ctypes.data_as(ctypes.c_void_p),
            int(matrix.shape[1]), cr, int(valid_row),
        )

    def _max_rows(self, matrix: np.ndarray, max_rows: Optional[int]) -> int:
        cap = int(matrix.shape[1])
        return cap if max_rows is None else min(int(max_rows), cap)

    def decode_packed(
        self,
        data: bytes,
        matrix: np.ndarray,
        col_rows: Sequence[int],
        valid_row: int,
        base_ms: int,
        max_rows: Optional[int] = None,
    ) -> Tuple[int, int]:
        """Newline-JSON straight into the packed matrix: column i of the
        schema writes matrix row ``col_rows[i]`` (floats bitcast, bools
        widened, timestamps rebased to int32 batch-relative ms against
        ``base_ms``), validity into ``matrix[valid_row]`` as int32 0/1.
        The decoder zeroes its own rows first, so reused (dirty) pool
        matrices are fine. Returns (rows decoded, bytes consumed)."""
        self._push_python_entries()
        base, stride, cr, vrow = self._packed_args(matrix, col_rows, valid_row)
        cap = self._max_rows(matrix, max_rows)
        consumed = ctypes.c_int64(0)
        n_threads = self.shard_count()
        self.last_shards = n_threads
        rows = self._lib.dx_decode_packed(
            self._d, data, len(data), cap, base, stride, cr, vrow,
            int(base_ms), ctypes.byref(consumed), n_threads,
        )
        self.last_bad_timestamps = int(self._lib.dx_bad_timestamps(self._d))
        self._pull_native_entries()
        return int(rows), int(consumed.value)

    def decode_kafka_packed(
        self,
        data: bytes,
        matrix: np.ndarray,
        col_rows: Sequence[int],
        valid_row: int,
        base_ms: int,
        max_rows: Optional[int] = None,
    ) -> Tuple[int, Dict[str, int]]:
        """Kafka v2 record batches straight into the packed matrix:
        CRC-32C verified per batch (corrupt batches skip + count instead
        of mis-parsing), control batches skipped, compressed batches
        rejected with a typed :class:`UnsupportedCodecError` naming the
        codec. Returns (rows decoded, stats) where stats carries
        ``records``/``malformed``/``corrupt_batches``/
        ``control_batches``/``overflow_dropped``."""
        self._push_python_entries()
        base, stride, cr, vrow = self._packed_args(matrix, col_rows, valid_row)
        cap = self._max_rows(matrix, max_rows)
        stats = (ctypes.c_int64 * 6)()
        n_threads = self.shard_count()
        self.last_shards = n_threads
        rows = self._lib.dx_decode_kafka_packed(
            self._d, data, len(data), cap, base, stride, cr, vrow,
            int(base_ms), stats, n_threads,
        )
        self.last_bad_timestamps = int(self._lib.dx_bad_timestamps(self._d))
        self._pull_native_entries()
        codec = int(stats[_KSTAT_CODEC])
        if codec >= 0:
            raise UnsupportedCodecError(KAFKA_CODEC_NAMES.get(codec, str(codec)))
        return int(rows), {
            "records": int(stats[_KSTAT_RECORDS]),
            "malformed": int(stats[_KSTAT_MALFORMED]),
            "corrupt_batches": int(stats[_KSTAT_CORRUPT]),
            "control_batches": int(stats[_KSTAT_CONTROL]),
            "overflow_dropped": int(stats[_KSTAT_OVERFLOW]),
        }
