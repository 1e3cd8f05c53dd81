"""The engine core: build and run a flow's per-batch processing step.

reference: datax-host processor/CommonProcessorFactory.scala:42-660 —
init loads schema/projections/transform/UDFs, then per batch:
``project()`` raw->typed projection (:90-103), ``route()`` SQL pipeline +
time windows + outputs (:131-328), ``processDataset()`` orchestration +
metrics (:333-399).

As in the JAX package, everything per batch runs on the device —
projection, ring-buffer window update, the whole SQL pipeline, output
compaction and the count metrics — and only one int32 counts vector and
the compacted output rows come back. PyTorch runs the step eagerly: its
operations queue on the device's stream and nothing in it reads a value
back.

Ingest and transfer: ``encode_json_bytes`` decodes JSON bytes with the
port's native decoder (``native/``) straight into one pooled
``[n_cols+1, capacity]`` int32 matrix, page-locked on a CUDA processor;
``dispatch_batch`` ships it with ONE host-to-device copy (``PackedRaw``)
and the step splits its rows back into columns. After the step, a side
stream copies the counts vector and each output, sliced to its adaptive
capacity (sized transfer) and staged in A/B output slots, into pinned
host memory; ``PendingBatch.collect_counts`` is the batch's one blocking
read and ``collect_tables`` lands the tables that are already on their
way.

Sources: one per ``input.sources.<name>`` (plus ``input.default.*`` as
the primary), each with its own schema, projection, target table,
capacity, pooled ingest matrix and host-to-device copy per batch; the
window rings of every target advance together. CSV reference data
(``input.referencedata.*``) loads onto the device once and joins like
any table.

``process.compile.manifest`` has an eager meaning here, since nothing is
traced: at init the processor dispatches one zero-filled batch (on CUDA
that builds and launches every kernel UDF the step calls), runs one
zero-filled sized transfer per output, capacity bucket and A/B slot, and
then resets every adaptive state the warm touched. A failure in the warm
raises, where the JAX package logs it and compiles at the first batch.
``compile.cachedir`` and ``compile.cacheurl`` are read by nothing: there
is no compile cache to route.

State tables (``process.statetable.*``, the ``--DataXStates--``
accumulators) and partitioned state (``process.state.*``) run as in the
JAX package: each table loads onto the device at init and is a step
input; the step returns the new state, which leaves the card with the
batch's outputs (the same side stream and pinned host memory) and is
overwritten into its A/B partition snapshots from host memory at
landing (``runtime/statetable.py``, ``runtime/statepartition.py``).
``commit`` persists the pointers after the sinks, and with
``state.snapshoturl`` the partitions and the window rings travel through
the ``objstore://`` mirror to a successor replica.

The ``process.debug`` block arms the debug runtime: ``nans`` and
``tracerleaks`` guard the step's views and UDF calls
(``runtime/debugguard.py``, the eager counterpart of the JAX package's
``jax.debug_nans``/``jax.checking_leaks``), and ``buffersanitizer``
poisons released ingest matrices, scans landed tables and checks window
checkpoints (``runtime/sanitizer.py``, runtime DX805).

Mesh execution is not ported yet; a flow whose conf asks for it raises
``EngineException``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import threading
import time
import types
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..compile.pipeline import Pipeline, PipelineCompiler, parse_state_table_schema
from ..compile.planner import PlannerConfig, SelectCompiler, TableData, ViewSchema
from ..compile.sqlparser import parse_select
from ..compile.stringops import _MAX_ROUNDS, AuxTableBuilder
from ..constants import ColumnName, DatasetName
from ..core.config import EngineException, SettingDictionary, SettingNamespace
from ..core.schema import ColType, Schema, StringDictionary
from ..kernels import build as kernel_build
from ..native import NativeDecoder, PackedBufferPool
from ..obs import tracing
from ..ops.compact import compact_indices
from ..udf import UdfRegistry, load_udfs_from_conf
from .materialize import materialize_rows
from .statepartition import (
    DEFAULT_STATE_PARTITIONS,
    ObjstoreSnapshotStore,
    merge_window_snapshots,
    other_side,
    owned_partitions,
    partition_ids,
    snapshot_from_bytes,
    snapshot_to_bytes,
    split_window_snapshot,
)
from . import debugguard, sanitizer
from .statetable import StateTable
from .timewindow import (
    WindowBuffers,
    make_buffers,
    num_slots,
    update_buffers,
    window_table,
)

logger = logging.getLogger(__name__)

# default in-flight window of a pipelined host (conf
# datax.job.process.pipeline.depth): decode/dispatch of batch N+k
# proceeds while up to `depth` earlier batches compute and their
# device-to-host copies land; finish/commit stays strictly FIFO
DEFAULT_PIPELINE_DEPTH = 2

# sized output transfer: adapt the per-output device-to-host copy to the
# rows a flow actually produces (EWMA of observed counts, bucketed to
# powers of two) instead of the full padded capacity
TRANSFER_EWMA_ALPHA = 0.25
TRANSFER_HEADROOM = 4  # sized cap >= HEADROOM * EWMA (burst absorption)
MIN_TRANSFER_ROWS = 256  # below this, shrinking saves nothing
# after an overflow re-fetch, the output's headroom factor doubles for
# the next N batches so back-to-back bursts can't thrash the two-phase
# fallback (the EWMA jump alone only covers the observed count, not a
# still-climbing one)
OVERFLOW_BOOST_FACTOR = 2
OVERFLOW_BOOST_BATCHES = 8

# double-buffered output slots: each output's transfer view is written
# into one of two resident buffer sets per (output, capacity bucket),
# with its pinned host destination, alternating A/B so batch N+1's step
# never writes into what batch N's copy is still reading
OUTPUT_SLOT_BUFFERS = 2

_CTYPE_TO_PLAN = {
    ColType.LONG: "long",
    ColType.DOUBLE: "double",
    ColType.BOOLEAN: "boolean",
    ColType.STRING: "string",
    ColType.TIMESTAMP: "timestamp",
}


def schema_to_view(schema: Schema) -> ViewSchema:
    return ViewSchema({c.name: _CTYPE_TO_PLAN[c.ctype] for c in schema.columns})


def default_projection(schema: Schema, timestamp_column: Optional[str]) -> str:
    """The HomeAutomation normalization snippet shape
    (gui.input.properties.normalizationSnippet) used when a source
    declares no projection of its own."""
    lines = ["Raw.*"]
    if timestamp_column and not schema.has(timestamp_column):
        lines.insert(0, f"current_timestamp() AS {timestamp_column}")
    return "\n".join(lines)


def projection_select(step_text: str, from_table: str):
    """One projection step (selectExpr lines) -> parsed Select
    (handler/ProjectionHandler.scala semantics)."""
    items = [
        ln.strip()
        for ln in step_text.replace("\r", "").split("\n")
        if ln.strip() and not ln.strip().startswith("--")
    ]
    return parse_select("SELECT " + ", ".join(items) + f" FROM {from_table}")


def window_target(wname: str, targets: List[str]) -> str:
    """Bind a window name to its projected table: the longest target
    ``T`` such that the window is named ``T_<duration>``. A single-source
    flow may name windows freely (they can only mean its one table);
    multi-source flows must prefix-match or set the window's ``table``
    conf key."""
    best = ""
    for t in targets:
        if wname.startswith(t + "_") and len(t) > len(best):
            best = t
    if best:
        return best
    return targets[0] if len(targets) == 1 else ""


def _read_maybe_file(value: str) -> str:
    """Conf values may inline content or point at a file (the reference
    always loads from storage; one-box flows inline the schema JSON)."""
    if value is None:
        return None
    v = value.strip()
    if v.startswith("{") or v.startswith("[") or "\n" in v or "--" in v[:4]:
        return value
    if v.startswith("objstore://") or v.startswith("objstore+https://"):
        from ..utils.fs import read_text

        return read_text(v)
    if os.path.exists(v):
        with open(v, "r", encoding="utf-8") as f:
            return f.read()
    return value


def _host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host column onto ``device``. The numpy dtype follows the
    reference's x64-off ``jnp.asarray``: floats become float32 and
    integers int32 (wrapping), bools stay. A CUDA copy goes through
    pinned memory without blocking the host."""
    if a.dtype != np.bool_:
        a = a.astype(np.float32 if a.dtype.kind == "f" else np.int32, copy=False)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def load_reference_data_tables(
    dict_: SettingDictionary, dictionary: StringDictionary,
    device: torch.device,
) -> Dict[str, Tuple[ViewSchema, TableData]]:
    """CSV reference data as joinable tables on ``device``
    (reference: handler/ReferenceDataHandler.scala:17-66): column types
    inferred as long (int32), double (float32) or string (dictionary
    ids), every row valid."""
    import csv

    out: Dict[str, Tuple[ViewSchema, TableData]] = {}
    groups = dict_.group_by_sub_namespace(
        SettingNamespace.JobInputPrefix + "referencedata."
    )
    for name, sub in groups.items():
        path = sub.get_string("path")
        delimiter = sub.get_or_else("delimiter", ",") or ","
        header = (sub.get_or_else("header", "true") or "true").lower() == "true"
        with open(path, "r", encoding="utf-8") as f:
            rows = [r for r in csv.reader(f, delimiter=delimiter) if r]
        if not rows:
            continue
        if header:
            col_names, data_rows = rows[0], rows[1:]
        else:
            col_names = [f"_c{i}" for i in range(len(rows[0]))]
            data_rows = rows
        types = {
            c: _infer_csv_type([r[j] for r in data_rows if j < len(r)])
            for j, c in enumerate(col_names)
        }
        cols: Dict[str, torch.Tensor] = {}
        for j, cname in enumerate(col_names):
            t = types[cname]
            if t == "long":
                arr = np.array([int(r[j]) for r in data_rows], dtype=np.int32)
            elif t == "double":
                arr = np.array([float(r[j]) for r in data_rows], dtype=np.float32)
            else:
                arr = np.array(
                    [dictionary.encode(r[j]) for r in data_rows], dtype=np.int32
                )
            cols[cname] = torch.from_numpy(arr).to(device)
        valid = torch.ones((len(data_rows),), dtype=torch.bool, device=device)
        out[name] = (ViewSchema(types), TableData(cols, valid))
    return out


def _infer_csv_type(vals: List[str]) -> str:
    for cast, kind in ((int, "long"), (float, "double")):
        try:
            for v in vals:
                cast(v)
            return kind
        except ValueError:
            pass
    return "string"


@dataclass
class PackedRaw:
    """A raw batch as ONE ``[len(layout)+1, capacity]`` int32 matrix:
    every 4-byte column a row (floats bitcast, bools widened), validity
    the last row. The matrix crosses to the card in one copy, and the
    step splits it back into columns with views.

    ``ingest_slot`` is the ``(pool, matrix)`` the native decoder wrote
    into, owned by the batch until the pool may reuse it;
    ``h2d_event`` is the CUDA event recorded after the matrix's copy to
    the card (None while the matrix is on the host, and on the CPU)."""

    data: torch.Tensor
    layout: Tuple[Tuple[str, str], ...]  # (column, kind: i32|f32|bool)
    ingest_slot: Optional[Tuple[PackedBufferPool, torch.Tensor]] = None
    h2d_event: Optional["torch.cuda.Event"] = None

    def unpack(self) -> TableData:
        """The rows as named columns: views of ``data``, no copy."""
        cols: Dict[str, torch.Tensor] = {}
        for i, (name, kind) in enumerate(self.layout):
            row = self.data[i]
            if kind == "f32":
                row = row.view(torch.float32)
            elif kind == "bool":
                row = row != 0
            cols[name] = row
        return TableData(cols, self.data[len(self.layout)] != 0)


def pack_raw(np_cols: Dict[str, np.ndarray], valid: np.ndarray) -> PackedRaw:
    """Stack host columns into the single-transfer matrix, on the host
    (``dispatch_batch`` ships it): float32/float64 rows bitcast as
    float32, bools widened, other integers wrapped to int32 as the
    reference's x64-off ``jnp.asarray`` does."""
    rows: List[np.ndarray] = []
    layout: List[Tuple[str, str]] = []
    for c, a in np_cols.items():
        if a.dtype.kind == "f":
            kind = "f32"
            a = a.astype(np.float32, copy=False).view(np.int32)
        elif a.dtype == np.bool_:
            kind = "bool"
            a = a.astype(np.int32)
        else:
            kind = "i32"
            a = a.astype(np.int32, copy=False)
        rows.append(a)
        layout.append((c, kind))
    rows.append(valid.astype(np.int32))
    return PackedRaw(torch.from_numpy(np.stack(rows)), tuple(layout))


def pack_from_matrix(
    matrix: Union[np.ndarray, torch.Tensor], layout: Tuple[Tuple[str, str], ...],
) -> PackedRaw:
    """PackedRaw over an ALREADY-packed host matrix, without a copy: the
    sibling of ``pack_raw`` for a matrix written in the transfer layout
    to begin with, such as a native decoder pool's."""
    if isinstance(matrix, np.ndarray):
        matrix = torch.from_numpy(matrix)
    return PackedRaw(matrix, tuple(layout))


# raw-schema type -> PackedRaw row kind (the bitcast pack_raw applies)
_PACK_KINDS = {"double": "f32", "boolean": "bool"}


def packed_raw_layout(raw_types: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    """The PackedRaw layout the ingest hot path builds for a raw schema
    (column order preserved; kinds per the pack_raw bitcast rules)."""
    return tuple(
        (c, _PACK_KINDS.get(t, "i32")) for c, t in raw_types.items()
    )


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def transfer_buckets(full_cap: int) -> List[int]:
    """Every sized-transfer capacity an output of padded capacity
    ``full_cap`` can be fetched at: the pow2 lattice
    ``transfer_capacity`` buckets to (engaging only while the sized cap
    at least halves the copy), plus the full capacity itself (the
    pre-EWMA / overflow / sized-off fetch). Bounds the A/B output slots
    an output can hold."""
    caps: List[int] = []
    c = _pow2_ceil(MIN_TRANSFER_ROWS)
    while c * 2 <= full_cap:
        caps.append(c)
        c *= 2
    caps.append(int(full_cap))
    return caps


def _row_shaped(v: torch.Tensor, t: TableData) -> bool:
    return v.shape[:1] == t.valid.shape


def _slice_table(t: TableData, cap: int) -> TableData:
    """An (already compacted) output table's first ``cap`` rows, as
    views: the device-to-host copy then moves ``cap`` rows instead of
    the full padded capacity. The full table stays referenced by its
    batch for the two-phase overflow re-fetch."""
    return TableData(
        {c: v[:cap] if _row_shaped(v, t) else v for c, v in t.cols.items()},
        t.valid[:cap],
    )


def _map_table(t: TableData, fn) -> TableData:
    return TableData({c: fn(v) for c, v in t.cols.items()}, fn(t.valid))


def _pack_slot(t: TableData, slot: TableData) -> TableData:
    """Write a sliced output table into a resident transfer slot (the
    port of the JAX package's donated ``_pack_slot``): one ``copy_`` a
    column on the step's stream. The caller guarantees the slot's last
    transfer has landed."""
    for c, v in t.cols.items():
        slot.cols[c].copy_(v)
    slot.valid.copy_(t.valid)
    return slot


def _pinned_like(t: TableData) -> TableData:
    """Page-locked host buffers of ``t``'s shapes and dtypes, the
    destination of its non-blocking device-to-host copy."""
    return _map_table(
        t, lambda v: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
    )


def _table_nbytes(t: TableData) -> int:
    return sum(a.nbytes for a in t.cols.values()) + t.valid.nbytes


def build_step_fn(
    ts_col: Optional[str],
    windows: Dict[str, Tuple[str, float]],
    output_datasets: List[str],
    state_names: List[str],
    refdata_names: List[str],
    ring_tables: List[str],
    pipeline: Pipeline,
    source_targets: List[Tuple[str, str]],
    proj_views: Dict[str, list],
    primary_target: str,
):
    """Build the per-batch step from its compiled parts: the port of the
    JAX package's fused step (``runtime/processor.py::build_step_fn``).

    ``step(raw, rings, state, refdata, base_s, now_rel_ms, counter,
    delta_ms, aux)`` takes one raw batch per source (a ``TableData`` or
    a ``PackedRaw`` on the device, whose rows it splits into columns),
    the window rings (updated in place), the state tables, the
    reference tables, the 0-d int32 time tensors, the host-side batch
    counter and base delta, and the string-op tables.
    ``source_targets`` lists (source, target table) pairs. It returns
    (compacted output tables, counts vector, new state) without reading
    anything back from the device. A state table's new value is the
    statement that assigns its name (a GROUP BY's capacity, which may
    differ from the loaded table's) or, without one, the old table.
    """

    def step(
        raw: Dict[str, Union[TableData, PackedRaw]],
        rings: Dict[str, WindowBuffers],
        state: Dict[str, TableData],
        refdata: Dict[str, TableData],
        base_s: torch.Tensor,
        now_rel_ms: torch.Tensor,
        counter: int,
        delta_ms: int,
        aux: Dict[str, torch.Tensor],
    ):
        # 1. per-source projection into its target table (each source
        # gets its own env so `Raw` binds to ITS raw table)
        projected: Dict[str, TableData] = {}
        for sname, target in source_targets:
            rt = raw[sname]
            if isinstance(rt, PackedRaw):
                rt = rt.unpack()  # split the single-transfer matrix
            env: Dict[str, TableData] = {
                "Raw": rt,
                DatasetName.DataStreamRaw: rt,
                "__aux": aux,
            }
            for v in proj_views[sname]:
                env[v.name] = v.fn(env, base_s, now_rel_ms)
            projected[target] = env[target]

        # 2. ring updates, in place; each ring's slot derives from the
        # shared batch counter on the host
        for table in ring_tables:
            buf = rings[table]
            update_buffers(
                buf, projected[table], counter % buf.slots, delta_ms, ts_col
            )

        tables: Dict[str, TableData] = dict(projected)
        for wname, (table, dur_s) in windows.items():
            tables[wname] = window_table(
                rings[table], int(dur_s * 1000), now_rel_ms, ts_col
            )
        for rname in refdata_names:
            tables[rname] = refdata[rname]
        for sname in state_names:
            tables[sname] = state[sname]

        out = pipeline.run(tables, base_s, now_rel_ms, aux=aux)

        new_state = {n: out.get(n, state[n]) for n in state_names}

        # compact outputs on the device (valid rows to the front) so the
        # host copies only [:count] rows; every per-batch scalar rides
        # ONE int32 vector
        datasets = {}
        counts = [projected[primary_target].count()]
        for n in output_datasets:
            t = out[n]
            idx, ov = compact_indices(t.valid, t.valid.shape[0])
            datasets[n] = TableData(
                {c: v[idx] if v.shape[:1] == t.valid.shape else v
                 for c, v in t.cols.items()},
                ov,
            )
            counts.append(t.count())
        # fixed layout: per output one groups-overflow then one
        # join-overflow slot; -1 marks "output does not track this
        # overflow" so the host can keep emitting 0 for ones that do
        missing = torch.full((), -1, dtype=torch.int32, device=base_s.device)
        for key in ("__overflow.groups", "__overflow.joins"):
            for n in output_datasets:
                counts.append(
                    out[n].cols[key][0] if key in out[n].cols else missing
                )
        # per-target projected input counts (multi-source metrics)
        for _sname, target in source_targets:
            counts.append(projected[target].count())
        counts_vec = torch.stack([c.to(torch.int32) for c in counts])
        return datasets, counts_vec, new_state

    return step


@dataclass
class SourceSpec:
    """One named input stream of a flow: its schema, projection chain,
    the table its projected rows land in, its batch capacity, and its
    input conf (``datax.job.input.default.*`` or
    ``datax.job.input.sources.<name>.*``), from which a host builds its
    source."""

    name: str
    target: str
    schema: Schema
    raw_schema: ViewSchema
    projection_steps: List[str]
    capacity: int
    conf: SettingDictionary


DEFAULT_SOURCE = "default"


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


class FlowProcessor:
    """Compiled per-flow processor. Build once; call process_batch per
    micro-batch (the closure the reference builds at
    CommonProcessorFactory.scala:50-120).

    ``device`` is where the step runs: ``"cuda"`` by default, which
    raises when no CUDA device is present; ``"cpu"`` runs the same step
    with each kernel's plain PyTorch version."""

    def __init__(
        self,
        dict_: SettingDictionary,
        dictionary: Optional[StringDictionary] = None,
        udfs: Optional[dict] = None,
        batch_capacity: Optional[int] = None,
        output_datasets: Optional[List[str]] = None,
        device: "torch.device | str" = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise EngineException(
                f"FlowProcessor device {str(self.device)!r}: no CUDA device "
                "is present (pass device='cpu' to run on the CPU)"
            )
        self.dict = dict_
        self._refuse_unported(dict_)
        self.dictionary = dictionary or StringDictionary()
        # dictionary capacity bound (see StringDictionary.__init__) —
        # applied even to an injected shared dictionary so the flow conf
        # stays authoritative
        sd_conf = dict_.get_sub_dictionary(
            SettingNamespace.JobProcessPrefix + "stringdictionary."
        )
        maxsize = sd_conf.get_int_option("maxsize")
        if maxsize is not None:
            if maxsize < 1:
                raise EngineException(
                    f"process.stringdictionary.maxsize must be >= 1, "
                    f"got {maxsize}"
                )
            self.dictionary.max_size = maxsize
        if (sd_conf.get_or_else("strict", "false") or "").lower() == "true":
            self.dictionary.strict = True
        # conf-declared UDFs (jar.udf/jar.udaf namespaces) + direct ones;
        # reference: ExtendedUDFHandler/JarUDFHandler reflection loading
        self.udfs = {**load_udfs_from_conf(dict_), **(udfs or {})}
        # on_interval failures, drained into the DATAX-<flow>:
        # UdfRefreshError metric at collect()
        self.udf_refresh_errors = 0

        input_conf = dict_.get_sub_dictionary(SettingNamespace.JobInputPrefix)
        process_conf = dict_.get_sub_dictionary(SettingNamespace.JobProcessPrefix)

        # pipelining + sized output transfer conf
        # (datax.job.process.pipeline.*): `depth` is the in-flight
        # window of a pipelined host; `sizedtransfer` adapts each
        # output's device-to-host copy to observed row counts;
        # `outputslots` stages those copies in resident A/B slots
        pipe_conf = process_conf.get_sub_dictionary("pipeline.")
        depth = pipe_conf.get_int_option("depth")
        if depth is None:
            depth = DEFAULT_PIPELINE_DEPTH
        elif depth < 1:
            raise EngineException(
                f"process.pipeline.depth must be >= 1, got {depth}"
            )
        self.pipeline_depth = depth
        # the shard count the native decoder fans each payload across
        # (datax.job.process.ingest.decoderthreads; DATAX_DECODER_THREADS
        # stays the operator override); None = the engine default
        decoder_threads = process_conf.get_sub_dictionary(
            "ingest."
        ).get_int_option("decoderthreads")
        if decoder_threads is not None and decoder_threads < 1:
            raise EngineException(
                f"process.ingest.decoderthreads must be >= 1, got "
                f"{decoder_threads}"
            )
        self.decoder_threads = decoder_threads
        self.sized_transfer = (
            pipe_conf.get_or_else("sizedtransfer", "true") or ""
        ).lower() != "false"
        self.output_slots_enabled = (
            pipe_conf.get_or_else("outputslots", "true") or ""
        ).lower() != "false"
        # per-output EWMA of observed valid row counts — the sized
        # transfer capacity tracks this, bucketed to powers of two
        self.transfer_ewma: Dict[str, float] = {}
        # outputs still riding the post-overflow doubled headroom:
        # name -> batches remaining
        self.transfer_boost: Dict[str, int] = {}
        # (output, capacity) -> [slot A, slot B], each slot
        # (device table, pinned host table or None on the CPU, landed
        # event of the batch that last shipped it)
        self._slots: Dict[Tuple[str, int], list] = {}
        self._slot_parity: Dict[str, int] = {}
        # counters drained into metrics at collect: Transfer_<name>_Count
        # and the host-side Input_<name>_Count. A landing thread drains
        # them while the dispatch thread adds to them, hence the lock.
        self._stats_lock = threading.Lock()
        self.transfer_stats: Dict[str, int] = {}
        # the side stream every batch's device-to-host copies run on
        self._d2h_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

        self.interval_s = float(
            input_conf.get_or_else("streaming.intervalinseconds", "1")
        )
        max_rate = int(input_conf.get_or_else("eventhub.maxrate", "1000"))
        # flow-level default batch capacity: ctor arg > process conf
        # (generation.py S400 writes process.batchcapacity) > input conf
        default_capacity = (
            batch_capacity
            or process_conf.get_int_option("batchcapacity")
            or int(
                input_conf.get_or_else(
                    "streaming.maxbatchsize",
                    str(max(64, int(max_rate * self.interval_s))),
                )
            )
        )

        self.timestamp_column = process_conf.get("timestampcolumn")
        self.watermark_s = process_conf.get_duration_option("watermark") or 0.0

        # per-row Properties map (reference: handler/PropertiesHandler.scala
        # — appendproperty.* conf entries + BatchTime/CPTime/CPExecutor).
        # Conf-gated: flows opt in by declaring appendproperty.* keys or
        # process.properties.enabled=true; otherwise the column stays NULL.
        self.append_properties = dict(
            process_conf.get_sub_dictionary("appendproperty.").dict
        )
        self.properties_enabled = bool(self.append_properties) or (
            process_conf.get_or_else("properties.enabled", "false") or ""
        ).lower() == "true"
        self._props_cache: Dict[Tuple, int] = {}
        import socket as _socket

        self._executor_id = f"{_socket.gethostname()}:{os.getpid()}"

        self.planner_config = self._planner_config(process_conf)

        # -- named sources ------------------------------------------------
        self.specs: Dict[str, SourceSpec] = {}
        source_groups = dict_.group_by_sub_namespace(
            SettingNamespace.JobPrefix + "input.sources."
        )
        global_projection = process_conf.get_string_seq_option("projection")
        if source_groups:
            # the flow's main input (input.default.*) joins the map as
            # the primary source when it is declared and the sources map
            # does not name its own "default": "main input + additional
            # sources"
            if (
                DEFAULT_SOURCE not in source_groups
                and input_conf.get("blobschemafile")
            ):
                self.specs[DEFAULT_SOURCE] = self._make_spec(
                    DEFAULT_SOURCE, input_conf, default_capacity,
                    global_projection,
                )
            for sname, sub in source_groups.items():
                self.specs[sname] = self._make_spec(
                    sname, sub, default_capacity,
                    # the flow-level projection applies to the default
                    # source only; others declare their own
                    global_projection if sname == DEFAULT_SOURCE else None,
                )
        else:
            self.specs[DEFAULT_SOURCE] = self._make_spec(
                DEFAULT_SOURCE, input_conf, default_capacity, global_projection
            )
        targets = [sp.target for sp in self.specs.values()]
        if len(set(targets)) != len(targets):
            raise EngineException(
                f"input sources project into duplicate tables: {targets}"
            )
        self.primary = (
            DEFAULT_SOURCE if DEFAULT_SOURCE in self.specs
            else next(iter(self.specs))
        )
        self.spec = self.specs[self.primary]
        self.batch_capacity = self.spec.capacity
        # what a host reads of the mesh, which this port refuses by conf
        # (_refuse_unported)
        self.mesh = None
        # the debug runtime (process.debug.*): conf nans / tracerleaks
        # arm the step's guards around every view and UDF call, conf
        # buffersanitizer the dynamic half of the DX8xx buffer-lifetime
        # defense (released pool slots poisoned, landed tables scanned,
        # checkpoints alias-checked). Off, none of it runs.
        dbg_conf = process_conf.get_sub_dictionary("debug.")
        self.step_guard = debugguard.from_conf(dbg_conf)
        self.debug_nans = bool(self.step_guard and self.step_guard.nans)
        self.debug_tracer_leaks = bool(self.step_guard and self.step_guard.leaks)
        self.buffer_sanitizer = sanitizer.from_conf(dbg_conf)

        # partitioned state (datax.job.process.state.*): every stateful
        # surface — accumulator tables AND window-ring snapshots —
        # hashes onto `partitions` key-range partitions
        # (runtime/statepartition.py); this replica owns the contiguous
        # range `replicaindex`/`replicacount` assigns it, persists only
        # those partitions, and (with `snapshoturl` set) ships them
        # through the shared objstore:// store so a successor replica
        # pulls exactly its assigned partitions on a rescale handoff.
        # `partitionkey` names the key column (per-table override:
        # statetable.<name>.partitionkey); `filteringest` drops rows of
        # un-owned partitions at encode time (key-routed ingest).
        state_conf = process_conf.get_sub_dictionary("state.")
        sp = state_conf.get_int_option("partitions")
        if sp is not None and sp < 1:
            raise EngineException(
                f"process.state.partitions must be >= 1, got {sp}"
            )
        self.state_partitions = sp or DEFAULT_STATE_PARTITIONS
        self.state_replica_count = max(
            1, state_conf.get_int_option("replicacount") or 1
        )
        self.state_replica_index = state_conf.get_int_option("replicaindex") or 1
        if not 1 <= self.state_replica_index <= self.state_replica_count:
            raise EngineException(
                f"process.state.replicaindex must be in "
                f"1..{self.state_replica_count}, got {self.state_replica_index}"
            )
        self.state_owned = owned_partitions(
            self.state_replica_index, self.state_replica_count,
            self.state_partitions,
        )
        self.state_partition_key = state_conf.get("partitionkey")
        self.state_filter_ingest = (
            (state_conf.get_or_else("filteringest", "false") or "")
            .lower() == "true"
        ) and self.state_replica_count > 1
        self._filter_warned: set = set()
        self.state_mirror = None
        snapshot_url = state_conf.get("snapshoturl")
        if snapshot_url:
            try:
                self.state_mirror = ObjstoreSnapshotStore(snapshot_url)
            except ValueError as e:
                raise EngineException(
                    f"process.state.snapshoturl invalid: {e}"
                ) from None
        # State_* metric deltas drained at collect + DX53x events the
        # host flight-records (shared with every StateTable). The ingest
        # filter adds to the stats on the decode thread, collect drains
        # them on the landing thread: both under _stats_lock.
        self.state_stats: Dict[str, float] = {}
        self.state_events: List[dict] = []

        self.transform_text = _read_maybe_file(process_conf.get("transform")) or ""

        # reference data: CSV tables on the device, loaded once
        self.refdata = load_reference_data_tables(
            dict_, self.dictionary, self.device
        )

        # time windows (handler/TimeWindowHandler.scala:23-68); each
        # window targets one projected table (conf `table`, else the
        # longest target that prefixes the window name, else the one
        # target of a single-source flow)
        self.windows: Dict[str, Tuple[str, float]] = {}
        for wname, sub in dict_.group_by_sub_namespace(
            SettingNamespace.JobProcessPrefix + "timewindow."
        ).items():
            table = sub.get("table") or window_target(wname, targets)
            if table not in targets:
                raise EngineException(
                    f"timewindow {wname} targets unknown table {table!r} "
                    f"(projected tables: {targets})"
                )
            self.windows[wname] = (table, sub.get_duration("windowduration"))

        # state tables — partitioned: each replica persists only its
        # owned key-range partitions, mirrored through objstore:// when
        # process.state.snapshoturl is set (the rescale-handoff path);
        # capacity 4 x the batch capacity, as in the JAX package
        self.state_tables: Dict[str, StateTable] = {}
        for sname, sub in dict_.group_by_sub_namespace(
            SettingNamespace.JobProcessPrefix + "statetable."
        ).items():
            schema = parse_state_table_schema(sub.get_string("schema"))
            location = sub.get_or_else("location", f"/tmp/dxtpu-state/{sname}")
            key = sub.get("partitionkey") or (
                self.state_partition_key
                if self.state_partition_key in schema.types else None
            )
            self.state_tables[sname] = StateTable(
                sname, schema, self.batch_capacity * 4, location,
                partitions=self.state_partitions,
                owned=self.state_owned,
                partition_key=key,
                mirror=self.state_mirror,
                stats=self.state_stats,
                events=self.state_events,
                device=self.device,
            )

        # step rebuilds after init (a UDF on_interval refresh), drained
        # into the Retrace_Count metric, the conformance monitor's DX503
        # input: eager PyTorch has no trace, and a rebuild is the work
        # the steady-state model leaves out
        self.retrace_count = 0

        # the compile manifest (process.compile.manifest: inline JSON or
        # a file path, as generation embeds it); with compile.aot
        # (default on when a manifest is present) the processor warms at
        # init. compile.cachedir/cacheurl are read by nothing here.
        comp_conf = process_conf.get_sub_dictionary("compile.")
        self.compile_manifest: Optional[dict] = None
        manifest_raw = _read_maybe_file(comp_conf.get("manifest"))
        if manifest_raw:
            try:
                self.compile_manifest = json.loads(manifest_raw)
            except ValueError as e:
                logger.warning("compile manifest does not parse: %s", e)
        aot = (
            (comp_conf.get_or_else("aot", "true") or "").lower() != "false"
        ) and self.compile_manifest is not None
        # Compile_* metric deltas drained at collect (ColdStart_Ms,
        # WarmMiss_Count)
        self.compile_stats: Dict[str, float] = {}
        self._aot_warmed = False

        self._build_pipeline(output_datasets)
        self._init_device_state()
        self._build_step()
        if aot:
            self._aot_warm()

    # -- build -----------------------------------------------------------
    @staticmethod
    def _refuse_unported(dict_: SettingDictionary) -> None:
        """Raise for conf that asks for a feature this port lacks, naming
        it, rather than run the flow without it."""
        proc = SettingNamespace.JobProcessPrefix
        if (dict_.get_int_option(proc + "numchips") or 1) > 1:
            raise EngineException(
                "mesh execution (process.numchips > 1) is not ported to "
                "data_accelerator_tpu_torch yet"
            )

    def _planner_config(self, process_conf: SettingDictionary) -> PlannerConfig:
        kwargs = {}
        maxgroups = (
            process_conf.get_int_option("maxgroups")
            or process_conf.get_int_option("groupcapacity")
        )
        if maxgroups is not None:
            if maxgroups < 1:
                raise EngineException(
                    f"process.maxgroups must be >= 1, got {maxgroups}"
                )
            kwargs["max_group_capacity"] = maxgroups
        joincap = process_conf.get_int_option("joincapacity")
        if joincap is not None:
            if joincap < 1:
                raise EngineException(
                    f"process.joincapacity must be >= 1, got {joincap}"
                )
            kwargs["join_capacity"] = joincap
        return PlannerConfig(**kwargs)

    def _make_spec(
        self,
        name: str,
        conf: SettingDictionary,
        default_capacity: int,
        global_projection: Optional[List[str]],
    ) -> SourceSpec:
        schema_text = _read_maybe_file(conf.get("blobschemafile"))
        if schema_text is None:
            raise ValueError(
                f"input schema (blobschemafile) is required for source {name!r}"
            )
        schema = Schema.from_spark_json(schema_text)
        capacity = (
            conf.get_int_option("streaming.maxbatchsize") or default_capacity
        )
        target = conf.get("target") or (
            DatasetName.DataStreamProjection if name == DEFAULT_SOURCE else name
        )

        raw_types = dict(schema_to_view(schema).types)
        raw_types.setdefault(ColumnName.RawPropertiesColumn, "string")
        raw_types.setdefault(ColumnName.RawSystemPropertiesColumn, "string")

        # projection: selectExpr lines (handler/ProjectionHandler.scala);
        # the source's own `projection` conf wins, then the flow-level
        # one, then the normalization default
        projections = (
            conf.get_string_seq_option("projection") or global_projection or []
        )
        steps = [_read_maybe_file(p) for p in projections] or [
            default_projection(schema, self.timestamp_column)
        ]
        return SourceSpec(
            name=name,
            target=target,
            schema=schema,
            raw_schema=ViewSchema(raw_types),
            projection_steps=steps,
            capacity=capacity,
            conf=conf,
        )

    def _step_udfs(self) -> dict:
        """The UDFs the step's views call: under armed debug guards,
        copies whose calls the guards check; else the UDFs themselves."""
        if self.step_guard is None:
            return self.udfs
        return {n: self.step_guard.udf(u) for n, u in self.udfs.items()}

    def _build_pipeline(self, output_datasets: Optional[List[str]]):
        udfs = self._step_udfs()
        pc = PipelineCompiler(self.dictionary, udfs, config=self.planner_config)
        # one dictionary-table registry for the whole flow (projection +
        # transform share string-op tables; see compile/stringops.py)
        self.aux_registry = pc.aux

        # 1. per-source projection pipelines: Raw -> <target table>
        self.projection_views: Dict[str, list] = {}
        self.target_schemas: Dict[str, ViewSchema] = {}
        for spec in self.specs.values():
            proj_catalog = {
                "Raw": spec.raw_schema,
                DatasetName.DataStreamRaw: spec.raw_schema,
            }
            proj_caps = {
                "Raw": spec.capacity,
                DatasetName.DataStreamRaw: spec.capacity,
            }
            cur_name = "Raw"
            views = []
            for i, step_text in enumerate(spec.projection_steps):
                sel = projection_select(step_text, cur_name)
                compiler = SelectCompiler(
                    proj_catalog, proj_caps, self.dictionary, udfs,
                    self.planner_config, aux=pc.aux,
                )
                vname = (
                    spec.target
                    if i == len(spec.projection_steps) - 1
                    else f"__proj{i}"
                )
                view = compiler.compile_select(vname, sel)
                views.append(view)
                proj_catalog[vname] = view.schema
                proj_caps[vname] = view.capacity
                cur_name = vname
            self.projection_views[spec.name] = views
            self.target_schemas[spec.target] = proj_catalog[spec.target]
        self.projected_schema = self.target_schemas[self.spec.target]

        # 2. window slots per windowed target table
        self.ring_slots: Dict[str, int] = {}
        for wname, (table, dur_s) in self.windows.items():
            if self.timestamp_column not in self.target_schemas[table].types:
                raise EngineException(
                    f"timewindow {wname} requires timestamp column "
                    f"{self.timestamp_column!r} in table {table}"
                )
            slots = num_slots(dur_s, self.watermark_s, self.interval_s)
            self.ring_slots[table] = max(self.ring_slots.get(table, 1), slots)

        # 3. main pipeline inputs: every target, every window, every
        # reference table
        target_caps = self._target_caps()
        inputs: Dict[str, Tuple[ViewSchema, int]] = {
            t: (sch, target_caps[t]) for t, sch in self.target_schemas.items()
        }
        for wname, (table, _dur) in self.windows.items():
            inputs[wname] = (
                self.target_schemas[table],
                self.ring_slots[table] * target_caps[table],
            )
        for rname, (rschema, rtable) in self.refdata.items():
            inputs[rname] = (rschema, rtable.capacity)
        state_inputs = {
            sname: (st.schema, st.capacity) for sname, st in self.state_tables.items()
        }
        self.pipeline: Pipeline = pc.compile_transform(
            self.transform_text, inputs, state_inputs
        )

        try:
            max_rounds = self.dict.get_int_option(
                "datax.job.process.stringmap.maxrounds")
        except ValueError as e:
            raise EngineException(
                f"datax.job.process.stringmap.maxrounds must be an "
                f"integer: {e}"
            ) from None
        if max_rounds is None:
            max_rounds = _MAX_ROUNDS
        elif max_rounds < 1:
            raise EngineException(
                "datax.job.process.stringmap.maxrounds must be >= 1, got "
                f"{max_rounds}"
            )
        self.aux_tables = AuxTableBuilder(
            self.aux_registry, self.dictionary,
            max_rounds=max_rounds,
            strict=(self.dict.get_or_else(
                "datax.job.process.stringmap.strict", "false") or ""
            ).lower() == "true",
            device=self.device,
        )

        # output datasets: explicit list or conf-declared output names that
        # match pipeline views (S500-style dataset==output-name contract)
        if output_datasets is None:
            conf_outputs = self.dict.get_sub_dictionary(
                SettingNamespace.JobOutputPrefix
            ).group_by_sub_namespace()
            output_datasets = [
                n for n in conf_outputs if n in self.pipeline.catalog
            ]
        self.output_datasets = [
            n for n in output_datasets if n in self.pipeline.catalog
        ]

    def _build_step(self):
        pipeline, proj_views = self.pipeline, dict(self.projection_views)
        guard = self.step_guard
        if guard is not None:
            # the step runs guarded copies of the views; the processor's
            # own pipeline (what analysis and landing read) stays as built
            pipeline = dataclasses.replace(
                pipeline, views=[guard.view_fn(v) for v in pipeline.views]
            )
            proj_views = {
                s: [guard.view_fn(v) for v in views]
                for s, views in proj_views.items()
            }
        self._step = build_step_fn(
            ts_col=self.timestamp_column,
            windows=dict(self.windows),
            output_datasets=list(self.output_datasets),
            state_names=list(self.state_tables),
            refdata_names=list(self.refdata),
            ring_tables=list(self.ring_slots),
            pipeline=pipeline,
            source_targets=[(n, sp.target) for n, sp in self.specs.items()],
            proj_views=proj_views,
            primary_target=self.spec.target,
        )

    def _target_caps(self) -> Dict[str, int]:
        return {sp.target: sp.capacity for sp in self.specs.values()}

    def _fresh_rings(self) -> Dict[str, WindowBuffers]:
        target_caps = self._target_caps()
        return {
            table: make_buffers(
                self.target_schemas[table], target_caps[table], slots,
                self.device,
            )
            for table, slots in self.ring_slots.items()
        }

    def _init_device_state(self):
        self.window_buffers: Dict[str, WindowBuffers] = self._fresh_rings()
        # state load is the handoff-critical path of a successor
        # replica (pull owned partitions from the mirror): time it once
        # so State_Handoff_Ms reports what the rescale actually cost
        t0 = time.time()
        self.state_data: Dict[str, TableData] = {
            sname: st.load(self.dictionary) for sname, st in self.state_tables.items()
        }
        if self.state_tables:
            self.state_stats.setdefault(
                "Handoff_Ms", (time.time() - t0) * 1000.0
            )
        self._slot_counter = 0
        self._base_ms: Optional[int] = None
        # held while a dispatch advances the rings, the slot counter and
        # the time base, and while a window snapshot copies them: a host
        # snapshots on its landing thread while its dispatch thread
        # enqueues the next step, and the rings change in place
        self._dispatch_lock = threading.Lock()
        # the CUDA stream the last step ran on; a snapshot's copies queue
        # behind it
        self._step_stream: Optional["torch.cuda.Stream"] = None
        # host-side ingest counters (e.g. rows dropped for garbage
        # timestamps), drained into metrics at each collect
        self.ingest_stats: Dict[str, int] = {}
        # monotonic malformed-line total (never cleared, unlike the
        # collect-time drain of ingest_stats)
        self.malformed_rows_total = 0
        # the native decoder (built at first use) and the ingest fast
        # path's pooled matrices (page-locked on CUDA), per source; the
        # schema-column -> matrix-row map; the decode gauges
        # (Decode_Shards / Decode_RowsPerSec / Decode_BufferReuse_Count)
        self._native_decoders: Dict[str, NativeDecoder] = {}
        self._ingest_pools: Dict[str, PackedBufferPool] = {}
        self._ingest_col_rows: Dict[str, List[int]] = {}
        self._decode_shards: Optional[int] = None
        self._decode_rows_per_sec: Optional[float] = None
        # which decode served the last encode_json_bytes call:
        # "native-sharded" (packed pool path) or "native-mt" (row layout)
        self.last_decoder_path: Optional[str] = None

    # -- window-state checkpoint ------------------------------------------
    def snapshot_window_state(self) -> Dict[str, object]:
        """Host copy of everything a restart would otherwise lose: the
        window ring buffers, the slot counter, the time base the ring
        timestamps are relative to, AND the string dictionary — ring
        columns hold dictionary ids, which only mean anything against
        the dictionary that encoded them. Numpy-only, in the JAX
        package's layout.

        One consistent cut: the rings change in place at every dispatch,
        so under the dispatch lock every column and ``valid`` is copied
        (on CUDA into pinned host memory, queued on the stream of the
        last step, behind it) and the counter, the time base and the
        dictionary are read. No dispatch lands between two copies; the
        caller waits for the copies after the lock is released."""
        cuda = self.device.type == "cuda"
        with self._dispatch_lock:
            stream = self._step_stream if cuda else None
            if cuda and stream is None:
                stream = torch.cuda.current_stream(self.device)
            copies = {
                table: (
                    {c: self._copy_out(a, stream) for c, a in buf.cols.items()},
                    self._copy_out(buf.valid, stream),
                )
                for table, buf in self.window_buffers.items()
            }
            counter, base_ms = self._slot_counter, self._base_ms
            entries = self.dictionary.entries()
            copied = None
            if cuda:
                copied = torch.cuda.Event()
                copied.record(stream)
        if copied is not None:
            copied.synchronize()
        return {
            "rings": {
                table: {"cols": {c: t.numpy() for c, t in cols.items()},
                        "valid": valid.numpy()}
                for table, (cols, valid) in copies.items()
            },
            "slot_counter": counter,
            "base_ms": base_ms,
            "dictionary": entries,
        }

    @staticmethod
    def _copy_out(a: torch.Tensor, stream) -> torch.Tensor:
        """A host copy of ring tensor ``a``: a clone on the CPU, or a
        pinned buffer its non-blocking copy is queued into on ``stream``."""
        if stream is None:
            return a.clone()
        with torch.cuda.stream(stream):
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a, non_blocking=True)
        return host

    def restore_window_state(self, snap: Dict[str, object]) -> bool:
        """Restore a ``snapshot_window_state`` result — this port's or the
        JAX package's, whose layout is the same — onto this processor's
        device. Shape-checked: a conf change that resized the rings
        invalidates the snapshot (returns False and keeps the fresh zero
        state). The saved dictionary must agree with the strings this
        process has already encoded (same conf => same compile-time
        literals in the same order); on agreement the remaining saved
        entries replay so every restored ring id decodes to the string
        it meant before."""
        saved_dict = snap.get("dictionary")
        if saved_dict is not None:
            if not self.dictionary.restore_entries(saved_dict):
                return False
        rings = snap.get("rings", {})
        restored: Dict[str, WindowBuffers] = {}
        for table, buf in self.window_buffers.items():
            saved = rings.get(table)
            if saved is None:
                return False
            if set(saved["cols"]) != set(buf.cols) or any(
                tuple(saved["cols"][c].shape) != tuple(buf.cols[c].shape)
                or saved["cols"][c].dtype != _np_dtype(buf.cols[c])
                for c in buf.cols
            ):
                return False
            restored[table] = WindowBuffers(
                {c: torch.from_numpy(np.array(a, copy=True)).to(self.device)
                 for c, a in saved["cols"].items()},
                torch.from_numpy(np.array(saved["valid"], copy=True)).to(self.device),
            )
        base = snap.get("base_ms")
        with self._dispatch_lock:
            self.window_buffers = restored
            self._slot_counter = int(snap.get("slot_counter", 0))
            self._base_ms = int(base) if base is not None else None
        return True

    # -- partitioned window state (the rescale-handoff path) --------------
    WINDOW_STORE_NAME = "__window__"

    def _window_key_cols(self) -> Dict[str, Tuple[str, str]]:
        """Ring table -> (partition-key column, kind): the conf'd
        ``state.partitionkey`` when the table carries it, else the
        first non-timestamp column (rows of tables with no usable key
        land in partition 0 — statepartition.split_window_snapshot)."""
        out: Dict[str, Tuple[str, str]] = {}
        for table in self.ring_slots:
            types = self.target_schemas[table].types
            if self.state_partition_key and self.state_partition_key in types:
                key = self.state_partition_key
            else:
                key = next(
                    (c for c in types if c != self.timestamp_column), None
                )
            if key is not None:
                out[table] = (key, types[key])
        return out

    def push_window_partitions(self, snap: Dict[str, object]) -> int:
        """Ship this replica's OWNED window partitions to the objstore
        mirror as per-partition A/B snapshots + pointer (the same
        layout the state tables use). Called on the checkpoint cadence
        after commit; fail-closed like every state push."""
        if self.state_mirror is None or not snap.get("rings"):
            return 0
        parts = split_window_snapshot(
            snap, self.state_partitions, self._window_key_cols(),
            dictionary=self.dictionary, only=self.state_owned,
        )
        for p, part_snap in parts.items():
            prefix = f"{self.WINDOW_STORE_NAME}/p{p:02d}"
            side = other_side(self.state_mirror.get_pointer(prefix) or "B")
            self.state_mirror.put_files(
                prefix, side, {"window.npz": snapshot_to_bytes(part_snap)}
            )
            self.state_mirror.put_pointer(prefix, side)
        self._count_state("Snapshot_Push_Count", len(parts))
        return len(parts)

    def pull_window_partitions(self) -> List[Dict]:
        """Fetch this replica's assigned window partitions from the
        mirror — possibly written by SEVERAL predecessors. A corrupt
        active side falls back to the standby (DX530 +
        ``State_LoadFallback_Count``), both-bad loads nothing for that
        partition (DX531) and the un-acked window replay re-aggregates."""
        if self.state_mirror is None:
            return []
        out: List[Dict] = []
        for p in self.state_owned:
            prefix = f"{self.WINDOW_STORE_NAME}/p{p:02d}"
            pointer = self.state_mirror.get_pointer(prefix)
            if pointer is None:
                continue
            snap = None
            for attempt, side in enumerate((pointer, other_side(pointer))):
                data = self.state_mirror.get_file(prefix, side, "window.npz")
                if data is None:
                    continue
                try:
                    snap = snapshot_from_bytes(data)
                    break
                except Exception as e:  # noqa: BLE001 — corrupt snapshot
                    self._count_state("LoadFallback_Count", 1)
                    self.state_events.append({
                        "code": "DX530" if attempt == 0 else "DX531",
                        "table": self.WINDOW_STORE_NAME,
                        "partition": p, "side": side,
                        "message": (
                            f"window partition {p} side {side} "
                            f"unreadable ({e})"
                        ),
                        "ts": time.time(),
                    })
            if snap is not None:
                out.append(snap)
        if out:
            self._count_state("Snapshot_Pull_Count", len(out))
        return out

    def restore_window_partitions(self) -> bool:
        """The successor half of a window handoff: pull the assigned
        partitions, merge them (re-packed per slot, timestamps rebased,
        string ids remapped into the LIVE dictionary —
        statepartition.merge_window_snapshots) and restore. False when
        the mirror holds nothing usable."""
        parts = self.pull_window_partitions()
        if not parts:
            return False
        merged = merge_window_snapshots(
            parts,
            {t: dict(self.target_schemas[t].types) for t in self.ring_slots},
            self.dictionary,
            self.timestamp_column,
        )
        if merged is None:
            return False
        dropped = merged.pop("dropped_rows", 0)
        if dropped:
            self._count_state("WindowRows_Dropped_Count", dropped)
        return self.restore_window_state(merged)

    def commit(self) -> None:
        """Commit state-table pointers after sinks succeed (and push the
        committed partitions to the objstore mirror, fail-closed)."""
        for st in self.state_tables.values():
            st.persist()

    # -- re-entrant use (LiveQuery kernels) ---------------------------------
    def reset_state(self) -> None:
        """Start the flow over, for re-entrant uses like LiveQuery
        kernels where each execute must be idempotent: the rings zeroed
        in place, the slot counter and time base cleared and the state
        tables reloaded, under the dispatch lock; then the adaptive
        transfer state (count EWMA, overflow boost, slot parity), so
        every execute copies its outputs at full capacity through the
        same transfer slots. The string dictionary stays, as in the JAX
        package. On CUDA the zeroing queues behind the last step."""
        with self._dispatch_lock:
            cuda = self.device.type == "cuda"
            if cuda and self._step_stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(self._step_stream)
            for buf in self.window_buffers.values():
                for a in buf.cols.values():
                    a.zero_()
                buf.valid.zero_()
            self.state_data = {
                sname: st.load(self.dictionary)
                for sname, st in self.state_tables.items()
            }
            self._slot_counter = 0
            self._base_ms = None
        self.transfer_ewma.clear()
        self.transfer_boost.clear()
        self._slot_parity.clear()

    def _step_cache_size(self) -> int:
        """The compile surface eager PyTorch can grow: the step builds
        alive, 1 once the step is built (a rebuild replaces it). The JAX
        package counts its jitted step's cache entries."""
        return 1 if self._step is not None else 0

    def device_bytes(self) -> int:
        """Resident bytes this processor holds on its device: the sum
        over the distinct tensor storages reachable from it (rings,
        state tables, reference tables, string-op tables, the step's
        constants, the transfer slots' device side) that lie on its
        device, so pinned host memory is left out. On CUDA each storage
        counts at the caching allocator's 512-byte block granularity,
        the unit of ``torch.cuda.memory_allocated``."""
        storages: Dict[int, int] = {}
        seen: set = set()
        stack: list = [self.__dict__]
        # nothing under these holds a tensor of the processor's
        skip = (str, bytes, int, float, bool, type(None), np.ndarray, type,
                types.ModuleType, torch.device, torch.dtype, StringDictionary)
        while stack:
            obj = stack.pop()
            if isinstance(obj, skip) or id(obj) in seen:
                continue
            seen.add(id(obj))
            if isinstance(obj, torch.Tensor):
                dev = obj.device
                if dev.type == self.device.type and (
                    self.device.index is None or dev.index == self.device.index
                ):
                    st = obj.untyped_storage()
                    if st.data_ptr():
                        storages[st.data_ptr()] = st.nbytes()
            elif isinstance(obj, dict):
                stack.extend(obj.values())
            elif isinstance(obj, (list, tuple, set, frozenset, deque)):
                stack.extend(obj)
            elif isinstance(obj, types.FunctionType):
                for cell in obj.__closure__ or ():
                    try:
                        stack.append(cell.cell_contents)
                    except ValueError:  # a cell not bound yet
                        pass
                stack.extend(obj.__defaults__ or ())
            elif isinstance(obj, types.MethodType):
                stack.append(obj.__self__)
            elif isinstance(obj, functools.partial):
                stack.extend((obj.func, obj.args, obj.keywords))
            elif hasattr(obj, "__dict__"):
                stack.append(vars(obj))
        if self.device.type == "cuda":
            return sum(-(-n // 512) * 512 for n in storages.values())
        return sum(storages.values())

    def device_memory_stats(self) -> Optional[Dict[str, int]]:
        """The device allocator's live watermark under the JAX package's
        keys: ``bytes_in_use`` and ``peak_bytes_in_use`` from
        ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
        ``.peak``) of the processor's card. None on the CPU, which
        reports none, as in the JAX package."""
        if self.device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(self.device)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        }

    # -- per-batch host path ----------------------------------------------
    def _properties_id(self, base_ms: int, file_info: Optional[dict] = None) -> int:
        """Dictionary id of the per-row Properties JSON map (reference:
        PropertiesHandler's per-row UDF result). Cached per (batch
        second, file) so repeated rows share one dictionary entry."""
        import datetime as _dt

        key = (base_ms, file_info.get("path") if file_info else None)
        sid = self._props_cache.get(key)
        if sid is not None:
            return sid

        def iso(ms: int) -> str:
            return _dt.datetime.fromtimestamp(
                ms / 1000, _dt.timezone.utc
            ).strftime("%Y-%m-%d %H:%M:%S")

        from ..constants import ProcessingPropertyName as P

        props = dict(self.append_properties)
        props[P.BatchTime] = iso(base_ms)
        props[P.CPTime] = iso(int(time.time()) * 1000)
        props[P.CPExecutor] = self._executor_id
        if file_info:
            if file_info.get("fileTimeMs"):
                props[P.BlobTime] = iso(int(file_info["fileTimeMs"]))
            if file_info.get("path"):
                props[P.BlobPathHint] = os.path.basename(file_info["path"])
        sid = self.dictionary.encode(json.dumps(props, sort_keys=True))
        if len(self._props_cache) > 4096:
            self._props_cache.clear()
        self._props_cache[key] = sid
        return sid

    def encode_rows(
        self, rows: List[dict], base_ms: int, source: Optional[str] = None
    ) -> TableData:
        """Host-side encoder of JSON-like row dicts (python loop)."""
        from ..core.batch import batch_from_rows

        spec = self._spec_for(source)
        stats: Dict[str, int] = {}
        # encoded on the host, filtered there, then copied to the card
        b = batch_from_rows(
            rows, spec.schema, spec.capacity, self.dictionary,
            base_ms, stats=stats,
        )
        for k, n in stats.items():
            self._count_ingest(k, n)
        cols = {
            c: _host_to_device(v.numpy(), self.device) for c, v in b.columns.items()
        }
        valid = b.valid.numpy()
        if self.state_filter_ingest:
            src = b.columns.get(self.state_partition_key)
            valid = self._filter_unowned(
                src.numpy() if src is not None else None, valid, spec
            )
        if self.properties_enabled:
            default_id = self._properties_id(base_ms)
            props = np.full(spec.capacity, 0, np.int32)
            for i in range(min(len(rows), spec.capacity)):
                fi = rows[i].get(ColumnName.InternalColumnFileInfo)
                props[i] = (
                    self._properties_id(base_ms, fi) if fi else default_id
                )
            cols[ColumnName.RawPropertiesColumn] = _host_to_device(props, self.device)
        for extra in (
            ColumnName.RawPropertiesColumn, ColumnName.RawSystemPropertiesColumn
        ):
            cols.setdefault(
                extra,
                torch.zeros((spec.capacity,), dtype=torch.int32, device=self.device),
            )
        return TableData(cols, _host_to_device(valid, self.device))

    def encode_columns(
        self, np_cols: Dict[str, np.ndarray], n: int,
        source: Optional[str] = None,
    ) -> TableData:
        """Host columns (the first ``n`` rows valid) as the raw batch on
        the device, padded to capacity. On CUDA the copies queue on the
        calling thread's current stream."""
        spec = self._spec_for(source)
        cap = spec.capacity
        fill_dtype = {"double": torch.float32, "boolean": torch.bool}
        cols = {}
        for c, t in spec.raw_schema.types.items():
            if c in np_cols:
                a = np_cols[c]
                pad = np.zeros(cap, dtype=a.dtype)
                pad[: min(n, cap)] = a[: min(n, cap)]
                cols[c] = _host_to_device(pad, self.device)
            elif (
                c == ColumnName.RawPropertiesColumn and self.properties_enabled
            ):
                cols[c] = torch.full(
                    (cap,),
                    self._properties_id(int(time.time()) * 1000),
                    dtype=torch.int32, device=self.device,
                )
            else:
                cols[c] = torch.zeros(
                    (cap,), dtype=fill_dtype.get(t, torch.int32), device=self.device
                )
        valid = np.zeros(cap, dtype=bool)
        valid[: min(n, cap)] = True
        if self.state_filter_ingest and n > 0:
            key = self.state_partition_key
            kv = None
            if key in np_cols:
                kv = np.zeros(cap, dtype=np_cols[key].dtype)
                kv[: min(n, cap)] = np_cols[key][: min(n, cap)]
            valid = self._filter_unowned(kv, valid, spec)
        return TableData(cols, _host_to_device(valid, self.device))

    # -- JSON ingest --------------------------------------------------------
    def _spec_for(self, source: Optional[str]) -> SourceSpec:
        spec = self.specs.get(self.primary if source is None else source)
        if spec is None:
            raise EngineException(
                f"unknown source {source!r} (declared: {list(self.specs)})"
            )
        return spec

    def encode_json_bytes(
        self,
        data: bytes,
        base_ms: int,
        source: Optional[str] = None,
        packed: bool = True,
        to_device: bool = True,
        fmt: str = "jsonl",
    ) -> Union[TableData, PackedRaw]:
        """Raw wire bytes decoded by the native decoder
        (``csrc/decoder.cpp``) straight into columnar buffers: the
        from_json role at CommonProcessorFactory.scala:90-103 without any
        per-event Python object. The decoder builds with ``g++`` at first
        use; a failed build raises, there is no Python decoder.

        ``fmt``: ``"jsonl"`` (newline-delimited JSON) or ``"kafka-v2"``
        (whole Kafka message-format-v2 record batches: CRC-32C verified
        per batch, corrupt batches skipped and counted, compressed ones
        refused with a typed error).

        ``packed`` (the default): the decoder shards write into a pooled
        ``[n_cols+1, capacity]`` int32 matrix in the ``PackedRaw``
        layout, page-locked on a CUDA processor, with no per-call column
        allocation. ``to_device=False`` returns it on the host, for a
        decode-ahead thread; ``dispatch_batch`` then makes the one
        host-to-device copy. ``packed=False`` decodes in the row layout
        (kafka-v2 record values through ``kafka_wire``'s Python walker)
        and copies each column to the device."""
        spec = self._spec_for(source)
        decoder = self._native_decoders.get(spec.name)
        if decoder is None:
            decoder = NativeDecoder(
                spec.schema, self.dictionary, threads=self.decoder_threads
            )
            self._native_decoders[spec.name] = decoder
        if packed:
            return self._encode_packed_native(
                decoder, data, base_ms, spec, fmt, to_device
            )
        self.last_decoder_path = "native-mt"
        if fmt == "kafka-v2":
            data = self._kafka_values_to_lines(data)
        arrays, valid, rows, consumed = decoder.decode(data, spec.capacity)
        self._decode_shards = decoder.last_shards
        self._count_jsonl_malformed(data, consumed, rows)
        self._count_ingest("bad_timestamps", decoder.last_bad_timestamps)
        cap = spec.capacity
        np_cols: Dict[str, np.ndarray] = {}
        for col in spec.schema.columns:
            a = arrays[col.name]
            if col.ctype == ColType.TIMESTAMP:
                # slots the decoder left at 0 (field missing) stay at
                # relative 0; deltas saturate at the int32 range like the
                # Python encoder (core/batch.py) instead of wrapping
                a = np.where(
                    a == 0,
                    np.int64(0),
                    np.clip(a - np.int64(base_ms), -2**31, 2**31 - 1),
                ).astype(np.int32)
            elif col.ctype == ColType.BOOLEAN:
                a = a.astype(np.bool_)
            np_cols[col.name] = a
        for extra in (
            ColumnName.RawPropertiesColumn,
            ColumnName.RawSystemPropertiesColumn,
        ):
            if extra in spec.raw_schema.types and extra not in np_cols:
                if (
                    extra == ColumnName.RawPropertiesColumn
                    and self.properties_enabled
                ):
                    np_cols[extra] = np.full(
                        cap, self._properties_id(base_ms), np.int32
                    )
                else:
                    np_cols[extra] = np.zeros(cap, np.int32)
        valid = np.asarray(valid)
        if self.state_filter_ingest:
            valid = self._filter_unowned(
                np_cols.get(self.state_partition_key), valid, spec
            )
        return TableData(
            {c: _host_to_device(a, self.device) for c, a in np_cols.items()},
            _host_to_device(valid, self.device),
        )

    def _kafka_values_to_lines(self, data: bytes) -> bytes:
        """Python record-batch walk for the row layout: extract record
        values (CRC verified, corrupt batches counted, compressed
        rejected typed) and hand them to the line decoder. Well-formed
        JSON never contains a raw newline, so the join is loss-free; a
        malformed value containing one just counts as malformed
        twice."""
        from .kafka_wire import decode_record_batches

        stats: Dict[str, int] = {}
        recs, _next = decode_record_batches(data, stats=stats)
        self._count_ingest("CorruptBatch", stats.get("corrupt_batches", 0))
        return b"\n".join(v for _o, _ts, v in recs) + (b"\n" if recs else b"")

    def _count_jsonl_malformed(self, data: bytes, consumed: int,
                               rows: int) -> None:
        """Malformed lines in the consumed range = newline count minus
        decoded rows (the decoder zero-gaps them); feeds the
        Input_malformed_rows_Count metric. A blank line counts as
        malformed too, as in the JAX package."""
        consumed_blob = data[:consumed] if consumed else data
        lines_seen = consumed_blob.count(b"\n")
        if consumed_blob and not consumed_blob.endswith(b"\n"):
            lines_seen += 1
        self._count_ingest(
            "malformed_rows", max(0, lines_seen - int(rows)), malformed=True
        )

    def _count_ingest(self, key: str, n: int, malformed: bool = False) -> None:
        if not n:
            return
        with self._stats_lock:
            self.ingest_stats[key] = self.ingest_stats.get(key, 0) + n
            if malformed:
                self.malformed_rows_total += n

    def _encode_packed_native(
        self, decoder: NativeDecoder, data: bytes, base_ms: int,
        spec: SourceSpec, fmt: str, to_device: bool,
    ) -> PackedRaw:
        """The allocation-free hot path: acquire a pooled, persistent
        matrix already laid out as the packed transfer and let the
        decoder shards write straight into it. The returned PackedRaw
        carries its pool slot, which its PendingBatch gives back."""
        layout = packed_raw_layout(spec.raw_schema.types)
        names = [c for c, _k in layout]
        n_rows = len(layout) + 1
        cap = spec.capacity
        pool = self._ingest_pools.get(spec.name)
        if pool is None or pool.n_rows != n_rows or pool.capacity != cap:
            pool = PackedBufferPool(
                n_rows, cap, pin=self.device.type == "cuda"
            )
            # armed debug.buffersanitizer: released slots get poisoned
            pool.sanitizer = self.buffer_sanitizer
            self._ingest_pools[spec.name] = pool
        col_rows = self._ingest_col_rows.get(spec.name)
        if col_rows is None:
            index = {c: i for i, c in enumerate(names)}
            col_rows = [index[c.name] for c in spec.schema.columns]
            self._ingest_col_rows[spec.name] = col_rows
        valid_row = len(layout)
        mat = pool.acquire()
        host = mat.numpy()  # the decoder writes through this view
        t0 = time.perf_counter()
        try:
            if fmt == "kafka-v2":
                rows, kstats = decoder.decode_kafka_packed(
                    data, host, col_rows, valid_row, base_ms, max_rows=cap
                )
                self._count_ingest(
                    "malformed_rows", kstats["malformed"], malformed=True
                )
                self._count_ingest("CorruptBatch", kstats["corrupt_batches"])
                # records that arrived without a row slot are LOST data
                # (a producer batch larger than the flow capacity):
                # counted, never silent
                self._count_ingest(
                    "kafka_overflow_rows", kstats["overflow_dropped"]
                )
            else:
                rows, consumed = decoder.decode_packed(
                    data, host, col_rows, valid_row, base_ms, max_rows=cap
                )
                self._count_jsonl_malformed(data, consumed, rows)
        except Exception:
            pool.release(mat)
            raise
        dt = time.perf_counter() - t0
        self.last_decoder_path = "native-sharded"
        self._decode_shards = decoder.last_shards
        if dt > 0 and rows:
            self._decode_rows_per_sec = rows / dt
        self._count_ingest("bad_timestamps", decoder.last_bad_timestamps)
        # rows the decoder doesn't own (Properties/SystemProperties):
        # the pool hands back dirty matrices, so (re)fill them per call
        schema_rows = set(col_rows)
        for i, cname in enumerate(names):
            if i in schema_rows:
                continue
            if (
                cname == ColumnName.RawPropertiesColumn
                and self.properties_enabled
            ):
                host[i].fill(self._properties_id(base_ms))
            else:
                host[i].fill(0)
        if self.state_filter_ingest:
            # the key row of the pinned matrix, filtered before the
            # host-to-device copy
            key = self.state_partition_key
            kv = None
            if key in names:
                krow = host[names.index(key)]
                kv = krow.view(np.float32) if dict(layout)[key] == "f32" else krow
            host[valid_row] = self._filter_unowned(
                kv, host[valid_row] != 0, spec
            ).astype(np.int32)
        raw = PackedRaw(mat, layout, ingest_slot=(pool, mat))
        return self._ship(raw) if to_device else raw

    def _ship(self, raw: PackedRaw) -> PackedRaw:
        """A host PackedRaw onto a CUDA processor's card: ONE
        non-blocking copy of the matrix on the current stream, and the
        event after it that gates the pool's reuse of the matrix. A
        PackedRaw already on the card, or any on a CPU processor, is
        returned as it is."""
        if self.device.type != "cuda" or raw.data.is_cuda:
            return raw
        data = raw.data.to(self.device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return PackedRaw(data, raw.layout, raw.ingest_slot, copied)

    def dispatch_batch(
        self,
        raw: Union[TableData, PackedRaw, Dict[str, Union[TableData, PackedRaw]], None],
        batch_time_ms: Optional[int] = None,
    ) -> "PendingBatch":
        """Queue one micro-batch on the device and return a handle.

        ``raw``: one TableData or PackedRaw (routed to the primary
        source) or a dict {source name -> TableData or PackedRaw};
        sources absent from the dict run with an empty batch, so
        independent streams may tick at their own pace (None runs an
        empty batch on every source). A PackedRaw still on the host
        crosses to the card in one copy here. The device runs
        asynchronously: the caller can encode the next batch while this
        one computes. The handle's result copies start at once on a side
        stream; ``PendingBatch.collect_counts`` waits for the counts and
        ``collect_tables`` for the tables.
        """
        t0 = time.time()
        if batch_time_ms is None:
            batch_time_ms = int(time.time() * 1000)
        if raw is None:
            raw = {}
        elif not isinstance(raw, dict):
            raw = {self.primary: raw}
        for name in raw:
            if name not in self.specs:
                raise EngineException(
                    f"dispatch_batch got unknown source {name!r} "
                    f"(declared: {list(self.specs)})"
                )
        raws: Dict[str, Union[TableData, PackedRaw]] = {}
        # (pool, matrix, h2d event) per pooled ingest matrix the batch
        # rides on, owned by the batch until it lands
        ingest: List[tuple] = []
        for name, spec in self.specs.items():
            r = raw.get(name)
            if r is None:
                r = self.encode_columns({}, 0, source=name)
            elif isinstance(r, PackedRaw):
                r = self._ship(r)
                if r.ingest_slot is not None:
                    ingest.append((*r.ingest_slot, r.h2d_event))
            raws[name] = r
        try:
            with self._dispatch_lock:
                out_datasets, counts_vec, new_state, new_base_ms = self._advance(
                    raws, batch_time_ms
                )
        except Exception:
            # the step never launched: the pool slots may be reused once
            # their copies (if any) are done
            for pool, mat, copied in ingest:
                pool.release(mat, copied)
            raise
        # sized output transfer: shrink each output's copy to its
        # adaptive capacity (power-of-two bucket over the count EWMA),
        # staged in the output's A/B transfer slot. The device has
        # already compacted valid rows to the front, so the slice keeps
        # every real row as long as the cap holds; the full-capacity
        # table stays referenced for the two-phase overflow fallback.
        fetch_tables: Dict[str, TableData] = {}
        fetch_hosts: Dict[str, Optional[TableData]] = {}
        fetch_caps: Dict[str, int] = {}
        staged_slots = []  # (slot key, parity), owned by the handle below
        for n, t in out_datasets.items():
            full_cap = int(t.valid.shape[0])
            cap = self.transfer_capacity(n, full_cap)
            fetch_caps[n] = cap
            fetch_tables[n], fetch_hosts[n] = self._stage_output(
                n, t, cap, full_cap, staged_slots
            )
        handle = PendingBatch(
            self, self.pipeline, out_datasets, counts_vec,
            batch_time_ms, new_base_ms, t0,
            out_names=list(self.output_datasets),
            fetch_tables=fetch_tables, fetch_hosts=fetch_hosts,
            fetch_caps=fetch_caps, ingest=ingest,
            # the table's own columns: a GROUP BY's state also carries
            # its overflow count
            state={
                n: TableData(
                    {c: new_state[n].cols[c] for c in st.schema.types},
                    new_state[n].valid,
                )
                for n, st in self.state_tables.items()
            },
        )
        # each staged slot is owned by THIS batch until its transfer
        # lands: the dispatch that next rotates onto the slot checks the
        # handle's landed event before writing into it again
        for key, parity in staged_slots:
            dev, host, _ev = self._slots[key][parity]
            self._slots[key][parity] = (dev, host, handle._landed)
        handle.start_fetch()
        return handle

    def _advance(self, raw, batch_time_ms: int):
        """Advance the flow by one batch, under the dispatch lock: the
        UDF refresh, the time base and slot counter, and the step
        enqueued on the current stream. Returns (output tables, counts
        vector, new state, the batch's whole-second base). The new state
        is the next batch's state input: the step never writes a state
        table in place, so an earlier batch still copying its own state
        off the card reads what its step made."""
        # per-interval UDF refresh hooks; state changes rebuild the
        # pipeline (CommonProcessorFactory.scala:351-353 onInterval).
        # A throwing hook skips its refresh and surfaces as the
        # UdfRefreshError metric rather than killing the batch loop.
        registry = UdfRegistry(self.udfs)
        if registry.refresh(batch_time_ms):
            self._build_pipeline(self.output_datasets)
            self._build_step()
            self.retrace_count += 1
        if registry.last_errors:
            self.udf_refresh_errors += len(registry.last_errors)
        # whole-second base so device absolute-time math is exact
        new_base_ms = (batch_time_ms // 1000) * 1000
        if self._base_ms is None:
            self._base_ms = new_base_ms
        delta_ms = new_base_ms - self._base_ms
        if abs(delta_ms) > 2**31 - 1:
            # a restored checkpoint (or clock jump) more than ~24.8
            # days out: every ring row is long past any window
            # horizon, and the int32 rebase would overflow — start
            # from clean rings
            self.window_buffers = self._fresh_rings()
            delta_ms = 0
        self._base_ms = new_base_ms
        counter = self._slot_counter
        self._slot_counter += 1

        # 0-d device scalars made by a fill, not copied from the host
        base_s = torch.full(
            (), new_base_ms // 1000, dtype=torch.int32, device=self.device
        )
        now_rel_ms = torch.full(
            (), batch_time_ms - new_base_ms, dtype=torch.int32,
            device=self.device,
        )
        # string-op dictionary tables: refreshed AFTER this batch's
        # encode (so they cover every id the batch can contain),
        # copied to the device only when the dictionary grew
        aux = self.aux_tables.tables()
        refdata = {n: t for n, (_s, t) in self.refdata.items()}
        # child span of the host's "dispatch" when a batch trace is
        # active; a no-op without one
        with tracing.span("device-enqueue"), kernel_build.loads_recorded() as loads:
            out_datasets, counts_vec, new_state = self._step(
                raw, self.window_buffers, self.state_data, refdata, base_s,
                now_rel_ms, counter, delta_ms, aux,
            )
        self.state_data = new_state
        if self._aot_warmed and loads:
            # a kernel of this flow first built or loaded after its warm
            self._count_compile("WarmMiss_Count", len(loads))
        if self.device.type == "cuda":
            self._step_stream = torch.cuda.current_stream(self.device)
        return out_datasets, counts_vec, new_state, new_base_ms

    def _stage_output(
        self, name: str, t: TableData, cap: int, full_cap: int,
        staged_slots: list,
    ) -> Tuple[TableData, Optional[TableData]]:
        """Output ``name``'s transfer view at capacity ``cap`` and, on
        CUDA, the pinned host buffers its copy lands in.

        With output slots enabled the view is written into one of the
        output's two resident slots (A/B rotation), whose pinned host
        side stays with it, so batch N+1 writes into the other slot
        while batch N's copy is in flight. A slot whose previous batch
        has not landed yet falls back to fresh buffers (counted as
        ``Transfer_SlotContended_Count``) instead of blocking the
        dispatch loop."""
        cuda = self.device.type == "cuda"
        view = _slice_table(t, cap) if cap < full_cap else t
        if not self.output_slots_enabled or not all(
            _row_shaped(v, t) for v in t.cols.values()
        ):
            return view, (_pinned_like(view) if cuda else None)
        key = (name, cap)
        if self._aot_warmed and key not in self._slots:
            # a capacity bucket the warm did not stage
            self._count_compile("WarmMiss_Count", 1)
        ring = self._slots.setdefault(key, [None] * OUTPUT_SLOT_BUFFERS)
        parity = self._slot_parity.get(name, 0) % OUTPUT_SLOT_BUFFERS
        self._slot_parity[name] = parity + 1
        prev = ring[parity]
        if prev is not None and prev[2].is_set():
            # the batch that last shipped this slot has landed its host
            # copy: write this batch's rows into the slot's buffers
            dev, host = _pack_slot(view, prev[0]), prev[1]
        else:
            # first use of this (output, cap) slot, or its transfer is
            # still in flight: the slot takes fresh buffers
            if prev is not None:
                self._bump_transfer_stat("SlotContended")
            dev = _map_table(view, torch.clone)
            host = _pinned_like(view) if cuda else None
        ring[parity] = (dev, host, _SET_EVENT)
        staged_slots.append((key, parity))
        return dev, host

    def process_batch(
        self,
        raw: Union[TableData, PackedRaw, Dict[str, Union[TableData, PackedRaw]], None],
        batch_time_ms: Optional[int] = None,
    ) -> Tuple[Dict[str, List[dict]], Dict[str, float]]:
        """Run one micro-batch; returns (materialized datasets, metrics).

        reference: processDataset (CommonProcessorFactory.scala:333-399)
        incl. the metric names it emits (:344-379).
        """
        return self.dispatch_batch(raw, batch_time_ms).collect_tables()

    # -- sized output transfer --------------------------------------------
    def transfer_capacity(self, name: str, full_cap: int) -> int:
        """Adaptive device-to-host capacity for output ``name``: the EWMA
        of observed valid counts with ``TRANSFER_HEADROOM`` x burst
        margin (doubled for ``OVERFLOW_BOOST_BATCHES`` batches after an
        overflow re-fetch), bucketed to a power of two. Engages only
        once counts have been observed and only when it at least halves
        the copy."""
        if not self.sized_transfer:
            return full_cap
        ewma = self.transfer_ewma.get(name)
        if ewma is None:
            return full_cap
        headroom = TRANSFER_HEADROOM * (
            OVERFLOW_BOOST_FACTOR if self.transfer_boost.get(name, 0) > 0
            else 1
        )
        cap = _pow2_ceil(max(int(ewma * headroom) + 1, MIN_TRANSFER_ROWS))
        return cap if cap * 2 <= full_cap else full_cap

    def observe_transfer_counts(self, counts: Dict[str, int]) -> None:
        """Feed observed per-output valid counts into the EWMA (called
        from ``PendingBatch.collect_tables``; an overflow re-fetch also
        bumps the EWMA straight to the observed count). Each observation
        also burns one batch off any post-overflow headroom boost."""
        a = TRANSFER_EWMA_ALPHA
        for n, c in counts.items():
            prev = self.transfer_ewma.get(n)
            self.transfer_ewma[n] = (
                float(c) if prev is None else a * c + (1.0 - a) * prev
            )
            boost = self.transfer_boost.get(n, 0)
            if boost > 0:
                self.transfer_boost[n] = boost - 1

    def _bump_transfer_stat(self, key: str) -> None:
        with self._stats_lock:
            self.transfer_stats[key] = self.transfer_stats.get(key, 0) + 1

    def _count_state(self, key: str, n: float) -> None:
        with self._stats_lock:
            self.state_stats[key] = self.state_stats.get(key, 0) + n

    def _drain_state_stats(self) -> Dict[str, float]:
        """The State_* deltas since the last drain. Cleared in place:
        every StateTable holds the same dict."""
        with self._stats_lock:
            stats = dict(self.state_stats)
            self.state_stats.clear()
        return stats

    def _filter_unowned(self, key_vals, valid: np.ndarray,
                        spec: SourceSpec) -> np.ndarray:
        """Key-routed ingest (``process.state.filteringest``): zero the
        validity of rows whose key hashes to a partition this replica
        does NOT own, so N replicas fed the same stream process each
        key exactly once between them (the consumer-group contract
        restated over key-range partitions). Dropped rows count into
        ``State_IngestFiltered_Count``. No-op unless armed AND the
        source's raw schema carries the conf'd partition key. Host
        arrays only: it runs before the batch's copy to the card."""
        key = self.state_partition_key
        if not key or key not in spec.raw_schema.types:
            if spec.name not in self._filter_warned:
                self._filter_warned.add(spec.name)
                logger.warning(
                    "state.filteringest armed but source %r has no "
                    "partition-key column %r; NOT filtering",
                    spec.name, key,
                )
            return valid
        if key_vals is None:
            return valid
        pids = partition_ids(
            np.asarray(key_vals), self.state_partitions,
            spec.raw_schema.types[key], dictionary=self.dictionary,
        )
        mask = np.isin(pids, np.asarray(self.state_owned, dtype=np.int64))
        valid = np.asarray(valid)
        dropped = int(np.count_nonzero(valid & ~mask))
        if dropped:
            self._count_state("IngestFiltered_Count", dropped)
        return valid & mask

    def _count_compile(self, key: str, n: float) -> None:
        with self._stats_lock:
            self.compile_stats[key] = self.compile_stats.get(key, 0.0) + n

    def _drain_compile_stats(self) -> Dict[str, float]:
        with self._stats_lock:
            stats, self.compile_stats = self.compile_stats, {}
        return stats

    # -- the manifest warm ------------------------------------------------
    def _aot_warm(self) -> None:
        """The eager meaning of ``process.compile.manifest``: take every
        first-use cost off the first real batch, at init.

        One zero-filled batch per source goes through the step, and only
        its counts are collected (on CUDA every kernel UDF the step calls
        builds and launches there); then one zero-filled sized transfer
        per output, capacity bucket and A/B slot makes each transfer
        slot's device and pinned host buffers. After it, every adaptive
        state the warm touched starts over: the window rings, slot
        counter and time base, the transfer EWMA, boost and counters.
        ``Compile_ColdStart_Ms`` reports the warm's cost. A failure here
        raises: there is no compile-at-first-batch to fall back to."""
        t0 = time.time()
        handle = self.dispatch_batch(None, batch_time_ms=0)
        handle.collect_counts()
        handle.abandon()
        self._warm_transfers(handle.out_datasets)
        self._init_device_state()
        self.transfer_ewma.clear()
        self.transfer_boost.clear()
        self._slot_parity.clear()
        with self._stats_lock:
            self.transfer_stats.clear()
        self._aot_warmed = True
        self._count_compile("ColdStart_Ms", (time.time() - t0) * 1000.0)

    def _warm_transfers(self, out_datasets: Dict[str, TableData]) -> None:
        """Stage and copy a zero-filled table into every transfer slot an
        output can be fetched through: each bucket of
        ``transfer_buckets`` (the full capacity alone without sized
        transfer), both A/B slots."""
        cuda = self.device.type == "cuda"
        for name, t in out_datasets.items():
            zero = _map_table(t, torch.zeros_like)
            full_cap = t.capacity
            caps = transfer_buckets(full_cap) if self.sized_transfer else [full_cap]
            for cap in caps:
                for _ in range(OUTPUT_SLOT_BUFFERS):
                    dev, host = self._stage_output(name, zero, cap, full_cap, [])
                    if cuda:
                        for c, v in dev.cols.items():
                            host.cols[c].copy_(v, non_blocking=True)
                        host.valid.copy_(dev.valid, non_blocking=True)
        if cuda:
            torch.cuda.synchronize(self.device)

    def _drain_stats(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """The ingest and transfer counters since the last drain."""
        with self._stats_lock:
            ingest, self.ingest_stats = self.ingest_stats, {}
            transfer, self.transfer_stats = self.transfer_stats, {}
        return ingest, transfer


def _host_sort(rows: List[dict], order: List[Tuple[str, bool]]) -> None:
    """Stable multi-key in-place sort matching SQL semantics: ascending
    puts NULLs first, descending puts them last (Spark defaults).
    Applied least-significant key first so significance composes."""
    for key, asc in reversed(order):
        def kf(r, k=key):
            v = r.get(k)
            # the second element only compares within equal null-flags,
            # so the placeholder never meets a real value
            return (v is not None, v if v is not None else 0)

        rows.sort(key=kf, reverse=not asc)


# placeholder for "no transfer in flight" while a freshly staged slot
# waits for its owning PendingBatch to be constructed
_SET_EVENT = threading.Event()
_SET_EVENT.set()


def _numpy_table(t: TableData) -> TableData:
    return _map_table(t, lambda v: v.numpy())


@dataclass
class BatchCounts:
    """The parsed counts vector: per-output valid row counts, the
    dropped-group/join overflow slots, and the projected input count."""

    counts: np.ndarray  # the raw packed vector (nbytes = sync cost)
    dataset_counts: Dict[str, int]
    dropped_groups: Dict[str, int]
    dropped_joins: Dict[str, int]
    target_counts: Dict[str, int]


class PendingBatch:
    """An in-flight micro-batch: device work queued, results on their
    way to the host.

    Two-phase result path: ``start_fetch`` (run by ``dispatch_batch``)
    copies the counts vector and the sized, slot-staged output tables
    into pinned host memory on the processor's side stream, after an
    event recorded behind the step. ``collect_counts()`` waits only for
    the counts' copy, the batch's one blocking read; ``collect_tables()``
    waits for the tables' copy, re-fetches an output that overflowed its
    sized capacity, materializes rows and overwrites each state table's
    standby partitions from the batch's new state, which rides the same
    side stream into pinned memory whole (its valid rows are not known
    on the host until then), possibly on a background landing thread.
    The handle holds its stream and events itself, since PyTorch keeps
    the current stream per thread, and it keeps every tensor the side
    stream reads referenced until that copy is done."""

    def __init__(
        self, proc: FlowProcessor, pipeline: Pipeline, out_datasets,
        counts_vec: torch.Tensor, batch_time_ms: int, base_ms: int,
        t0: float, out_names: List[str],
        fetch_tables: Dict[str, TableData],
        fetch_hosts: Dict[str, Optional[TableData]],
        fetch_caps: Dict[str, int],
        ingest: Optional[List[tuple]] = None,
        state: Optional[Dict[str, TableData]] = None,
    ):
        self.proc = proc
        # THIS batch's pipeline: a UDF onInterval refresh may rebuild
        # proc.pipeline before an in-flight batch collects; its outputs
        # must decode against the schemas of the step that produced them
        self.pipeline = pipeline
        self.out_names = out_names
        self.target_names = [sp.target for sp in proc.specs.values()]
        self.out_datasets = out_datasets  # the full-capacity fallback
        # sized-transfer views: what start_fetch copies and collect reads
        self.fetch_tables = fetch_tables
        self.fetch_hosts = fetch_hosts
        self.fetch_caps = fetch_caps
        self.counts_vec = counts_vec
        self.batch_time_ms = batch_time_ms
        self.base_ms = base_ms
        self.t0 = t0
        self._counts: Optional[BatchCounts] = None
        # set once the host copies have been consumed (or the batch is
        # abandoned): the signal slot rotation checks before writing
        # into this batch's transfer buffers again
        self._landed = threading.Event()
        # (pool, matrix, h2d event) of each pooled ingest matrix this
        # batch's raw inputs came in; given back exactly once
        self._ingest = ingest or []
        self._stream = proc._d2h_stream  # None on the CPU
        self._step_done = self._counts_event = self._tables_event = None
        self._host_counts: Optional[torch.Tensor] = None
        self._d2h_bytes = 0
        self._transferred_rows = 0
        # THIS batch's new state on the device and, once start_fetch has
        # queued its copies, its pinned host destination (the tensors
        # themselves on the CPU); overwritten into the state tables at
        # landing. ``state_d2h_bytes`` is what the copy moves.
        self.state = state or {}
        self.host_state: Dict[str, TableData] = {}
        self.state_d2h_bytes = sum(_table_nbytes(t) for t in self.state.values())

    def _release_ingest(self) -> None:
        ingest, self._ingest = self._ingest, []
        for pool, mat, copied in ingest:
            pool.release(mat, copied)

    def start_fetch(self) -> None:
        """Enqueue the device-to-host copies of everything
        ``collect_tables`` reads: the counts vector, then each sized
        output table. On CUDA they run on the processor's side stream,
        which first waits for an event recorded behind the step on the
        dispatching thread's stream; the host reads a copy only after its
        event (``collect_counts``, ``collect_tables``), since the pinned
        buffers hold garbage until then. On the CPU the tables are host
        memory already."""
        if self._stream is None:
            self._host_counts = self.counts_vec
            self.fetch_hosts = self.fetch_tables
            self.host_state = self.state
            return
        self._step_done = torch.cuda.Event()
        self._step_done.record()
        self._counts_event = torch.cuda.Event()
        self._tables_event = torch.cuda.Event()
        self._stream.wait_event(self._step_done)
        with torch.cuda.stream(self._stream):
            self._host_counts = torch.empty(
                self.counts_vec.shape, dtype=self.counts_vec.dtype,
                pin_memory=True,
            )
            self._host_counts.copy_(self.counts_vec, non_blocking=True)
            self._counts_event.record(self._stream)
            for n, t in self.fetch_tables.items():
                host = self.fetch_hosts[n]
                for c, v in t.cols.items():
                    host.cols[c].copy_(v, non_blocking=True)
                host.valid.copy_(t.valid, non_blocking=True)
            for n, t in self.state.items():
                host = self.host_state[n] = _pinned_like(t)
                for c, v in t.cols.items():
                    host.cols[c].copy_(v, non_blocking=True)
                host.valid.copy_(t.valid, non_blocking=True)
            self._tables_event.record(self._stream)

    def block_until_evaluated(self) -> None:
        """Wait for the device step to COMPLETE (rules evaluated, state
        advanced) without waiting for any result copy."""
        if self._step_done is not None:
            self._step_done.synchronize()

    def abandon(self) -> None:
        """Mark a batch that will never be collected (window requeued
        after a failure): waits until nothing of it is in flight, then
        gives back its ingest matrix and releases its transfer slots."""
        if self._tables_event is not None:
            self._tables_event.synchronize()
        self._release_ingest()
        self._landed.set()

    def collect_counts(self) -> BatchCounts:
        """The batch's ONLY blocking device read: wait for the counts
        vector's copy (layout: input count, per-output counts, per-output
        overflow slots for groups then joins, projected input count) and
        parse it. On CUDA the ingest matrix goes back to its pool here,
        gated on its copy's event. Idempotent."""
        if self._counts is not None:
            return self._counts
        with tracing.span("sync-counts"):
            if self._counts_event is not None:
                self._counts_event.synchronize()
                self._release_ingest()
            counts = self._host_counts.numpy()
        names = self.out_names
        self._counts = BatchCounts(
            counts=counts,
            dataset_counts={
                n: int(counts[1 + i]) for i, n in enumerate(names)
            },
            dropped_groups={
                n: int(counts[1 + len(names) + i])
                for i, n in enumerate(names)
                if int(counts[1 + len(names) + i]) >= 0
            },
            dropped_joins={
                n: int(counts[1 + 2 * len(names) + i])
                for i, n in enumerate(names)
                if int(counts[1 + 2 * len(names) + i]) >= 0
            },
            target_counts={
                t: int(counts[1 + 3 * len(names) + i])
                for i, t in enumerate(self.target_names)
            },
        )
        return self._counts

    def _fetch_now(self, t: TableData) -> TableData:
        """A blocking copy of ``t`` to the host on this batch's side
        stream (the step is done once the counts have landed)."""
        if self._stream is None:
            return t
        with torch.cuda.stream(self._stream):
            return _map_table(t, lambda v: v.to("cpu"))

    def _land(self, bc: BatchCounts) -> Dict[str, TableData]:
        """The landed host tables sliced to their counts, with the
        two-phase re-fetch of any output whose count exceeded its sized
        capacity."""
        proc = self.proc
        if self._tables_event is not None:
            self._tables_event.synchronize()
        host_full = {n: _numpy_table(t) for n, t in self.fetch_hosts.items()}
        self._d2h_bytes = bc.counts.nbytes + sum(
            _table_nbytes(t) for t in host_full.values()
        )
        self._transferred_rows = sum(
            int(t.valid.shape[0]) for t in host_full.values()
        )
        host_tables: Dict[str, TableData] = {}
        for n, t in host_full.items():
            cnt = bc.dataset_counts[n]
            if cnt > int(t.valid.shape[0]):
                # the sized copy undershot: re-fetch the full-capacity
                # table sliced to the true count (Transfer_Overflow_Count),
                # jump the EWMA straight to the observed count and double
                # the headroom for the next OVERFLOW_BOOST_BATCHES batches
                proc._bump_transfer_stat("Overflow")
                proc.transfer_ewma[n] = float(cnt)
                proc.transfer_boost[n] = OVERFLOW_BOOST_BATCHES
                with tracing.span("device-refetch"):
                    t = _numpy_table(
                        self._fetch_now(_slice_table(self.out_datasets[n], cnt))
                    )
                self._d2h_bytes += _table_nbytes(t)
                self._transferred_rows += cnt
                host_tables[n] = t
            else:
                host_tables[n] = TableData(
                    {c: v[:cnt] if _row_shaped(v, t) else v
                     for c, v in t.cols.items()},
                    t.valid[:cnt],
                )
        return host_tables

    def collect_tables(self) -> Tuple[Dict[str, List[dict]], Dict[str, float]]:
        """Land the output tables the side stream has been copying since
        dispatch, materialize their rows, and return (datasets,
        metrics). Every batch fetches its sized tables whole: the JAX
        package does so wherever its arrays copy to the host
        asynchronously, which every PyTorch tensor does. Thread-safe to
        run on a landing thread other than the dispatching one."""
        proc = self.proc
        bc = self.collect_counts()
        names = self.out_names
        datasets: Dict[str, List[dict]] = {}
        try:
            with tracing.span("device-fetch"):
                tables = self._land(bc)
            # the step is done with its ingest matrix once the tables
            # have landed: give it back before they are read, so that an
            # armed sanitizer's poison shows through any view of it that
            # outlived its release
            self._release_ingest()
            if proc.buffer_sanitizer is not None:
                for name, table in tables.items():
                    proc.buffer_sanitizer.scan_table(name, table)
            with tracing.span("materialize"):
                for name, table in tables.items():
                    rows = materialize_rows(
                        table, self.pipeline.schema_of(name), proc.dictionary,
                        self.base_ms,
                    )
                    view = self.pipeline.view_by_name(name)
                    if view is not None and view.host_order:
                        # ORDER BY over computed-string columns: the
                        # device has no id to sort by, so the ordering
                        # (and limit) applies to the materialized rows
                        # (planner host-order path)
                        _host_sort(rows, view.host_order)
                        if view.host_limit is not None:
                            rows = rows[: view.host_limit]
                    datasets[name] = rows
            # persist state tables (A/B overwrite; persist() is the
            # caller's post-sink commit) — from THIS batch's state, in
            # host memory since _land waited for its copy
            for sname, st in proc.state_tables.items():
                st.overwrite(_numpy_table(self.host_state[sname]), proc.dictionary)
        finally:
            # the host copies are consumed (or the landing failed): this
            # batch's transfer slots and their pinned host buffers may
            # take a later batch, and its ingest matrix goes back to the
            # pool (on the CPU the step read the pool's memory itself)
            self._release_ingest()
            self._landed.set()

        metrics = {
            "Latency-Process": (time.time() - self.t0) * 1000.0,
            "BatchProcessedET": float(self.batch_time_ms),
        }
        for t, c in bc.target_counts.items():
            metrics[f"Input_{t}_Events_Count"] = float(c)
        for n, c in bc.dataset_counts.items():
            metrics[f"Output_{n}_Events_Count"] = float(c)
        for n, c in bc.dropped_groups.items():
            metrics[f"Output_{n}_GroupsDropped"] = float(c)
        for n, c in bc.dropped_joins.items():
            metrics[f"Output_{n}_JoinRowsDropped"] = float(c)
        ingest_stats, transfer_stats = proc._drain_stats()
        # host-side ingest counters accumulated since the last collect
        for k, v in ingest_stats.items():
            if v:
                metrics[f"Input_{k}_Count"] = float(v)
        # ingest decode gauges: the shard count in effect, the last
        # measured decode rate, and pool reuses since the last collect
        if proc._decode_shards is not None:
            metrics["Decode_Shards"] = float(proc._decode_shards)
        if proc._decode_rows_per_sec is not None:
            metrics["Decode_RowsPerSec"] = float(proc._decode_rows_per_sec)
        reuse = sum(p.take_reuse_count() for p in proc._ingest_pools.values())
        if reuse:
            metrics["Decode_BufferReuse_Count"] = float(reuse)
        if proc.dictionary.overflow_count:
            metrics["Input_string_dictionary_overflow_Count"] = float(
                proc.dictionary.overflow_count
            )
            proc.dictionary.overflow_count = 0
        if proc.udf_refresh_errors:
            metrics["UdfRefreshError"] = float(proc.udf_refresh_errors)
            proc.udf_refresh_errors = 0
        # step rebuilds since the last collect: the DX503 input
        if proc.retrace_count:
            metrics["Retrace_Count"] = float(proc.retrace_count)
            proc.retrace_count = 0
        for k, v in proc._drain_compile_stats().items():
            metrics[f"Compile_{k}"] = float(v)
        # sized-transfer accounting: bytes actually moved device->host
        # for this batch and the valid/transferred row ratio (1.0 = wire
        # minimum)
        if names:
            metrics["Transfer_D2HBytes"] = float(self._d2h_bytes)
            metrics["Transfer_Efficiency"] = (
                sum(bc.dataset_counts.values()) / self._transferred_rows
                if self._transferred_rows else 1.0
            )
        # partitioned-state accounting: the partition geometry this
        # replica runs (gauges) plus the deltas since the last collect
        # — load fallbacks (DX530/531), snapshot pushes/pulls through
        # the objstore mirror, the successor handoff cost, and rows the
        # key-routed ingest filter dropped as un-owned
        if proc.state_tables or proc.state_replica_count > 1:
            metrics["State_Partition_Count"] = float(proc.state_partitions)
            metrics["State_Partition_Owned"] = float(len(proc.state_owned))
        for k, v in proc._drain_state_stats().items():
            metrics[f"State_{k}"] = float(v)
        # bytes the blocking counts-only read moved
        metrics["Sync_CountsBytes"] = float(bc.counts.nbytes)
        for k, v in transfer_stats.items():
            metrics[f"Transfer_{k}_Count"] = float(v)
        # sanitizer accounting: views guarded since the last collect,
        # and poison hits (only once nonzero)
        if proc.buffer_sanitizer is not None:
            metrics.update(proc.buffer_sanitizer.drain_metric_deltas())
        # feed the adaptive capacity for the NEXT batches
        proc.observe_transfer_counts(bc.dataset_counts)
        return datasets, metrics

    def collect(self) -> Tuple[Dict[str, List[dict]], Dict[str, float]]:
        """Counts and tables in one call, the synchronous path; the same
        result as ``collect_counts()`` then ``collect_tables()``."""
        return self.collect_tables()
