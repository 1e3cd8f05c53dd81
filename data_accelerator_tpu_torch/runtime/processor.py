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
back, so ``PendingBatch.collect_counts`` is the batch's one blocking read.

This slice runs single-source flows on one device. Mesh execution,
multiple sources, state tables, reference data, the native ingest
decoder, AOT warm-up, sized transfer and debug guards are not ported
yet; a flow whose conf asks for one of them raises ``EngineException``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..compile.pipeline import Pipeline, PipelineCompiler
from ..compile.planner import PlannerConfig, SelectCompiler, TableData, ViewSchema
from ..compile.sqlparser import parse_select
from ..compile.stringops import _MAX_ROUNDS, AuxTableBuilder
from ..constants import ColumnName, DatasetName
from ..core.config import EngineException, SettingDictionary, SettingNamespace
from ..core.schema import ColType, Schema, StringDictionary
from ..ops.compact import compact_indices
from ..udf import UdfRegistry, load_udfs_from_conf
from .materialize import materialize_rows
from .timewindow import (
    WindowBuffers,
    make_buffers,
    num_slots,
    update_buffers,
    window_table,
)

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


def build_step_fn(
    ts_col: Optional[str],
    windows: Dict[str, Tuple[str, float]],
    output_datasets: List[str],
    ring_tables: List[str],
    pipeline: Pipeline,
    proj_views: list,
    target: str,
):
    """Build the per-batch step from its compiled parts: the port of the
    JAX package's fused step (``runtime/processor.py::build_step_fn``)
    for one source.

    ``step(raw, rings, base_s, now_rel_ms, counter, delta_ms, aux)``
    takes the raw batch, the window rings (updated in place), the 0-d
    int32 time tensors, the host-side batch counter and base delta, and
    the string-op tables. It returns (compacted output tables, counts
    vector) without reading anything back from the device.
    """

    def step(
        raw: TableData,
        rings: Dict[str, WindowBuffers],
        base_s: torch.Tensor,
        now_rel_ms: torch.Tensor,
        counter: int,
        delta_ms: int,
        aux: Dict[str, torch.Tensor],
    ):
        # 1. projection into the target table
        env: Dict[str, TableData] = {
            "Raw": raw,
            DatasetName.DataStreamRaw: raw,
            "__aux": aux,
        }
        for v in proj_views:
            env[v.name] = v.fn(env, base_s, now_rel_ms)
        projected = env[target]

        # 2. ring updates, in place; each ring's slot derives from the
        # shared batch counter on the host
        for table in ring_tables:
            buf = rings[table]
            update_buffers(buf, projected, counter % buf.slots, delta_ms, ts_col)

        tables: Dict[str, TableData] = {target: projected}
        for wname, (table, dur_s) in windows.items():
            tables[wname] = window_table(
                rings[table], int(dur_s * 1000), now_rel_ms, ts_col
            )

        out = pipeline.run(tables, base_s, now_rel_ms, aux=aux)

        # compact outputs on the device (valid rows to the front) so the
        # host copies only [:count] rows; every per-batch scalar rides
        # ONE int32 vector
        datasets = {}
        counts = [projected.count()]
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
        # per-target projected input count (the multi-source slot layout)
        counts.append(projected.count())
        counts_vec = torch.stack([c.to(torch.int32) for c in counts])
        return datasets, counts_vec

    return step


@dataclass
class SourceSpec:
    """The flow's input stream: its schema, projection chain, the table
    its projected rows land in, and its batch capacity."""

    name: str
    target: str
    schema: Schema
    raw_schema: ViewSchema
    projection_steps: List[str]
    capacity: int


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

        self.spec = self._make_spec(
            DEFAULT_SOURCE, input_conf, default_capacity,
            process_conf.get_string_seq_option("projection"),
        )
        self.primary = DEFAULT_SOURCE
        self.batch_capacity = self.spec.capacity

        self.transform_text = _read_maybe_file(process_conf.get("transform")) or ""

        # time windows (handler/TimeWindowHandler.scala:23-68); with one
        # source every window targets its one table
        self.windows: Dict[str, Tuple[str, float]] = {}
        for wname, sub in dict_.group_by_sub_namespace(
            SettingNamespace.JobProcessPrefix + "timewindow."
        ).items():
            table = sub.get("table") or self.spec.target
            if table != self.spec.target:
                raise EngineException(
                    f"timewindow {wname} targets unknown table {table!r} "
                    f"(projected tables: {[self.spec.target]})"
                )
            self.windows[wname] = (table, sub.get_duration("windowduration"))

        self._build_pipeline(output_datasets)
        self._init_device_state()
        self._build_step()

    # -- build -----------------------------------------------------------
    @staticmethod
    def _refuse_unported(dict_: SettingDictionary) -> None:
        """Raise for conf that asks for a feature this port lacks, naming
        it, rather than run the flow without it."""
        proc = SettingNamespace.JobProcessPrefix
        inp = SettingNamespace.JobInputPrefix
        truthy = lambda key: (dict_.get(key) or "").lower() == "true"  # noqa: E731
        checks = [
            ((dict_.get_int_option(proc + "numchips") or 1) > 1,
             "mesh execution (process.numchips > 1)"),
            (bool(dict_.group_by_sub_namespace(SettingNamespace.JobPrefix + "input.sources.")),
             "multi-source flows (input.sources.*)"),
            (bool(dict_.group_by_sub_namespace(proc + "statetable.")),
             "state tables (process.statetable.*)"),
            (bool(dict_.group_by_sub_namespace(inp + "referencedata.")),
             "reference data (input.referencedata.*)"),
            (any(truthy(proc + "debug." + k)
                 for k in ("nans", "tracerleaks", "buffersanitizer")),
             "debug guards (process.debug.*)"),
            (bool(dict_.get(proc + "compile.manifest")),
             "AOT warm-up (process.compile.manifest)"),
            ((dict_.get_int_option(proc + "state.replicacount") or 1) > 1
             or truthy(proc + "state.filteringest"),
             "partitioned state (process.state.replicacount/filteringest)"),
        ]
        for asked, feature in checks:
            if asked:
                raise EngineException(
                    f"{feature} is not ported to data_accelerator_tpu_torch yet"
                )

    def _planner_config(self, process_conf: SettingDictionary) -> PlannerConfig:
        maxgroups = (
            process_conf.get_int_option("maxgroups")
            or process_conf.get_int_option("groupcapacity")
        )
        if maxgroups is None:
            return PlannerConfig()
        if maxgroups < 1:
            raise EngineException(
                f"process.maxgroups must be >= 1, got {maxgroups}"
            )
        return PlannerConfig(max_group_capacity=maxgroups)

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
        target = conf.get("target") or DatasetName.DataStreamProjection

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
        )

    def _build_pipeline(self, output_datasets: Optional[List[str]]):
        pc = PipelineCompiler(
            self.dictionary, self.udfs, config=self.planner_config
        )
        # one dictionary-table registry for the whole flow (projection +
        # transform share string-op tables; see compile/stringops.py)
        self.aux_registry = pc.aux

        # 1. projection pipeline: Raw -> target table
        spec = self.spec
        proj_catalog = {
            "Raw": spec.raw_schema,
            DatasetName.DataStreamRaw: spec.raw_schema,
        }
        proj_caps = {
            "Raw": spec.capacity,
            DatasetName.DataStreamRaw: spec.capacity,
        }
        cur_name = "Raw"
        self.projection_views = []
        for i, step_text in enumerate(spec.projection_steps):
            sel = projection_select(step_text, cur_name)
            compiler = SelectCompiler(
                proj_catalog, proj_caps, self.dictionary, self.udfs,
                self.planner_config, aux=pc.aux,
            )
            vname = (
                spec.target
                if i == len(spec.projection_steps) - 1
                else f"__proj{i}"
            )
            view = compiler.compile_select(vname, sel)
            self.projection_views.append(view)
            proj_catalog[vname] = view.schema
            proj_caps[vname] = view.capacity
            cur_name = vname
        self.projected_schema = proj_catalog[spec.target]

        # 2. window slots of the target table
        self.ring_slots: Dict[str, int] = {}
        for wname, (table, dur_s) in self.windows.items():
            if self.timestamp_column not in self.projected_schema.types:
                raise EngineException(
                    f"timewindow {wname} requires timestamp column "
                    f"{self.timestamp_column!r} in table {table}"
                )
            slots = num_slots(dur_s, self.watermark_s, self.interval_s)
            self.ring_slots[table] = max(self.ring_slots.get(table, 1), slots)

        # 3. main pipeline inputs
        inputs: Dict[str, Tuple[ViewSchema, int]] = {
            spec.target: (self.projected_schema, spec.capacity)
        }
        for wname, (table, _dur) in self.windows.items():
            inputs[wname] = (
                self.projected_schema, self.ring_slots[table] * spec.capacity
            )
        self.pipeline: Pipeline = pc.compile_transform(self.transform_text, inputs)

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
        self._step = build_step_fn(
            ts_col=self.timestamp_column,
            windows=dict(self.windows),
            output_datasets=list(self.output_datasets),
            ring_tables=list(self.ring_slots),
            pipeline=self.pipeline,
            proj_views=list(self.projection_views),
            target=self.spec.target,
        )

    def _fresh_rings(self) -> Dict[str, WindowBuffers]:
        return {
            table: make_buffers(
                self.projected_schema, self.spec.capacity, slots, self.device
            )
            for table, slots in self.ring_slots.items()
        }

    def _init_device_state(self):
        self.window_buffers: Dict[str, WindowBuffers] = self._fresh_rings()
        self._slot_counter = 0
        self._base_ms: Optional[int] = None
        # host-side ingest counters (e.g. rows dropped for garbage
        # timestamps), drained into metrics at each collect
        self.ingest_stats: Dict[str, int] = {}

    # -- window-state checkpoint ------------------------------------------
    def snapshot_window_state(self) -> Dict[str, object]:
        """Host copy of everything a restart would otherwise lose: the
        window ring buffers, the slot counter, the time base the ring
        timestamps are relative to, AND the string dictionary — ring
        columns hold dictionary ids, which only mean anything against
        the dictionary that encoded them. Numpy-only, in the JAX
        package's layout. The arrays are copies: the next dispatch
        updates the rings in place, and a view would change under the
        caller."""
        rings = {}
        for table, buf in self.window_buffers.items():
            rings[table] = {
                "cols": {
                    c: a.cpu().numpy().copy() for c, a in buf.cols.items()
                },
                "valid": buf.valid.cpu().numpy().copy(),
            }
        return {
            "rings": rings,
            "slot_counter": self._slot_counter,
            "base_ms": self._base_ms,
            "dictionary": self.dictionary.entries(),
        }

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
        self.window_buffers = restored
        self._slot_counter = int(snap.get("slot_counter", 0))
        base = snap.get("base_ms")
        self._base_ms = int(base) if base is not None else None
        return True

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

    def encode_rows(self, rows: List[dict], base_ms: int) -> TableData:
        """Host-side encoder of JSON-like row dicts (python loop)."""
        from ..core.batch import batch_from_rows

        spec = self.spec
        b = batch_from_rows(
            rows, spec.schema, spec.capacity, self.dictionary,
            base_ms, stats=self.ingest_stats, device=self.device,
        )
        cols = dict(b.columns)
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
        return TableData(cols, b.valid)

    def encode_columns(self, np_cols: Dict[str, np.ndarray], n: int) -> TableData:
        """Host columns (the first ``n`` rows valid) as the raw batch on
        the device, padded to capacity."""
        cap = self.spec.capacity
        fill_dtype = {"double": torch.float32, "boolean": torch.bool}
        cols = {}
        for c, t in self.spec.raw_schema.types.items():
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
        return TableData(cols, _host_to_device(valid, self.device))

    def dispatch_batch(
        self,
        raw: Union[TableData, Dict[str, TableData], None],
        batch_time_ms: Optional[int] = None,
    ) -> "PendingBatch":
        """Queue one micro-batch on the device and return a handle.

        ``raw``: the source's TableData (or ``{"default": TableData}``;
        None runs an empty batch). The device runs asynchronously: the
        caller can encode the next batch while this one computes, and
        collects the results with ``PendingBatch.collect()``.
        """
        t0 = time.time()
        if batch_time_ms is None:
            batch_time_ms = int(time.time() * 1000)
        if isinstance(raw, dict):
            unknown = [n for n in raw if n != self.primary]
            if unknown:
                raise EngineException(
                    f"dispatch_batch got unknown source {unknown[0]!r} "
                    f"(declared: {[self.primary]})"
                )
            raw = raw.get(self.primary)
        if raw is None:
            raw = self.encode_columns({}, 0)
        # per-interval UDF refresh hooks; state changes rebuild the
        # pipeline (CommonProcessorFactory.scala:351-353 onInterval).
        # A throwing hook skips its refresh and surfaces as the
        # UdfRefreshError metric rather than killing the batch loop.
        registry = UdfRegistry(self.udfs)
        if registry.refresh(batch_time_ms):
            self._build_pipeline(self.output_datasets)
            self._build_step()
        if registry.last_errors:
            self.udf_refresh_errors += len(registry.last_errors)
        # whole-second base so device absolute-time math is exact
        new_base_ms = (batch_time_ms // 1000) * 1000
        if self._base_ms is None:
            self._base_ms = new_base_ms
        delta_ms = new_base_ms - self._base_ms
        if abs(delta_ms) > 2**31 - 1:
            # a restored checkpoint (or clock jump) more than ~24.8 days
            # out: every ring row is long past any window horizon, and
            # the int32 rebase would overflow — start from clean rings
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
            (), batch_time_ms - new_base_ms, dtype=torch.int32, device=self.device
        )
        # string-op dictionary tables: refreshed AFTER this batch's
        # encode (so they cover every id the batch can contain), copied
        # to the device only when the dictionary grew
        aux = self.aux_tables.tables()
        out_datasets, counts_vec = self._step(
            raw, self.window_buffers, base_s, now_rel_ms, counter, delta_ms, aux
        )
        return PendingBatch(
            self, self.pipeline, out_datasets, counts_vec,
            batch_time_ms, new_base_ms, t0,
            out_names=list(self.output_datasets),
        )

    def process_batch(
        self,
        raw: Union[TableData, Dict[str, TableData], None],
        batch_time_ms: Optional[int] = None,
    ) -> Tuple[Dict[str, List[dict]], Dict[str, float]]:
        """Run one micro-batch; returns (materialized datasets, metrics).

        reference: processDataset (CommonProcessorFactory.scala:333-399)
        incl. the metric names it emits (:344-379).
        """
        return self.dispatch_batch(raw, batch_time_ms).collect()


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
    """An in-flight micro-batch: device work queued, results not yet
    fetched. ``collect_counts()`` is the one blocking device read;
    ``collect()`` then copies the compacted rows the counts name and
    materializes them."""

    def __init__(
        self, proc: FlowProcessor, pipeline: Pipeline, out_datasets,
        counts_vec: torch.Tensor, batch_time_ms: int, base_ms: int,
        t0: float, out_names: List[str],
    ):
        self.proc = proc
        # THIS batch's pipeline: a UDF onInterval refresh may rebuild
        # proc.pipeline before an in-flight batch collects; its outputs
        # must decode against the schemas of the step that produced them
        self.pipeline = pipeline
        self.out_names = out_names
        self.target_names = [proc.spec.target]
        self.out_datasets = out_datasets
        self.counts_vec = counts_vec
        self.batch_time_ms = batch_time_ms
        self.base_ms = base_ms
        self.t0 = t0
        self._counts: Optional[BatchCounts] = None

    def collect_counts(self) -> BatchCounts:
        """Resolve and parse the packed counts vector (layout: input
        count, per-output counts, per-output overflow slots for groups
        then joins, projected input count). Blocks until the batch's
        device work is done; idempotent."""
        if self._counts is not None:
            return self._counts
        counts = self.counts_vec.cpu().numpy()
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

    def collect(self) -> Tuple[Dict[str, List[dict]], Dict[str, float]]:
        """Copy each output's first ``count`` rows to the host,
        materialize them, and return (datasets, metrics)."""
        proc = self.proc
        bc = self.collect_counts()
        d2h_bytes = bc.counts.nbytes
        datasets: Dict[str, List[dict]] = {}
        for name, t in self.out_datasets.items():
            cnt = bc.dataset_counts[name]
            host = TableData(
                {c: (v[:cnt] if v.shape[:1] == t.valid.shape else v).cpu().numpy()
                 for c, v in t.cols.items()},
                t.valid[:cnt].cpu().numpy(),
            )
            d2h_bytes += sum(a.nbytes for a in host.cols.values())
            d2h_bytes += host.valid.nbytes
            rows = materialize_rows(
                host, self.pipeline.schema_of(name), proc.dictionary,
                self.base_ms,
            )
            view = self.pipeline.view_by_name(name)
            if view is not None and view.host_order:
                # ORDER BY over computed-string columns: the device has
                # no id to sort by, so the ordering (and limit) applies
                # to the materialized rows (planner host-order path)
                _host_sort(rows, view.host_order)
                if view.host_limit is not None:
                    rows = rows[: view.host_limit]
            datasets[name] = rows

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
        # drain host-side ingest counters accumulated since last collect
        for k, v in proc.ingest_stats.items():
            if v:
                metrics[f"Input_{k}_Count"] = float(v)
        proc.ingest_stats.clear()
        if proc.dictionary.overflow_count:
            metrics["Input_string_dictionary_overflow_Count"] = float(
                proc.dictionary.overflow_count
            )
            proc.dictionary.overflow_count = 0
        if proc.udf_refresh_errors:
            metrics["UdfRefreshError"] = float(proc.udf_refresh_errors)
            proc.udf_refresh_errors = 0
        # bytes this batch moved device->host, and those of the blocking
        # counts-only read
        metrics["Transfer_D2HBytes"] = float(d2h_bytes)
        metrics["Sync_CountsBytes"] = float(bc.counts.nbytes)
        return datasets, metrics
