"""Device-plan analyzer: abstract interpretation of the compiled plan.

The ``--device`` tier. Where ``analyzer.py`` checks a flow's *meaning*
(references, types, legality), this tier checks what the compiled plan
will *cost*: it reuses the production lowering (the same
``SelectCompiler``/``PipelineCompiler`` the runtime's step runs), derives
every stage's static shapes by running each view on tensors of the
``meta`` device (shapes and dtypes only: no data, no allocation, no
kernel) and emits

- a **cost report**: per-stage device bytes and FLOP estimate (closed
  forms over group cardinality and join fan-out, ``costmodel.py``),
- the **DX2xx lint family**: capacity risk (group/join/dictionary
  bounds vs declared cardinality), O(n*m) match-matrix joins at window
  scale, step-rebuild hazards, and int32 ring-rebase proximity.

Two byte numbers per stage keep the model honest: ``hbm_bytes`` comes
from the meta evaluation of the production lowering (ground-truth
shapes), ``model_bytes`` from the closed forms; a test holds both equal
to the tensors a real batch materializes (``materialized_stage_bytes``).

Copy of the JAX package's ``analysis/deviceplan.py`` with these
changes:

- ``jax.eval_shape`` becomes the meta evaluation (``_abstract_eval``).
  The port's step has no data-dependent shape (its compactions are
  prefix sums, never ``nonzero``, and nothing reads a value back), so
  every view evaluates on ``meta`` as it runs on a card.
- The plan is priced at 1 chip (one card) unless a chip count is
  given: an argument, the flow's ``jobNumChips`` (or the legacy
  ``jobNumExecutors``), or for a processor the size of its mesh (what
  its step runs over, where the JAX package reads ``process.numchips``
  before the clamp to the visible cards). At more than one chip every
  stage carries the reference's expected ICI bytes
  (``costmodel.stage_ici_bytes``).
- ``latencyModel`` prices the plan under a calibrated machine profile
  (``obs/calibrate.py``) that the caller passes; without one it reports
  ``source: "uncalibrated"`` and no milliseconds (the JAX package falls
  back to a TPU datasheet, which the port does not carry).
- DX204 speaks of a step rebuild (the eager step has no trace), DX290 of
  a failed meta evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..compile.codegen import CodegenEngine, RulesCode
from ..compile.pipeline import (
    Pipeline,
    PipelineCompiler,
    parse_state_table_schema,
)
from ..compile.planner import (
    CompiledView,
    PlannerConfig,
    SelectCompiler,
    TableData,
    ViewSchema,
)
from ..constants import ColumnName, DatasetName
from ..core.config import EngineException, parse_duration_seconds
from ..core.schema import Schema, StringDictionary
from ..kernels.launch import MetaLaunchCounter
from ..runtime.processor import (
    PackedRaw,
    build_step_fn,
    default_projection,
    packed_raw_layout,
    projection_select,
    schema_to_view,
    window_target,
)
from ..runtime.timewindow import make_buffers, num_slots
from ..serve.flowbuilder import RuleDefinitionGenerator
from .costmodel import (
    DEFAULT_MATCH_MATRIX_BUDGET,
    OUTPUT_SLOT_BUFFERS,
    d2h_transfer_bytes,
    output_slot_bytes,
    row_bytes,
    stage_flops,
    stage_ici_bytes,
    stage_transient_bytes,
    table_bytes,
    view_output_bytes,
)
from .diagnostics import AnalysisReport, Diagnostic, make

# the plan's chip count when nothing names one: the port's flow runs on
# one card unless a mesh is asked for
DEFAULT_CHIPS = 1

# int32 relative-millis horizon for ring timestamps (~24.8 days); DX205
# fires when retention crosses a quarter of it
INT32_MS_HORIZON = 2 ** 31
REBASE_PROXIMITY_FRACTION = 0.25

# DX206 fires when an OUTPUT view's static capacity exceeds the modeled
# row count (declared group-key cardinality) by this factor: the sync
# stage would transfer >98% padding on a full-capacity fetch
D2H_OVERSIZE_FACTOR = 64

# the dtypes the runtime encodes each planner type to (core/schema.py)
_DTYPES = {"double": torch.float32, "boolean": torch.bool}

# the CUDA caching allocator's allocation unit (FlowProcessor.device_bytes)
CUDA_BLOCK_BYTES = 512

# stage kinds that persist across batches (device-resident state) vs
# materialized per batch; "outslot" = the A/B output transfer slots the
# runtime keeps resident per output
PERSISTENT_KINDS = ("ring", "state", "refdata", "outslot")


def _table(schema: ViewSchema, rows: int, device) -> TableData:
    cols = {
        c: torch.zeros((rows,), dtype=_DTYPES.get(t, torch.int32), device=device)
        for c, t in schema.types.items()
    }
    return TableData(cols, torch.zeros((rows,), dtype=torch.bool, device=device))


def table_struct(schema: ViewSchema, rows: int) -> TableData:
    """Abstract TableData (``meta`` tensors) for one input table, with
    the exact dtypes the runtime encodes (core/schema.py)."""
    return _table(schema, rows, "meta")


def _aux_on(aux: Dict[str, object], device) -> Dict[str, object]:
    """The string-op tables on ``device`` (``meta``: shapes only)."""
    return {
        k: torch.empty_like(v, device="meta") if device == "meta" else v.to(device)
        for k, v in aux.items()
    }


def _leaf_bytes(a: torch.Tensor) -> int:
    return int(a.numel()) * a.element_size()


def _table_data_bytes(td: TableData) -> int:
    return sum(_leaf_bytes(a) for a in td.cols.values()) + _leaf_bytes(td.valid)


def _blocks(n: int, block: int) -> int:
    """``n`` bytes as the allocator holds them: whole ``block``-byte
    blocks (exact with ``block`` 0)."""
    return -(-n // block) * block if block else n


def _resident_bytes(td: TableData, block: int) -> int:
    """A resident table's bytes with each tensor in whole blocks."""
    return sum(_blocks(_leaf_bytes(a), block)
               for a in list(td.cols.values()) + [td.valid])


# ---------------------------------------------------------------------------
# Report types
# ---------------------------------------------------------------------------
@dataclass
class StageCost:
    name: str
    kind: str  # input | project | ring | window | state | refdata | group | union | outslot
    rows: int
    hbm_bytes: int  # from the meta evaluation of the production lowering
    model_bytes: int  # closed-form prediction (costmodel.py)
    transient_bytes: int = 0  # peak in-stage intermediates (match matrix)
    flops: float = 0.0
    ici_bytes: float = 0.0  # expected interconnect bytes/batch at `chips`
    # device->host bytes a full-capacity fetch of this stage moves per
    # batch: non-zero only for OUTPUT views (the sync-stage wire cost)
    d2h_bytes: int = 0
    detail: str = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "rows": self.rows,
            "hbmBytes": self.hbm_bytes,
            "modelBytes": self.model_bytes,
            "transientBytes": self.transient_bytes,
            "flops": round(self.flops, 1),
            "iciBytes": round(self.ici_bytes, 1),
            "d2hBytes": self.d2h_bytes,
            "detail": self.detail,
        }


@dataclass
class DevicePlanReport:
    flow: str
    chips: int
    stages: List[StageCost]
    diagnostics: List[Diagnostic]
    # OUTPUT dataset -> {"rows": modeled cardinality, "capacity": padded
    # static capacity}: the occupancy side of the runtime conformance
    # model (obs/conformance.py DX502)
    outputs: Dict[str, dict] = field(default_factory=dict)
    # kernels one batch launches on a card (count_step_launches): the
    # launch count the latency model charges a dispatch overhead each
    launches_per_step: int = 1

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]

    @property
    def ok(self) -> bool:
        return not self.errors

    def totals(self) -> dict:
        persistent = sum(
            s.hbm_bytes for s in self.stages if s.kind in PERSISTENT_KINDS
        )
        per_batch = sum(
            s.hbm_bytes for s in self.stages if s.kind not in PERSISTENT_KINDS
        )
        return {
            "hbmBytes": persistent + per_batch,
            "persistentBytes": persistent,
            "perBatchBytes": per_batch,
            "modelBytes": sum(s.model_bytes for s in self.stages),
            "transientBytes": sum(s.transient_bytes for s in self.stages),
            "flops": round(sum(s.flops for s in self.stages), 1),
            "iciBytesPerBatch": round(
                sum(s.ici_bytes for s in self.stages), 1
            ),
            "d2hBytesPerBatch": sum(s.d2h_bytes for s in self.stages),
        }

    def plan_dict(self, profile: Optional[dict] = None,
                  source: str = "calibrated") -> dict:
        """The cost-report portion (no diagnostics), with the roofline
        ``latencyModel`` under ``profile`` (uncalibrated without one)."""
        return {
            "flow": self.flow,
            "chips": self.chips,
            "stages": [s.to_dict() for s in self.stages],
            "totals": self.totals(),
            "launchesPerStep": self.launches_per_step,
            "latencyModel": self.latency_model(profile, source),
        }

    def latency_model(
        self, profile: Optional[dict] = None, source: str = "calibrated",
    ) -> dict:
        """The time axis of this report: per-stage roofline ms and the
        deviceStep/d2h decomposition (costmodel.latency_model) under
        ``profile``, a ``MachineProfile.to_dict()`` of the card (or CPU)
        the flow runs on. Without a profile there are no milliseconds:
        ``profileSource`` is ``"uncalibrated"`` and the rest null."""
        from .costmodel import latency_model

        if profile is None:
            return {"profileSource": "uncalibrated", "profile": None,
                    "stages": None, "totals": None}
        return latency_model(
            [s.to_dict() for s in self.stages], self.totals(),
            profile, profile_source=source, launches=self.launches_per_step,
        )

    def to_dict(self) -> dict:
        from .diagnostics import REPORT_SCHEMA_VERSION

        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "device": self.plan_dict(),
        }

    def runtime_model(self) -> dict:
        """The machine-readable conformance artifact config generation
        embeds into the flow's conf
        (``datax.job.process.conformance.model``)."""
        from .costmodel import runtime_conformance_model

        return runtime_conformance_model(
            self.totals(),
            [s.to_dict() for s in self.stages],
            self.outputs,
        )


def _ordered(diags: List[Diagnostic]) -> List[Diagnostic]:
    return sorted(
        diags, key=lambda d: (d.severity != "error", d.span.line, d.code)
    )


def combined_report_dict(
    base: AnalysisReport, device: Optional[DevicePlanReport] = None,
    udfs=None, fleet=None, compile_surface=None, mesh=None, race=None,
    protocol=None, conf=None,
) -> dict:
    """Merge the semantic tier with the optional device, UDF, fleet,
    compile, mesh, race, protocol and conf tiers into one response: a
    superset of ``AnalysisReport.to_dict()`` plus each tier's block,
    with one ``schemaVersion``, one merged diagnostics list and one exit
    contract."""
    from .diagnostics import REPORT_SCHEMA_VERSION

    tiers = [("device", device, "plan_dict"), ("udfs", udfs, "udfs_dict"),
             ("fleet", fleet, "fleet_dict"),
             ("compile", compile_surface, "compile_dict"),
             ("mesh", mesh, "mesh_dict"),
             ("race", race, "race_dict"), ("protocol", protocol, "protocol_dict"),
             ("conf", conf, "conf_dict")]
    diags = list(base.diagnostics)
    for _key, tier, _block in tiers:
        if tier is not None:
            diags += list(tier.diagnostics)
    diags = _ordered(diags)
    errors = [d for d in diags if d.is_error]
    out = {
        "schemaVersion": REPORT_SCHEMA_VERSION,
        "ok": not errors,
        "errorCount": len(errors),
        "warningCount": len(diags) - len(errors),
        "diagnostics": [d.to_dict() for d in diags],
    }
    for key, tier, block in tiers:
        if tier is not None:
            out[key] = getattr(tier, block)()
    return out


# ---------------------------------------------------------------------------
# The compiled flow bundle both entry points produce
# ---------------------------------------------------------------------------
@dataclass
class FlowDevicePlan:
    """Everything the evaluator/linter needs, built from either a flow
    config (``analyze_flow_device``) or a live ``FlowProcessor``
    (``analyze_processor``)."""

    name: str
    pipeline: Pipeline
    projection_views: Dict[str, List[CompiledView]]  # source -> views
    raw_schemas: Dict[str, Tuple[ViewSchema, int]]  # source -> (schema, cap)
    target_of: Dict[str, str]  # source -> projected table
    target_schemas: Dict[str, ViewSchema]
    target_caps: Dict[str, int]
    ring_slots: Dict[str, int]  # windowed table -> slots
    windows: Dict[str, Tuple[str, float]]  # window name -> (table, dur_s)
    state: Dict[str, Tuple[ViewSchema, int]]
    refdata: Dict[str, Tuple[ViewSchema, int]]
    aux_tables: Dict[str, object]
    dict_max_size: Optional[int] = None
    declared_cardinality: Dict[str, int] = field(default_factory=dict)
    declared_strings: int = 0
    udf_refresh_names: List[str] = field(default_factory=list)
    uses_string_ops: bool = False
    watermark_s: float = 0.0
    interval_s: float = 1.0
    chips: int = DEFAULT_CHIPS
    # datasets routed to sinks: the views whose tables cross the
    # device->host boundary every batch (the D2H term + DX206 surface)
    output_datasets: List[str] = field(default_factory=list)
    # transfer slots each output keeps resident: the A/B pair of a
    # streaming processor, none with process.pipeline.outputslots=false
    output_slots: int = OUTPUT_SLOT_BUFFERS
    # the rings' timestamp column (the step rebases it each batch)
    ts_col: Optional[str] = None
    # the allocator's block on the plan's device: a card's caching
    # allocator holds each tensor in 512-byte blocks, so the resident
    # stages count whole blocks there (0: exact bytes, as on the CPU)
    block_bytes: int = 0


def _declared_cardinality(schema: Schema) -> Tuple[Dict[str, int], int]:
    """Per-leaf-column declared value cardinality from schema metadata
    ``allowedValues``, plus the total count of distinct declared string
    values (the dictionary-pressure bound). Keyed by the leaf name
    because projections alias nested fields to their leaves."""
    cards: Dict[str, int] = {}
    n_strings = 0
    for col in schema.columns:
        vals = (col.metadata or {}).get("allowedValues")
        if not isinstance(vals, list) or not vals:
            continue
        leaf = col.name.rsplit(".", 1)[-1]
        cards[leaf] = len(vals)
        cards.setdefault(col.name, len(vals))
        if col.ctype.value == "string":
            n_strings += len(set(map(str, vals)))
    return cards, n_strings


# ---------------------------------------------------------------------------
# Builder: from a designer flow config (gui JSON / full flow document)
# ---------------------------------------------------------------------------
def _jobconf_int(jobconf: dict, *names: str) -> Optional[int]:
    for n in names:
        v = jobconf.get(n)
        if v in (None, ""):
            continue
        try:
            return int(v)
        except (TypeError, ValueError):
            return None
    return None


def _plan_from_gui(
    gui: dict, diags: List[Diagnostic], chips: Optional[int]
) -> Optional[FlowDevicePlan]:
    name = gui.get("name") or ""
    iprops = (gui.get("input") or {}).get("properties") or {}
    proc = gui.get("process") or {}
    jobconf = proc.get("jobconfig") or {}

    batch_capacity = _jobconf_int(jobconf, "jobBatchCapacity") or 65536
    try:
        interval_s = float(
            iprops.get("windowDuration") or iprops.get("intervalInSeconds") or 1
        )
    except (TypeError, ValueError):
        interval_s = 1.0
    watermark = proc.get("watermark") or (
        f"{iprops.get('watermarkValue', 0)} "
        f"{iprops.get('watermarkUnit', 'second')}"
    )
    try:
        watermark_s = parse_duration_seconds(watermark)
    except Exception:  # noqa: BLE001 — malformed watermark: keep 0
        watermark_s = 0.0
    ts_col = proc.get("timestampColumn") or ""

    # planner capacities from the flow config (conf process.maxgroups /
    # process.joincapacity analogs in the designer's jobconfig)
    pc_kwargs = {}
    maxgroups = _jobconf_int(jobconf, "maxGroups", "maxgroups")
    if maxgroups is not None and maxgroups >= 1:
        pc_kwargs["max_group_capacity"] = maxgroups
    joincap = _jobconf_int(jobconf, "joinCapacity", "joincapacity")
    if joincap is not None and joincap >= 1:
        pc_kwargs["join_capacity"] = joincap
    planner_config = PlannerConfig(**pc_kwargs)
    dict_max = _jobconf_int(
        jobconf, "stringDictionaryMaxSize", "stringdictionarymaxsize"
    )

    # -- sources ---------------------------------------------------------
    sources: List[Tuple[str, dict, str]] = []  # (source, props, target)
    if iprops.get("inputSchemaFile"):
        sources.append(("default", iprops, DatasetName.DataStreamProjection))
    for src in (gui.get("input") or {}).get("sources") or []:
        sname = src.get("id") or src.get("name")
        if not sname:
            continue
        sprops = src.get("properties") or {}
        sources.append((sname, sprops, sprops.get("target") or sname))
    if not sources:
        diags.append(make(
            "DX291", "",
            "device analysis needs a concrete input schema "
            "(gui.input.properties.inputSchemaFile)",
        ))
        return None

    schemas: Dict[str, Schema] = {}
    raw_schemas: Dict[str, Tuple[ViewSchema, int]] = {}
    target_of: Dict[str, str] = {}
    snippets: Dict[str, Optional[str]] = {}
    for sname, sprops, target in sources:
        try:
            schema = Schema.from_spark_json(sprops.get("inputSchemaFile"))
        except (TypeError, ValueError, KeyError) as e:
            diags.append(make(
                "DX291", target,
                f"device analysis skipped: input schema for source "
                f"'{sname}' does not parse ({e})",
            ))
            return None
        schemas[sname] = schema
        raw_types = dict(schema_to_view(schema).types)
        raw_types.setdefault(ColumnName.RawPropertiesColumn, "string")
        raw_types.setdefault(ColumnName.RawSystemPropertiesColumn, "string")
        raw_schemas[sname] = (ViewSchema(raw_types), batch_capacity)
        target_of[sname] = target
        snippets[sname] = sprops.get("normalizationSnippet")
    targets = list(target_of.values())

    # -- UDFs (design-time reflection load, the JarUDFHandler path) ------
    udfs: Dict[str, object] = {}
    for fn in proc.get("functions") or []:
        ftype = (fn.get("type") or "udf").lower()
        if ftype not in ("udf", "udaf", "jarudf", "jarudaf", "pythonudf"):
            continue  # azure functions are a sink tier, not compiled
        props = fn.get("properties") or {}
        path = props.get("module") or props.get("class") or ""
        fid = fn.get("id") or ""
        if not fid or not path:
            continue
        try:
            from ..udf.api import _import_attr

            obj = _import_attr(path)
            if isinstance(obj, type) or not hasattr(obj, "compile_call"):
                obj = obj()
        except Exception as e:  # noqa: BLE001 — reflection load
            diags.append(make(
                "DX291", "",
                f"device analysis skipped: UDF '{fid}' ({path}) is not "
                f"loadable at design time ({e})",
            ))
            return None
        obj.name = fid
        udfs[fid.lower()] = obj

    # -- codegen (the S450 pass the runtime also consumes) ---------------
    queries = proc.get("queries") or []
    code = "\n".join(q if isinstance(q, str) else str(q) for q in queries)
    rules_json = RuleDefinitionGenerator().generate(gui.get("rules") or [], name)
    try:
        rc: RulesCode = CodegenEngine().generate_code(
            code, rules_json, name, windowable_tables=set(targets)
        )
    except Exception as e:  # noqa: BLE001 — base tier owns codegen findings
        diags.append(make(
            "DX291", "", f"device analysis skipped: codegen failed ({e})"
        ))
        return None

    dictionary = StringDictionary()
    pc = PipelineCompiler(dictionary, udfs, config=planner_config)

    try:
        # per-source projection lowering (the FlowProcessor path)
        projection_views: Dict[str, List[CompiledView]] = {}
        target_schemas: Dict[str, ViewSchema] = {}
        target_caps: Dict[str, int] = {}
        for sname, _sprops, target in sources:
            raw_schema, cap = raw_schemas[sname]
            snippet = snippets[sname]
            steps = [snippet] if snippet else [
                default_projection(schemas[sname], ts_col)
            ]
            proj_catalog = {
                "Raw": raw_schema, DatasetName.DataStreamRaw: raw_schema,
            }
            proj_caps = {"Raw": cap, DatasetName.DataStreamRaw: cap}
            cur = "Raw"
            views: List[CompiledView] = []
            for i, step in enumerate(steps):
                sel = projection_select(step, cur)
                compiler = SelectCompiler(
                    proj_catalog, proj_caps, dictionary, udfs,
                    planner_config, aux=pc.aux,
                )
                vname = target if i == len(steps) - 1 else f"__proj{i}"
                view = compiler.compile_select(vname, sel)
                views.append(view)
                proj_catalog[vname] = view.schema
                proj_caps[vname] = view.capacity
                cur = vname
            projection_views[sname] = views
            target_schemas[target] = proj_catalog[target]
            target_caps[target] = cap

        # windows over projected tables (ring retention model)
        windows: Dict[str, Tuple[str, float]] = {}
        ring_slots: Dict[str, int] = {}
        for wname, duration in rc.time_windows.items():
            table = window_target(wname, targets)
            if table not in target_schemas:
                raise EngineException(
                    f"timewindow {wname} targets unknown table {table!r}"
                )
            dur_s = parse_duration_seconds(duration)
            if ts_col not in target_schemas[table].types:
                raise EngineException(
                    f"timewindow {wname} requires timestamp column "
                    f"{ts_col!r} in table {table}"
                )
            windows[wname] = (table, dur_s)
            slots = num_slots(dur_s, watermark_s, interval_s)
            ring_slots[table] = max(ring_slots.get(table, 1), slots)

        # accumulation tables
        state: Dict[str, Tuple[ViewSchema, int]] = {}
        for sname_, ddl in rc.accumulation_tables.items():
            state[sname_] = (
                parse_state_table_schema(ddl), batch_capacity * 4
            )

        inputs: Dict[str, Tuple[ViewSchema, int]] = {
            t: (sch, target_caps[t]) for t, sch in target_schemas.items()
        }
        for wname, (table, _d) in windows.items():
            inputs[wname] = (
                target_schemas[table],
                ring_slots[table] * target_caps[table],
            )
        pipeline = pc.compile_transform(rc.code, inputs, state)
    except EngineException as e:
        diags.append(make("DX290", "", str(e)))
        return None
    except Exception as e:  # noqa: BLE001 — any lowering blowup is a finding
        diags.append(make("DX290", "", f"device lowering failed: {e}"))
        return None

    from ..compile.stringops import AuxTableBuilder

    aux = AuxTableBuilder(pc.aux, dictionary).tables()

    cards: Dict[str, int] = {}
    n_strings = 0
    for sname in schemas:
        c, ns = _declared_cardinality(schemas[sname])
        for k, v in c.items():
            cards.setdefault(k, v)
        n_strings += ns

    refresh = [
        u.name for u in udfs.values()
        if getattr(u, "_on_interval", None) is not None
    ]

    # OUTPUT statements name the datasets that cross D2H every batch
    view_names = {v.name for v in pipeline.views}
    out_datasets: List[str] = []
    for tables, _sink in rc.outputs:
        for t in tables.split(","):
            t = t.strip()
            if t in view_names and t not in out_datasets:
                out_datasets.append(t)

    return FlowDevicePlan(
        ts_col=ts_col or None,
        name=name,
        pipeline=pipeline,
        projection_views=projection_views,
        raw_schemas=raw_schemas,
        target_of=target_of,
        target_schemas=target_schemas,
        target_caps=target_caps,
        ring_slots=ring_slots,
        windows=windows,
        state=state,
        refdata={},
        aux_tables=aux,
        dict_max_size=dict_max,
        declared_cardinality=cards,
        declared_strings=n_strings,
        udf_refresh_names=refresh,
        uses_string_ops=not pc.aux.empty,
        watermark_s=watermark_s,
        interval_s=interval_s,
        chips=chips
        or _jobconf_int(jobconf, "jobNumChips", "jobNumExecutors")
        or DEFAULT_CHIPS,
        output_datasets=out_datasets,
    )


# ---------------------------------------------------------------------------
# Builder: from a live FlowProcessor
# ---------------------------------------------------------------------------
def flow_plan_from_processor(
    proc, chips: Optional[int] = None, output_slots: Optional[int] = None,
) -> FlowDevicePlan:
    """Bundle an already-built ``FlowProcessor``'s compiled plan (the
    exact views its step runs) for cost analysis, priced at ``chips``,
    by default the size of the processor's mesh (1 without one).
    ``output_slots``: the transfer slots each output holds; by default
    the processor's own (``OUTPUT_SLOT_BUFFERS``, or 0 with its output
    slots off)."""
    if output_slots is None:
        output_slots = OUTPUT_SLOT_BUFFERS if proc.output_slots_enabled else 0
    cards: Dict[str, int] = {}
    n_strings = 0
    for spec in proc.specs.values():
        c, ns = _declared_cardinality(spec.schema)
        for k, v in c.items():
            cards.setdefault(k, v)
        n_strings += ns
    return FlowDevicePlan(
        ts_col=proc.timestamp_column,
        name=proc.dict.get("datax.job.name") or "",
        pipeline=proc.pipeline,
        projection_views=dict(proc.projection_views),
        raw_schemas={
            s.name: (s.raw_schema, s.capacity) for s in proc.specs.values()
        },
        target_of={s.name: s.target for s in proc.specs.values()},
        target_schemas=dict(proc.target_schemas),
        target_caps={s.target: s.capacity for s in proc.specs.values()},
        ring_slots=dict(proc.ring_slots),
        windows=dict(proc.windows),
        state={
            n: (st.schema, st.capacity)
            for n, st in proc.state_tables.items()
        },
        refdata={
            n: (sch, t.capacity) for n, (sch, t) in proc.refdata.items()
        },
        aux_tables=proc.aux_tables.tables(),
        dict_max_size=proc.dictionary.max_size,
        declared_cardinality=cards,
        declared_strings=n_strings,
        udf_refresh_names=[
            u.name for u in proc.udfs.values()
            if getattr(u, "_on_interval", None) is not None
        ],
        uses_string_ops=not proc.aux_registry.empty,
        watermark_s=proc.watermark_s,
        interval_s=proc.interval_s,
        chips=chips
        or (proc.mesh.size if proc.mesh is not None else None)
        or DEFAULT_CHIPS,
        output_datasets=list(proc.output_datasets),
        output_slots=output_slots,
        block_bytes=CUDA_BLOCK_BYTES if proc.device.type == "cuda" else 0,
    )


# ---------------------------------------------------------------------------
# Evaluator: abstract-interpret every stage of the compiled plan
# ---------------------------------------------------------------------------
def _view_stage(
    view: CompiledView,
    out_bytes: int,
    plan: FlowDevicePlan,
    catalog: Dict[str, ViewSchema],
) -> StageCost:
    p = view.plan
    kind = p.kind if p is not None else "project"
    details = []
    if p is not None:
        for s in p.joins:
            details.append(
                f"{s.kind.lower()}-join[{s.algorithm}] "
                f"{s.left_rows}x{s.right_rows}->{s.out_rows}"
            )
        if p.grouped:
            details.append(
                f"group keys={p.group_keys} aggs={p.n_aggregates} "
                f"bound={p.groups_bound}"
            )
        if p.union_branches > 1:
            details.append(f"union x{p.union_branches}")
        if p.limit is not None:
            details.append(f"limit {p.limit}")
    right_rb = {
        t: row_bytes(sch.types) for t, sch in catalog.items()
    }
    return StageCost(
        name=view.name,
        kind=kind,
        rows=view.capacity,
        hbm_bytes=out_bytes,
        model_bytes=view_output_bytes(view.schema.types, p, view.capacity),
        transient_bytes=stage_transient_bytes(p),
        flops=stage_flops(p, len(view.schema.types)),
        ici_bytes=stage_ici_bytes(
            p, row_bytes(view.schema.types), plan.chips, right_rb
        ),
        detail="; ".join(details),
    )


def _stage_walk(
    plan: FlowDevicePlan,
    make_table: Callable[[ViewSchema, int], TableData],
    eval_view: Callable[[CompiledView, Dict[str, TableData]], TableData],
    aux_tables: Dict[str, object],
) -> List[StageCost]:
    """Walk raw -> projection -> rings/windows -> state/refdata ->
    transform views, building stage costs. ``make_table``, ``eval_view``
    and ``aux_tables`` select abstract (meta) or concrete evaluation:
    the same walk serves the analyzer and the drift test."""
    stages: List[StageCost] = []
    env: Dict[str, object] = {"__aux": aux_tables}

    for source, views in plan.projection_views.items():
        raw_schema, cap = plan.raw_schemas[source]
        raw = make_table(raw_schema, cap)
        b = _table_data_bytes(raw)
        stages.append(StageCost(
            name=f"input:{source}", kind="input", rows=cap,
            hbm_bytes=b, model_bytes=table_bytes(raw_schema.types, cap),
            detail="raw ingest batch",
        ))
        penv: Dict[str, object] = {
            "Raw": raw, DatasetName.DataStreamRaw: raw, "__aux": aux_tables,
        }
        proj_catalog = {"Raw": raw_schema}
        for v in views:
            out = eval_view(v, penv)
            penv[v.name] = out
            stages.append(_view_stage(
                v, _table_data_bytes(out), plan, proj_catalog
            ))
            proj_catalog[v.name] = v.schema
        target = plan.target_of[source]
        env[target] = penv[target]

    block = plan.block_bytes
    for table, slots in plan.ring_slots.items():
        rows = slots * plan.target_caps[table]
        schema = plan.target_schemas[table]
        stages.append(StageCost(
            name=f"ring:{table}", kind="ring", rows=rows,
            hbm_bytes=_resident_bytes(_table(schema, rows, "meta"), block),
            model_bytes=table_bytes(schema.types, rows),
            detail=f"{slots} slots x {plan.target_caps[table]} rows "
                   "(device-resident window state)",
        ))
    for wname, (table, dur_s) in plan.windows.items():
        rows = plan.ring_slots[table] * plan.target_caps[table]
        schema = plan.target_schemas[table]
        t = make_table(schema, rows)
        env[wname] = t
        stages.append(StageCost(
            name=wname, kind="window", rows=rows,
            hbm_bytes=_table_data_bytes(t),
            model_bytes=table_bytes(schema.types, rows),
            detail=f"{dur_s:g}s window over {table}",
        ))
    for sname, (schema, cap) in plan.state.items():
        t = make_table(schema, cap)
        env[sname] = t
        # display names are prefixed: an accumulation table is BOTH a
        # state input and (by the same name) a pipeline view output
        stages.append(StageCost(
            name=f"state:{sname}", kind="state", rows=cap,
            hbm_bytes=_resident_bytes(t, block),
            model_bytes=table_bytes(schema.types, cap),
            detail="accumulation table",
        ))
    for rname, (schema, cap) in plan.refdata.items():
        t = make_table(schema, cap)
        env[rname] = t
        stages.append(StageCost(
            name=f"refdata:{rname}", kind="refdata", rows=cap,
            hbm_bytes=_resident_bytes(t, block),
            model_bytes=table_bytes(schema.types, cap),
            detail="reference data",
        ))

    for view in plan.pipeline.views:
        out = eval_view(view, env)
        env[view.name] = out
        stage = _view_stage(
            view, _table_data_bytes(out), plan, plan.pipeline.catalog
        )
        if view.name in plan.output_datasets:
            # the sync-stage wire cost: a full-capacity fetch of this
            # output's table crosses the device->host boundary per batch
            stage.d2h_bytes = d2h_transfer_bytes(
                view.schema.types, view.plan, view.capacity
            )
        stages.append(stage)
        if view.name in plan.output_datasets and plan.output_slots:
            # the transfer slots the runtime keeps resident for this
            # output (runtime/processor.py _stage_output): persistent
            # device bytes, derived from the same evaluated table as the
            # view stage, so model == evaluation stays exact (but for
            # the whole blocks of a card)
            n = plan.output_slots
            stages.append(StageCost(
                name=f"outslot:{view.name}", kind="outslot",
                rows=view.capacity,
                hbm_bytes=n * _resident_bytes(out, block),
                model_bytes=output_slot_bytes(
                    view.schema.types, view.plan, view.capacity, buffers=n
                ),
                detail=f"{n}x transfer slots (A/B double buffer)",
            ))
    return stages


def _abstract_eval(plan: FlowDevicePlan) -> List[StageCost]:
    """Every view run once on ``meta`` tensors: the shapes and dtypes the
    step produces, with no data, no allocation and no kernel."""
    base = torch.zeros((), dtype=torch.int32, device="meta")
    now = torch.zeros((), dtype=torch.int32, device="meta")

    def eval_view(view, env):
        return view.fn(env, base, now)

    return _stage_walk(plan, table_struct, eval_view, _aux_on(plan.aux_tables, "meta"))


def meta_step_args(plan: FlowDevicePlan, forms: Dict[str, str],
                   refdata: Dict[str, TableData]) -> tuple:
    """The step's nine arguments on ``meta``, in the JAX package's
    structure: each source's raw batch (one ``PackedRaw`` matrix where
    ``forms`` says ``packed``, else columns), the rings, the state, the
    reference tables, the four int32 scalars (the port passes the slot
    counter and base delta as host ints; the structure keeps the JAX
    package's four) and the string-op tables."""
    raw: Dict[str, object] = {}
    for source, (schema, cap) in plan.raw_schemas.items():
        if forms.get(source) == "packed":
            layout = packed_raw_layout(schema.types)
            raw[source] = PackedRaw(torch.empty(
                (len(layout) + 1, cap), dtype=torch.int32, device="meta"), layout)
        else:
            raw[source] = table_struct(schema, cap)
    rings = {
        t: make_buffers(plan.target_schemas[t], plan.target_caps[t], slots, "meta")
        for t, slots in plan.ring_slots.items()
    }
    state = {n: table_struct(sch, cap) for n, (sch, cap) in plan.state.items()}
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    return (raw, rings, state, refdata, scalar, scalar, scalar, scalar,
            _aux_on(plan.aux_tables, "meta"))


def meta_step(plan: FlowDevicePlan, refdata_names: List[str], delta_ms: int = 1000):
    """The runtime's step (``build_step_fn``) over the plan's views,
    called with ``meta_step_args``' structure as a batch ``delta_ms``
    after the last."""
    targets = list(plan.target_of.values())
    step = build_step_fn(
        ts_col=plan.ts_col,
        windows=dict(plan.windows),
        output_datasets=list(plan.output_datasets),
        state_names=list(plan.state),
        refdata_names=sorted(refdata_names),
        ring_tables=list(plan.ring_slots),
        pipeline=plan.pipeline,
        source_targets=list(plan.target_of.items()),
        proj_views=dict(plan.projection_views),
        primary_target=plan.target_of.get("default") or (targets[0] if targets else ""),
    )

    def run(raw, rings, state, refdata, base_s, now, _counter, _delta, aux):
        return step(raw, rings, state, refdata, base_s, now, 1, delta_ms, aux)

    return run


def count_step_launches(plan: FlowDevicePlan) -> int:
    """The kernels one batch launches on a card, counted on ``meta``
    (``kernels/launch.py::MetaLaunchCounter``): the two time scalars'
    fills, each source's one host-to-device copy of its packed matrix,
    the production step, each output's copy into its transfer slot, and
    the device-to-host copies of the outputs, the counts vector and the
    state. A kernel UDF counts once."""
    refdata = {n: table_struct(sch, cap) for n, (sch, cap) in plan.refdata.items()}
    args = meta_step_args(plan, dict.fromkeys(plan.raw_schemas, "packed"), refdata)
    step = meta_step(plan, list(plan.refdata))
    counter = MetaLaunchCounter()
    with counter:
        for _ in range(2):
            torch.full((), 0, dtype=torch.int32, device="meta")
        for raw in args[0].values():
            torch.empty_like(raw.data).copy_(raw.data)
        datasets, counts, new_state = step(*args)
        landed = [counts] + list(datasets.values()) + list(new_state.values())
        for t in datasets.values():  # staged into the output's slot
            for v in list(t.cols.values()) + [t.valid]:
                torch.empty_like(v).copy_(v)
        for t in landed:  # copied off the card
            for v in ([t] if isinstance(t, torch.Tensor)
                      else list(t.cols.values()) + [t.valid]):
                torch.empty_like(v).copy_(v)
    return counter.count


def materialized_stage_bytes(
    plan: FlowDevicePlan, device: "torch.device | str" = "cpu",
) -> Dict[str, int]:
    """Ground truth for the drift test: run every compiled view ONCE on
    real (zero-filled) tables on ``device`` and return the actual bytes
    per stage name. Small capacities only: this executes the plan."""
    dev = torch.device(device)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    now = torch.zeros((), dtype=torch.int32, device=dev)

    def eval_view(view, env):
        return view.fn(env, base, now)

    def make_table(schema, rows):
        return _table(schema, rows, dev)

    return {
        s.name: s.hbm_bytes
        for s in _stage_walk(plan, make_table, eval_view, _aux_on(plan.aux_tables, dev))
    }


# ---------------------------------------------------------------------------
# DX2xx lints over the compiled plan
# ---------------------------------------------------------------------------
def _lint(
    plan: FlowDevicePlan,
    diags: List[Diagnostic],
    match_matrix_budget: int,
) -> None:
    for view in plan.pipeline.views:
        p = view.plan
        if p is None:
            continue
        if p.grouped and p.group_key_cols:
            cards = [
                plan.declared_cardinality.get(c) for c in p.group_key_cols
            ]
            if cards and all(c is not None for c in cards):
                product = 1
                for c in cards:
                    product *= c
                if product > p.groups_bound:
                    diags.append(make(
                        "DX200", view.name,
                        f"group keys {list(p.group_key_cols)} have declared "
                        f"cardinality {product} but the static group "
                        f"capacity is {p.groups_bound} (process.maxgroups); "
                        f"overflow groups drop and surface only as "
                        f"Output_{view.name}_GroupsDropped",
                    ))
                elif (
                    view.name in plan.output_datasets
                    and view.capacity > D2H_OVERSIZE_FACTOR * product
                ):
                    per_batch = d2h_transfer_bytes(
                        view.schema.types, p, view.capacity
                    )
                    slot_bytes = output_slot_bytes(
                        view.schema.types, p, view.capacity
                    )
                    diags.append(make(
                        "DX206", view.name,
                        f"output capacity {view.capacity} exceeds the "
                        f"modeled group count {product} by more than "
                        f"{D2H_OVERSIZE_FACTOR}x: a full fetch moves "
                        f"{per_batch} D2H bytes/batch of mostly padding "
                        f"through the sync stage, and the "
                        f"{OUTPUT_SLOT_BUFFERS}x transfer slots hold "
                        f"{slot_bytes} device bytes at that padding; "
                        f"sized output transfer "
                        f"(process.pipeline.sizedtransfer, default on) "
                        f"or a tighter process.maxgroups shrinks both to "
                        f"the wire minimum",
                    ))
        for s in p.joins:
            if s.out_rows < s.left_rows:
                diags.append(make(
                    "DX201", view.name,
                    f"join output capacity {s.out_rows} is below the left "
                    f"input capacity {s.left_rows} "
                    f"(vs {s.right_table}): even a 1:1 match overflows, "
                    f"dropped pairs surface only as "
                    f"Output_{view.name}_JoinRowsDropped",
                ))
            pairs = s.left_rows * s.right_rows
            if s.algorithm == "match-matrix" and pairs > match_matrix_budget:
                diags.append(make(
                    "DX203", view.name,
                    f"non-equi ON terms force the O(n*m) match matrix: "
                    f"{s.left_rows} x {s.right_rows} = {pairs} pair "
                    f"evaluations per batch (budget "
                    f"{match_matrix_budget}); the sort-merge path needs "
                    f"a pure equality ON",
                ))
    if (
        plan.dict_max_size is not None
        and plan.declared_strings > plan.dict_max_size
    ):
        diags.append(make(
            "DX202", "",
            f"string dictionary capacity {plan.dict_max_size} is below "
            f"the declared/sampled distinct string-value count "
            f"{plan.declared_strings}; over-capacity keys collapse to "
            f"NULL (watch Input_string_dictionary_overflow_Count)",
        ))
    if plan.udf_refresh_names:
        diags.append(make(
            "DX204", "",
            f"UDF(s) {sorted(plan.udf_refresh_names)} declare interval "
            "refresh: every state change rebuilds the whole step "
            "(Retrace_Count)",
        ))
    if plan.uses_string_ops and plan.dict_max_size is None:
        diags.append(make(
            "DX204", "",
            "device string ops with an unbounded dictionary: dictionary "
            "growth past the string-op table capacity rebuilds the "
            "tables every batch it grows; set "
            "process.stringdictionary.maxsize",
        ))
    for wname, (_table_name, dur_s) in plan.windows.items():
        retention_ms = (dur_s + plan.watermark_s) * 1000.0
        if retention_ms > INT32_MS_HORIZON * REBASE_PROXIMITY_FRACTION:
            diags.append(make(
                "DX205", wname,
                f"window retention {retention_ms / 86_400_000.0:.1f} days "
                f"is past {int(REBASE_PROXIMITY_FRACTION * 100)}% of the "
                "int32 relative-millis horizon (~24.8 days); ring "
                "timestamps approach the rebase overflow guard",
            ))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def _output_model(bundle: FlowDevicePlan) -> Dict[str, dict]:
    """Per-OUTPUT modeled row occupancy: the declared-cardinality bound
    for grouped views (capped by the static group capacity), the padded
    capacity otherwise. The DX502 baseline."""
    out: Dict[str, dict] = {}
    for view in bundle.pipeline.views:
        if view.name not in bundle.output_datasets:
            continue
        p = view.plan
        rows = view.capacity
        if p is not None and p.grouped:
            rows = p.groups_bound
            cards = [
                bundle.declared_cardinality.get(c)
                for c in (p.group_key_cols or ())
            ]
            if cards and all(c is not None for c in cards):
                product = 1
                for c in cards:
                    product *= c
                rows = min(rows, product)
        out[view.name] = {
            "rows": int(rows), "capacity": int(view.capacity),
        }
    return out


def _analyze(
    bundle: Optional[FlowDevicePlan],
    diags: List[Diagnostic],
    name: str,
    match_matrix_budget: int,
) -> DevicePlanReport:
    if bundle is None:
        return DevicePlanReport(name, DEFAULT_CHIPS, [], _ordered(diags))
    # lints read only the recorded plan: run them before the meta
    # evaluation so a plan that cannot even evaluate still gets its
    # capacity/cliff diagnostics
    _lint(bundle, diags, match_matrix_budget)
    try:
        stages = _abstract_eval(bundle)
    except Exception as e:  # noqa: BLE001 — a failed evaluation is a finding
        diags.append(make(
            "DX290", "", f"device plan meta evaluation failed: {e}"
        ))
        return DevicePlanReport(bundle.name, bundle.chips, [], _ordered(diags))
    return DevicePlanReport(
        bundle.name, bundle.chips, stages, _ordered(diags),
        outputs=_output_model(bundle),
        launches_per_step=count_step_launches(bundle),
    )


def analyze_flow_device(
    flow: dict,
    chips: Optional[int] = None,
    match_matrix_budget: int = DEFAULT_MATCH_MATRIX_BUDGET,
) -> DevicePlanReport:
    """Device-plan analysis of a flow config (gui JSON or full flow
    document). Pure abstract interpretation: compiles with the
    production planner and evaluates on ``meta``; touches no device."""
    gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
    diags: List[Diagnostic] = []
    bundle = _plan_from_gui(gui, diags, chips)
    return _analyze(bundle, diags, gui.get("name") or "", match_matrix_budget)


def analyze_processor(
    proc,
    chips: Optional[int] = None,
    match_matrix_budget: int = DEFAULT_MATCH_MATRIX_BUDGET,
    output_slots: Optional[int] = None,
) -> DevicePlanReport:
    """Device-plan analysis of an already-built ``FlowProcessor``: the
    exact compiled views its step runs, evaluated on ``meta``.
    ``output_slots`` as in ``flow_plan_from_processor``."""
    diags: List[Diagnostic] = []
    bundle = flow_plan_from_processor(proc, chips, output_slots)
    return _analyze(bundle, diags, bundle.name, match_matrix_budget)
