"""Mesh-sharding analyzer: static partition plans with census-validated
ICI cost closed forms.

Sixth analysis tier (the ``--mesh [--chips=N]`` tier, DX7xx). The mesh
path runs the whole step partitioned over a 1-D ``data`` mesh
(``dist/mesh.py``, ``runtime/processor.py::build_mesh_step_fn``): rows
shard over the ``data`` axis, window rings shard their capacity dim,
reference/state tables replicate, and a collective stage gathers its
sharded inputs and runs replicated. This tier predicts, statically,
how a flow partitions under that layout and what the interconnect will
cost:

- it infers a **partition plan** from the planner's ``StagePlan``/
  ``JoinSite`` metadata: which axis every stage keeps its rows on
  (``data`` vs ``replicated``), where a resharding all-gather is forced
  (GROUP BY / JOIN / DISTINCT / ORDER BY / LIMIT stages pull their
  sharded inputs onto every chip; sharded OUTPUT views gather at the
  step boundary), and what each stage leaves resident per chip;
- it prices every reshard edge with **closed forms**: result bytes are
  exact functions of the static shapes (rows x column widths, group
  capacity G bounding grouped outputs, join fan-out F bounding join
  outputs), and wire bytes apply the ring-collective factors over chips
  N (``costmodel.allgather_wire_bytes`` et al.);
- it **cross-checks the model against the mesh step's census**: the
  flow's mesh step runs once, over M = min(chips, 8) virtual shards of
  one device, on one batch of the flow's schema at its capacity, and the
  ``MeshCollectives`` it records must equal the model: one all-gather
  of each table the model gathers (the step shares it among the stages
  that read the table), with every reshard edge's result bytes
  exactly, and no other collective but the one all-reduce of the
  counts vector. A disagreement, or a step that raises, is DX790, an
  error.

A port of the JAX package's ``analysis/meshcheck.py``; codes, tables,
axes, scaling and bytes equal the reference's. Deliberate differences:

- The JAX package lowers each stage with ``jax.jit`` under a real
  ``Mesh`` and parses the partitioner's HLO. PyTorch has no partitioner:
  the port's mesh step partitions itself and records every collective
  it makes, so the cross-check runs that step and reads its census.
  By default the step runs on ``meta`` tensors (shapes only: no data,
  no allocation, no kernel), as the device tier evaluates its plan;
  ``device="cpu"`` or ``"cuda"`` runs it on zero-filled tables there.
- Virtual shards always exist, so ``validated`` holds on one device.
  DX791 remains only for a flow with no plan: no concrete schema, or a
  UDF that cannot be loaded.
- ``DEFAULT_MESH_CHIPS`` is 8, one HGX H100 node of NVLink-joined cards.
- ``latency_model()`` without a caller's profile is ``"uncalibrated"``
  with no milliseconds: the reference's default is a TPU datasheet,
  which the port does not carry, and one card has no link to calibrate
  (``obs/calibrate.py``).
- The default fleet spec is the machine's cards (``FleetSpec(chips=
  chips)``), as the fleet tier's, whatever device the cross-check runs
  on: ``meta`` only propagates shapes and describes no machine. Without
  a card it raises; pass ``spec=`` (``FleetSpec(..., device="cpu")``
  judges against ``constants.CPU_DEVICE_MEMORY_BYTES``).
- DX700 names the CUDA kernel UDF (``udf/api.py::CudaKernelUdf``).

The emitted **sharding-plan artifact** (``runtime_model()``) is
embedded into mesh jobs' generated confs by the S660 stage
(``datax.job.process.mesh.model``); at runtime the host's
``ConformanceMonitor`` compares it against the observed
``Mesh_ICI_Bytes`` / ``Mesh_Reshard_Count`` series (the census of the
executed step's collectives) and fires DX510/DX511 ICI-drift events
beside DX501-503.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..compile.planner import CompiledView, ViewSchema
from ..dist.mesh import COUNTS_TABLE, MeshCollectives, is_collective_view, make_mesh
from .costmodel import (
    allgather_wire_bytes,
    table_bytes,
    view_output_bytes,
)
from .deviceplan import (
    FlowDevicePlan,
    _aux_on,
    _jobconf_int,
    _ordered,
    _plan_from_gui,
    _table,
    flow_plan_from_processor,
)
from .diagnostics import Diagnostic, make
from .fleetcheck import FleetSpec

# default chip count for the mesh tier: one HGX H100 node (8 cards)
DEFAULT_MESH_CHIPS = 8

# the most virtual shards the cross-check runs the step over: result
# bytes do not depend on the chip count, so 8 validate any --chips=N
MAX_CHECK_SHARDS = 8

# shard axes a stage's rows can live on (dist/mesh.py's 1-D data mesh)
AXIS_DATA = "data"
AXIS_REPLICATED = "replicated"

# compute-scaling classes for the DX704 cliff lint: "sharded" work
# shrinks 1/N, "collective" work shrinks 1/N plus wire cost, and
# "replicated" work is flat in N
SCALE_SHARDED = "sharded"
SCALE_COLLECTIVE = "collective"
SCALE_REPLICATED = "replicated"

OUTPUT_BOUNDARY = " (output boundary)"


# ---------------------------------------------------------------------------
# Report types
# ---------------------------------------------------------------------------
@dataclass
class ReshardEdge:
    """One forced layout transition: a ``data``-sharded table gathered
    onto every chip at a stage boundary."""

    table: str
    result_bytes: int  # full logical bytes of the gathered table
    wire_bytes: float  # ring all-gather wire cost at the plan's chips

    @property
    def source(self) -> str:
        """The table the gather brings whole (the output view itself
        for an output-boundary edge)."""
        return self.table.split(" ")[0]

    def to_dict(self) -> dict:
        return {
            "table": self.table,
            "collective": "all-gather",
            "resultBytes": self.result_bytes,
            "wireBytes": round(self.wire_bytes, 1),
        }


@dataclass
class MeshStage:
    """One stage of the partition plan."""

    name: str
    kind: str  # input | project | ring | window | state | refdata | group | union
    axis: str  # AXIS_DATA | AXIS_REPLICATED
    scaling: str  # SCALE_SHARDED | SCALE_COLLECTIVE | SCALE_REPLICATED
    rows: int
    hbm_bytes: int  # full logical residency (the DX2xx byte model)
    per_chip_bytes: int  # what one chip keeps resident at N chips
    reshards: List[ReshardEdge] = field(default_factory=list)
    # cross-check result: all-gather result bytes the mesh step's census
    # recorded for this stage's edges (None = not cross-checked)
    lowered_bytes: Optional[int] = None
    detail: str = ""

    @property
    def ici_result_bytes(self) -> int:
        return sum(e.result_bytes for e in self.reshards)

    @property
    def ici_wire_bytes(self) -> float:
        return sum(e.wire_bytes for e in self.reshards)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "axis": self.axis,
            "scaling": self.scaling,
            "rows": self.rows,
            "hbmBytes": self.hbm_bytes,
            "perChipBytes": self.per_chip_bytes,
            "iciResultBytes": self.ici_result_bytes,
            "iciWireBytes": round(self.ici_wire_bytes, 1),
            "reshards": [e.to_dict() for e in self.reshards],
            "loweredBytes": self.lowered_bytes,
            "detail": self.detail,
        }


@dataclass
class CensusCheck:
    """What the cross-check ran and read: the device and virtual shard
    count of the step, the model's and the census's bytes edge by edge,
    the all-reduce of the counts vector, and the wall-clock ms of the
    run (kept out of ``to_dict``, so reports of one flow compare
    equal)."""

    device: str
    shards: int
    edges: List[dict] = field(default_factory=list)
    all_reduce_bytes: int = 0
    census: Dict[str, dict] = field(default_factory=dict)
    ms: float = 0.0

    def to_dict(self) -> dict:
        return {
            "device": self.device,
            "shards": self.shards,
            "allReduceBytes": self.all_reduce_bytes,
            "census": self.census,
            "edges": self.edges,
        }


@dataclass
class MeshPlanReport:
    flow: str
    chips: int
    stages: List[MeshStage]
    diagnostics: List[Diagnostic]
    # True when the mesh step's census was held against every reshard
    # edge (the cross-check ran)
    validated: bool = False
    cross_check: Optional[CensusCheck] = None

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def totals(self) -> dict:
        return {
            "iciResultBytesPerBatch": sum(
                s.ici_result_bytes for s in self.stages
            ),
            "iciWireBytesPerBatch": round(
                sum(s.ici_wire_bytes for s in self.stages), 1
            ),
            "reshardCount": sum(len(s.reshards) for s in self.stages),
            "perChipHbmBytes": sum(s.per_chip_bytes for s in self.stages),
            "chips": self.chips,
        }

    def mesh_dict(self) -> dict:
        """The sharding-plan portion (no diagnostics): what the designer
        renders as the sharding table and the CLI's ``--json`` report
        carries under ``mesh``."""
        return {
            "flow": self.flow,
            "chips": self.chips,
            "validated": self.validated,
            "stages": [s.to_dict() for s in self.stages],
            "totals": self.totals(),
            "latencyModel": self.latency_model(),
            "crossCheck": (
                self.cross_check.to_dict() if self.cross_check else None
            ),
        }

    def latency_model(
        self, profile: Optional[dict] = None, source: str = "calibrated",
    ) -> dict:
        """The wire-time axis of the sharding plan: the DX7xx collective
        wire bytes priced over ``profile``'s ICI link bandwidth
        (``ici_gbps`` of a ``MachineProfile.to_dict()``; per-stage and
        total ms), a roofline lower bound. Without a profile there are
        no milliseconds: ``profileSource`` is ``"uncalibrated"``."""
        from .costmodel import transfer_time_ms

        if profile is None:
            profile, source = {}, "uncalibrated"
        gbps = profile.get("ici_gbps")
        stages = [
            {
                "name": s.name,
                "iciMs": (
                    round(transfer_time_ms(s.ici_wire_bytes, gbps), 4)
                    if gbps else None
                ),
            }
            for s in self.stages
        ]
        total = transfer_time_ms(
            self.totals()["iciWireBytesPerBatch"], gbps
        )
        return {
            "profileSource": source,
            "iciGBps": gbps,
            "stages": stages,
            "totals": {
                "iciMs": round(total, 4) if total is not None else None,
            },
        }

    def to_dict(self) -> dict:
        from .diagnostics import REPORT_SCHEMA_VERSION

        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "mesh": self.mesh_dict(),
        }

    def runtime_model(self) -> dict:
        """The machine-readable sharding-plan artifact the S660
        generation stage embeds into mesh jobs' confs
        (``datax.job.process.mesh.model``): the slice a running host
        checks its observed collective census against
        (``obs/conformance.py`` DX510/DX511)."""
        from .costmodel import mesh_runtime_model

        return mesh_runtime_model(
            self.totals(), [s.to_dict() for s in self.stages]
        )


# ---------------------------------------------------------------------------
# Partition-plan inference
# ---------------------------------------------------------------------------
def _replication_origin(view: CompiledView) -> Optional[str]:
    """The structural reason a stage cannot scale with N, if any: a
    global sort over the raw scope, a host-side finishing sort, or a
    CUDA-kernel UDF (it sees whole columns). Grouped sorts don't count:
    they sort the G-row group output, and the gather itself is
    modeled."""
    p = view.plan
    if view.host_order:
        return "host-side ORDER BY"
    if p is not None and p.order_keys and not p.grouped:
        return "device ORDER BY"
    if p is not None and p.unshardable_udfs:
        return "CUDA kernel UDF " + "/".join(p.unshardable_udfs)
    return None


def _view_model_bytes(view: CompiledView) -> int:
    return view_output_bytes(view.schema.types, view.plan, view.capacity)


def _per_chip(bytes_: int, axis: str, chips: int) -> int:
    if axis == AXIS_DATA and chips > 1:
        return int(math.ceil(bytes_ / chips))
    return int(bytes_)


@dataclass
class _EnvEntry:
    """One table visible to pipeline views: its schema, row capacity,
    planned axis and gatherable byte size."""

    schema: ViewSchema
    rows: int
    axis: str
    gather_bytes: int  # bytes an all-gather of this table moves


def _infer_plan(
    bundle: FlowDevicePlan, chips: int,
) -> Tuple[List[MeshStage], Dict[str, _EnvEntry]]:
    """Walk raw -> projections -> rings/windows -> state/refdata ->
    transform views, assigning each stage an axis and collecting the
    reshard edges the layout forces."""
    stages: List[MeshStage] = []
    env: Dict[str, _EnvEntry] = {}

    # raw ingest + per-source projection chains: rows shard end to end
    for source, views in bundle.projection_views.items():
        raw_schema, cap = bundle.raw_schemas[source]
        raw_bytes = table_bytes(raw_schema.types, cap)
        stages.append(MeshStage(
            name=f"input:{source}", kind="input", axis=AXIS_DATA,
            scaling=SCALE_SHARDED, rows=cap, hbm_bytes=raw_bytes,
            per_chip_bytes=_per_chip(raw_bytes, AXIS_DATA, chips),
            detail="raw ingest batch (rows shard on arrival)",
        ))
        for v in views:
            b = _view_model_bytes(v)
            stages.append(MeshStage(
                name=v.name, kind="project", axis=AXIS_DATA,
                scaling=SCALE_SHARDED, rows=v.capacity, hbm_bytes=b,
                per_chip_bytes=_per_chip(b, AXIS_DATA, chips),
                detail="projection (elementwise, stays sharded)",
            ))
        target = bundle.target_of[source]
        schema = bundle.target_schemas[target]
        env[target] = _EnvEntry(
            schema, bundle.target_caps[target], AXIS_DATA,
            table_bytes(schema.types, bundle.target_caps[target]),
        )

    # window rings shard their capacity dim; the flattened window view
    # the pipeline reads inherits the data axis
    for table, slots in bundle.ring_slots.items():
        rows = slots * bundle.target_caps[table]
        schema = bundle.target_schemas[table]
        b = table_bytes(schema.types, rows)
        stages.append(MeshStage(
            name=f"ring:{table}", kind="ring", axis=AXIS_DATA,
            scaling=SCALE_SHARDED, rows=rows, hbm_bytes=b,
            per_chip_bytes=_per_chip(b, AXIS_DATA, chips),
            detail=f"{slots} slots x {bundle.target_caps[table]} rows, "
                   "capacity dim sharded",
        ))
    for wname, (table, dur_s) in bundle.windows.items():
        rows = bundle.ring_slots[table] * bundle.target_caps[table]
        schema = bundle.target_schemas[table]
        b = table_bytes(schema.types, rows)
        env[wname] = _EnvEntry(schema, rows, AXIS_DATA, b)
        stages.append(MeshStage(
            name=wname, kind="window", axis=AXIS_DATA,
            scaling=SCALE_SHARDED, rows=rows, hbm_bytes=b,
            per_chip_bytes=_per_chip(b, AXIS_DATA, chips),
            detail=f"{dur_s:g}s window over {table} (sharded with the ring)",
        ))

    # state/refdata replicate (broadcast-join sides)
    for sname, (schema, cap) in bundle.state.items():
        b = table_bytes(schema.types, cap)
        env[sname] = _EnvEntry(schema, cap, AXIS_REPLICATED, b)
        stages.append(MeshStage(
            name=f"state:{sname}", kind="state", axis=AXIS_REPLICATED,
            scaling=SCALE_REPLICATED, rows=cap, hbm_bytes=b,
            per_chip_bytes=b,
            detail="accumulation table (replicated)",
        ))
    for rname, (schema, cap) in bundle.refdata.items():
        b = table_bytes(schema.types, cap)
        env[rname] = _EnvEntry(schema, cap, AXIS_REPLICATED, b)
        stages.append(MeshStage(
            name=f"refdata:{rname}", kind="refdata", axis=AXIS_REPLICATED,
            scaling=SCALE_REPLICATED, rows=cap, hbm_bytes=b,
            per_chip_bytes=b,
            detail="reference data (replicated)",
        ))

    # transform views
    for view in bundle.pipeline.views:
        p = view.plan
        kind = p.kind if p is not None else "project"
        sources = [s for s in (p.sources if p else ()) if s in env]
        collective = is_collective_view(view)
        if collective:
            axis, scaling = AXIS_REPLICATED, SCALE_COLLECTIVE
            if _replication_origin(view):
                # a global sort over the raw scope or a kernel UDF has no
                # sharded form: the stage runs whole on every chip
                # regardless of N (a grouped ORDER BY only sorts the
                # G-row group output — that stays collective)
                scaling = SCALE_REPLICATED
        elif sources and all(env[s].axis == AXIS_DATA for s in sources):
            axis, scaling = AXIS_DATA, SCALE_SHARDED
        else:
            # elementwise over replicated input(s): runs replicated
            axis, scaling = AXIS_REPLICATED, SCALE_REPLICATED
        edges = []
        if collective:
            for s in sources:
                if env[s].axis == AXIS_DATA:
                    edges.append(ReshardEdge(
                        s, env[s].gather_bytes,
                        allgather_wire_bytes(env[s].gather_bytes, chips),
                    ))
        b = _view_model_bytes(view)
        details = []
        if p is not None and p.grouped:
            details.append(f"group G<={p.groups_bound}")
        for site in (p.joins if p else ()):
            details.append(
                f"{site.algorithm}-join F<={site.out_rows} vs "
                f"{site.right_table}"
            )
        if p is not None and (p.order_keys or view.host_order):
            details.append("global sort")
        if edges:
            details.append(
                "gathers " + ", ".join(e.table for e in edges)
            )
        stage = MeshStage(
            name=view.name, kind=kind, axis=axis, scaling=scaling,
            rows=view.capacity, hbm_bytes=b,
            per_chip_bytes=_per_chip(b, axis, chips),
            reshards=edges, detail="; ".join(details),
        )
        # sharded OUTPUT views gather at the step boundary: the step
        # takes every output whole before the host reads it
        if view.name in bundle.output_datasets and axis == AXIS_DATA:
            stage.reshards.append(ReshardEdge(
                f"{view.name}{OUTPUT_BOUNDARY}", b,
                allgather_wire_bytes(b, chips),
            ))
            if not stage.detail:
                stage.detail = "sharded output: gathered at step boundary"
        stages.append(stage)
        env[view.name] = _EnvEntry(view.schema, view.capacity, axis, b)
    return stages, env


# ---------------------------------------------------------------------------
# Census cross-check: the model must equal what the mesh step gathers
# ---------------------------------------------------------------------------
def _run_mesh_step(
    bundle: FlowDevicePlan, shards: int, device: torch.device,
) -> MeshCollectives:
    """One batch of the flow's schema at its capacities (zero-filled
    tables; shapes only on ``meta``) through the flow's mesh step over
    ``shards`` virtual shards of ``device``: the census it records."""
    from ..runtime.processor import build_mesh_step_fn
    from ..runtime.timewindow import ShardedWindowBuffers, make_buffers

    mesh = make_mesh(shards, devices=(device,) * shards)
    targets = list(bundle.target_of.values())
    step = build_mesh_step_fn(
        mesh,
        ts_col=bundle.ts_col,
        windows=dict(bundle.windows),
        output_datasets=list(bundle.output_datasets),
        state_names=list(bundle.state),
        refdata_names=sorted(bundle.refdata),
        ring_tables=list(bundle.ring_slots),
        pipeline=bundle.pipeline,
        source_targets=list(bundle.target_of.items()),
        proj_views=dict(bundle.projection_views),
        primary_target=(
            bundle.target_of.get("default") or (targets[0] if targets else "")
        ),
    )
    raw = {
        source: _table(schema, cap, device)
        for source, (schema, cap) in bundle.raw_schemas.items()
    }
    rings = {}
    for table, slots in bundle.ring_slots.items():
        cap = bundle.target_caps[table]
        if cap % shards:
            raise ValueError(
                f"ring {table}: capacity {cap} does not divide over "
                f"{shards} shards"
            )
        rings[table] = ShardedWindowBuffers([
            make_buffers(bundle.target_schemas[table], cap // shards,
                         slots, device)
            for _ in range(shards)
        ])
    state = {n: _table(sch, cap, device) for n, (sch, cap) in bundle.state.items()}
    refdata = {
        n: _table(sch, cap, device) for n, (sch, cap) in bundle.refdata.items()
    }
    scalar = torch.zeros((), dtype=torch.int32, device=device)
    census = MeshCollectives()
    step(raw, rings, state, refdata, scalar, scalar, 1, 1000,
         _aux_on(bundle.aux_tables, device), census)
    return census


def _cross_check(
    bundle: FlowDevicePlan,
    stages: List[MeshStage],
    chips: int,
    device: torch.device,
    diags: List[Diagnostic],
) -> CensusCheck:
    """Run the flow's mesh step once over M = min(chips, 8) virtual
    shards of ``device`` and hold its census against the model, table by
    table: each table the model gathers must be gathered once, with
    exactly the result bytes of every reshard edge of that table, and
    the only other collective allowed is the one all-reduce of the
    counts vector. The step shares one gather of a table among every
    stage that reads it, so a table that the model gathers at several
    stage boundaries (DX701) is one gather in the census: the repeat is
    the model's price, not the step's. Anything else is DX790: the model
    may never silently drift from what the mesh step does."""
    shards = max(1, min(chips, MAX_CHECK_SHARDS))
    check = CensusCheck(device=str(device), shards=shards)
    t0 = time.perf_counter()
    try:
        census = _run_mesh_step(bundle, shards, device)
    except Exception as e:  # noqa: BLE001 — a step that raises is a finding
        check.ms = (time.perf_counter() - t0) * 1000.0
        diags.append(make(
            "DX790", "",
            f"the mesh step of the partition plan raised on {shards} "
            f"virtual shards of {device}: {e}",
        ))
        return check
    check.ms = (time.perf_counter() - t0) * 1000.0
    check.census = census.to_dict()

    gathers: Dict[str, List[int]] = defaultdict(list)
    reduced = False
    for op, table, nbytes in census.log:
        if op == "all-gather":
            gathers[table].append(nbytes)
        elif op == "all-reduce" and table == COUNTS_TABLE and not reduced:
            reduced = True
            check.all_reduce_bytes = nbytes
        else:
            diags.append(make(
                "DX790", table,
                f"the mesh step ran a {op} of {table or 'an unnamed value'} "
                f"({nbytes} result bytes), which the model does not price: "
                f"it allows all-gathers on its reshard edges and one "
                f"all-reduce of the counts vector",
            ))
    if shards > 1 and not reduced:
        diags.append(make(
            "DX790", "",
            "the mesh step ran no all-reduce of the counts vector on "
            f"{shards} shards",
        ))

    modeled = {e.source for s in stages for e in s.reshards}
    for table, got in sorted(gathers.items()):
        if table not in modeled:
            diags.append(make(
                "DX790", table,
                f"the mesh step gathered {table} ({got[0]} result bytes), "
                f"an all-gather the partition plan lacks",
            ))
        elif len(got) > 1:
            diags.append(make(
                "DX790", table,
                f"the mesh step gathered {table} {len(got)} times; it "
                f"shares one gather of a table among its consumers",
            ))

    for stage in stages:
        total = 0
        for edge in stage.reshards:
            got = gathers.get(edge.source)
            check.edges.append({
                "stage": stage.name, "table": edge.table,
                "modelBytes": edge.result_bytes,
                "censusBytes": got[0] if got else None,
            })
            if not got:
                if shards > 1:
                    diags.append(make(
                        "DX790", stage.name,
                        f"sharding model mismatch: the plan gathers "
                        f"{edge.table} ({edge.result_bytes} result bytes) "
                        f"but the mesh step made no such all-gather",
                    ))
                continue
            if got[0] != edge.result_bytes:
                diags.append(make(
                    "DX790", stage.name,
                    f"sharding model mismatch on the {edge.table} reshard: "
                    f"closed form says {edge.result_bytes} all-gather "
                    f"result bytes, the mesh step gathered {got[0]} — the "
                    f"byte model must match the step exactly",
                ))
            total += got[0]
        stage.lowered_bytes = total
    return check


# ---------------------------------------------------------------------------
# DX7xx lints over the partition plan
# ---------------------------------------------------------------------------
def _lint(
    bundle: FlowDevicePlan,
    stages: List[MeshStage],
    chips: int,
    spec: FleetSpec,
    jobconf: Dict[str, object],
    diags: List[Diagnostic],
) -> None:
    batch_scale = max(bundle.target_caps.values(), default=0)

    # DX700: structurally unshardable stages (global sorts over the raw
    # scope, kernel UDF calls) replicate everything regardless of N (a
    # grouped ORDER BY only sorts the G-row output)
    for view in bundle.pipeline.views:
        p = view.plan
        origin = _replication_origin(view)
        if origin:
            rows = p.input_rows if p is not None else view.capacity
            diags.append(make(
                "DX700", view.name,
                f"unshardable stage forces full replication: the "
                f"{origin} materializes all {rows} input rows on every "
                f"chip at any chip count — this stage cannot shard",
            ))

    # DX701: the same sharded table gathered at 2+ stage boundaries
    gathers: Dict[str, List[str]] = {}
    for s in stages:
        for e in s.reshards:
            if not e.table.endswith(OUTPUT_BOUNDARY):
                gathers.setdefault(e.table, []).append(s.name)
    for table, consumers in sorted(gathers.items()):
        if len(consumers) > 1:
            diags.append(make(
                "DX701", table,
                f"resharding between adjacent stages: {table} is "
                f"gathered onto every chip at {len(consumers)} stage "
                f"boundaries ({', '.join(consumers)}) — each pays the "
                f"all-gather again; fold the consumers or share a "
                f"gathered intermediate",
            ))

    # DX702: per-chip residency vs chip memory at the requested N
    per_chip = sum(s.per_chip_bytes for s in stages)
    budget = spec.hbm_per_chip_bytes * spec.headroom_fraction
    if per_chip > budget:
        diags.append(make(
            "DX702", "",
            f"per-chip shard exceeds chip HBM at {chips} chips: "
            f"{per_chip} bytes resident per chip (sharded shards + "
            f"replicated tables) vs the {spec.hbm_per_chip_bytes}-byte "
            f"chip at {spec.headroom_fraction:.0%} headroom "
            f"({int(budget)} usable)",
        ))

    # DX703: ICI wire demand vs the fleet-spec interconnect budget
    wire = sum(s.ici_wire_bytes for s in stages)
    interval = bundle.interval_s or 1.0
    ici_budget = spec.ici_bytes_per_sec_per_chip * chips * interval
    if wire > ici_budget:
        diags.append(make(
            "DX703", "",
            f"predicted ICI traffic {wire:.0f} bytes/batch exceeds the "
            f"fleet-spec budget ({spec.ici_bytes_per_sec_per_chip:.0f} "
            f"B/s/chip x {chips} chips x {interval:g}s interval = "
            f"{ici_budget:.0f}) — collectives will dominate the step",
        ))

    # DX704: stages flat or worse in N (replicated compute at batch
    # scale: doubling the chips doubles the fleet's work, not the
    # speed). Only replication ORIGINS fire — a stage that merely
    # inherits a replicated input is the origin's symptom, not a second
    # finding.
    origins = {
        v.name for v in bundle.pipeline.views if _replication_origin(v)
    }
    for s in stages:
        if (
            s.scaling == SCALE_REPLICATED
            and s.name in origins
            and batch_scale
            and s.rows >= batch_scale
        ):
            diags.append(make(
                "DX704", s.name,
                f"scaling cliff: stage runs replicated over {s.rows} "
                f"rows on every chip — its modeled per-chip cost is "
                f"flat in the chip count, so the flow stops scaling "
                f"here (first {chips}-chip victim)",
            ))

    # DX705: single-card transfer optimizations silently off under mesh
    def _off(key: str) -> bool:
        return str(jobconf.get(key, "")).lower() == "false"

    if (
        chips > 1
        and bundle.output_datasets
        and not (_off("jobSizedTransfer") and _off("jobOutputSlots"))
    ):
        diags.append(make(
            "DX705", "",
            f"sized output transfer and donated output slots "
            f"auto-disable under a {chips}-chip mesh: every batch "
            f"fetches the full padded capacity of "
            f"{sorted(bundle.output_datasets)} and the background "
            f"double-buffered landing path does not apply — the "
            f"single-card transfer optimizations do not compound here yet",
        ))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def _analyze(
    bundle: Optional[FlowDevicePlan],
    diags: List[Diagnostic],
    name: str,
    chips: int,
    spec: Optional[FleetSpec],
    jobconf: Dict[str, object],
    lower: Optional[bool],
    device: "torch.device | str",
) -> MeshPlanReport:
    if bundle is None:
        return MeshPlanReport(name, chips, [], _ordered(diags))
    dev = torch.device(device)
    spec = spec or FleetSpec(chips=chips)
    try:
        stages, _env = _infer_plan(bundle, chips)
    except Exception as e:  # noqa: BLE001 — plan inference blowup is a finding
        diags.append(make("DX790", "", f"partition-plan inference failed: {e}"))
        return MeshPlanReport(bundle.name, chips, [], _ordered(diags))
    _lint(bundle, stages, chips, spec, jobconf, diags)

    check = None
    if lower is not False:
        check = _cross_check(bundle, stages, chips, dev, diags)
    return MeshPlanReport(
        bundle.name, chips, stages, _ordered(diags),
        validated=check is not None, cross_check=check,
    )


def _resolve_chips(chips: Optional[int], jobconf: Dict[str, object]) -> int:
    if chips is not None:
        return chips
    return (
        _jobconf_int(jobconf, "jobNumChips", "jobNumExecutors")
        or DEFAULT_MESH_CHIPS
    )


def analyze_flow_mesh(
    flow: dict,
    chips: Optional[int] = None,
    spec: Optional[FleetSpec] = None,
    lower: Optional[bool] = None,
    device: "torch.device | str" = "meta",
) -> MeshPlanReport:
    """Mesh-sharding analysis of a flow config (gui JSON or full flow
    document). Compiles with the production planner, infers the
    partition plan, prices the collectives, and (unless ``lower=False``,
    the fast model-only path config generation uses) cross-checks the
    byte model against the census of the flow's mesh step run once over
    virtual shards of ``device`` (``meta`` by default: shapes only).
    DX702/DX703 judge the plan against ``spec``, by default the
    machine's cards (raises without one)."""
    gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
    jobconf = ((gui.get("process") or {}).get("jobconfig") or {})
    n_chips = _resolve_chips(chips, jobconf)
    diags: List[Diagnostic] = []
    plan_diags: List[Diagnostic] = []
    bundle = _plan_from_gui(gui, plan_diags, n_chips)
    # the bundle builder reports in DX2xx; re-code for this tier
    for d in plan_diags:
        code = "DX790" if d.code == "DX290" else "DX791"
        diags.append(make(code, d.table, d.message, d.span))
    return _analyze(
        bundle, diags, gui.get("name") or "", n_chips, spec, jobconf, lower,
        device,
    )


def analyze_processor_mesh(
    proc,
    chips: Optional[int] = None,
    spec: Optional[FleetSpec] = None,
    lower: Optional[bool] = None,
    device: "torch.device | str" = "meta",
) -> MeshPlanReport:
    """Mesh-sharding analysis of an already-built ``FlowProcessor``: the
    exact compiled views its (possibly mesh-sharded) step runs,
    mirroring ``deviceplan.analyze_processor``. ``chips`` defaults to
    the size of the processor's mesh."""
    diags: List[Diagnostic] = []
    n_chips = chips or (proc.mesh.size if proc.mesh is not None else None)
    bundle = flow_plan_from_processor(proc, n_chips)
    n_chips = n_chips or DEFAULT_MESH_CHIPS
    return _analyze(
        bundle, diags, bundle.name, n_chips, spec, {}, lower, device,
    )
