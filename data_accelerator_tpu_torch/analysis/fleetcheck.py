"""Fleet analyzer: whole-fleet placement + cross-flow interference.

Fourth analysis tier (the ``--fleet`` tier). The first three tiers each
judge ONE flow; this one judges a *set* of flows against a *fleet spec*
(chips, HBM per chip, ICI topology) and answers the question ROADMAP
item 2(b) asks: can these flows share the fleet, and where does each
one go? The reference platform's cluster clients (Livy/Databricks,
SURVEY §1 L3) deployed blind and discovered oversubscription by
watching jobs die; we have a cost model that is asserted byte-exact
against the XLA lowering (``costmodel.py`` + the tier-1 drift test), so
placement is computed *before* anything spawns.

Two lint families plus a concrete placement plan:

- **capacity (DX400-403)** — first-fit-decreasing bin-packing of each
  flow's DX2xx HBM total onto the fleet's chips. The per-flow numbers
  are CONSUMED from ``analyze_flow_device`` (``DevicePlanReport
  .totals()``), never re-derived, so the fleet tier inherits the byte
  exactness the drift test proves: a chip's packed total is exactly the
  sum of the arrays its flows' batches materialize.
- **interference (DX410-413)** — collisions no single-flow tier can
  see: shared checkpoint/state/output directories, Kafka/EventHub
  consumer-group collisions on overlapping topics, metric-series key
  collisions in the shared store (``constants.MetricName``), and
  observability-port conflicts between co-placed flows.

The placement plan doubles as a runtime input: ``serve/jobs.py``'s
``FleetAdmissionGate`` runs this analyzer at job submission (DX400/401/
410/411 reject the submit before a process spawns) and
``serve/scheduler.py``'s ``PlacementReplanner`` re-runs it on job
stop/start so freed capacity is reusable.

Placement model (documented in ANALYSIS.md "Placement model"): each
flow is a single-chip tenant — the many-small-flows multi-tenancy case
— packed by modeled HBM under first-fit-decreasing; flows declaring a
multi-chip mesh (``jobNumChips``) still place whole but contribute
their ICI demand at the declared chip count.

Copy of the JAX package's ``analysis/fleetcheck.py`` over the port's
device plan, with the fleet described by the machine the port runs on:

- The default spec is the cards present (one on the CPU), each with the
  memory of its device: a card's total memory
  (``torch.cuda.get_device_properties``), or
  ``constants.CPU_DEVICE_MEMORY_BYTES`` on the CPU, as
  ``costmodel.warm_kernel_cache_budget_bytes`` reads it. The modeled
  link budgets are an H100 SXM's published rates (PCIe Gen5 x16 to the
  host, NVLink 4 between cards). No TPU number stays.
- Footprints come from the port's plan (``hbmBytes`` of config 1 is
  144,388,096 against the JAX plan's 133,902,336), so the two tiers
  agree on placement only when fed the same footprints.
- A flow that declares more than one card is priced at its chip count,
  as in the reference (``analyze_flow_device(flow, chips=N)``).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

import torch

from ..constants import CPU_DEVICE_MEMORY_BYTES, MetricName
from .diagnostics import REPORT_SCHEMA_VERSION, Diagnostic, make

# ---------------------------------------------------------------------------
# Fleet spec
# ---------------------------------------------------------------------------
# DX402 fires when a chip's packed HBM exceeds this fraction of its
# capacity: the remaining slack is the retrace/dictionary-growth margin
DEFAULT_HEADROOM_FRACTION = 0.8

# modeled per-card bandwidth budgets for the DX403 aggregate-demand
# lint: an H100 SXM's published PCIe Gen5 x16 rate to the host (64 GB/s
# a direction) and NVLink 4 rate to its peers (450 GB/s a direction).
# Both are spec fields; override them to model other hardware.
DEFAULT_D2H_BYTES_PER_SEC = 64_000_000_000
DEFAULT_ICI_BYTES_PER_SEC = 450_000_000_000

DEFAULT_ICI_TOPOLOGY = "nvlink"


def device_memory_bytes(device: "torch.device | str" = "cuda") -> int:
    """The memory of one device of ``device``'s kind: a card's total
    memory, ``CPU_DEVICE_MEMORY_BYTES`` on the CPU. Raises when
    ``device`` is a card and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"fleet spec for {str(dev)!r}: no CUDA device is present"
            )
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return CPU_DEVICE_MEMORY_BYTES


def device_count(device: "torch.device | str" = "cuda") -> int:
    """The devices of ``device``'s kind this machine has (1 on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        device_memory_bytes(dev)
        return torch.cuda.device_count()
    return 1


@dataclass
class FleetSpec:
    """What the fleet *is*: chip count, HBM per chip, topology and the
    modeled bandwidth budgets. ``--fleet-spec=<file.json>`` / the REST
    ``fleetSpec`` body use the camelCase keys of ``to_dict``."""

    chips: Optional[int] = None
    hbm_per_chip_bytes: Optional[int] = None
    headroom_fraction: float = DEFAULT_HEADROOM_FRACTION
    d2h_bytes_per_sec_per_chip: float = DEFAULT_D2H_BYTES_PER_SEC
    ici_bytes_per_sec_per_chip: float = DEFAULT_ICI_BYTES_PER_SEC
    ici_topology: str = DEFAULT_ICI_TOPOLOGY
    # whose devices an unset chip count and chip memory describe
    device: str = "cuda"

    def __post_init__(self):
        if self.chips is None:
            self.chips = device_count(self.device)
        if self.hbm_per_chip_bytes is None:
            self.hbm_per_chip_bytes = device_memory_bytes(self.device)

    @classmethod
    def from_dict(cls, d: dict, device: str = "cuda") -> "FleetSpec":
        """A spec from its camelCase keys; what they leave unset comes
        from ``device``'s machine."""
        spec = cls(chips=1, hbm_per_chip_bytes=0, device=device)
        if d.get("chips") is None:
            spec.chips = device_count(device)
        if d.get("hbmPerChipBytes") is None:
            spec.hbm_per_chip_bytes = device_memory_bytes(device)
        # the chips key funnels through the one shared chip-count
        # parser every surface uses (analysis/chipcount.py) — a typed
        # ChipCountError (a ValueError) on non-positive/non-integer N
        from .chipcount import parse_chip_count

        chips = parse_chip_count(d.get("chips"), "fleet spec 'chips'")
        if chips is not None:
            spec.chips = chips
        mapping = {
            "hbmPerChipBytes": ("hbm_per_chip_bytes", int),
            "headroomFraction": ("headroom_fraction", float),
            "d2hBytesPerSecPerChip": ("d2h_bytes_per_sec_per_chip", float),
            "iciBytesPerSecPerChip": ("ici_bytes_per_sec_per_chip", float),
            "iciTopology": ("ici_topology", str),
        }
        for key, (attr, conv) in mapping.items():
            if d.get(key) is not None:
                setattr(spec, attr, conv(d[key]))
        return spec

    def to_dict(self) -> dict:
        return {
            "chips": self.chips,
            "hbmPerChipBytes": self.hbm_per_chip_bytes,
            "headroomFraction": self.headroom_fraction,
            "d2hBytesPerSecPerChip": self.d2h_bytes_per_sec_per_chip,
            "iciBytesPerSecPerChip": self.ici_bytes_per_sec_per_chip,
            "iciTopology": self.ici_topology,
        }


# ---------------------------------------------------------------------------
# Per-flow footprint: DX2xx totals + statically extracted resources
# ---------------------------------------------------------------------------
@dataclass
class FlowFootprint:
    """One flow's placement-relevant surface: the DX2xx cost-model
    totals (consumed, not re-derived) plus the shared-resource claims
    the interference lints compare. ``hbm_bytes`` is ``None`` when the
    device tier could not analyze the flow (its diagnostics ride along
    and the flow is excluded from packing)."""

    name: str
    hbm_bytes: Optional[int] = None
    persistent_bytes: int = 0
    per_batch_bytes: int = 0
    flops: float = 0.0
    d2h_bytes_per_batch: int = 0
    ici_bytes_per_batch: float = 0.0
    interval_s: float = 1.0
    chips_required: int = 1
    # interference resources
    dirs: Set[str] = field(default_factory=set)  # checkpoint/state/sink
    consumer_keys: Set[Tuple[str, ...]] = field(default_factory=set)
    metric_series: Set[str] = field(default_factory=set)
    obs_port: Optional[int] = None
    diagnostics: List[Diagnostic] = field(default_factory=list)

    @property
    def placeable(self) -> bool:
        return self.hbm_bytes is not None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "hbmBytes": self.hbm_bytes,
            "persistentBytes": self.persistent_bytes,
            "perBatchBytes": self.per_batch_bytes,
            "flops": round(self.flops, 1),
            "d2hBytesPerBatch": self.d2h_bytes_per_batch,
            "iciBytesPerBatch": round(self.ici_bytes_per_batch, 1),
            "intervalSeconds": self.interval_s,
            "chipsRequired": self.chips_required,
        }


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


_OUTPUT_RE = re.compile(
    r"^\s*OUTPUT\s+([A-Za-z0-9_,\s]+?)\s+TO\s+([A-Za-z0-9_]+)\s*;?\s*$",
    re.IGNORECASE | re.MULTILINE,
)


def _prop(props: dict, *names: str):
    """Case-insensitive property lookup (designer props are camelCase,
    pass-through conf keys are lowercased)."""
    lowered = {str(k).lower(): v for k, v in (props or {}).items()}
    for n in names:
        v = lowered.get(n.lower())
        if v not in (None, "", [], {}):
            return v
    return None


def flow_resources(gui: dict, footprint: FlowFootprint) -> None:
    """Statically extract the flow's shared-resource claims from its
    config — pure dict walking, no compilation. Populates ``dirs``,
    ``consumer_keys``, ``metric_series`` and ``obs_port``."""
    name = footprint.name
    inp = gui.get("input") or {}
    iprops = inp.get("properties") or {}
    proc = gui.get("process") or {}
    jobconf = proc.get("jobconfig") or {}

    # -- checkpoint/state/output directories -----------------------------
    # the generated defaults are flow-name-keyed (serve/generation.py
    # writes <runtime>/<name>/checkpoints etc.), so the derived claim is
    # the name-relative path: two same-named flows collide on it, and
    # explicit overrides collide on their literal value
    footprint.dirs.add(f"{name}/checkpoints")
    explicit = _prop(iprops, "checkpointDir", "eventhub.checkpointdir")
    if explicit:
        footprint.dirs.add(str(explicit))
    sources = inp.get("sources") or []
    for src in sources:
        sprops = src.get("properties") or {}
        sdir = _prop(sprops, "checkpointDir", "eventhub.checkpointdir")
        if sdir:
            footprint.dirs.add(str(sdir))
    for out in gui.get("outputs") or []:
        otype = (out.get("type") or "").lower()
        if otype in ("blob", "file", "local"):
            folder = _prop(out.get("properties") or {}, "folder", "path")
            if folder:
                footprint.dirs.add(str(folder))

    # -- Kafka / EventHub consumer identity ------------------------------
    # runtime/sources.py defaults kafka's group id to the literal
    # "dxtpu" for the default source — SHARED across flows — so two
    # flows on the same topics without an explicit groupid genuinely
    # split records between them
    def consumer_key(stype: str, props: dict, source: str):
        stype = (stype or "local").lower()
        if stype == "kafka":
            topics = str(_prop(props, "kafka.topics", "topics") or "")
            group = str(
                _prop(props, "kafka.groupid", "consumerGroup", "groupid")
                or ("dxtpu" if source == "default" else f"{source}.dxtpu")
            )
            for t in topics.split(";"):
                if t.strip():
                    footprint.consumer_keys.add(("kafka", group, t.strip()))
        elif stype in ("eventhub", "iothub"):
            conn = str(_prop(props, "inputEventhubConnection",
                             "connection") or "")
            group = str(_prop(props, "consumerGroup") or name)
            if conn:
                footprint.consumer_keys.add(("eventhub", conn, group))

    consumer_key(inp.get("type"), iprops, "default")
    for src in sources:
        consumer_key(src.get("type"),
                     src.get("properties") or {},
                     src.get("id") or src.get("name") or "")

    # -- metric series in the shared store -------------------------------
    # every engine series lives under the DATAX-<job> app key, and the
    # job name derives from the flow name (flowbuilder jobCommonTokens
    # jobName=_S_{name}); metric-sink tables add <app>:<table> series
    app = MetricName.metric_app_name(name)
    footprint.metric_series.add(f"{app}:{MetricName.LatencyPrefix}Batch")
    metric_sinks = {
        out.get("id") for out in gui.get("outputs") or []
        if (out.get("type") or "").lower() == "metric"
    }
    queries = (proc.get("queries") or [])
    script = "\n".join(q if isinstance(q, str) else str(q) for q in queries)
    for m in _OUTPUT_RE.finditer(script):
        tables, sink = m.group(1), m.group(2)
        if sink in metric_sinks or sink.lower() == "metrics":
            for t in tables.split(","):
                if t.strip():
                    footprint.metric_series.add(f"{app}:{t.strip()}")

    # -- observability port ----------------------------------------------
    port = _jobconf_int(jobconf, "jobObservabilityPort",
                        "observabilityPort")
    if port:  # 0/unset = ephemeral, never conflicts
        footprint.obs_port = port


def flow_footprint(flow: dict, name: Optional[str] = None) -> FlowFootprint:
    """Build one flow's fleet footprint by CONSUMING the DX2xx device
    tier (``analyze_flow_device`` at the flow's declared chip count,
    default 1 — the single-chip-tenant placement model). The HBM number
    is ``DevicePlanReport.totals()['hbmBytes']`` verbatim: the fleet
    tier never re-derives bytes, so it stays byte-exact with the
    lowering by construction."""
    from .deviceplan import analyze_flow_device

    gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
    fname = name or gui.get("name") or ""
    jobconf = (gui.get("process") or {}).get("jobconfig") or {}
    chips_req = _jobconf_int(jobconf, "jobNumChips", "jobNumExecutors") or 1
    fp = FlowFootprint(name=fname, chips_required=chips_req)
    try:
        fp.interval_s = float(
            _prop((gui.get("input") or {}).get("properties") or {},
                  "windowDuration", "intervalInSeconds") or 1
        )
    except (TypeError, ValueError):
        fp.interval_s = 1.0
    flow_resources(gui, fp)

    device = analyze_flow_device(flow, chips=chips_req)
    if device.stages and device.ok:
        totals = device.totals()
        fp.hbm_bytes = int(totals["hbmBytes"])
        fp.persistent_bytes = int(totals["persistentBytes"])
        fp.per_batch_bytes = int(totals["perBatchBytes"])
        fp.flops = float(totals["flops"])
        fp.d2h_bytes_per_batch = int(totals["d2hBytesPerBatch"])
        fp.ici_bytes_per_batch = float(totals["iciBytesPerBatch"])
    # carry the device tier's findings (DX290 errors / DX291 warnings)
    # so a footprint-less flow explains itself in the fleet report
    fp.diagnostics = [
        Diagnostic(d.code, d.severity, fname or d.table, d.message, d.span)
        for d in device.diagnostics
        if d.code in ("DX290", "DX291")
    ]
    return fp


# ---------------------------------------------------------------------------
# Placement: first-fit-decreasing bin-packing by modeled HBM
# ---------------------------------------------------------------------------
@dataclass
class ChipAssignment:
    chip: int
    flows: List[str] = field(default_factory=list)
    hbm_bytes: int = 0

    def utilization(self, spec: FleetSpec) -> float:
        return self.hbm_bytes / spec.hbm_per_chip_bytes

    def to_dict(self, spec: FleetSpec) -> dict:
        util = self.utilization(spec)
        return {
            "chip": self.chip,
            "flows": list(self.flows),
            "hbmBytes": self.hbm_bytes,
            "hbmCapacityBytes": spec.hbm_per_chip_bytes,
            "utilization": round(util, 6),
            "headroom": round(1.0 - util, 6),
        }


@dataclass
class PlacementPlan:
    chips: List[ChipAssignment]
    unplaced: List[str] = field(default_factory=list)  # fit nowhere (DX400)
    oversized: List[str] = field(default_factory=list)  # exceed any chip (DX401)
    unanalyzed: List[str] = field(default_factory=list)  # no footprint (DX29x)

    @property
    def feasible(self) -> bool:
        return not self.unplaced and not self.oversized

    def chip_of(self, flow: str) -> Optional[int]:
        for c in self.chips:
            if flow in c.flows:
                return c.chip
        return None

    def to_dict(self, spec: FleetSpec) -> dict:
        return {
            "feasible": self.feasible,
            "chips": [c.to_dict(spec) for c in self.chips if c.flows],
            "unplaced": list(self.unplaced),
            "oversized": list(self.oversized),
            "unanalyzed": list(self.unanalyzed),
        }


def pack_fleet(
    footprints: Sequence[FlowFootprint], spec: FleetSpec
) -> PlacementPlan:
    """First-fit-decreasing by modeled HBM: sort flows largest-first,
    place each on the first chip whose packed total stays within
    capacity. FFD is the classic 11/9·OPT bin-packing heuristic —
    deterministic (ties broken by flow name), so a re-plan over the
    same set reproduces the same assignment."""
    plan = PlacementPlan(
        chips=[ChipAssignment(chip=i) for i in range(spec.chips)]
    )
    placeable: List[FlowFootprint] = []
    for fp in footprints:
        if not fp.placeable:
            plan.unanalyzed.append(fp.name)
        elif fp.hbm_bytes > spec.hbm_per_chip_bytes:
            plan.oversized.append(fp.name)
        else:
            placeable.append(fp)
    for fp in sorted(placeable, key=lambda f: (-f.hbm_bytes, f.name)):
        for chip in plan.chips:
            if chip.hbm_bytes + fp.hbm_bytes <= spec.hbm_per_chip_bytes:
                chip.flows.append(fp.name)
                chip.hbm_bytes += fp.hbm_bytes
                break
        else:
            plan.unplaced.append(fp.name)
    return plan


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------
def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GB"


@dataclass
class FleetReport:
    spec: FleetSpec
    footprints: List[FlowFootprint]
    placement: PlacementPlan
    diagnostics: List[Diagnostic]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]

    @property
    def ok(self) -> bool:
        return not self.errors

    def fleet_dict(self) -> dict:
        """The placement portion (no diagnostics) — what the designer
        renders as the placement table and what job records persist."""
        return {
            "spec": self.spec.to_dict(),
            "flows": [fp.to_dict() for fp in self.footprints],
            "placement": self.placement.to_dict(self.spec),
        }

    def to_dict(self) -> dict:
        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "fleet": self.fleet_dict(),
        }


def _ordered(diags: List[Diagnostic]) -> List[Diagnostic]:
    return sorted(
        diags,
        key=lambda d: (d.severity != "error", d.code, d.table, d.message),
    )


# ---------------------------------------------------------------------------
# Lints
# ---------------------------------------------------------------------------
def _capacity_lints(
    footprints: Sequence[FlowFootprint],
    plan: PlacementPlan,
    spec: FleetSpec,
    diags: List[Diagnostic],
) -> None:
    by_name = {fp.name: fp for fp in footprints}
    for name in plan.oversized:
        fp = by_name[name]
        diags.append(make(
            "DX401", name,
            f"modeled HBM footprint {_fmt_bytes(fp.hbm_bytes)} exceeds "
            f"every chip's capacity "
            f"{_fmt_bytes(spec.hbm_per_chip_bytes)}: the flow can never "
            f"place on this fleet",
        ))
    for name in plan.unplaced:
        fp = by_name[name]
        diags.append(make(
            "DX400", name,
            f"no feasible placement: {_fmt_bytes(fp.hbm_bytes)} does not "
            f"fit on any of the {spec.chips} chip(s) "
            f"({_fmt_bytes(spec.hbm_per_chip_bytes)} each) after packing "
            f"the co-resident flows — the fleet is oversubscribed",
        ))
    for chip in plan.chips:
        util = chip.utilization(spec)
        if chip.flows and util > spec.headroom_fraction:
            diags.append(make(
                "DX402", "/".join(sorted(chip.flows)),
                f"chip {chip.chip} packs "
                f"{_fmt_bytes(chip.hbm_bytes)} "
                f"({util:.0%} of capacity), above the "
                f"{spec.headroom_fraction:.0%} headroom fraction: one "
                f"capacity bump or dictionary retrace OOMs it",
            ))
    # aggregate bandwidth demand vs the fleet-wide modeled budget
    placed = [
        fp for fp in footprints
        if fp.placeable and fp.name not in plan.unplaced
        and fp.name not in plan.oversized
    ]
    d2h_demand = sum(
        fp.d2h_bytes_per_batch / max(fp.interval_s, 1e-9) for fp in placed
    )
    d2h_budget = spec.d2h_bytes_per_sec_per_chip * spec.chips
    if d2h_demand > d2h_budget:
        diags.append(make(
            "DX403", "",
            f"aggregate D2H demand {_fmt_bytes(d2h_demand)}/s exceeds "
            f"the fleet's modeled budget {_fmt_bytes(d2h_budget)}/s "
            f"({spec.chips} chip(s) x "
            f"{_fmt_bytes(spec.d2h_bytes_per_sec_per_chip)}/s): sync "
            f"stages will contend on the host link",
        ))
    ici_demand = sum(
        fp.ici_bytes_per_batch / max(fp.interval_s, 1e-9) for fp in placed
    )
    ici_budget = spec.ici_bytes_per_sec_per_chip * spec.chips
    if ici_demand > ici_budget:
        diags.append(make(
            "DX403", "",
            f"aggregate ICI demand {_fmt_bytes(ici_demand)}/s exceeds "
            f"the fleet's modeled {spec.ici_topology} budget "
            f"{_fmt_bytes(ici_budget)}/s: collectives will contend on "
            f"the interconnect",
        ))


def _pair_table(a: str, b: str) -> str:
    return "/".join(sorted((a, b)))


def _interference_lints(
    footprints: Sequence[FlowFootprint],
    plan: PlacementPlan,
    diags: List[Diagnostic],
) -> None:
    for i, a in enumerate(footprints):
        for b in footprints[i + 1:]:
            shared_dirs = a.dirs & b.dirs
            if shared_dirs:
                diags.append(make(
                    "DX410", _pair_table(a.name, b.name),
                    f"flows '{a.name}' and '{b.name}' share "
                    f"checkpoint/state/output path(s) "
                    f"{sorted(shared_dirs)}: restarts would corrupt "
                    f"each other's offsets and window state",
                ))
            shared_consumers = a.consumer_keys & b.consumer_keys
            if shared_consumers:
                desc = ", ".join(
                    f"{k[0]} group/conn {k[1]!r} on {k[2]!r}"
                    if k[0] == "kafka"
                    else f"{k[0]} {k[2]!r} on connection {k[1]!r}"
                    for k in sorted(shared_consumers)
                )
                diags.append(make(
                    "DX411", _pair_table(a.name, b.name),
                    f"flows '{a.name}' and '{b.name}' collide on "
                    f"{desc}: the broker splits records between them, "
                    f"so each flow silently sees a fraction of the "
                    f"stream",
                ))
            shared_series = a.metric_series & b.metric_series
            if shared_series:
                diags.append(make(
                    "DX412", _pair_table(a.name, b.name),
                    f"flows '{a.name}' and '{b.name}' emit the same "
                    f"metric series key(s) {sorted(shared_series)[:3]} "
                    f"into the shared store: dashboard series "
                    f"interleave indistinguishably",
                ))
            # port conflicts only matter between CO-PLACED flows (one
            # chip = one host process slot)
            if (
                a.obs_port is not None
                and a.obs_port == b.obs_port
                and plan.chip_of(a.name) is not None
                and plan.chip_of(a.name) == plan.chip_of(b.name)
            ):
                diags.append(make(
                    "DX413", _pair_table(a.name, b.name),
                    f"co-placed flows '{a.name}' and '{b.name}' (chip "
                    f"{plan.chip_of(a.name)}) both bind observability "
                    f"port {a.obs_port}: the second host fails to "
                    f"expose /metrics and /healthz",
                ))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def analyze_fleet(
    footprints: Sequence[FlowFootprint],
    spec: Optional[FleetSpec] = None,
) -> FleetReport:
    """Whole-fleet analysis over pre-computed footprints: FFD packing,
    DX400-403 capacity lints, DX410-413 interference lints."""
    spec = spec or FleetSpec()
    diags: List[Diagnostic] = []
    for fp in footprints:
        diags.extend(fp.diagnostics)
    plan = pack_fleet(footprints, spec)
    _capacity_lints(footprints, plan, spec, diags)
    _interference_lints(list(footprints), plan, diags)
    return FleetReport(spec, list(footprints), plan, _ordered(diags))


def analyze_fleet_flows(
    flows: Sequence[dict],
    spec: Optional[FleetSpec] = None,
    names: Optional[Sequence[str]] = None,
) -> FleetReport:
    """Convenience wrapper: build every footprint (running the DX2xx
    device tier per flow), then analyze the set."""
    footprints = [
        flow_footprint(flow, name=(names[i] if names else None))
        for i, flow in enumerate(flows)
    ]
    return analyze_fleet(footprints, spec)


def load_fleet_spec(path: str, device: str = "cuda") -> FleetSpec:
    """Read a ``--fleet-spec`` JSON file (camelCase ``to_dict`` keys);
    what it leaves unset comes from ``device``'s machine."""
    with open(path, "r", encoding="utf-8") as f:
        return FleetSpec.from_dict(json.load(f), device=device)
