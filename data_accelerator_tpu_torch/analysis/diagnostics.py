"""Typed diagnostics for the flow static analyzer.

Every finding the analyzer emits is a ``Diagnostic`` carrying a stable
``DXnnn`` code, a severity, the table (view) it concerns, a message and
a source ``Span`` into the transform script that was analyzed. The code
registry below is the single source of truth — ``ANALYSIS.md`` is
generated from the same one-line cause/fix strings, and tests assert
codes (not messages), so wording can improve without breaking callers.

Copy of the JAX package's ``analysis/diagnostics.py`` with the same code
registry (every code, at the same severity) and the same
``REPORT_SCHEMA_VERSION``, so the two packages' reports compare field
for field. The wording of the codes the port emits speaks of PyTorch:
DX204 of a step rebuild, DX290 of a failed meta evaluation, DX300-DX305
of eager CUDA hazards, DX700/DX790/DX791 of CUDA kernel UDFs and the
mesh step's census. The other tiers' codes (DX4xx, DX6xx, DX8xx-DX10xx)
keep the reference's words.

reference: the platform promise in PAPER.md §1 — design-time services
(SqlParser/Analyzer, schema inference, codegen validation) catch a bad
flow before the job is deployed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass(frozen=True)
class Span:
    """1-based location in the analyzed transform script.

    ``line`` is the first line of the statement; ``col`` is the 1-based
    character offset within the statement text (statements are joined to
    one logical line by the transform parser, so ``col`` indexes that
    joined text); ``end_line`` closes multi-line statements.
    """

    line: int = 0
    col: int = 1
    end_line: Optional[int] = None

    def to_dict(self) -> dict:
        d = {"line": self.line, "col": self.col}
        if self.end_line is not None:
            d["endLine"] = self.end_line
        return d


@dataclass(frozen=True)
class Diagnostic:
    code: str  # "DX001"
    severity: str  # SEV_ERROR | SEV_WARNING
    table: str  # view/table the finding concerns ("" = flow-level)
    message: str
    span: Span = Span()

    @property
    def is_error(self) -> bool:
        return self.severity == SEV_ERROR

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "table": self.table,
            "message": self.message,
            "span": self.span.to_dict(),
        }

    def render(self) -> str:
        loc = f" (line {self.span.line})" if self.span.line else ""
        tbl = f" [{self.table}]" if self.table else ""
        return f"{self.severity.upper()} {self.code}{tbl} {self.message}{loc}"


# ---------------------------------------------------------------------------
# Code registry: code -> (default severity, one-line cause, one-line fix).
# Pass 1 reference resolution DX00x · pass 2 type propagation DX01x ·
# pass 3 aggregation/window legality DX02x · pass 4 dead flow DX03x ·
# pass 5 device-compilation risk DX04x.
# ---------------------------------------------------------------------------
CODES: Dict[str, tuple] = {
    # -- pass 1: reference resolution -----------------------------------
    "DX001": (SEV_ERROR, "FROM/JOIN references a table no statement or input source defines",
              "define the view earlier in the script, or declare the input source/TIMEWINDOW projecting it"),
    "DX002": (SEV_ERROR, "column is not produced by any table in the statement's FROM scope",
              "check spelling against the input schema / upstream view's select list"),
    "DX003": (SEV_ERROR, "OUTPUT routes a dataset no transform statement produces",
              "name an assigned view in the OUTPUT statement (the job would deploy producing nothing)"),
    "DX004": (SEV_ERROR, "OUTPUT routes to a sink the flow's outputs section does not declare",
              "add the sink under gui.outputs, or route to the built-in Metrics sink"),
    "DX005": (SEV_ERROR, "view referenced before its definition (cyclic dependency)",
              "reorder the statements, or back the cycle with a --DataXStates-- accumulation table"),
    "DX006": (SEV_ERROR, "function is neither an engine builtin nor a declared UDF/UDAF",
              "declare it under gui.process.functions or fix the name"),
    "DX007": (SEV_ERROR, "duplicate output column name in one select list",
              "alias one of the colliding select items"),
    "DX008": (SEV_ERROR, "statement does not parse in the DataXQuery SQL subset",
              "fix the syntax at the reported offset"),
    "DX009": (SEV_ERROR, "TIMEWINDOW targets a table that is not a projected input",
              "window the main projection or a declared source target table"),
    # -- pass 2: type propagation ---------------------------------------
    "DX010": (SEV_ERROR, "operands of a comparison/arithmetic op have incompatible types",
              "cast one side explicitly, or compare like-typed columns"),
    "DX011": (SEV_ERROR, "join keys on the two sides of ON have disagreeing types",
              "cast one key, or join on like-typed columns"),
    "DX012": (SEV_ERROR, "CAST of a literal that cannot convert to the target type",
              "fix the literal or the CAST target"),
    # -- pass 3: aggregation/window legality ----------------------------
    "DX020": (SEV_ERROR, "aggregate function used outside an aggregation context (WHERE/ON/GROUP BY)",
              "move the aggregate into the select list or HAVING of a GROUP BY statement"),
    "DX021": (SEV_WARNING, "TIMEWINDOW retention exceeds the configured state capacity budget",
              "shorten the window, raise the batch interval, or lower the batch capacity"),
    "DX022": (SEV_ERROR, "accumulation table misuse: never updated, or update columns disagree with its DDL",
              "assign the state table from a query whose output columns match the CREATE TABLE schema"),
    # -- pass 4: dead flow ----------------------------------------------
    "DX030": (SEV_WARNING, "view is computed but never reaches a sink, metric, accumulator or downstream view",
              "OUTPUT it, reference it downstream, or delete the statement"),
    "DX031": (SEV_WARNING, "flow routes nothing to any sink or accumulator",
              "add an OUTPUT statement so the job produces something"),
    # -- pass 5: device-compilation risk --------------------------------
    "DX040": (SEV_WARNING, "ORDER BY over a computed string sorts on the host (device round-trip per batch)",
              "sort on a device column, or accept the host-side finishing cost"),
    "DX041": (SEV_ERROR, "string-op argument must be constant: dictionary tables are keyed on it",
              "use a literal pattern/position (column-valued patterns have no device tier)"),
    "DX042": (SEV_ERROR, "string function over a computed string (CONCAT/CAST result) is unsupported on device",
              "apply the function to the inputs before concatenating"),
    # -- pass 6: device plan (analysis/deviceplan.py, the --device tier:
    #    abstract interpretation of the compiled plan's static shapes) --
    "DX200": (SEV_WARNING, "declared group-key cardinality exceeds the static group capacity: groups beyond the bound drop",
              "raise process.maxgroups above the key cardinality, or group by a lower-cardinality key"),
    "DX201": (SEV_WARNING, "join output capacity is below the left input capacity: even one match per row overflows and rows drop",
              "raise process.joincapacity to at least the left side's batch/window capacity"),
    "DX202": (SEV_WARNING, "string dictionary capacity is below the declared/sampled key cardinality: over-capacity keys collapse to NULL",
              "raise process.stringdictionary.maxsize above the distinct string-value count"),
    "DX203": (SEV_WARNING, "non-equi join terms force the O(n*m) match matrix at window scale",
              "add an equality conjunct carrying the selectivity, shrink the window, or bound the pair budget"),
    "DX204": (SEV_WARNING, "rebuild hazard: refresh-capable UDF or unbounded dictionary growth rebuilds the eager step",
              "bound the dictionary (process.stringdictionary.maxsize) and keep UDF refresh intervals coarse"),
    "DX205": (SEV_WARNING, "window retention approaches the int32 ring-rebase horizon (~24.8 days of relative millis)",
              "shorten the window/watermark well below a quarter of the 2^31 ms horizon"),
    "DX206": (SEV_WARNING, "output capacity exceeds the modeled row count by >64x: the sync stage transfers mostly padding device->host",
              "keep sized output transfer on (process.pipeline.sizedtransfer) or tighten process.maxgroups toward the modeled cardinality"),
    "DX290": (SEV_ERROR, "flow fails device lowering: the planner rejected a statement the runtime would also reject, or the meta evaluation of a view failed",
              "fix the statement per the planner's message (it is the production compiler's own error)"),
    "DX291": (SEV_WARNING, "device analysis unavailable: no concrete input schema or design-time-unloadable UDF",
              "inline the input schema JSON and declare UDF modules importable on the control plane"),
    # -- pass 8: fleet capacity/interference (analysis/fleetcheck.py,
    #    the --fleet tier: whole-fleet placement analysis over a SET of
    #    flow configs against a fleet spec, consuming the DX2xx cost
    #    model as its placement oracle) ------------------------------
    "DX400": (SEV_ERROR, "fleet oversubscribed: no feasible placement packs every flow's modeled HBM onto the fleet's chips",
              "add chips, shrink flow capacities (batch/window/maxgroups), or stop a co-resident flow"),
    "DX401": (SEV_ERROR, "single flow's modeled HBM footprint exceeds every chip in the fleet: it can never place",
              "lower the flow's batch capacity/window retention/group bounds, or provision chips with more HBM"),
    "DX402": (SEV_WARNING, "placement feasible but a chip lands above the configured headroom fraction: one capacity bump or retrace OOMs it",
              "rebalance by adding chips or shrinking the co-placed flows, or raise headroomFraction deliberately"),
    "DX403": (SEV_WARNING, "aggregate D2H/ICI bandwidth demand across the fleet exceeds the modeled budget: sync stages will contend",
              "stagger batch intervals, shrink output capacities (sized transfer), or raise the spec's bandwidth budgets"),
    "DX410": (SEV_ERROR, "two flows share a checkpoint/state/output directory: restarts corrupt each other's offsets and window state",
              "give each flow a distinct checkpoint dir and sink folder (flow names key the defaults — rename one flow)"),
    "DX411": (SEV_ERROR, "Kafka/EventHub consumer-group collision on overlapping topics: the broker splits records between the flows",
              "set a distinct kafka.groupid/consumerGroup per flow (the default group is shared) or de-overlap topics"),
    "DX412": (SEV_WARNING, "metric series collision: two flows emit under the same DATAX-<app> key so store/dashboard series interleave",
              "rename one flow (the metric app name derives from it) so every series key is unique in the shared store"),
    "DX413": (SEV_WARNING, "observability-port conflict: co-placed flows bind the same process.observability.port on one host",
              "give each co-placed flow a distinct jobObservabilityPort, or 0 for an ephemeral port"),
    # -- pass 7: UDF tracing-safety/purity/determinism (analysis/
    #    udfcheck.py, the --udfs tier: taint-lattice abstract
    #    interpretation of UDF device-function ASTs) -------------------
    "DX300": (SEV_ERROR, "data-dependent Python control flow on a device tensor: if/while/and/or/not bool-convert it, a blocking device-to-host sync every batch that also rules out CUDA-graph capture",
              "replace the branch with torch.where so control flow stays on the device"),
    "DX301": (SEV_ERROR, "host sync point on a device tensor: .item()/.tolist()/.cpu()/.numpy()/float()/int()/bool() or torch.cuda.synchronize() block the host every batch and rule out CUDA-graph capture",
              "keep the computation in torch ops on the device; read values back only outside the step"),
    "DX302": (SEV_WARNING, "impure device function: mutates global/closure state, does I/O, or draws host randomness or torch's global generator — eager PyTorch repeats the effect every batch, so results depend on state outside the batch",
              "make the function pure; pass an explicit torch.Generator, and move state behind on_interval"),
    "DX303": (SEV_WARNING, "captured mutable state with no on_interval declared: eager PyTorch reads the state on every call, so an update lands mid-stream with no batch boundary and no refresh",
              "declare on_interval so state changes take effect at a batch boundary (DynamicUDF.onInterval semantics), or capture immutable values"),
    "DX304": (SEV_WARNING, "declared out_type disagrees with the return dtype inferred under the type lattice: results decode through the wrong column type",
              "fix out_type (or the return expression) so the declared SQL type matches what the function computes"),
    "DX305": (SEV_ERROR, "CUDA launch hazard: cuda_call without out_shape, or its grid/out_shape derived from device tensor values (a host read every batch)",
              "derive grid and out_shape from static shapes (.shape/.numel()) only and always pass out_shape"),
    "DX310": (SEV_ERROR, "UDF conf entry does not load: bad package.module:attr, non-callable target, or aggregate without reduce",
              "point class/module at an importable UDF object or zero-arg factory; aggregates must provide reduce"),
    # -- pass 10: mesh sharding (analysis/meshcheck.py, the --mesh
    #    tier: static partition plan over the compiled views —
    #    per-stage shard axis, reshard edges, collective byte model
    #    cross-checked exactly against the mesh step's census) --------
    "DX700": (SEV_WARNING, "unshardable stage forces full replication: a global ORDER BY (device or host-side) or a CUDA-kernel UDF call materializes every row on every chip, so the stage gains nothing from more chips",
              "drop the ORDER BY (sinks can sort), push it behind a GROUP BY that shrinks the rows, or rewrite the kernel UDF in torch ops so the mesh step can run it per shard"),
    "DX701": (SEV_WARNING, "resharding between adjacent stages: the same sharded table is gathered onto every chip at two or more stage boundaries, paying the all-gather repeatedly",
              "fold the consumers into one statement, or materialize a shared intermediate view so the gather happens once"),
    "DX702": (SEV_ERROR, "per-chip shard exceeds chip HBM at the requested chip count: the sharded residency plus replicated tables cannot fit one chip",
              "add chips, shrink batch/window/group capacities, or provision chips with more HBM (fleet-spec hbmPerChipBytes)"),
    "DX703": (SEV_WARNING, "predicted ICI bytes/batch exceed the fleet-spec interconnect budget at the batch interval: collectives will dominate the step",
              "group/join on lower-cardinality keys, shrink output capacities, or raise the spec's iciBytesPerSecPerChip deliberately"),
    "DX704": (SEV_WARNING, "scaling cliff: the stage's modeled per-chip cost is flat or worse in the chip count (replicated compute at batch scale, or collective wire growth outpacing the compute shrink)",
              "reshape the stage so rows stay sharded (shard-friendly keys, no full-capacity replication), or stop adding chips past the cliff"),
    "DX705": (SEV_WARNING, "sized output transfer and donated output slots auto-disable under a mesh: every output fetch moves the full padded capacity and no background double-buffering applies",
              "expect full-capacity D2H under the mesh, or keep the flow single-chip until the sharded sized-transfer path exists"),
    "DX790": (SEV_ERROR, "mesh step failed or disagrees with the sharding model: the partition plan's closed-form collective bytes do not match the collectives the mesh step recorded",
              "fix the statement per the error, or regenerate after engine changes — the byte model must match the mesh step's census exactly"),
    "DX791": (SEV_WARNING, "mesh analysis unavailable: no concrete input schema, or a UDF that cannot load, so the flow has no partition plan",
              "inline the input schema JSON and make every UDF module importable where the analyzer runs"),
    # -- pass 9: compile surface (analysis/compilecheck.py, the
    #    --compile tier: enumerate every jit entry point, lower each
    #    over eval_shape avals, prove the signature set finite and
    #    stable, emit the AOT compile manifest) -----------------------
    "DX600": (SEV_WARNING, "open trace surface: UDF interval refresh or unbounded dictionary growth re-traces the step with new signatures, so the jit cache (and any AOT promise) grows without bound",
              "drop the on_interval refresh or bound the dictionary (process.stringdictionary.maxsize) so the manifest covers every signature the flow can dispatch"),
    "DX601": (SEV_WARNING, "reachable sized-transfer capacity buckets alone exceed the transfer-helper jit cache bound: steady-state LRU eviction recompiles helpers mid-stream",
              "lower the batch capacity (fewer pow2 buckets) or raise process.compile.jitcachecap above the lattice size"),
    "DX602": (SEV_ERROR, "manifest donation/aliasing mismatch: a shipped manifest entry's donated argnums disagree with the runtime's donation contract",
              "regenerate the manifest (--compile emits it); never hand-edit donation patterns — they alias live device buffers"),
    "DX603": (SEV_ERROR, "manifest-vs-lowering drift: a shipped manifest's entries/avals/lowering digests no longer match what this flow compiles to",
              "regenerate the manifest after any flow, schema, capacity or engine change (warm starts from a stale manifest recompile at dispatch, surfacing as Compile_WarmMiss_Count)"),
    "DX690": (SEV_ERROR, "compile-surface lowering failed: the fused step (or a transfer helper) cannot trace/lower over the derived avals",
              "fix the statement per the lowering error (it is the production compiler's own failure, seen early)"),
    "DX691": (SEV_WARNING, "compile-surface analysis unavailable: no concrete input schema, design-time-unloadable UDF, or unreadable reference data",
              "inline the input schema JSON, make UDF modules importable on the control plane, and keep refdata CSVs readable at design time"),
    # -- pass 11: buffer lifetime / concurrency (analysis/racecheck.py,
    #    the --race tier: provenance-lattice abstract interpretation of
    #    the ENGINE'S OWN runtime/lq/pilot modules — the standing CI
    #    race gate against the donated/zero-copy bug class. DX805 is
    #    the runtime half (runtime/sanitizer.py), fired into the
    #    flight recorder, never by the static pass) -------------------
    "DX800": (SEV_ERROR, "donated/pooled buffer view escapes its guarded scope (return, attribute/container store, or cross-thread handoff) without a real copy: the next dispatch donates/reuses the memory under the escaped view — use-after-free, not just stale data",
              "copy before the escape (np.array(x, copy=True) / .copy()), or mark a designed ownership transfer with '# dx-race: owner-handoff <reason>'"),
    "DX801": (SEV_ERROR, "np.asarray/jnp.asarray of an aligned pool/ring buffer outside an annotated allowed-zero-copy site: on the CPU backend this is a zero-copy VIEW of memory the engine will donate or reuse",
              "use a real copy, or annotate the site '# dx-race: allow-zero-copy <reason>' if the view provably dies before the buffer is donated/reused"),
    "DX802": (SEV_ERROR, "shared state raced between the dispatch loop and a background thread: an attribute guarded by a lock elsewhere is mutated without that lock, or two locks are acquired in conflicting orders",
              "take the associated lock around the write (or mark a provably pre-thread path '# dx-race: single-threaded <reason>'); keep lock acquisition order consistent with the device-state lock"),
    "DX803": (SEV_ERROR, "transfer slot re-donated before its land ack: donation of an A/B slot buffer is not dominated by the previous batch's landed-event check, so XLA may free a buffer the background landing thread is still reading",
              "gate the donation on the previous slot's _landed.is_set()/wait() (the slot-rotation contract the compile manifest's donate pattern assumes)"),
    "DX804": (SEV_ERROR, "blocking device sync on a thread the pipeline model requires non-blocking: block_until_ready/device_get/a blocking wait inside a function marked '# dx-race: non-blocking' stalls the dispatch overlap the depth-N window exists to provide",
              "move the sync to the landing thread (collect_counts is the one sanctioned sync point), use the async copy path, or drop the non-blocking marker if the function is genuinely allowed to block"),
    # -- pass 12: exactly-once delivery protocol (analysis/protocheck.py,
    #    the --protocol tier: typed effect-trace extraction over the
    #    engine packages + serve/jobs.py, checked against the declared
    #    ordering-rule table in analysis/protospec.py. DX906 is the
    #    runtime half (runtime/protocolmonitor.py), fired into the
    #    flight recorder, never by the static pass) -------------------
    "DX900": (SEV_ERROR, "durability-before-ack violated: the upstream FIFO is acked before the durable pointer flip, or an os.replace runs without the tmp-file fsync before the rename and the parent-dir fsync after it",
              "move the ack after processor.commit()/the pointer flip; fence every checkpoint rename with fsync(tmp) then os.replace then fsync(dir) (use _durable_replace)"),
    "DX901": (SEV_ERROR, "sink-before-pointer-commit violated: the state-table pointer flips before the sinks accepted the batch, so a replay after a sink failure double-counts the committed rows",
              "dispatch to sinks first and flip the pointer only after dispatch returns (the order StreamingHost._finish_tail and the BatchHost landing tail establish)"),
    "DX902": (SEV_ERROR, "ack-at-most-once-per-batch violated: more than one ack call site on one batch path — a second ack releases a window the failure path still expects to requeue",
              "keep a single ack loop per batch tail; route every early-exit through the same commit point"),
    "DX903": (SEV_ERROR, "requeue-covers-unacked-window violated: a function that acks has no failure handler requeuing the unacked window, or a looped ack is paired with a single-source requeue",
              "requeue every source in the except handler that guards the ack (or mark a delegating wrapper '# dx-proto: requeue-upstream <reason>' when the caller owns the handler)"),
    "DX904": (SEV_ERROR, "effect-outside-requeue-scope: a pre-ack effect sits outside any try whose handler requeues, or a post-ack effect (offset commit / snapshot write) is not declared with a post-commit marker",
              "wrap pre-ack effects in the requeue-guarded try; annotate designed at-least-once tails '# dx-proto: post-commit <reason>' so the inventory pins them"),
    "DX905": (SEV_ERROR, "handoff-pull-before-first-dispatch violated: a rescale dispatches a successor job before pulling/stamping its owned-partition plan, so the replica boots without its state assignment",
              "compute _state_partition_plan and stamp statePartitionsOwned/confOverrides on the record before client.submit"),

    # 11. configuration lattice (analysis/confcheck.py, --conf): the
    #     designer knob -> S400 token -> S650 flat key -> runtime read
    #     chain checked against the ONE typed registry in
    #     analysis/confspec.py. DX1006 is the registry's runtime half
    #     (runtime/confaudit.py flight-records it at host/LQ init).
    "DX1000": (SEV_ERROR, "runtime-read-but-never-producible: a conf read site waits on a key no registry row covers — a dead knob or a typo'd key no generation path can produce",
               "register the key in analysis/confspec.py CONF_REGISTRY (with type/default/chain) or fix the read site's key string"),
    "DX1001": (SEV_WARNING, "generated-but-never-read: a produced conf key (generation stage, control plane or conf file) matches no registry row, or a registered read=True key has no read site — dead conf",
               "delete the production, or register the key (read=False for deliberate reference-parity keys)"),
    "DX1002": (SEV_ERROR, "broken designer->runtime chain: a gui token no generated key carries, or a registered knob whose declared conf key generation never writes — the designer's choice is dropped on the floor",
               "wire the token through S650/S640 to its registered key (or fix the registry row's knob/key chain)"),
    "DX1003": (SEV_WARNING, "default-value drift: a read-site fallback or S400 generation default disagrees with the registry's canonical default — 'unset' behaves differently per layer",
               "align the fallback literal with the registry default (the registry row is the single source of truth)"),
    "DX1004": (SEV_ERROR, "conf type/bounds violation: a concrete flow conf value fails its registry row's type, bounds or choices (pipeline.depth=0, a negative TTL, an HBM budget above the chip)",
               "fix the flow's designer knob / conf value to satisfy the registered type and bounds"),
    "DX1005": (SEV_ERROR, "incompatible conf combination: a declared mutual-exclusion constraint is violated (mesh+sizedtransfer, mesh+backgroundtransfer, state.filteringest without state partitions)",
               "drop one side of the combination — the constraint table in analysis/confspec.py documents why they cannot compose"),
    "DX1006": (SEV_ERROR, "live conf failed the registry audit: the host/LQ service booted with an unknown or out-of-bounds datax.job.process.* key (runtime/confaudit.py)",
               "regenerate the flow's conf (stale key) or fix the out-of-bounds value; the Conf_{Audited,Unknown,OutOfBounds}_Count metrics carry the counts"),
}

# which pass each code family belongs to (for grouping/reporting)
PASS_NAMES = {
    "DX00": "reference resolution",
    "DX01": "type propagation",
    "DX02": "aggregation/window legality",
    "DX03": "dead flow",
    "DX04": "device-compilation risk",
    "DX20": "device plan",
    "DX29": "device plan",
    "DX30": "udf tracing safety",
    "DX31": "udf tracing safety",
    "DX40": "fleet capacity",
    "DX41": "fleet interference",
    "DX60": "compile surface",
    "DX69": "compile surface",
    "DX70": "mesh sharding",
    "DX79": "mesh sharding",
    "DX80": "buffer lifetime/race",
    "DX90": "delivery protocol",
    "DX10": "configuration lattice",
}

# version of every ``--json`` report shape the analysis tiers emit (the
# CLI per-file/fleet reports and the ``flow/validate`` response). Bump
# when top-level keys change so downstream consumers (designer,
# admission gate, CI tooling) can detect report-format drift; a tier-1
# test pins the current key sets against this number.
# v2: the ``mesh`` report block (the --mesh tier's sharding plan).
# v3: the ``race`` report block (the --race tier's engine buffer-
# lifetime/concurrency gate).
# v4: the ``protocol`` report block (the --protocol tier's exactly-
# once delivery-protocol gate).
# v5: the ``conf`` report block (the --conf tier's configuration-
# lattice gate: typed registry + designer->runtime chain).
REPORT_SCHEMA_VERSION = 5


def make(code: str, table: str, message: str, span: Optional[Span] = None,
         severity: Optional[str] = None) -> Diagnostic:
    """Build a diagnostic, defaulting severity from the registry."""
    default_sev = CODES[code][0]
    return Diagnostic(
        code=code,
        severity=severity or default_sev,
        table=table,
        message=message,
        span=span or Span(),
    )


@dataclass
class AnalysisReport:
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

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def to_dict(self) -> dict:
        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }
