"""The DECLARED configuration lattice (shared by the static ``--conf``
tier and the runtime ``ConfAudit``).

The platform's whole contract is "flow JSON compiles to a flat job
``.conf`` the runtime trusts" — and until this module that contract
was stringly typed: 60+ ``datax.job.process.*`` keys hand-plumbed from
designer ``jobXxx`` knob to S400 gui token to S650 flat key to a
runtime ``conf.get`` with an inline fallback, and nothing checking any
hop. Here the lattice is a TABLE: one :class:`ConfKey` per key, with
its type, canonical default, bounds, owner subsystem and (where the
designer can set it) the knob→token chain that produces it. The static
pass (``analysis/confcheck.py``, DX1000-DX1005) checks every scanned
read site and every generated key against it; the runtime audit
(``runtime/confaudit.py``, DX1006) checks every LIVE conf against the
SAME rows via :func:`check_value` / :func:`check_conf_mapping`.

Key syntax
----------
``key`` is relative to ``datax.job.process.`` (the only namespace in
scope — ``datax.job.input.*`` / ``output.*`` belong to the source and
sink planes, configured by the template, not by engine knobs). A ``*``
segment matches exactly one dotted segment (``timewindow.*.
windowduration`` covers every named window); read sites the scanner
can only resolve to a family (``group_by_sub_namespace()`` /
``.dict`` walks) are recorded with a ``**`` tail that matches any
remainder.

``read=False`` rows are produced-for-parity keys: the generation
chain emits them (reference-template compatibility) but no runtime
module reads them yet. They are registered so DX1001 stays a typo
detector instead of flagging deliberate forward-compat keys; the
tier-1 self-lint pins their exact count so a new one is a conscious
decision.

Copy of the JAX package's ``analysis/confspec.py`` with the same rows,
so the port's boot audit judges a conf exactly as the JAX host does.
Trimmed: the ``CONF.md`` renderer and its ``__main__``. The rows
describe the keys by their JAX-package meaning; where the port reads a
key differently (``compile.*``, ``debug.*``), its reader says so.

One row the reference reads is ``read=False`` here, because nothing in
the port reads it: ``compile.jitcachecap`` (the JAX package's
transfer-helper jit cache; the port has none, and
``analysis/compilecheck.py`` retires DX601). ``compile.cachedir`` and
``compile.cacheurl`` are read: they arm the port's kernel build cache
(``compile/aotcache.py``), where the reference arms its persistent
compilation cache. Every type, default and bound is the reference's, so
the boot audit's ``Conf_*`` gauges are unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from ..core.config import parse_duration_seconds

#: the single namespace this lattice governs
PROCESS_PREFIX = "datax.job.process."

#: value types :func:`check_value` understands
TYPES = (
    "string", "int", "float", "bool", "duration", "json", "path",
    "url", "port", "list",
)

_BOOL_WORDS = {
    "true": True, "false": False, "1": True, "0": False,
    "yes": True, "no": False, "on": True, "off": False,
}


@dataclass(frozen=True)
class ConfKey:
    """One row of the configuration lattice."""

    key: str                      # relative to ``datax.job.process.``
    type: str                     # a ``TYPES`` member
    default: Optional[str]        # canonical engine fallback (None = no default)
    subsystem: str                # owning subsystem (runtime, pipeline, lq, ...)
    knob: Optional[str] = None    # designer jobconfig knob (``jobXxx``)
    token: Optional[str] = None   # S400 gui token carrying the knob
    source: str = "generation"    # designer|template|generation|control|manual
    min: Optional[float] = None   # numeric/duration lower bound (inclusive)
    max: Optional[float] = None   # numeric/duration upper bound (inclusive)
    choices: Optional[Tuple[str, ...]] = None
    read: bool = True             # False = produced-for-parity, no reader yet
    description: str = ""

    def __post_init__(self) -> None:
        if self.type not in TYPES:
            raise ValueError(f"ConfKey {self.key}: unknown type {self.type!r}")
        if self.key.startswith(PROCESS_PREFIX):
            raise ValueError(
                f"ConfKey {self.key}: registry keys are relative to "
                f"{PROCESS_PREFIX!r}"
            )


def _segments_match(pattern: str, key: str) -> bool:
    """``*`` matches exactly one segment; a trailing ``**`` matches any
    non-empty remainder (used for family read sites, not registry rows).
    """
    pseg = pattern.split(".")
    kseg = key.split(".")
    if pseg and pseg[-1] == "**":
        head = pseg[:-1]
        if len(kseg) < len(head) + 1:
            return False
        kseg = kseg[: len(head)]
        pseg = head
    if len(pseg) != len(kseg):
        return False
    return all(p == "*" or p == k for p, k in zip(pseg, kseg))


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------
# Filled in below (kept at module bottom for readability: the helpers
# first, then the long table).

def registry_index() -> Dict[str, ConfKey]:
    """Exact-key index (wildcard rows excluded)."""
    return {e.key: e for e in CONF_REGISTRY if "*" not in e.key}


def match_key(key: str) -> Optional[ConfKey]:
    """Find the registry row governing ``key`` (relative form).

    Exact rows win; otherwise the first wildcard row whose pattern
    matches. Returns None for an unregistered key.
    """
    if key.startswith(PROCESS_PREFIX):
        key = key[len(PROCESS_PREFIX):]
    exact = registry_index().get(key)
    if exact is not None:
        return exact
    for e in CONF_REGISTRY:
        if "*" in e.key and _segments_match(e.key, key):
            return e
    return None


def rows_matching_family(family: str) -> List[ConfKey]:
    """Registry rows a family read site (``prefix.**`` / ``a.*.b``)
    covers — used to decide whether a family read is DX1000-dead."""
    out = []
    for e in CONF_REGISTRY:
        if _segments_match(family, e.key) or _family_covers(family, e.key):
            out.append(e)
    return out


def _family_covers(family: str, key: str) -> bool:
    """True when the family pattern's fixed head is a prefix of the
    registry row's segments (both may contain ``*`` segments)."""
    fseg = family.split(".")
    kseg = key.split(".")
    if fseg and fseg[-1] == "**":
        fseg = fseg[:-1]
        if len(kseg) < len(fseg):
            return False
        kseg = kseg[: len(fseg)]
    if len(fseg) != len(kseg):
        return False
    return all(f == "*" or k == "*" or f == k for f, k in zip(fseg, kseg))


# ---------------------------------------------------------------------------
# Value checking (shared static + runtime)
# ---------------------------------------------------------------------------
def canonical_default(entry: ConfKey) -> Optional[str]:
    return entry.default


def _num(entry: ConfKey, value: str) -> Optional[float]:
    if entry.type in ("int", "port"):
        return float(int(value))
    if entry.type == "float":
        return float(value)
    if entry.type == "duration":
        return float(parse_duration_seconds(value))
    return None


def defaults_equal(entry: ConfKey, other: Optional[str]) -> bool:
    """Compare a fallback literal against the registry default, up to
    numeric/bool canonicalization (``8`` == ``8.0``, ``True`` ==
    ``true``)."""
    if entry.default is None or other is None:
        return entry.default == other
    a, b = str(entry.default), str(other)
    if a == b:
        return True
    if entry.type == "bool":
        return _BOOL_WORDS.get(a.lower()) == _BOOL_WORDS.get(b.lower())
    try:
        na, nb = _num(entry, a), _num(entry, b)
    except (ValueError, TypeError):
        return False
    if na is None or nb is None:
        return False
    return na == nb


def check_value(entry: ConfKey, value: str) -> Optional[str]:
    """Validate one concrete value against its registry row. Returns a
    human-readable reason when the value violates the row's type,
    bounds or choices — None when it conforms."""
    v = str(value)
    if entry.choices is not None and v not in entry.choices:
        return (
            f"value {v!r} not one of {', '.join(entry.choices)}"
        )
    if entry.type == "bool":
        if v.strip().lower() not in _BOOL_WORDS:
            return f"expected a boolean, got {v!r}"
        return None
    if entry.type == "json":
        try:
            json.loads(v)
        except ValueError:
            return "expected a JSON document"
        return None
    if entry.type == "list":
        return None  # ';'-separated, any content
    if entry.type in ("string", "path", "url"):
        return None
    # numeric family: int / float / duration / port
    try:
        n = _num(entry, v)
    except (ValueError, TypeError):
        return f"expected {entry.type}, got {v!r}"
    if n is None:  # pragma: no cover — TYPES is closed
        return None
    lo = entry.min
    hi = entry.max
    if entry.type == "port":
        lo = 0 if lo is None else lo
        hi = 65535 if hi is None else hi
    if lo is not None and n < lo:
        return f"value {v} below minimum {lo:g}"
    if hi is not None and n > hi:
        return f"value {v} above maximum {hi:g}"
    return None


# ---------------------------------------------------------------------------
# Mutual-exclusion constraints
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ConfConstraint:
    """One incompatible-knob rule, evaluated over an effective conf
    mapping of RELATIVE keys (``pipeline.depth`` -> ``"2"``)."""

    name: str
    description: str
    violated: Callable[[Mapping[str, str]], bool]


def _truthy(conf: Mapping[str, str], key: str) -> bool:
    return _BOOL_WORDS.get(str(conf.get(key, "")).strip().lower(), False)


def _is_mesh(conf: Mapping[str, str]) -> bool:
    try:
        chips = int(str(conf.get("numchips", "1") or "1"))
    except ValueError:
        chips = 1
    return chips > 1 or bool(conf.get("mesh.model"))


CONSTRAINTS: Tuple[ConfConstraint, ...] = (
    ConfConstraint(
        "mesh-sizedtransfer",
        "pipeline.sizedtransfer=true on a multi-chip mesh job: the "
        "sized D2H fetch is a single-chip optimization — under a mesh "
        "every batch fetches the full padded capacity, so the knob is "
        "silently ignored (the conf half of the DX705 lint)",
        lambda c: _is_mesh(c) and _truthy(c, "pipeline.sizedtransfer"),
    ),
    ConfConstraint(
        "mesh-backgroundtransfer",
        "pipeline.backgroundtransfer=true on a multi-chip mesh job: "
        "the double-buffered background landing path is disabled under "
        "a mesh (runtime/host.py forces it off), so an explicit 'true' "
        "documents an intent the engine will not honor",
        lambda c: _is_mesh(c) and str(
            c.get("pipeline.backgroundtransfer", "")
        ).strip().lower() in ("true", "1", "yes", "on"),
    ),
    ConfConstraint(
        "filteringest-without-partitions",
        "state.filteringest=true without state.partitions: ingest-time "
        "partition filtering keys off the state-partition plan — with "
        "no partition count declared every replica would filter "
        "against an empty plan and drop all rows",
        lambda c: _truthy(c, "state.filteringest")
        and not str(c.get("state.partitions", "")).strip(),
    ),
)


def check_conf_mapping(
    conf: Mapping[str, str],
) -> List[Tuple[str, str, str]]:
    """Validate a concrete flat conf against the lattice. Returns
    ``(kind, key, reason)`` tuples where ``kind`` is ``unknown`` (no
    registry row), ``value`` (type/bounds/choices violation) or
    ``constraint`` (incompatible-knob rule; ``key`` is the rule name).

    Shared by the static DX1004/DX1005 checks and the runtime
    ``ConfAudit`` (DX1006) — one validator, two enforcement points.
    """
    out: List[Tuple[str, str, str]] = []
    rel: Dict[str, str] = {}
    for k, v in sorted(dict(conf).items()):
        if not k.startswith(PROCESS_PREFIX):
            continue
        r = k[len(PROCESS_PREFIX):]
        rel[r] = str(v)
        entry = match_key(r)
        if entry is None:
            out.append(("unknown", r, "key is not in the conf registry"))
            continue
        reason = check_value(entry, str(v))
        if reason:
            out.append(("value", r, reason))
    for rule in CONSTRAINTS:
        if rule.violated(rel):
            out.append(("constraint", rule.name, rule.description))
    return out


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------
# One row per ``datax.job.process.*`` key. Ordering is by subsystem —
# the auto-generated CONF.md reference table preserves it. Defaults are
# the ENGINE's canonical fallback (what the runtime does when the key
# is absent), not what any particular scenario sets; S400 token
# defaults and read-site literals are checked against these by DX1003.
_K = ConfKey

CONF_REGISTRY: Tuple[ConfKey, ...] = (
    # -- runtime core ------------------------------------------------------
    _K("batchcapacity", "int", "65536", "runtime", knob="jobBatchCapacity",
       token="guiJobBatchCapacity", source="designer", min=1,
       description="padded device batch capacity (rows per step)"),
    _K("numchips", "int", "1", "runtime", knob="jobNumChips",
       token="guiJobNumChips", source="designer", min=1,
       description="device-mesh width; >1 builds a 1-D data mesh over "
                   "the first N local chips (clamped to available)"),
    _K("transform", "path", None, "runtime", source="template",
       description="path to the flow's transform script (codegen input)"),
    _K("timestampcolumn", "string", None, "runtime", source="template",
       description="event-time column driving windows and watermarks"),
    _K("watermark", "duration", None, "runtime", source="template", min=0,
       description="allowed event-time lateness"),
    _K("projection", "list", None, "runtime", source="template",
       description="';'-separated projection column list"),
    _K("properties.enabled", "bool", "false", "runtime", source="manual",
       description="opt-in per-row properties map (documented opt-in; "
                   "off unless a flow declares it)"),
    _K("appendproperty.*", "string", None, "runtime", source="template",
       description="constant columns appended to every row"),
    # -- pipeline ----------------------------------------------------------
    _K("pipeline.depth", "int", "2", "pipeline", knob="jobPipelineDepth",
       token="guiJobPipelineDepth", source="designer", min=1,
       description="in-flight batch window (decode/dispatch overlap)"),
    _K("pipeline.sizedtransfer", "bool", "true", "pipeline",
       source="manual",
       description="bucketed sized D2H fetch (single-chip only; the "
                   "mesh-sizedtransfer constraint flags it under a mesh)"),
    _K("pipeline.backgroundtransfer", "bool", "true", "pipeline",
       source="manual",
       description="double-buffered background D2H landing thread"),
    _K("pipeline.outputslots", "bool", "true", "pipeline", source="manual",
       description="preallocated pinned output landing slots"),
    _K("ingest.decoderthreads", "int", None, "ingest",
       knob="jobDecoderThreads", token="guiJobDecoderThreads",
       source="designer", min=1,
       description="native decoder worker threads (None = serial)"),
    # -- ops ---------------------------------------------------------------
    _K("maxgroups", "int", None, "ops", source="manual", min=1,
       description="group-by capacity: max distinct groups per batch"),
    _K("groupcapacity", "int", None, "ops", source="manual", min=1,
       description="group-by capacity: max rows per group"),
    _K("joincapacity", "int", None, "ops", source="manual", min=1,
       description="broadcast-join build-side row capacity"),
    _K("stringdictionary.maxsize", "int", None, "ops", source="manual",
       min=1, description="string-dictionary slot budget"),
    _K("stringdictionary.strict", "bool", "false", "ops", source="manual",
       description="fail (vs evict) when the string dictionary is full"),
    _K("stringmap.maxrounds", "int", None, "ops", source="manual", min=1,
       description="string-map probe round budget"),
    _K("stringmap.strict", "bool", "false", "ops", source="manual",
       description="fail (vs drop) on string-map round exhaustion"),
    # -- state plane -------------------------------------------------------
    _K("state.partitions", "int", "16", "state", source="control", min=1,
       description="state-partition plan width (jobs.py replica rollout "
                   "writes it; DEFAULT_STATE_PARTITIONS otherwise)"),
    _K("state.replicaindex", "int", "1", "state", source="control", min=1,
       description="this replica's 1-based index in the group"),
    _K("state.replicacount", "int", "1", "state", source="control", min=1,
       description="replica-group size"),
    _K("state.partitionkey", "string", None, "state", source="manual",
       description="row column hashed into the partition plan"),
    _K("state.snapshoturl", "url", None, "state", source="manual",
       description="object-store URL for state snapshots/handoff"),
    _K("state.filteringest", "bool", "false", "state", source="manual",
       description="ingest-time partition filtering (requires "
                   "state.partitions — see the constraint)"),
    _K("statetable.*.schema", "string", None, "state", source="template",
       description="accumulator state-table schema ('k long, v double')"),
    _K("statetable.*.location", "path", None, "state", source="template",
       description="state-table spill/snapshot directory"),
    _K("statetable.*.partitionkey", "string", None, "state",
       source="manual",
       description="per-table partition column override"),
    # -- time windows ------------------------------------------------------
    _K("timewindow.*.windowduration", "duration", None, "window",
       source="template", min=0,
       description="tumbling window span for the named window"),
    _K("timewindow.*.table", "string", None, "window", source="manual",
       description="backing state-table override for the named window"),
    # -- compile plane -----------------------------------------------------
    _K("compile.aot", "bool", "true", "compile", source="manual",
       description="ahead-of-time compile the flow step at host start"),
    _K("compile.cachedir", "path", None, "compile", source="generation",
       description="AOT executable cache directory (S650 embed)"),
    _K("compile.cacheurl", "url", None, "compile", source="generation",
       description="shared AOT cache object-store URL (S650 embed)"),
    _K("compile.manifest", "path", None, "compile", source="generation",
       description="compile manifest path (DX601 surface pin)"),
    _K("compile.jitcachecap", "int", "32", "compile",
       knob="jobCompileJitCacheCap", token="guiJobCompileJitCacheCap",
       source="designer", min=1, read=False,
       description="transfer-helper jit cache entry cap"),
    # -- debug -------------------------------------------------------------
    _K("debug.nans", "bool", "false", "debug", source="manual",
       description="jax_debug_nans for the flow step"),
    _K("debug.tracerleaks", "bool", "false", "debug", source="manual",
       description="jax_check_tracer_leaks for the flow step"),
    _K("debug.buffersanitizer", "bool", "false", "debug", source="manual",
       description="arm the DX805 buffer sanitizer (poison freed views)"),
    _K("debug.protocolmonitor", "bool", "false", "debug", source="manual",
       description="arm the DX906 exactly-once protocol monitor"),
    # -- mesh --------------------------------------------------------------
    _K("mesh.model", "json", None, "mesh", source="generation",
       description="sharding-plan artifact (S660 embed; DX510/511 "
                   "conformance input)"),
    _K("mesh.observe", "bool", "true", "mesh", source="manual",
       description="summarize compiled collectives for ICI conformance"),
    # -- observability -----------------------------------------------------
    _K("observability.port", "port", None, "observability",
       knob="jobObservabilityPort", token="guiJobObservabilityPort",
       source="designer", min=1,
       description="/metrics + /readyz + profiler HTTP port"),
    _K("observability.profiler", "bool", "true", "observability",
       knob="jobProfiler", source="designer",
       description="on-demand device profiler endpoint"),
    _K("observability.profilerdir", "path", None, "observability",
       source="manual", description="profiler trace output directory"),
    _K("observability.hbmsample", "bool", "true", "observability",
       knob="jobHbmSample", source="designer",
       description="per-batch HBM watermark sampling"),
    _K("observability.calibration", "bool", "true", "observability",
       knob="jobCalibration", source="designer",
       description="machine-profile calibration at host start"),
    _K("observability.calibrationfile", "path", None, "observability",
       source="manual", description="pinned machine-profile JSON path"),
    _K("observability.calibrationurl", "url", None, "observability",
       source="manual", description="shared machine-profile store URL"),
    _K("observability.stallewmams", "float", None, "observability",
       knob="jobStallEwmaMs", source="designer", min=0,
       description="stall-EWMA half-life feeding /readyz + the pilot"),
    _K("observability.stallfailms", "float", None, "observability",
       source="manual", min=0,
       description="smoothed stall above this fails readiness"),
    # -- conformance -------------------------------------------------------
    _K("conformance.model", "json", None, "conformance",
       source="generation",
       description="roofline byte/time model artifact (S620 embed)"),
    _K("conformance.latency", "json", None, "conformance", source="manual",
       description="operator latency pin (stage->ms) replacing the "
                   "computed predictions"),
    _K("conformance.window", "int", "16", "conformance", source="manual",
       min=1, description="conformance evaluation window (batches)"),
    _K("conformance.warmup", "int", "4", "conformance", source="manual",
       min=0, description="batches ignored before evaluating"),
    _K("conformance.d2hratiohigh", "float", "1.5", "conformance",
       source="manual", min=0,
       description="observed/predicted D2H bytes alarm ratio"),
    _K("conformance.hbmratiohigh", "float", "1.5", "conformance",
       source="manual", min=0,
       description="observed/predicted HBM watermark alarm ratio"),
    _K("conformance.iciratiohigh", "float", "8.0", "conformance",
       source="manual", min=0,
       description="observed/predicted ICI bytes alarm ratio"),
    _K("conformance.occupancyfactor", "float", "2.0", "conformance",
       source="manual", min=0,
       description="occupancy headroom factor in the time model"),
    _K("conformance.stagetimeratiohigh", "float", "10.0", "conformance",
       source="manual", min=0,
       description="observed/predicted stage-time alarm ratio"),
    _K("conformance.stagetimefloorms", "float", "1.0", "conformance",
       source="manual", min=0,
       description="stage-time floor below which drift is ignored"),
    # -- telemetry ---------------------------------------------------------
    _K("telemetry.tracing", "bool", "true", "telemetry", source="manual",
       description="span flight-recording for the host"),
    _K("telemetry.tracefile", "path", None, "telemetry",
       source="generation",
       description="shared JSONL trace spool (telemetryTraceFile env "
                   "token; one file for control plane + jobs)"),
    _K("telemetry.tracefile.compress", "bool", "false", "telemetry",
       source="manual", description="gzip rotated trace segments"),
    _K("telemetry.tracefile.keep", "int", "1", "telemetry",
       source="manual", min=1,
       description="rotated trace segments kept"),
    _K("telemetry.tracefilemaxbytes", "int", None, "telemetry",
       source="manual", min=1,
       description="trace segment rotation size"),
    _K("telemetry.parenttrace", "string", None, "telemetry",
       source="manual",
       description="parent span context injected by the spawner"),
    _K("telemetry.httppost", "url", None, "telemetry", source="manual",
       description="telemetry event HTTP sink"),
    # -- metric sinks ------------------------------------------------------
    _K("metric.redis", "string", None, "metric", source="template",
       description="redis-analog metric sink: unset/any value keeps the "
                   "in-proc MetricStore (the dashboard feed); "
                   "'false'/'off'/'none'/'disabled' detaches it"),
    _K("metric.eventhub", "string", None, "metric", source="template",
       description="host:port of a MetricsIngestor side-car"),
    _K("metric.httppost", "url", None, "metric", source="template",
       description="metric point HTTP sink (website local mode)"),
    # -- fleet telemetry ---------------------------------------------------
    _K("fleet.publishurl", "url", None, "fleet", source="generation",
       description="object-store URL fleet frames publish to "
                   "(fleetPublishUrl env token)"),
    _K("fleet.replica", "string", None, "fleet", source="manual",
       description="replica lineage label override (r<index> default)"),
    _K("fleet.windowseconds", "float", "10", "fleet", source="manual",
       min=0, description="fleet frame publish window"),
    # -- alerts ------------------------------------------------------------
    _K("alerts.rules", "json", None, "alerts", source="generation",
       description="compiled alert rules artifact (S630 embed)"),
    # -- pilot -------------------------------------------------------------
    _K("pilot.enabled", "bool", "true", "pilot", knob="jobPilot",
       source="designer",
       description="in-host adaptive controller (jobPilot='false' "
                   "writes pilot.enabled=false)"),
    _K("pilot.windowseconds", "float", "5.0", "pilot",
       knob="jobPilotWindowSeconds", source="designer", min=0,
       description="signal evaluation cadence"),
    _K("pilot.cooldownseconds", "float", "15.0", "pilot",
       knob="jobPilotCooldownSeconds", source="designer", min=0,
       description="per-actuator-family min seconds between acts"),
    _K("pilot.budget", "int", "2", "pilot", knob="jobPilotBudget",
       source="designer", min=0,
       description="max actuations applied per window"),
    _K("pilot.mindepth", "int", "1", "pilot", source="manual", min=1,
       description="pipeline-depth actuation floor"),
    _K("pilot.maxdepth", "int", "8", "pilot", knob="jobPilotMaxDepth",
       source="designer", min=1,
       description="pipeline-depth actuation ceiling"),
    _K("pilot.stallhighms", "float", "500.0", "pilot", source="manual",
       min=0, description="smoothed stall above this: depth down"),
    _K("pilot.stalllowms", "float", "50.0", "pilot", source="manual",
       min=0, description="smoothed stall below this: headroom"),
    _K("pilot.backloghigh", "float", "2.0", "pilot", source="manual",
       min=0, description="pending landings >= this: backpressure"),
    _K("pilot.saturationhigh", "float", "0.8", "pilot", source="manual",
       min=0, max=1,
       description="full-poll fraction above this: scale out"),
    _K("pilot.laghighms", "float", "30000.0", "pilot", source="manual",
       min=0, description="source watermark lag: scale out"),
    _K("pilot.malformedhigh", "float", "0.3", "pilot", source="manual",
       min=0, max=1,
       description="malformed/total row ratio: backpressure"),
    _K("pilot.maxreplicas", "int", "4", "pilot",
       knob="jobPilotMaxReplicas", source="designer", min=1,
       description="rescale-up replica ceiling"),
    _K("pilot.minpollfraction", "float", "0.125", "pilot",
       source="manual", min=0, max=1,
       description="backpressure poll-fraction floor"),
    # -- livequery serving plane ------------------------------------------
    _K("lq.maxbatchwaitms", "float", "8.0", "lq",
       knob="jobLqMaxBatchWaitMs", source="designer", min=0,
       description="dispatch-tick coalescing deadline"),
    _K("lq.maxfanin", "int", "64", "lq", knob="jobLqMaxFanin",
       source="designer", min=1,
       description="max requests coalesced per dispatch"),
    _K("lq.exectimeoutseconds", "float", "30.0", "lq", source="manual",
       min=0, description="per-execute deadline"),
    _K("lq.sessionttlseconds", "float", "1800.0", "lq",
       knob="jobLqSessionTtlSeconds", source="designer", min=0,
       description="idle session eviction TTL"),
    _K("lq.hbmbudgetmb", "int", "0", "lq", knob="jobLqHbmBudgetMb",
       source="designer", min=0,
       description="warm-kernel HBM budget (0 = unbounded)"),
    _K("lq.maxsessions", "int", "1024", "lq", knob="jobLqMaxSessions",
       source="designer", min=1, description="global session cap"),
    _K("lq.tenant.maxsessions", "int", "8", "lq",
       knob="jobLqTenantMaxSessions", source="designer", min=1,
       description="per-tenant session cap"),
    _K("lq.tenant.maxqps", "float", "50.0", "lq",
       knob="jobLqTenantMaxQps", source="designer", min=0,
       description="per-tenant execute rate cap"),
    _K("lq.ticker", "bool", None, "lq", source="control",
       description="deadline-tick dispatcher thread (the real server "
                   "defaults it on; tickless in-process otherwise)"),
    # -- jar/external UDFs (template parity) -------------------------------
    _K("jar.udf.*.class", "string", None, "udf", source="template",
       description="registered UDF entry point"),
    _K("jar.udf.*.libs", "list", None, "udf", source="template",
       description="UDF dependency list"),
    _K("jar.udf.*.path", "path", None, "udf", source="template",
       description="UDF module path"),
    _K("jar.udaf.*.class", "string", None, "udf", source="template",
       description="registered UDAF entry point"),
    _K("jar.udaf.*.libs", "list", None, "udf", source="template",
       description="UDAF dependency list"),
    _K("jar.udaf.*.path", "path", None, "udf", source="template",
       description="UDAF module path"),
    _K("azurefunction.*.serviceendpoint", "url", None, "udf",
       source="template", read=False,
       description="external-fn sink endpoint (reference parity; the "
                   "sink plane reads it from the output namespace)"),
    _K("azurefunction.*.api", "string", None, "udf", source="template",
       read=False, description="external-fn API name (reference parity)"),
    _K("azurefunction.*.code", "string", None, "udf", source="template",
       read=False, description="external-fn auth code (reference parity)"),
    _K("azurefunction.*.methodtype", "string", None, "udf",
       source="template", read=False,
       description="external-fn HTTP method (reference parity)"),
    _K("azurefunction.*.params", "string", None, "udf", source="template",
       read=False,
       description="external-fn parameter list (reference parity)"),
)
