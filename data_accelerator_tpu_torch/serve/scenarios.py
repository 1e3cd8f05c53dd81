"""Canned e2e scenario suites over the live REST API.

reference: Tests/DataXScenarios/{SaveAndDeploy,
InteractiveQueryAndSchemaGenScenarios}.cs — [Step]-attributed HTTP
sequences sharing a ScenarioContext, run by ScenarioTester against a
deployed instance and scheduled continuously by Services/JobRunner as
the production liveness probe.

Each suite function returns a Scenario whose steps hit the given base URL
(website or gateway; pass a bearer token for the gateway). Wire into
JobRunner for the scheduled-probe role:

    runner = JobRunner([save_and_deploy(url), schema_and_query(url)])
    runner.start()

A copy of the JAX package's ``serve/scenarios.py``. The REST scenarios
are the reference's, run against the port's REST API
(``serve/restapi.py``). The five chaos drills keep the reference's
steps, signatures and defaults (4 events a poll, depth 2) and build the
port's ``StreamingHost``, ``SocketSource`` and ``pilot/chaos.py``
injectors, with these changes:

- Every drill function takes ``flow`` (a ``DrillFlow``: what the drill's host
  runs, on which device, its poll size and how an event row becomes a
  line; ``chaos_suite`` alone takes a ``device`` and builds the flows).
  The default flow is the reference's own, so a drill at its defaults feeds
  the reference's event counts; a larger flow scales every count by its
  poll, and ``DrillFlow.polls`` may cut a drill's polls.
- Each drill and its host-making helpers record what a caller checks
  after the drill:
  ``ctx["hosts"]`` (every host built), ``ctx["all_sinks"]`` (each
  host's recording sink per output), ``ctx["event_rows"]`` (the valid
  events fed to the first host), ``ctx["n_events"]`` (the valid events
  the whole drill feeds) and ``ctx["actuations"]`` (each asserted pilot action).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from .scenario import Scenario, ScenarioContext

_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False,
     "metadata": {"allowedValues": [1, 2, 3]}},
    {"name": "temperature", "type": "double", "nullable": False,
     "metadata": {"minValue": 0, "maxValue": 100}},
]})


def probe_deploy_gui(flow_name: str = "probe-deploy") -> dict:
    """The SaveAndDeploy probe's flow config — module-level so the
    analyzer self-lint (tests/test_analysis.py) can assert the shipped
    probe stays diagnostics-clean."""
    return {
        "name": flow_name,
        "displayName": "Probe Deploy",
        "input": {"mode": "streaming", "type": "local", "properties": {
            "inputSchemaFile": _SCHEMA,
            "normalizationSnippet": "Raw.*",
        }},
        "process": {"queries": [
            "--DataXQuery--\n"
            "Hot = SELECT deviceId, temperature FROM DataXProcessedInput "
            "WHERE temperature > 50;\n"
            "OUTPUT Hot TO HotConsole;"
        ]},
        "outputs": [{"id": "HotConsole", "type": "console",
                     "properties": {}}],
    }


def shipped_flow_guis() -> list:
    """Every flow config this module ships — the analyzer self-lint
    surface (all must produce zero error diagnostics)."""
    return [probe_deploy_gui()]


def _call(ctx: ScenarioContext, method: str, path: str, body=None):
    url = f"{ctx['base_url'].rstrip('/')}{path}"
    headers = {"Content-Type": "application/json"}
    if ctx.get("token"):
        headers["Authorization"] = f"Bearer {ctx['token']}"
    req = urllib.request.Request(
        url,
        data=json.dumps(body).encode() if body is not None else None,
        headers=headers,
        method=method,
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        payload = json.loads(r.read() or b"{}")
    return payload.get("result", payload)


def save_and_deploy(
    base_url: str,
    flow_name: str = "probe-deploy",
    token: Optional[str] = None,
    batches: int = 2,
) -> Scenario:
    """Save flow -> generate configs -> start -> jobs running -> stop ->
    delete (reference: SaveAndDeploy.cs over FlowManagementController)."""
    sc = Scenario(f"SaveAndDeploy")

    @sc.step
    def init_context(ctx):
        ctx.setdefault("base_url", base_url)
        ctx.setdefault("token", token)

    @sc.step
    def save_flow(ctx):
        r = _call(ctx, "POST", "/api/flow/flow/save",
                  probe_deploy_gui(flow_name))
        assert r.get("name") == flow_name, r

    @sc.step
    def generate_configs(ctx):
        r = _call(ctx, "POST", "/api/flow/flow/generateconfigs",
                  {"flowName": flow_name})
        assert r.get("jobNames"), r
        ctx["jobNames"] = r["jobNames"]

    @sc.step
    def start_jobs(ctx):
        r = _call(ctx, "POST", "/api/flow/flow/startjobs",
                  {"flowName": flow_name, "batches": batches})
        assert len(r) == len(ctx["jobNames"]), r

    @sc.step
    def jobs_reach_terminal_state(ctx):
        deadline = time.time() + 60
        states = {}
        while time.time() < deadline:
            jobs = _call(ctx, "POST", "/api/flow/job/getbynames",
                         {"jobNames": ctx["jobNames"]})
            states = {j["name"]: j.get("state") for j in jobs if j}
            if states and all(s in ("idle", "success")
                              for s in states.values()):
                return  # finite-batch run completed
            if any(s == "error" for s in states.values()):
                raise AssertionError(f"job failed: {states}")
            _call(ctx, "POST", "/api/flow/job/syncall", {})
            time.sleep(1)
        raise AssertionError(f"jobs never settled: {states}")

    @sc.step
    def stop_and_delete(ctx):
        _call(ctx, "POST", "/api/flow/flow/stopjobs", {"flowName": flow_name})
        r = _call(ctx, "POST", "/api/flow/flow/delete", {"flowName": flow_name})
        assert r.get("deleted") is True, r

    return sc


def schema_and_query(
    base_url: str,
    flow_name: str = "probe-query",
    token: Optional[str] = None,
) -> Scenario:
    """Infer schema from sampled events -> create kernel -> execute a
    query -> recycle (reference: InteractiveQueryAndSchemaGenScenarios)."""
    sc = Scenario("SchemaAndQuery")

    @sc.step
    def init_context(ctx):
        ctx.setdefault("base_url", base_url)
        ctx.setdefault("token", token)

    @sc.step
    def infer_schema(ctx):
        events = [{"deviceId": i % 3, "temperature": 10.0 * i} for i in range(20)]
        r = _call(ctx, "POST", "/api/schemainference/inputdata/inferschema",
                  {"name": flow_name, "events": events})
        schema = r.get("Schema") or r.get("schema")
        assert schema, r
        ctx["schema"] = schema if isinstance(schema, str) else json.dumps(schema)

    @sc.step
    def create_kernel(ctx):
        r = _call(ctx, "POST", "/api/interactivequery/kernel",
                  {"name": flow_name, "inputSchema": ctx["schema"]})
        assert r.get("kernelId"), r
        ctx["kernelId"] = r["kernelId"]

    @sc.step
    def execute_query(ctx):
        r = _call(ctx, "POST", "/api/interactivequery/kernel/executequery", {
            "kernelId": ctx["kernelId"],
            "query": "--DataXQuery--\nT = SELECT deviceId, "
                     "COUNT(*) AS c FROM DataXProcessedInput GROUP BY deviceId",
            "maxRows": 10,
        })
        assert r.get("result"), r

    @sc.step
    def recycle_kernel(ctx):
        r = _call(ctx, "POST", "/api/interactivequery/kernel/delete",
                  {"kernelId": ctx["kernelId"]})
        assert r.get("deleted") is True, r

    return sc


def default_suite(base_url: str, token: Optional[str] = None):
    """The JobRunner's standing probe set (DataXDeployJob analog)."""
    return [
        save_and_deploy(base_url, token=token),
        schema_and_query(base_url, token=token),
    ]




# ---------------------------------------------------------------------------
# Chaos scenario suite (ROADMAP item 5): in-process fault drills over a
# live StreamingHost, each asserting exactly-once-per-window recovery
# with the pilot DISABLED (baseline survives) and — pilot ENABLED —
# additionally that the expected actuation fired (pilot/chaos.py holds
# the injectors; the tier-1 suite runs these at depth 2).
# ---------------------------------------------------------------------------
_CHAOS_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
    {"name": "seq", "type": "long", "nullable": False, "metadata": {}},
]})

_CHAOS_TRANSFORM = (
    "--DataXQuery--\n"
    "Out = SELECT k, v, seq FROM DataXProcessedInput\n"
    "--DataXQuery--\n"
    "Hot = SELECT k, COUNT(*) AS c FROM DataXProcessedInput GROUP BY k\n"
)


@dataclass
class DrillFlow:
    """What a drill's host runs. ``poll``: events a poll takes;
    ``capacity``: the batch capacity; ``outputs``: every output, each
    given a recording sink (``Out`` is the exactly-once witness and
    carries ``seq``); ``line``: one event row ``{"k", "v", "seq"}`` as a
    JSON line (default: the row itself); ``udfs``: the UDF objects the
    host takes; ``extra``: more conf; ``polls``: polls' worth of events
    a drill feeds, by drill, where it feeds fewer than the reference;
    ``timeout_s``: a drain's time limit (a replica group's is twice
    it). The defaults are the reference drills' own flow."""

    poll: int = 4
    capacity: int = 8
    schema: str = _CHAOS_SCHEMA
    transform: str = _CHAOS_TRANSFORM
    outputs: Tuple[str, ...] = ("Out", "Hot")
    line: Optional[Callable[[dict], str]] = None
    udfs: Optional[dict] = None
    device: str = "cuda"
    extra: Optional[dict] = None
    polls: Optional[dict] = None
    timeout_s: float = 30.0

    def events(self, drill: str, polls: int) -> int:
        """The events ``drill`` feeds: ``polls`` polls' worth (the
        reference's count at 4 events a poll) unless ``polls`` cuts
        it."""
        return (self.polls or {}).get(drill, polls) * self.poll

    def payload(self, rows) -> bytes:
        line = self.line or json.dumps
        return b"".join(line(r).encode() + b"\n" for r in rows)

    def malformed(self, rows, flood_ratio: float) -> bytes:
        """``pilot/chaos.py::malformed_payload`` with each valid line in
        the flow's own form."""
        from ..pilot.chaos import malformed_payload

        payload = malformed_payload(rows, flood_ratio=flood_ratio)
        if self.line is None:
            return payload
        return b"".join(
            (self.line(json.loads(ln)).encode()
             if ln.startswith(b'{"k": ') and ln.endswith(b"}") else ln) + b"\n"
            for ln in payload.split(b"\n")[:-1]
        )


def _chaos_events(n: int) -> list:
    return [{"k": i % 4, "v": float(i), "seq": i} for i in range(n)]


def _feed(ctx, payload: bytes, n_lines: int, src=None) -> None:
    from ..pilot.chaos import feed_socket

    feed_socket(src if src is not None else ctx["src"], payload,
                expect_events=n_lines, timeout_s=max(5.0, n_lines / 2e5))


def _pilot_conf(conf: dict, pilot: bool, pilot_conf: Optional[dict]) -> None:
    if pilot:
        # tight loop knobs so evaluation windows elapse inside a drill
        conf.update({
            "datax.job.process.pilot.windowseconds": "0.02",
            "datax.job.process.pilot.cooldownseconds": "0.02",
            "datax.job.process.observability.stallewmams": "200",
        })
        for k, v in (pilot_conf or {}).items():
            conf[f"datax.job.process.pilot.{k}"] = str(v)
    else:
        conf["datax.job.process.pilot.enabled"] = "false"


def _host_over(ctx, conf: dict, flow: DrillFlow, src=None):
    """A StreamingHost over ``conf`` on the flow's device with a
    RecordingSink on every output, recorded in the context."""
    from ..core.config import SettingDictionary
    from ..pilot.chaos import RecordingSink
    from ..runtime.host import StreamingHost
    from ..runtime.sources import SocketSource

    if src is None:
        src = SocketSource(port=0)
    host = StreamingHost(SettingDictionary(conf), source=src, udfs=flow.udfs,
                         device=flow.device)
    sinks = {}
    for out in flow.outputs:
        sinks[out] = RecordingSink()
        host.dispatcher.operators[out].sinks = [sinks[out]]
    if "Hot" in sinks:
        ctx["hot_sink"] = sinks["Hot"]
    ctx["host"], ctx["src"], ctx["sink"] = host, src, sinks["Out"]
    ctx.setdefault("sinks", []).append(sinks["Out"])
    ctx.setdefault("all_sinks", []).append(sinks)
    ctx.setdefault("hosts", []).append(host)
    ctx["tracefile"] = conf["datax.job.process.telemetry.tracefile"]
    return host


def _build_chaos_host(ctx, name: str, pilot: bool, depth: int = 2,
                      pilot_conf: Optional[dict] = None,
                      reuse_source: bool = False,
                      flow: Optional[DrillFlow] = None):
    """One socket-fed StreamingHost with a RecordingSink on every output
    — the shared fixture every chaos scenario drills. ``ctx['workdir']``
    is the only required input. ``reuse_source`` rebuilds the host over
    the surviving source (the preemption-recovery 'new process')."""
    import os

    flow = flow or DrillFlow()
    workdir = ctx["workdir"]
    tpath = os.path.join(workdir, "chaos.transform")
    if not os.path.exists(tpath):
        with open(tpath, "w", encoding="utf-8") as f:
            f.write(flow.transform)
    conf = {
        "datax.job.name": name,
        "datax.job.input.default.blobschemafile": flow.schema,
        "datax.job.input.default.eventhub.maxrate": str(flow.poll),
        "datax.job.input.default.eventhub.checkpointdir": os.path.join(
            workdir, "ckpt"
        ),
        "datax.job.input.default.eventhub.checkpointinterval": "0 second",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.transform": tpath,
        "datax.job.process.batchcapacity": str(flow.capacity),
        "datax.job.process.pipeline.depth": str(depth),
        # every chaos drill runs with the buffer sanitizer armed: the
        # crash/rescale/outage churn is the exact regime where an
        # escaped pooled view would surface, and the drills assert it
        # stays silent (zero DX805 poison hits)
        "datax.job.process.debug.buffersanitizer": "true",
        # ... and with the protocol monitor armed: the same churn is
        # where an ack-before-durability reorder would surface, and
        # the drills assert zero DX906 protocol violations
        "datax.job.process.debug.protocolmonitor": "true",
        "datax.job.process.telemetry.tracefile": os.path.join(
            workdir, "trace.jsonl"
        ),
        **{f"datax.job.output.{o}.console.maxrows": "0" for o in flow.outputs},
        **(flow.extra or {}),
    }
    _pilot_conf(conf, pilot, pilot_conf)
    src = ctx["src"] if reuse_source and ctx.get("src") is not None else None
    return _host_over(ctx, conf, flow, src)


def _delivered(ctx) -> list:
    return [
        seq for sink in ctx.get("sinks", []) for seq in sink.values("seq")
    ]


def _assert_exactly_once(ctx, n: int) -> None:
    seqs = _delivered(ctx)
    assert sorted(seqs) == list(range(n)), (
        f"exactly-once violated: {len(seqs)} deliveries of {n} events; "
        f"dupes/losses over {sorted(set(range(n)) ^ set(seqs))[:10]}"
    )


def _assert_pilot_reacted(ctx, action: str, host=None) -> None:
    """Pilot-on acceptance: the expected actuation fired, the
    Pilot_Actuations_Count series is > 0, and the actuation is visible
    as a ``pilot/decide`` span in the flight recorder. ``host``
    overrides ``ctx['host']`` for drills that rotate hosts (the
    rescale handoff asserts against the PREDECESSOR's pilot)."""
    host = host if host is not None else ctx["host"]
    pilot = host.pilot
    assert pilot is not None
    applied = [
        d for d in ctx.get("applied_decisions", [])
        if d.applied and d.action == action
    ]
    assert applied, (
        f"no applied '{action}' actuation; decisions="
        f"{[(d.rule, d.action, d.suppressed) for d in ctx.get('applied_decisions', [])]}"
    )
    pts = host.metric_logger.store.points(
        host.metric_logger.key("Pilot_Actuations_Count")
    )
    assert pts and float(pts[-1]["val"]) > 0, "Pilot_Actuations_Count not > 0"
    spans = []
    with open(ctx["tracefile"], encoding="utf-8") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("type") == "span" and rec.get("name") == "pilot/decide":
                spans.append(rec)
    acted = [
        s for s in spans
        if s.get("properties", {}).get("applied")
        and s["properties"].get("action") == action
    ]
    assert acted, f"no applied pilot/decide span for '{action}'"
    ctx.setdefault("actuations", []).append(action)


def _drain(ctx, host, expect_total: int, chunk: int = 4,
           timeout_s: float = 30.0):
    """Run the pipelined loop in chunks until every expected event has
    landed (backpressure may shrink polls, so a fixed batch count can't
    know when the stream is drained), accumulating every pilot
    decision along the way. If the drain finished before an evaluation
    window ever elapsed, evaluate once directly — the signals (all
    EWMAs) are still live; only the wall-clock cadence is forced."""
    collected = ctx.setdefault("applied_decisions", [])
    pilot = host.pilot
    orig_evaluate = pilot.evaluate if pilot is not None else None

    def evaluate(*a, **k):
        ds = orig_evaluate(*a, **k)
        collected.extend(ds)
        return ds

    if pilot is not None:
        pilot.evaluate = evaluate
    try:
        deadline = time.time() + timeout_s
        while len(_delivered(ctx)) < expect_total:
            # max_batches counts batches over the host's LIFETIME, so
            # each chunk extends the allowance past what's done
            host.run_pipelined(
                max_batches=host.batches_processed + chunk
            )
            if time.time() > deadline:
                raise AssertionError(
                    f"drain timed out: {len(_delivered(ctx))}/"
                    f"{expect_total} delivered"
                )
        if pilot is not None and not any(d.applied for d in collected):
            evaluate()
    finally:
        if pilot is not None:
            pilot.evaluate = orig_evaluate


def chaos_preemption(pilot: bool = False, depth: int = 2,
                     flow: Optional[DrillFlow] = None) -> Scenario:
    """Job kill/restart mid-window: the 3rd dispatch dies with batches
    in flight (preemption analog), a fresh host over the same
    checkpoint dir + requeued source recovers, and every event lands
    exactly once. Pilot-on: the recovery backlog saturates ingest at
    the depth ceiling -> the pilot asks for a replica
    (``rescale-up`` through a ScaleActuator, vetted path)."""
    flow = flow or DrillFlow()
    sc = Scenario(f"ChaosPreemption{'Pilot' if pilot else ''}")
    n_events = flow.events("preemption", 8)

    @sc.step
    def build_host(ctx):
        _build_chaos_host(
            ctx, "ChaosPreemptP" if pilot else "ChaosPreemptB", pilot, depth,
            # cap depth so sustained saturation escalates to rescale
            pilot_conf={"maxdepth": depth, "saturationhigh": "0.5"},
            flow=flow,
        )

    @sc.step
    def feed_events(ctx):
        ctx["event_rows"] = _chaos_events(n_events)
        ctx["n_events"] = n_events
        _feed(ctx, flow.payload(ctx["event_rows"]), n_events)

    @sc.step
    def preempt_mid_window(ctx):
        from ..pilot.chaos import ChaosFault, PreemptionInjector

        inj = PreemptionInjector(kill_at_dispatch=3)
        inj.arm(ctx["host"])
        try:
            ctx["host"].run_pipelined(max_batches=n_events // flow.poll)
        except ChaosFault:
            ctx["preempted"] = True
        finally:
            inj.disarm()
            # the 'killed process': tear down without closing the
            # source — the successor host takes it over
            ctx["host"].stop(close_sources=False)
        assert ctx.get("preempted"), "injector never fired"

    @sc.step
    def recover_with_fresh_host(ctx):
        from ..pilot.controller import ScaleActuator
        from ..pilot.chaos import RecordingRescaler

        ctx["src"].requeue_unacked()
        host = _build_chaos_host(
            ctx, "ChaosPreemptP" if pilot else "ChaosPreemptB", pilot, depth,
            pilot_conf={"maxdepth": depth, "saturationhigh": "0.5"},
            reuse_source=True, flow=flow,
        )
        if pilot and host.pilot is not None:
            scaler = ctx["scaler"] = RecordingRescaler()
            act = ScaleActuator(scaler, "ChaosPreempt", max_replicas=4)
            for kind in act.kinds:
                host.pilot.actuators[kind] = act
        _drain(ctx, host, n_events, timeout_s=flow.timeout_s)
        host.stop()

    @sc.step
    def assert_recovered_exactly_once(ctx):
        _assert_exactly_once(ctx, n_events)

    if pilot:
        @sc.step
        def assert_pilot_rescaled(ctx):
            _assert_pilot_reacted(ctx, "rescale-up")
            assert ctx["scaler"].calls and ctx["scaler"].calls[0] >= 2

    return sc


def chaos_sink_outage(pilot: bool = False, depth: int = 2,
                      flow: Optional[DrillFlow] = None) -> Scenario:
    """Sink outage: a hard outage mid-window fails the batch — the
    whole un-acked window requeues (FIFO commit holds) — then the sink
    comes back SLOW (brown-out): landings queue behind the dispatch
    loop and, pilot-on, the landing-backlog signal engages source
    backpressure (the token bucket shrinks polls)."""
    flow = flow or DrillFlow()
    sc = Scenario(f"ChaosSinkOutage{'Pilot' if pilot else ''}")
    n_events = flow.events("sink-outage", 6)

    @sc.step
    def build_host(ctx):
        _build_chaos_host(ctx, "ChaosSinkP" if pilot else "ChaosSinkB", pilot, depth,
                          pilot_conf={"backloghigh": "2"}, flow=flow)

    @sc.step
    def feed_events(ctx):
        ctx["event_rows"] = _chaos_events(n_events)
        ctx["n_events"] = n_events
        _feed(ctx, flow.payload(ctx["event_rows"]), n_events)

    @sc.step
    def hard_outage_requeues_window(ctx):
        from ..pilot.chaos import ChaosFault, SinkOutageInjector

        inj = SinkOutageInjector(fail=True)
        inj.arm(ctx["host"])
        try:
            ctx["host"].run_pipelined(max_batches=n_events // flow.poll)
        except ChaosFault:
            ctx["outage_hit"] = True
        finally:
            inj.disarm()
        assert ctx.get("outage_hit"), "outage never hit a write"
        ctx["src"].requeue_unacked()

    @sc.step
    def brownout_recovery(ctx):
        from ..pilot.chaos import SinkOutageInjector

        inj = SinkOutageInjector(delay_s=0.08)
        inj.arm(ctx["host"])
        try:
            _drain(ctx, ctx["host"], n_events, timeout_s=flow.timeout_s)
        finally:
            inj.disarm()
            ctx["host"].stop()

    @sc.step
    def assert_recovered_exactly_once(ctx):
        _assert_exactly_once(ctx, n_events)

    if pilot:
        @sc.step
        def assert_pilot_backpressured(ctx):
            _assert_pilot_reacted(ctx, "backpressure")

    return sc


def chaos_hot_key_skew(pilot: bool = False, depth: int = 2,
                       flow: Optional[DrillFlow] = None) -> Scenario:
    """Hot-key skew: 90% of events hammer one group key and the device
    step slows under the serialized hot group (DeviceSlowdownInjector
    models the skewed groupby scan) — the dispatch loop stalls on the
    window's oldest batch. Pilot-on: the smoothed stall (the SAME
    conf'd EWMA /readyz judges) crosses ``stallhighms`` and the pilot
    drops pipeline depth, draining the window FIFO-first."""
    flow = flow or DrillFlow()
    sc = Scenario(f"ChaosHotKeySkew{'Pilot' if pilot else ''}")
    n_events = flow.events("hot-key-skew", 8)

    @sc.step
    def build_host(ctx):
        _build_chaos_host(ctx, "ChaosSkewP" if pilot else "ChaosSkewB", pilot, depth,
                          pilot_conf={"stallhighms": "20"}, flow=flow)

    @sc.step
    def feed_skewed_events(ctx):
        from ..pilot.chaos import skewed_events

        rows = ctx["event_rows"] = skewed_events(
            n_events, hot_key=0, hot_fraction=0.9)
        ctx["n_events"] = n_events
        _feed(ctx, flow.payload(rows), n_events)

    @sc.step
    def run_under_skew(ctx):
        from ..pilot.chaos import DeviceSlowdownInjector

        inj = DeviceSlowdownInjector(extra_s=0.06)
        inj.arm(ctx["host"])
        try:
            _drain(ctx, ctx["host"], n_events, timeout_s=flow.timeout_s)
        finally:
            inj.disarm()
            ctx["host"].stop()

    @sc.step
    def assert_exactly_once_under_skew(ctx):
        _assert_exactly_once(ctx, n_events)

    if pilot:
        @sc.step
        def assert_pilot_dropped_depth(ctx):
            _assert_pilot_reacted(ctx, "depth-down")
            assert ctx["host"].live_depth() < depth, (
                f"depth still {ctx['host'].live_depth()}"
            )

    return sc


def chaos_malformed_flood(pilot: bool = False, depth: int = 2,
                          flow: Optional[DrillFlow] = None) -> Scenario:
    """Malformed-input flood: half the stream is garbage (truncated
    JSON, binary noise). The decoders skip bad lines — every VALID
    event still lands exactly once — and, pilot-on, the malformed-rate
    signal engages backpressure so the host stops burning batch
    capacity decoding garbage at full rate."""
    flow = flow or DrillFlow()
    sc = Scenario(f"ChaosMalformedFlood{'Pilot' if pilot else ''}")
    n_valid = flow.events("malformed-flood", 4)

    @sc.step
    def build_host(ctx):
        _build_chaos_host(ctx, "ChaosFloodP" if pilot else "ChaosFloodB", pilot, depth,
                          pilot_conf={"malformedhigh": "0.3"}, flow=flow)

    @sc.step
    def feed_flood(ctx):
        ctx["event_rows"] = _chaos_events(n_valid)
        ctx["n_events"] = n_valid
        payload = flow.malformed(ctx["event_rows"], flood_ratio=0.5)
        ctx["total_lines"] = payload.count(b"\n")
        _feed(ctx, payload, ctx["total_lines"])

    @sc.step
    def run_through_flood(ctx):
        _drain(ctx, ctx["host"], n_valid, timeout_s=flow.timeout_s)
        ctx["host"].stop()

    @sc.step
    def assert_valid_events_exactly_once(ctx):
        _assert_exactly_once(ctx, n_valid)

    if pilot:
        @sc.step
        def assert_pilot_backpressured(ctx):
            _assert_pilot_reacted(ctx, "backpressure")

    return sc


# ---------------------------------------------------------------------------
# Rescale-with-state chaos drill (the elastic stateful rescale proof):
# a stateful TIMEWINDOW + accumulator flow is rescaled MID-WINDOW —
# up (1 -> 2 replicas) then down (2 -> 1) — with a snapshot corruption
# injected between predecessor stop and successor load. Every event
# must land exactly once ACROSS the whole replica lineage, partitioned
# state must follow the replicas through the objstore mirror, and the
# corrupted partition must recover via the standby side (DX530).
# ---------------------------------------------------------------------------
_STATE_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
    {"name": "seq", "type": "long", "nullable": False, "metadata": {}},
]})

_STATE_TRANSFORM = (
    "--DataXQuery--\n"
    "merged = SELECT k, v FROM DataXProcessedInput "
    "UNION ALL SELECT k, v FROM seen\n"
    "--DataXQuery--\n"
    "seen = SELECT k, MAX(v) AS v FROM merged GROUP BY k\n"
    "--DataXQuery--\n"
    "Out = SELECT k, v, seq FROM DataXProcessedInput\n"
    "--DataXQuery--\n"
    "Win = SELECT k, COUNT(*) AS c "
    "FROM DataXProcessedInput_30seconds GROUP BY k\n"
)

_STATE_KEYS = 8
_STATE_PARTS = 8


def state_drill_flow(poll: int = 4, device: str = "cuda") -> DrillFlow:
    """The rescale drill's stateful flow: a 30 s window ring and the
    ``seen`` MAX accumulator, ``poll`` events a poll (the reference's
    4 by default) into a batch of twice that."""
    return DrillFlow(poll=poll, capacity=2 * poll, schema=_STATE_SCHEMA,
                     transform=_STATE_TRANSFORM, outputs=("Out", "Win"),
                     device=device)


def _state_events(lo: int, hi: int) -> list:
    return [
        {"k": i % _STATE_KEYS, "v": float(i), "seq": i}
        for i in range(lo, hi)
    ]


def _state_max(hi: int) -> dict:
    """Each key's MAX(v) over events 0..hi-1 (``v`` is the event id)."""
    return {k: float(max(i for i in range(hi) if i % _STATE_KEYS == k))
            for k in range(_STATE_KEYS)}


def _build_stateful_host(ctx, name: str, pilot: bool, depth: int,
                         replica_index: int = 1, replica_count: int = 1,
                         gen: int = 0, pilot_conf: Optional[dict] = None,
                         src=None, flow: Optional[DrillFlow] = None):
    """One socket-fed stateful host: TIMEWINDOW ring + `seen` MAX
    accumulator, state hashed onto ``_STATE_PARTS`` key-range
    partitions mirrored through the scenario's live object store.
    ``gen`` isolates checkpoint/state dirs per host INSTANCE, so a
    successor's only route to predecessor state is the partition
    handoff through the mirror — exactly the cross-host shape."""
    import os

    flow = flow or state_drill_flow()
    workdir = ctx["workdir"]
    tpath = os.path.join(workdir, "state.transform")
    if not os.path.exists(tpath):
        with open(tpath, "w", encoding="utf-8") as f:
            f.write(flow.transform)
    hostdir = os.path.join(workdir, f"g{gen}-r{replica_index}")
    conf = {
        "datax.job.name": name,
        "datax.job.input.default.blobschemafile": flow.schema,
        "datax.job.input.default.eventhub.maxrate": str(flow.poll),
        "datax.job.input.default.eventhub.checkpointdir": os.path.join(
            hostdir, "ckpt"
        ),
        "datax.job.input.default.eventhub.checkpointinterval": "0 second",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.timestampcolumn": "ts",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.transform": tpath,
        "datax.job.process.batchcapacity": str(flow.capacity),
        "datax.job.process.pipeline.depth": str(depth),
        "datax.job.process.timewindow.DataXProcessedInput_30seconds"
        ".windowduration": "30 seconds",
        "datax.job.process.statetable.seen.schema": "k long, v double",
        "datax.job.process.statetable.seen.location": os.path.join(
            hostdir, "state", "seen"
        ),
        "datax.job.process.state.partitions": str(_STATE_PARTS),
        "datax.job.process.state.partitionkey": "k",
        "datax.job.process.state.replicaindex": str(replica_index),
        "datax.job.process.state.replicacount": str(replica_count),
        "datax.job.process.state.snapshoturl": ctx["store_url"],
        "datax.job.process.state.filteringest": "true",
        # fleet telemetry plane: every drill host publishes frames to
        # the scenario's live store (windowseconds=0 -> one frame per
        # batch), so the rescale lineage is observable as ONE fleet
        # series across generations
        "datax.job.process.fleet.publishurl": ctx["store_url"],
        "datax.job.process.fleet.windowseconds": "0",
        "datax.job.process.fleet.replica": f"g{gen}-r{replica_index}",
        # every drill runs with the DX805 buffer sanitizer armed: the
        # rescale handoff churn must not leak a pooled view
        "datax.job.process.debug.buffersanitizer": "true",
        # ... and the DX906 protocol monitor: the successor host must
        # hold the delivery ordering batch by batch too
        "datax.job.process.debug.protocolmonitor": "true",
        "datax.job.process.telemetry.tracefile": os.path.join(
            workdir, "trace.jsonl"
        ),
        **{f"datax.job.output.{o}.console.maxrows": "0" for o in flow.outputs},
        **(flow.extra or {}),
    }
    _pilot_conf(conf, pilot, pilot_conf)
    return _host_over(ctx, conf, flow, src)


def _drain_remaining_payload(src, chunk: int = 1000) -> bytes:
    """Everything a stopped predecessor's source still holds —
    requeued un-acked batches plus never-polled buffer — as one raw
    payload (the events a key-routed rebalance re-delivers)."""
    src.requeue_unacked()
    chunks = []
    while True:
        blob, n, _offsets = src.poll_raw(chunk)
        if n == 0:
            break
        chunks.append(blob)
    src.close()
    return b"".join(chunks)


def _drain_group(ctx, hosts, expect_total: int, chunk: int = 2,
                 timeout_s: float = 60.0) -> None:
    """Run a replica GROUP in round-robin chunks until every expected
    event has landed across the lineage's sinks."""
    deadline = time.time() + timeout_s
    while len(_delivered(ctx)) < expect_total:
        for h in hosts:
            h.run_pipelined(max_batches=h.batches_processed + chunk)
        if time.time() > deadline:
            raise AssertionError(
                f"group drain timed out: {len(_delivered(ctx))}/"
                f"{expect_total} delivered"
            )


def _loaded_state_map(host) -> dict:
    """The `seen` accumulator a replica PERSISTED (its owned
    partitions), reloaded from disk: {k: max v}."""
    import numpy as np

    t = host.processor.state_tables["seen"].load(host.processor.dictionary)
    cols = {c: np.asarray(v.cpu()) for c, v in t.cols.items()}
    return {
        int(k): float(v)
        for k, v, ok in zip(cols["k"], cols["v"], np.asarray(t.valid.cpu()))
        if ok
    }


def chaos_rescale_with_state(pilot: bool = False, depth: int = 2,
                             flow: Optional[DrillFlow] = None) -> Scenario:
    """Elastic stateful rescale, chaos-proven: a stateful flow
    (TIMEWINDOW ring + `seen` accumulator on 8 key-range partitions)
    is rescaled mid-window — up to two replicas, later back down to
    one — with every partition's ACTIVE state snapshot corrupted in
    the store between predecessor stop and successor load. Successors
    pull only their assigned partitions (windows merged, accumulators
    reloaded, corruption recovered via the standby side + un-acked
    replay), the key-routed ingest filter splits the remaining stream
    exactly once across the new replica group, and the whole lineage
    delivers every event exactly once. Pilot-on: the predecessor's
    sustained saturation drives a ``rescale-up`` actuation through the
    vetted ScaleActuator path before the handoff."""
    flow = flow or state_drill_flow()
    sc = Scenario(f"ChaosRescaleState{'Pilot' if pilot else ''}")
    n_pre = 6 * flow.poll    # events fed to the predecessor
    n_tail = 2 * flow.poll   # events fed after the scale-down
    n_kill = flow.poll       # events fed to the generation killed undrained
    expected_final = _state_max(n_pre + n_tail)
    chunk = max(1000, 4 * flow.poll)
    group_timeout_s = 2 * flow.timeout_s

    @sc.step
    def start_store(ctx):
        from .objectstore import ObjectStoreServer

        store = ObjectStoreServer(port=0).start()  # in-memory
        ctx["store"] = store
        scn = f"rescale-{'p' if pilot else 'b'}-d{depth}"
        ctx["store_url"] = (
            f"objstore://127.0.0.1:{store.port}/chaos/{scn}"
        )

    @sc.step
    def build_predecessor(ctx):
        _build_stateful_host(
            ctx, "RescaleStateP" if pilot else "RescaleStateB", pilot,
            depth, gen=0,
            pilot_conf={"maxdepth": depth, "saturationhigh": "0.5"},
            flow=flow,
        )

    @sc.step
    def feed_events(ctx):
        ctx["event_rows"] = _state_events(0, n_pre)
        ctx["n_events"] = n_pre + n_tail + n_kill
        _feed(ctx, flow.payload(ctx["event_rows"]), n_pre)

    @sc.step
    def run_until_mid_window(ctx):
        host = ctx["host"]
        collected = ctx.setdefault("applied_decisions", [])
        if pilot and host.pilot is not None:
            from ..pilot.chaos import RecordingRescaler
            from ..pilot.controller import ScaleActuator

            scaler = ctx["scaler"] = RecordingRescaler()
            act = ScaleActuator(scaler, "RescaleState", max_replicas=4)
            for kind in act.kinds:
                host.pilot.actuators[kind] = act
            orig_evaluate = host.pilot.evaluate

            def evaluate(*a, **k):
                ds = orig_evaluate(*a, **k)
                collected.extend(ds)
                return ds

            host.pilot.evaluate = evaluate
        # a few batches into the 30 s window, then 'preempt' for the
        # rescale: well under n_pre events processed — state + window
        # rings hold committed history the successors must inherit
        host.run_pipelined(max_batches=host.batches_processed + 3)
        if pilot and host.pilot is not None and not any(
            d.applied and d.action == "rescale-up" for d in collected
        ):
            host.pilot.evaluate()
        ctx["pilot_host"] = host
        ctx["pre_delivered"] = len(_delivered(ctx))
        assert 0 < ctx["pre_delivered"] < n_pre, ctx["pre_delivered"]
        host.stop(close_sources=False)

    @sc.step
    def corrupt_partitions_mid_handoff(ctx):
        from ..pilot.chaos import PartitionLossInjector

        inj = PartitionLossInjector(
            store_url=ctx["store_url"], table="seen", mode="truncate",
        )
        assert inj.corrupt(), "no active state snapshots to corrupt"
        ctx["corrupted"] = inj.corrupted

    @sc.step
    def rescale_up_handoff(ctx):
        payload = _drain_remaining_payload(ctx["src"], chunk)
        name = "RescaleStateP" if pilot else "RescaleStateB"
        b1 = _build_stateful_host(ctx, name, pilot=False, depth=depth,
                                  replica_index=1, replica_count=2, gen=1,
                                  flow=flow)
        src1 = ctx["src"]
        b2 = _build_stateful_host(ctx, name, pilot=False, depth=depth,
                                  replica_index=2, replica_count=2, gen=1,
                                  flow=flow)
        src2 = ctx["src"]
        ctx["successors"] = [b1, b2]
        # the successors inherited the windows through the partition
        # handoff (fresh local dirs — the mirror was the only route)
        assert b1.window_restored_from == "partitions", (
            b1.window_restored_from
        )
        assert b2.window_restored_from == "partitions", (
            b2.window_restored_from
        )
        # the corrupted active sides were recovered via standby (DX530)
        fallbacks = (
            b1.processor.state_stats.get("LoadFallback_Count", 0)
            + b2.processor.state_stats.get("LoadFallback_Count", 0)
        )
        assert fallbacks >= 1, "corruption never hit the loaders"
        # BOTH successors get the FULL remaining stream; the key-routed
        # ingest filter must split it exactly once across the group
        n_lines = payload.count(b"\n")
        if n_lines:
            _feed(ctx, payload, n_lines, src1)
            _feed(ctx, payload, n_lines, src2)
        _drain_group(ctx, [b1, b2], n_pre, timeout_s=group_timeout_s)
        for h in (b1, b2):
            h.stop()

    @sc.step
    def assert_scaled_up_exactly_once(ctx):
        _assert_exactly_once(ctx, n_pre)
        # partitioned accumulators followed the replicas: the merged
        # owned-partition state of the group equals the full-stream MAX
        merged = {}
        for h in ctx["successors"]:
            merged.update(_loaded_state_map(h))
        expect = _state_max(n_pre)
        assert merged == expect, f"state diverged: {merged} != {expect}"

    @sc.step
    def rescale_down_handoff(ctx):
        name = "RescaleStateP" if pilot else "RescaleStateB"
        c = _build_stateful_host(ctx, name, pilot=False, depth=depth,
                                 replica_index=1, replica_count=1, gen=2,
                                 flow=flow)
        # scale-down merge: C's windows come from TWO predecessors'
        # partition pushes (re-packed per slot, bases rebased)
        assert c.window_restored_from == "partitions", (
            c.window_restored_from
        )
        _feed(ctx, flow.payload(_state_events(n_pre, n_pre + n_tail)), n_tail)
        _drain_group(ctx, [c], n_pre + n_tail, timeout_s=group_timeout_s)
        ctx["final_host"] = c
        c.stop()

    @sc.step
    def assert_final_exactly_once_and_state(ctx):
        _assert_exactly_once(ctx, n_pre + n_tail)
        final = _loaded_state_map(ctx["final_host"])
        assert final == expected_final, (
            f"final state diverged: {final} != {expected_final}"
        )

    @sc.step
    def kill_replica_without_drain(ctx):
        # one more generation, killed WITHOUT a drain: its frames are
        # published (balanced ingested==emitted per acked batch) but
        # the final-frame marker is suppressed — the fleet view must
        # call that replica stale (DX542), not lost data (DX540)
        name = "RescaleStateP" if pilot else "RescaleStateB"
        d = _build_stateful_host(ctx, name, pilot=False, depth=depth,
                                 replica_index=1, replica_count=1, gen=3,
                                 flow=flow)
        total = n_pre + n_tail + n_kill
        _feed(ctx, flow.payload(_state_events(n_pre + n_tail, total)), n_kill)
        _drain_group(ctx, [d], total, timeout_s=group_timeout_s)
        assert d.fleet_publisher is not None, "fleet publisher not armed"
        assert d.fleet_publisher.frames_published >= 1, (
            "killed replica never published a frame"
        )
        d.fleet_publisher.kill()
        d.stop()
        ctx["killed_replica"] = "g3-r1"

    @sc.step
    def assert_fleet_view(ctx):
        # the control-plane aggregation over everything the lineage
        # published: one continuous fleet series (every generation
        # present), delivery conserved end to end, and exactly one
        # stale replica — the undrained kill
        from ..obs.fleetview import FleetView

        name = "RescaleStateP" if pilot else "RescaleStateB"
        view = FleetView(url=ctx["store_url"],
                         now_fn=lambda: time.time() + 60.0)
        assert view.refresh() >= 5, "fewer frames than replicas"
        fm = view.fleet_metrics(name)
        reps = fm["replicas"]
        assert set(reps) == {
            "g0-r1", "g1-r1", "g1-r2", "g2-r1", "g3-r1"
        }, f"lineage not continuous: {sorted(reps)}"
        lin = view.lineage(name)
        assert [seg["replica"] for seg in lin][0] == "g0-r1", lin
        assert len(lin) == 5, lin
        audit = view.audit(name, output="Out")
        counts = audit["counts"]
        assert counts.get("DX540", 0) == 0, f"phantom loss: {audit}"
        assert counts.get("DX541", 0) == 0, f"phantom dup: {audit}"
        assert counts.get("DX542", 0) == 1, f"stale count: {audit}"
        assert audit["conserved"], audit
        total = n_pre + n_tail + n_kill
        assert audit["ingested"] == total, (audit["ingested"], total)
        assert audit["emitted"].get("Out") == total, audit["emitted"]
        stale = [r for r, s in reps.items() if s["status"] == "stale"]
        assert stale == [ctx["killed_replica"]], stale
        done = [r for r, s in reps.items() if s["status"] == "completed"]
        assert len(done) == 4, reps

    @sc.step
    def stop_store(ctx):
        ctx["store"].stop()

    if pilot:
        @sc.step
        def assert_pilot_rescaled(ctx):
            # the PREDECESSOR ran the pilot (successors spawn unpiloted
            # in this drill); leave it as the context host so generic
            # pilot assertions read the right controller
            ctx["host"] = ctx["pilot_host"]
            _assert_pilot_reacted(ctx, "rescale-up", host=ctx["pilot_host"])
            assert ctx["scaler"].calls and ctx["scaler"].calls[0] >= 2

    return sc


def chaos_suite(pilot: bool = False, depth: int = 2, device: str = "cuda"):
    """All five chaos drills (preemption, sink outage, hot-key skew,
    malformed flood, rescale-with-state) — the scenario-diversity
    matrix PILOT.md tables. Each scenario needs a fresh
    ``ScenarioContext`` with a ``workdir``."""
    flow = DrillFlow(device=device)
    return [
        chaos_preemption(pilot=pilot, depth=depth, flow=flow),
        chaos_sink_outage(pilot=pilot, depth=depth, flow=flow),
        chaos_hot_key_skew(pilot=pilot, depth=depth, flow=flow),
        chaos_malformed_flood(pilot=pilot, depth=depth, flow=flow),
        chaos_rescale_with_state(pilot=pilot, depth=depth,
                                 flow=state_drill_flow(device=device)),
    ]
