"""The port's observability CLI, ``python -m data_accelerator_tpu_torch.obs``
(``obs/__main__.py``), against the JAX package's: the ``trace``,
``spans --aggregate``, ``alerts`` (``--validate`` and a host's
``/alerts``), ``profile`` and ``fleet`` commands print what the JAX
package's print and exit as they exit, on the cases of
``test_observability.py``, ``test_alerts.py`` and ``test_timemodel.py``.
From ``test_trace_propagation.py`` only what needs no control plane: a
port host under ``telemetry.parenttrace``, whose batch spans ``obs
trace`` renders under the parent's span."""

import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from data_accelerator_tpu.obs.__main__ import main as jmain
from data_accelerator_tpu_torch.obs import telemetry, tracing
from data_accelerator_tpu_torch.obs.__main__ import find_traces, load_spans, main as tmain
from data_accelerator_tpu_torch.obs.alerts import AlertEngine, default_rules
from data_accelerator_tpu_torch.obs.exposition import HealthState, ObservabilityServer
from data_accelerator_tpu_torch.obs.fleetview import FleetView
from data_accelerator_tpu_torch.obs.histogram import HistogramRegistry
from data_accelerator_tpu_torch.obs.store import MetricStore
from data_accelerator_tpu_torch.obs.tracing import Tracer

ROOT = Path(__file__).resolve().parent.parent
MAINS = {"jax": jmain, "torch": tmain}


def _both(capsys, argv):
    """Each package's CLI on ``argv``: ``{pkg: (exit code, stdout,
    stderr)}``."""
    out = {}
    for pkg, main in MAINS.items():
        rc = main(list(argv))
        captured = capsys.readouterr()
        out[pkg] = (rc, captured.out, captured.err)
    return out


@pytest.fixture
def recorder(tmp_path):
    """A flight recorder holding one batch's span tree, written by the
    port's tracer."""
    p = str(tmp_path / "t.jsonl")
    t = telemetry.TelemetryLogger("app", [telemetry.JsonlWriter(p)])
    tracer = Tracer(t)
    ctx = tracer.begin("streaming/batch")
    with ctx.activate():
        with tracing.span("decode"):
            pass
        with tracing.span("collect"):
            with tracing.span("materialize"):
                pass
    ctx.end(batchTime=1700000000123)
    return p, ctx.trace_id


def test_trace_cli_reconstructs_span_tree(recorder, capsys):
    p, trace_id = recorder
    rc = tmain(["trace", "1700000000123", "--file", p])
    out = capsys.readouterr().out
    assert rc == 0
    assert "streaming/batch" in out
    assert "├─ decode" in out
    assert "└─ materialize" in out
    assert tmain(["trace", trace_id, "--file", p]) == 0
    assert tmain(["trace", "999", "--file", p]) == 1
    assert "1700000000123" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["trace", "1700000000123"], ["trace", "1700000000123", "--json"],
    ["trace", "999"], ["trace", "all", "--stitch"], ["spans"],
    ["spans", "--aggregate"], ["spans", "--aggregate", "--json"],
])
def test_trace_and_spans_print_what_jax_prints(recorder, capsys, argv):
    p, _trace_id = recorder
    runs = _both(capsys, argv + ["--file", p])
    assert runs["torch"] == runs["jax"]


def test_rotation_never_loses_in_progress_batch_spans(tmp_path):
    """A batch whose spans straddle rotations still reconstructs: the
    reader stitches every segment (gz included)."""
    p = str(tmp_path / "t.jsonl")
    w = telemetry.JsonlWriter(p, max_bytes=700, keep=12, compress=True)
    tracer = Tracer(telemetry.TelemetryLogger("app", [w]))
    ctx = tracer.begin("streaming/batch")
    with ctx.activate():
        for i in range(24):
            with tracing.span(f"stage-{i:02d}"):
                pass
    ctx.end(batchTime=42)
    assert os.path.exists(p + ".1.gz")
    spans = load_spans(p)
    assert len([s for s in spans if s["trace"] == ctx.trace_id]) == 25
    assert find_traces(spans, "42") == [ctx.trace_id]


def test_spans_aggregate_flame_table(tmp_path, capsys):
    path = str(tmp_path / "telemetry.jsonl")
    with open(path, "w", encoding="utf-8") as f:
        for i, (name, dur, trace) in enumerate([
            ("decode", 1.0, "t1"), ("decode", 3.0, "t2"),
            ("device-step", 10.0, "t1"), ("device-step", 30.0, "t2"),
            ("streaming/batch", 50.0, "t2"),
        ]):
            f.write(json.dumps({"type": "span", "name": name, "trace": trace,
                                "span": str(i), "parent": None, "startTs": i,
                                "durationMs": dur}) + "\n")
        f.write(json.dumps({"type": "event", "name": "noise"}) + "\n")
    runs = _both(capsys, ["spans", "--aggregate", "--file", path])
    assert runs["torch"] == runs["jax"]
    rc, out, _err = runs["torch"]
    lines = out.splitlines()
    assert rc == 0 and lines[0].startswith("stage")
    assert lines[1].split()[0] == "streaming/batch"
    assert lines[2].split()[0] == "device-step" and "t2" in lines[2]
    assert tmain(["spans", "--aggregate", "--json", "--file", path]) == 0
    rows = json.loads(capsys.readouterr().out)
    ds = next(r for r in rows if r["stage"] == "device-step")
    assert ds["count"] == 2 and ds["totalMs"] == 40.0
    assert ds["p99Ms"] == pytest.approx(29.8)
    assert ds["maxTrace"] == "t2"


def test_trace_cli_without_spans_exits_2(tmp_path, capsys):
    runs = _both(capsys, ["trace", "1", "--file", str(tmp_path / "none.jsonl")])
    assert runs["torch"] == runs["jax"] and runs["torch"][0] == 2


# -- alerts ----------------------------------------------------------------------
def test_obs_alerts_cli_validate(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(default_rules()))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"name": "x"}]))
    for path, rc in ((good, 0), (bad, 2)):
        runs = _both(capsys, ["alerts", "--validate", str(path)])
        assert runs["torch"] == runs["jax"] and runs["torch"][0] == rc
    assert "metric" in runs["torch"][2]


def test_obs_alerts_cli_queries_host(capsys):
    store = MetricStore()
    store.add_point("DATAX-F:M", int(999 * 1000), 100.0)
    eng = AlertEngine(
        [{"name": "hot", "metric": "M", "op": ">", "threshold": 1.0,
          "severity": "page"}],
        flow="F", store=store, now_fn=lambda: 1000.0,
    )
    srv = ObservabilityServer(HealthState(flow="F"), HistogramRegistry(), store,
                              port=0, alerts=eng)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        runs = _both(capsys, ["alerts", "--url", url])
        assert runs["torch"] == runs["jax"]
        rc, out, _err = runs["torch"]
        assert rc == 1  # firing => non-zero (scriptable)
        assert "hot" in out and "firing" in out
        assert tmain(["alerts", "--url", url, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["firing"][0]["name"] == "hot"
    finally:
        srv.stop()
    assert tmain(["alerts", "--url", "http://127.0.0.1:1"]) == 2


# -- profile -----------------------------------------------------------------------
def test_obs_profile_cli_arms_a_live_hosts_capture(tmp_path, capsys):
    from test_torch_calibrate import _host_conf
    from data_accelerator_tpu_torch.runtime.host import StreamingHost

    host = StreamingHost(_host_conf(tmp_path, {
        "datax.job.process.observability.port": "0",
        "datax.job.process.observability.profilerdir": str(tmp_path / "prof"),
    }), device="cpu")
    try:
        url = f"http://127.0.0.1:{host.obs_server.port}"
        assert tmain(["profile", url, "--seconds", "60"]) == 0
        out = capsys.readouterr().out
        assert "capture armed for 60.0s -> " + str(tmp_path / "prof") in out
        # a second capture while the first runs is a conflict (409):
        # both CLIs print the host's answer and exit 1
        runs = _both(capsys, ["profile", url, "--json"])
        assert runs["torch"] == runs["jax"] and runs["torch"][0] == 1
        assert json.loads(runs["torch"][1])["error"] == "capture already in progress"
        host.run_batch()
    finally:
        host.stop()  # closes the capture
    assert host.profiler.captures_count == 1
    assert tmain(["profile", "http://127.0.0.1:1"]) == 2


# -- fleet --------------------------------------------------------------------------
class _FleetRoutes(BaseHTTPRequestHandler):
    """``/fleet/metrics`` and ``/fleet/flows/<flow>`` over a view, as
    the JAX package's control plane wraps them (``{"result": ...}``)."""

    view = None

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/fleet/metrics":
            body = {"result": self.view.summary()}
        elif path.startswith("/fleet/flows/"):
            body = {"result": self.view.fleet_metrics(path.rsplit("/", 1)[1])}
        else:
            self.send_response(404)
            self.end_headers()
            return
        data = json.dumps(body, default=str).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture
def fleet_url():
    from test_torch_fleet import DictStore, _good_frame

    view = FleetView(client=DictStore(), now_fn=lambda: 60.0)
    delivery = {"ingested": {"default": 2.0}, "emitted": {"Out": 2.0}}
    view.ingest_frame(_good_frame(0, replica="r1", flow="Cli", final=True,
                                  windowSeconds=1.0, publishedAtMs=50_000,
                                  delivery=delivery))
    view.ingest_frame(_good_frame(0, replica="r2", flow="Cli", windowSeconds=1.0,
                                  publishedAtMs=51_000, delivery=delivery))
    handler = type("Routes", (_FleetRoutes,), {"view": view})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


@pytest.mark.parametrize("argv", [[], ["--json"], ["--flow", "Cli"],
                                  ["--flow", "Cli", "--output", "Out"]])
def test_obs_fleet_cli_reads_the_rollup(fleet_url, capsys, argv):
    runs = _both(capsys, ["fleet", "--url", fleet_url] + argv)
    assert runs["torch"] == runs["jax"]
    rc, out, _err = runs["torch"]
    if argv == ["--flow", "Cli"]:
        # r2 went quiet without its final frame: DX542, exit 1
        assert rc == 1 and "lineage: r1 -> r2" in out and "DX542" in out
    elif not argv:
        assert rc == 0 and "Cli" in out and "completed=1" in out


def test_obs_cli_help_names_the_port_and_the_fleet_source():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "data_accelerator_tpu_torch.obs", "fleet", "--help"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0
    assert "python -m data_accelerator_tpu_torch.obs fleet" in res.stdout
    assert "JAX" in res.stdout and "control" in res.stdout


# -- trace propagation ---------------------------------------------------------------
def test_host_batches_render_under_the_parent_span(tmp_path, capsys):
    """A port host started with ``telemetry.parenttrace`` (what the
    control plane's job submit passes): its batch roots join the parent's
    trace under the parent's span, span ids stay unique, and ``obs
    trace`` renders the batches nested under the parent."""
    from test_torch_calibrate import _host_conf
    from data_accelerator_tpu_torch.runtime.host import StreamingHost

    trace_file = str(tmp_path / "telemetry.jsonl")
    parent_tracer = Tracer(telemetry.TelemetryLogger(
        "DataX-ControlPlane", [telemetry.JsonlWriter(trace_file)]))
    req = parent_tracer.begin("rest/flow/startjobs")
    with req.activate():
        with tracing.span("submit"):
            parent = tracing.format_parent(tracing.capture())
    req.end()
    host = StreamingHost(_host_conf(tmp_path, {
        "datax.job.process.telemetry.tracefile": trace_file,
        "datax.job.process.telemetry.parenttrace": parent,
    }), device="cpu")
    try:
        host.run(max_batches=2)
    finally:
        host.stop()
    trace_id, submit_span = tracing.parse_parent(parent)
    spans = [s for s in load_spans(trace_file) if s["trace"] == trace_id]
    roots = [s for s in spans if s["name"] == "streaming/batch"]
    assert len(roots) == 2 and all(r["parent"] == submit_span for r in roots)
    ids = [s["span"] for s in spans]
    assert len(ids) == len(set(ids))
    root_ids = {r["span"] for r in roots}
    assert all(s["parent"] in root_ids for s in spans if s["name"] == "decode")
    capsys.readouterr()
    assert tmain(["trace", trace_id, "--file", trace_file]) == 0
    out = capsys.readouterr().out
    assert "rest/flow/startjobs" in out and "submit" in out
    for line in out.splitlines():
        if "streaming/batch" in line:
            assert not line.startswith("streaming/batch"), out
    batch_id = str(roots[0]["properties"]["batchTime"])
    assert tmain(["trace", batch_id, "--file", trace_file]) == 0
    capsys.readouterr()
    runs = _both(capsys, ["trace", trace_id, "--file", trace_file])
    assert runs["torch"] == runs["jax"]
