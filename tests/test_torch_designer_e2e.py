"""The designer end to end on the port: the SPA's own call sequence
through the port's website, its gateway with roles on, and its API,
beside the same sequence on the JAX package's stack. Save, validate
(the device cost report is the port's plan), generate, start, stop;
a reader's website may browse but not write; ``app.js`` carries the
designer's editors and names the port's UDF module; a multi-source
flow from the designer builds a processor whose join rows equal the
JAX package's. Last, the one-box entry point from a subprocess: without
a card it exits non-zero naming the card, and with ``device=cpu`` it
serves ``flow/getall``."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from data_accelerator_tpu.serve import gateway as jgateway
from data_accelerator_tpu.serve import restapi as jrestapi
from data_accelerator_tpu.web import WebsiteServer as JWebsiteServer
from data_accelerator_tpu_torch.analysis import analyze_flow_device
from data_accelerator_tpu_torch.serve import gateway as tgateway
from data_accelerator_tpu_torch.serve import restapi as trestapi
from data_accelerator_tpu_torch.web import WebsiteServer

from test_designer_e2e import WX_SCHEMA, designer_gui
from test_serve_generation import make_gui
from test_torch_serve_restapi import JAX_UDF, PORT_UDF, make_api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACKS = {"jax": (jrestapi, jgateway, JWebsiteServer),
          "torch": (trestapi, tgateway, WebsiteServer)}
SERVICES = ("flow", "interactivequery", "schemainference", "livedata")


def _gui(pkg, name):
    """The designer's tabs: base flow, an aggregate rule, a UDF of the
    package's own module."""
    gui = designer_gui(name)
    mod = gui["process"]["functions"][0]["properties"]
    mod["module"] = mod["module"].replace(JAX_UDF, PORT_UDF if pkg == "torch" else JAX_UDF)
    return gui


@pytest.fixture
def stacks(tmp_path):
    """website -> gateway (roles on) -> API, per package."""
    out, parts = {}, []
    try:
        for pkg, (ra, gw_mod, web_cls) in STACKS.items():
            api = make_api(pkg, str(tmp_path / pkg), require_roles=True)
            svc = ra.DataXApiService(api, port=0)
            svc.start()
            parts.append((svc, api))
            auth = gw_mod.AuthTable()
            auth.add("writer-tok", "designer@example", [gw_mod.ROLE_READER, gw_mod.ROLE_WRITER])
            auth.add("reader-tok", "viewer@example", [gw_mod.ROLE_READER])
            gw = gw_mod.Gateway(auth, port=0, backends={
                s: f"http://127.0.0.1:{svc.port}" for s in SERVICES})
            gw.start()
            parts.append((gw, None))
            web = web_cls(gateway_url=f"http://127.0.0.1:{gw.port}",
                          gateway_token="writer-tok", port=0)
            web.start()
            parts.append((web, None))
            out[pkg] = (web, gw, api)
        yield out
    finally:
        for server, api in reversed(parts):
            server.stop()
            if api is not None:
                api.livequery.stop()


def _call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def test_spa_path_save_generate_start_stop(stacks, tmp_path):
    seen = {}
    for pkg, (web, _gw, _api) in stacks.items():
        name = "DesignerE2E"
        steps = [_call(web.port, "POST", "/api/flow/flow/save", _gui(pkg, name))]
        status, out = _call(web.port, "POST", "/api/flow/flow/generateconfigs",
                            {"flowName": name})
        assert status == 200, out
        [job] = out["result"]["jobNames"]
        conf_dir = tmp_path / pkg / "runtime" / name
        transform = (conf_dir / f"{name}.transform").read_text()
        assert "AVG(deviceDetails.temperature)" in transform
        assert "GROUP BY deviceDetails.homeId" in transform
        conf_text = (conf_dir / f"{job}.conf").read_text()
        want = PORT_UDF if pkg == "torch" else JAX_UDF
        assert f"datax.job.process.jar.udf.anomalyscore.class={want}samples:anomalyscore" \
            in conf_text
        for path in ("/api/flow/flow/startjobs", "/api/flow/flow/stopjobs"):
            status, out = _call(web.port, "POST", path, {"flowName": name})
            steps.append((status, [(j["name"], j["state"]) for j in out["result"]]))
        seen[pkg] = (steps, transform, job)
    assert seen["torch"] == seen["jax"]
    assert [s[1] for s in seen["torch"][0][1:]] == [
        [("DataXTpu-DesignerE2E", "starting")], [("DataXTpu-DesignerE2E", "idle")]]


def test_gateway_blocks_writes_without_writer_role(stacks):
    _web, gw, _api = stacks["torch"]
    ro = WebsiteServer(gateway_url=f"http://127.0.0.1:{gw.port}",
                       gateway_token="reader-tok", port=0)
    ro.start()
    try:
        assert _call(ro.port, "GET", "/api/flow/flow/getall")[0] == 200
        assert _call(ro.port, "POST", "/api/flow/flow/save", _gui("torch", "No"))[0] == 403
    finally:
        ro.stop()


def test_spa_ships_designer_editors_naming_the_port(stacks):
    web, *_ = stacks["torch"]
    with urllib.request.urlopen(f"http://127.0.0.1:{web.port}/static/app.js", timeout=10) as r:
        js = r.read().decode()
    for marker in ('"functions"', "AggregateRule", "_S_pivots", "_S_aggs", '"scale"',
                   '"schedule"', "azureFunction", "Additional sources", "renderCostTable",
                   "renderCompileSurface", "renderShardingTable", "all: true",
                   "data_accelerator_tpu_torch.udf.samples:anomalyscore"):
        assert marker in js, marker
    assert "data_accelerator_tpu.udf" not in js


def test_spa_validate_returns_the_ports_plan(stacks):
    reports = {}
    for pkg, (web, _gw, _api) in stacks.items():
        status, out = _call(web.port, "POST", "/api/flow/flow/validate",
                            {"flow": make_gui("ValidateDev"), "device": True})
        assert status == 200, out
        reports[pkg] = out["result"]
    dev = reports["torch"]["device"]
    assert reports["torch"]["ok"], reports["torch"]["diagnostics"]
    assert dev["totals"] == analyze_flow_device(make_gui("ValidateDev")).plan_dict()["totals"]
    assert {s["kind"] for s in dev["stages"]} >= {"input", "group"}
    # the reference's report on the same flow: same stages and bytes
    jdev = reports["jax"]["device"]
    assert dev["totals"]["hbmBytes"] == jdev["totals"]["hbmBytes"]
    assert [s["name"] for s in dev["stages"]] == [s["name"] for s in jdev["stages"]]


def test_gui_sources_generate_a_runnable_multi_source_flow(stacks, tmp_path):
    from data_accelerator_tpu.core.confmanager import ConfigManager as JConfigManager
    from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
    from data_accelerator_tpu_torch.core.confmanager import ConfigManager
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    name = "MSDesigner"
    gui = make_gui(name)
    gui["input"]["sources"] = [{"id": "weather", "type": "local", "properties": {
        "inputSchemaFile": WX_SCHEMA, "target": "Weather",
        "normalizationSnippet": "current_timestamp() AS eventTimeStamp\nRaw.*"}}]
    gui["process"]["queries"] = [
        "--DataXQuery--\nDoorEvents = SELECT deviceDetails.deviceId AS deviceId, "
        "eventTimeStamp FROM DataXProcessedInput;\n--DataXQuery--\n"
        "Storm = SELECT d.deviceId, w.windSpeed FROM DoorEvents d INNER JOIN Weather "
        "TIMEWINDOW('10 seconds') w ON d.deviceId = w.stationId;\nOUTPUT Storm TO Metrics;"]
    rows = {}
    for pkg, (web, _gw, _api) in stacks.items():
        assert _call(web.port, "POST", "/api/flow/flow/save", gui)[0] == 200
        status, out = _call(web.port, "POST", "/api/flow/flow/generateconfigs",
                            {"flowName": name})
        assert status == 200, out
        conf_path = tmp_path / pkg / "runtime" / name / f"{out['result']['jobNames'][0]}.conf"
        cm, proc_cls = ((ConfigManager, FlowProcessor) if pkg == "torch"
                        else (JConfigManager, JFlowProcessor))
        cm.reset()
        cm.get_configuration_from_arguments([f"conf={conf_path}"])
        d = cm.load_config()
        cm.reset()
        proc = proc_cls(d, output_datasets=["Storm"],
                        **({"device": "cpu"} if pkg == "torch" else {}))
        assert set(proc.specs) == {"default", "weather"}
        base = 1_700_000_000_000
        proc.process_batch({"weather": proc.encode_rows(
            [{"stationId": 1, "windSpeed": 77.0}], base, source="weather")}, base)
        datasets, _ = proc.process_batch({"default": proc.encode_rows(
            [{"deviceDetails": {"deviceId": 1, "deviceType": "DoorLock", "status": 0}}],
            base + 2000)}, base + 2000)
        rows[pkg] = datasets["Storm"]
    assert rows["torch"] == rows["jax"] == [{"deviceId": 1, "windSpeed": 77.0}]


# -- the one-box entry point ----------------------------------------------------------
def _serve(args, tmp_path):
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    return subprocess.Popen([sys.executable, "-m", "data_accelerator_tpu_torch.serve", *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_entry_point_without_a_card_exits_naming_it(tmp_path):
    proc = _serve(["port=0"], tmp_path)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in out and "device='cpu'" in out
    assert "control plane on" not in out


def test_entry_point_on_the_cpu_serves_the_designer(tmp_path):
    proc = _serve(["port=0", "device=cpu", f"root={tmp_path / 'root'}", "tracefile=off"],
                  tmp_path)
    try:
        port, seen, deadline = None, [], time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            seen.append(line)
            if "control plane on :" in line:
                port = int(line.split("control plane on :", 1)[1].split()[0])
        assert port, "".join(seen)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/flow/getall",
                                    timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {"result": []}
        assert "device cpu" in "".join(seen)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    assert proc.returncode is not None
