"""The port's REST API (``serve/restapi.py``) against the JAX package's:
the same route table, ``dispatch`` parity on flow CRUD, the query
editor's routes and schema inference, the role gate, a live HTTP round
trip, and the designer's interactive queries (``kernel/executequery``,
``lq/execute``) of the anomaly query with the port on the CPU.

The reference's kernels and sessions carry no UDF (its REST route
answers ``unknown function ANOMALYSCORE``); the port's load the saved
flow's declared UDFs as its job does, so the JAX side of that
comparison is the JAX package's ``KernelService``/``LiveQueryService``
given its own ``anomalyscore`` on the same sample. Statuses, headers,
ints and strings compare exactly; float cells within rtol 1e-5.
"""

import copy
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import chip_smoke
from data_accelerator_tpu.analysis import FleetSpec as JFleetSpec
from data_accelerator_tpu.lq.service import LiveQueryService as JLiveQueryService
from data_accelerator_tpu.serve import flowservice as jflowservice
from data_accelerator_tpu.serve import livequery as jlivequery
from data_accelerator_tpu.serve import restapi as jrestapi
from data_accelerator_tpu.serve import storage as jstorage
from data_accelerator_tpu.udf.samples import anomalyscore as janomalyscore
from data_accelerator_tpu_torch.analysis import FleetSpec
from data_accelerator_tpu_torch.serve import flowservice as tflowservice
from data_accelerator_tpu_torch.serve import livequery as tlivequery
from data_accelerator_tpu_torch.serve import restapi as trestapi
from data_accelerator_tpu_torch.serve import storage as tstorage

from test_serve_generation import INPUT_SCHEMA, make_gui
from test_torch_flow import _assert_same_rows
from test_torch_serve_jobs import recording_client

PACKAGES = {"jax": (jflowservice, jrestapi, jstorage), "torch": (tflowservice, trestapi, tstorage)}
PORT_UDF, JAX_UDF = "data_accelerator_tpu_torch.udf.", "data_accelerator_tpu.udf."
# one explicit fleet for both gates (their defaults are their machines')
FLEET = {"chips": 2, "hbmPerChipBytes": 1 << 30}


def make_api(pkg, root, **kw):
    fs, ra, st = PACKAGES[pkg]
    jobs_mod = __import__(f"{fs.__name__.rsplit('.', 1)[0]}.jobs", fromlist=["x"])
    dev = {"device": "cpu"} if pkg == "torch" else {}
    spec_cls = JFleetSpec if pkg == "jax" else FleetSpec
    ops = fs.FlowOperation(st.LocalDesignTimeStorage(f"{root}/design"),
                           st.LocalRuntimeStorage(f"{root}/runtime"),
                           job_client=recording_client(jobs_mod),
                           fleet_spec=spec_cls.from_dict(FLEET), **dev)
    return ra.DataXApi(ops, **dev, **kw)


@pytest.fixture
def apis(tmp_path):
    made = {pkg: make_api(pkg, str(tmp_path / pkg)) for pkg in PACKAGES}
    yield made
    for api in made.values():
        api.livequery.stop()


def _both(apis, tmp_path, method, path, body=None, query=None, roles=None):
    out = {}
    for pkg, api in apis.items():
        status, payload = api.dispatch(method, path, body=copy.deepcopy(body),
                                       query=query, roles=roles)
        text = json.dumps(payload, sort_keys=True, default=str)
        out[pkg] = (status, json.loads(text.replace(str(tmp_path / pkg), "@ROOT@")))
    return out


def test_route_tables_are_equal(apis):
    assert set(apis["torch"].routes) == set(apis["jax"].routes)
    assert {k: v[1] for k, v in apis["torch"].routes.items()} == \
        {k: v[1] for k, v in apis["jax"].routes.items()}


def test_flow_crud_and_jobs_equal_the_reference(apis, tmp_path):
    calls = [
        ("GET", "api/nope", None, None),
        ("POST", "api/flow/save", make_gui("ApiFlow"), None),
        ("POST", "api/flow/generateconfigs", {"flowName": "ApiFlow"}, None),
        ("GET", "api/flow/get", None, {"flowName": ["ApiFlow"]}),
        ("GET", "api/flow/getall/min", None, None),
        ("POST", "api/flow/startjobs", {"flowName": "ApiFlow"}, None),
        ("POST", "api/job/syncall", {}, None),
        ("GET", "api/job/get", None, {"jobName": ["DataXTpu-ApiFlow"]}),
        ("POST", "api/job/getbynames", {"jobNames": ["DataXTpu-ApiFlow", "x"]}, None),
        ("POST", "api/flow/stopjobs", {"flowName": "ApiFlow"}, None),
        ("POST", "api/flow/generateconfigs", {}, None),
        ("GET", "api/flow/get", None, {"flowName": ["missing"]}),
        ("POST", "api/flow/delete", {"flowName": "ApiFlow"}, None),
        ("GET", "api/flow/getall", None, None),
    ]
    for method, path, body, query in calls:
        got = _both(apis, tmp_path, method, path, body, query)
        status, payload = got["torch"]
        if path == "api/flow/get" and status == 200:
            # the stored document: equal but for the conformance model's
            # and manifest's own numbers, which the generation test pins
            assert payload["result"]["jobNames"] == got["jax"][1]["result"]["jobNames"]
            assert payload["result"]["gui"] == got["jax"][1]["result"]["gui"]
            continue
        assert got["torch"] == got["jax"], (method, path)


def test_query_editor_and_inference_equal_the_reference(apis, tmp_path):
    calls = [
        ("api/userqueries/schema", {
            "query": "--DataXQuery--\nT = SELECT a, b AS c FROM DataXProcessedInput",
            "inputColumns": ["a", "b"]}),
        ("api/userqueries/schema", {"query": make_gui()["process"]["queries"][0]}),
        ("api/userqueries/codegen", {
            "query": "--DataXQuery--\nT = SELECT * FROM DataXProcessedInput "
                     "TIMEWINDOW('2 minutes');\nOUTPUT T TO Metrics;", "rules": [], "name": "X"}),
        ("api/userqueries/codegen", {"query": make_gui()["process"]["queries"][0],
                                     "rules": make_gui()["rules"], "name": "GenTestFlow"}),
        ("api/inputdata/inferschema", {"name": "SFlow",
                                       "events": [{"a": 1, "b": "x"}, {"a": 2.5}]}),
        ("api/inputdata/inferschema", {"name": "IoT", "events": [
            json.loads(ln) for ln in chip_smoke.make_json_payload(
                np.random.RandomState(3), 40).decode().splitlines()]}),
    ]
    for path, body in calls:
        got = _both(apis, tmp_path, "POST", path, body)
        assert got["torch"] == got["jax"], path
        assert got["torch"][0] == 200


def test_role_gate_equals_the_reference(tmp_path):
    apis = {pkg: make_api(pkg, str(tmp_path / pkg), require_roles=True) for pkg in PACKAGES}
    try:
        for roles, method, path, body in (
            (None, "GET", "api/flow/getall", None),
            (["DataXReader"], "GET", "api/flow/getall", None),
            (["DataXReader"], "POST", "api/flow/save", make_gui("X")),
            (["DataXWriter"], "POST", "api/flow/save", make_gui("X")),
        ):
            got = _both(apis, tmp_path, method, path, body, roles=roles)
            assert got["torch"] == got["jax"]
        assert [_both(apis, tmp_path, "GET", "api/flow/getall")[p][0] for p in apis] == [401, 401]
    finally:
        for api in apis.values():
            api.livequery.stop()


# -- the designer's interactive queries ---------------------------------------
SAMPLE_N = 64


def _flow_gui(pkg):
    gui = chip_smoke.main_flow_gui(1024)
    return json.loads(json.dumps(gui).replace(PORT_UDF, JAX_UDF)) if pkg == "jax" else gui


@pytest.fixture
def pinned_time(monkeypatch):
    """Both packages' kernels read one clock for current_timestamp()."""
    clock = types.SimpleNamespace(time=lambda: chip_smoke.BASE_MS / 1000.0 + 0.25)
    monkeypatch.setattr(tlivequery, "time", clock)
    monkeypatch.setattr(jlivequery, "time", clock)


def test_anomaly_query_through_rest_equals_the_reference(apis, tmp_path, pinned_time):
    sample = [json.loads(ln) for ln in chip_smoke.make_json_payload(
        np.random.RandomState(5), SAMPLE_N).decode().splitlines()]
    query = chip_smoke.designer_queries()["Scored"]
    name = chip_smoke.HOST_FLOW
    api = apis["torch"]
    assert api.dispatch("POST", "api/flow/save", body=_flow_gui("torch"))[0] == 200
    status, out = api.dispatch("POST", "api/inputdata/inferschema",
                               body={"name": name, "events": sample})
    assert status == 200 and out["result"]["EventsSampled"] == SAMPLE_N
    status, out = api.dispatch("POST", "api/kernel", body={"name": name})
    assert status == 200, out
    status, got = api.dispatch("POST", "api/kernel/executequery", body={
        "kernelId": out["result"]["kernelId"], "query": query, "maxRows": SAMPLE_N})
    assert status == 200, got
    status, out = api.dispatch("POST", "api/lq/session", body={
        "name": name, "tenant": "designer", "sampleRows": sample})
    assert status == 200, out
    status, got_lq = api.dispatch("POST", "api/lq/execute", body={
        "sessionId": out["result"]["id"], "query": query, "maxRows": SAMPLE_N})
    assert status == 200, got_lq

    # the reference: its REST kernels carry no UDF ...
    japi = apis["jax"]
    japi.dispatch("POST", "api/flow/save", body=_flow_gui("jax"))
    japi.dispatch("POST", "api/inputdata/inferschema", body={"name": name, "events": sample})
    _s, jk = japi.dispatch("POST", "api/kernel", body={"name": name})
    status, jout = japi.dispatch("POST", "api/kernel/executequery", body={
        "kernelId": jk["result"]["kernelId"], "query": query})
    assert status == 500 and "unknown function ANOMALYSCORE" in jout["error"]["message"]
    # ... so its services, given its UDF, on the same sample
    props = chip_smoke.main_flow_gui()["input"]["properties"]
    jsvc = jlivequery.KernelService(runtime_storage=japi.flow_ops.runtime)
    kid = jsvc.create_kernel(name, props["inputSchemaFile"],
                             normalization=props["normalizationSnippet"],
                             udfs={"anomalyscore": janomalyscore()})
    want = jsvc.execute(kid, query, SAMPLE_N)
    jlq = JLiveQueryService()
    try:
        sid = jlq.create_session("designer", name, props["inputSchemaFile"],
                                 normalization=props["normalizationSnippet"],
                                 sample_rows=sample, udfs={"anomalyscore": janomalyscore()})["id"]
        want_lq = jlq.execute(sid, query, SAMPLE_N)
    finally:
        jlq.stop()
    for g, w in ((got["result"], want), (got_lq["result"], want_lq)):
        assert g["headers"] == w["headers"] == ["deviceId", "temperature", "score"]
        assert g["table"] == w["table"]
        assert len(g["result"]) == SAMPLE_N
        _assert_same_rows(w["result"], g["result"], "anomaly query")


def test_a_flow_naming_the_jax_udf_is_refused_by_the_port(apis, pinned_time):
    """The port's server never loads the JAX package: a saved flow whose
    function names the JAX module fails the kernel create, naming the
    port's counterpart."""
    api = apis["torch"]
    api.dispatch("POST", "api/flow/save", body=_flow_gui("jax"))
    status, out = api.dispatch("POST", "api/kernel", body={"name": chip_smoke.HOST_FLOW})
    assert status == 500
    assert "data_accelerator_tpu_torch.udf.samples:anomalyscore" in out["error"]["message"]


def test_validate_runs_the_ported_tiers_and_refuses_the_mesh(apis):
    api = apis["torch"]
    gui = make_gui("Val")
    status, out = api.dispatch("POST", "api/flow/validate", body={"flow": gui, "all": True})
    assert status == 200 and out["result"]["ok"], out
    assert {"device", "udfs", "fleet", "compile", "race", "protocol", "conf"} <= set(out["result"])
    assert "mesh" not in out["result"]
    status, out = api.dispatch("POST", "api/flow/validate", body={"flow": gui, "mesh": True})
    assert status == 500 and "slice 8" in out["error"]["message"]
    status, out = api.dispatch("POST", "api/flow/validate",
                               body={"flow": gui, "device": True, "chips": 2})
    assert status == 500 and "slice 8" in out["error"]["message"]
    gui["process"]["jobconfig"]["jobNumChips"] = "2"
    api.dispatch("POST", "api/flow/save", body=gui)
    status, out = api.dispatch("POST", "api/flow/generateconfigs", body={"flowName": "Val"})
    assert status == 500 and "slice 8" in out["error"]["message"]


def test_the_default_services_are_on_the_card(tmp_path):
    ops = tflowservice.FlowOperation(tstorage.LocalDesignTimeStorage(f"{tmp_path}/d"),
                                     tstorage.LocalRuntimeStorage(f"{tmp_path}/r"),
                                     fleet_admission=False, device="cpu")
    from data_accelerator_tpu_torch.core.config import EngineException

    with pytest.raises(EngineException, match="no CUDA device"):
        trestapi.DataXApi(ops)
    api = trestapi.DataXApi(ops, device="cpu")
    assert api.kernels.device == "cpu" and str(api.livequery.cache.device) == "cpu"
    api.livequery.stop()


# -- live HTTP --------------------------------------------------------------------
@pytest.fixture
def server(tmp_path):
    api = make_api("torch", str(tmp_path))
    svc = trestapi.DataXApiService(api, port=0)
    svc.start()
    yield svc
    svc.stop()
    api.livequery.stop()


def http(server, method, path, body=None, roles=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/{path.lstrip('/')}",
        data=json.dumps(body).encode() if body is not None else None, method=method)
    req.add_header("Content-Type", "application/json")
    if roles:
        req.add_header("X-DataX-Roles", ",".join(roles))
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip(server):
    assert http(server, "POST", "api/flow/save", make_gui("HFlow"))[0] == 200
    status, out = http(server, "GET", "api/flow/getall")
    assert status == 200 and out["result"][0]["name"] == "HFlow"
    assert http(server, "GET", "api/bogus")[0] == 404
    status, out = http(server, "POST", "api/kernel", {
        "name": "KFlow", "inputSchema": INPUT_SCHEMA, "sampleRows": [
            {"deviceDetails": {"deviceId": 1, "deviceType": "DoorLock", "status": 0}},
            {"deviceDetails": {"deviceId": 2, "deviceType": "Heating", "status": 1}}]})
    assert status == 200, out
    status, out = http(server, "POST", "api/kernel/executequery", {
        "kernelId": out["result"]["kernelId"],
        "query": "T = SELECT deviceDetails.deviceId AS id FROM DataXProcessedInput "
                 "WHERE deviceDetails.status = 0"})
    assert status == 200 and [r["id"] for r in out["result"]["result"]] == [1]
