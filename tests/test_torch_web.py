"""The port's website (``web/server.py`` and ``web/static/``) against
the JAX package's: each package's website in process over its own API,
the same paths answering alike (the SPA shell and assets, the traversal
guard, the in-process API bridge, metric history and keys, the
Prometheus text, probes, the page registry, the SSE feed). The port's
assets are the reference's bytes but for three lines of ``app.js``,
which name the port's UDF module, its analysis CLI and a torch-callable
UDF."""

import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import pytest

from data_accelerator_tpu.obs.store import MetricStore as JMetricStore
from data_accelerator_tpu.web import WebsiteServer as JWebsiteServer
from data_accelerator_tpu_torch.obs.store import MetricStore
from data_accelerator_tpu_torch.web import WebsiteServer
from data_accelerator_tpu_torch.web import server as tserver

from test_torch_serve_restapi import make_api

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_STATIC = ROOT / "data_accelerator_tpu" / "web" / "static"
PORT_STATIC = ROOT / "data_accelerator_tpu_torch" / "web" / "static"


@pytest.fixture
def webs(tmp_path):
    made, apis = {}, []
    try:
        for pkg, (cls, store_cls) in {"jax": (JWebsiteServer, JMetricStore),
                                      "torch": (WebsiteServer, MetricStore)}.items():
            api = make_api(pkg, str(tmp_path / pkg))
            apis.append(api)
            store = store_cls()
            srv = cls(api=api, store=store, port=0)
            srv.start()
            made[pkg] = (srv, store)
        yield made
    finally:
        for srv, _store in made.values():
            srv.stop()
        for api in apis:
            api.livequery.stop()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def test_static_assets_are_the_references_but_three_lines():
    for name in ("index.html", "style.css"):
        assert (PORT_STATIC / name).read_bytes() == (JAX_STATIC / name).read_bytes()
    jlines = (JAX_STATIC / "app.js").read_text(encoding="utf-8").splitlines()
    tlines = (PORT_STATIC / "app.js").read_text(encoding="utf-8").splitlines()
    assert len(tlines) == len(jlines)
    changed = [i + 1 for i, (a, b) in enumerate(zip(jlines, tlines)) if a != b]
    assert changed == [134, 548, 552]
    assert "data_accelerator_tpu_torch.udf.samples:anomalyscore" in tlines[547]
    assert "torch-callable" in tlines[551] and "jax" not in tlines[551]
    assert "python -m data_accelerator_tpu_torch.analysis" in tlines[133]
    assert pathlib.Path(tserver.STATIC_DIR) == PORT_STATIC


PATHS = ("/", "/static/app.js", "/static/style.css", "/some/deep/route",
         "/static/../server.py", "/composition", "/healthz", "/readyz",
         "/api/flow/flow/getall/min", "/metrics/keys?prefix=DATAX-F")


@pytest.mark.parametrize("path", PATHS)
def test_paths_answer_as_the_reference(webs, path):
    got = {}
    for pkg, (srv, _store) in webs.items():
        status, ctype, body = _get(srv.port, path)
        if path == "/static/app.js":
            body = body.replace(b"data_accelerator_tpu_torch.", b"data_accelerator_tpu.") \
                       .replace(b"torch-callable", b"jax-callable")
        got[pkg] = (status, ctype.split(";")[0], body)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] in (200, 403)


def test_api_bridge_metric_history_and_prometheus(webs):
    srv, store = webs["torch"]
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/api/flow/flow/save",
        data=json.dumps({"name": "webflow", "displayName": "W"}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200
    status, _, body = _get(srv.port, "/api/flow/flow/getall/min")
    assert status == 200 and json.loads(body)["result"][0]["name"] == "webflow"
    store.add_point("DATAX-F:Input_Events_Count", 1000, 5)
    store.add_point("DATAX-F:Input_Events_Count", 2000, 7)
    status, _, body = _get(srv.port, "/metrics/history?key=DATAX-F:Input_Events_Count")
    assert json.loads(body) == [{"uts": 1000, "val": 5}, {"uts": 2000, "val": 7}]
    status, ctype, body = _get(srv.port, "/metrics")
    assert status == 200 and "text/plain" in ctype
    assert b'datax_metric_last_value{app="DATAX-F",metric="Input_Events_Count"} 7' in body


def test_metrics_post_from_a_job_lands_in_the_store(webs):
    """The one-box path a generated conf's ``localMetricsHttpEndpoint``
    takes: a job posts its points, the dashboard's store holds them."""
    srv, store = webs["torch"]
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/metrics/post",
        data=json.dumps([{"app": "DATAX-J", "metric": "Input_Events_Count",
                          "uts": 5, "value": 3}]).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert json.loads(r.read()) == {"stored": 1}
    assert store.points("DATAX-J:Input_Events_Count") == [{"uts": 5, "val": 3}]


def test_sse_stream_pushes_datapoints(webs):
    srv, store = webs["torch"]
    got = []

    def listen():
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/metrics/stream?prefix=DATAX-X")
        with urllib.request.urlopen(req, timeout=10) as r:
            for raw in r:
                line = raw.decode().strip()
                if line.startswith("data: "):
                    got.append(json.loads(line[6:]))
                    return

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    deadline = time.time() + 5
    while not store._listeners and time.time() < deadline:
        time.sleep(0.02)
    store.add_point("DATAX-Y:Ignored", 500, 1)
    store.add_point("DATAX-X:Input", 1000, 42)
    t.join(timeout=5)
    assert not t.is_alive()
    assert len(got) == 1 and got[0]["key"] == "DATAX-X:Input"
    assert json.loads(got[0]["member"]) == {"uts": 1000, "val": 42}
