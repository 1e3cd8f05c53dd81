"""The port's gateway (``serve/gateway.py``) against the JAX package's:
each package's gateway in front of its own control plane (roles on),
the same calls, the same statuses and bodies: authentication, the
reader/writer roles, the whitelist, stripped identity headers, unknown
services and an unreachable backend. Every server binds port 0 and
stops in the fixture's teardown."""

import json
import urllib.error
import urllib.request

import pytest

from data_accelerator_tpu.serve import gateway as jgateway
from data_accelerator_tpu_torch.serve import gateway as tgateway
from data_accelerator_tpu_torch.serve import restapi as trestapi

from test_torch_serve_restapi import make_api

GATEWAYS = {"jax": jgateway, "torch": tgateway}


def _call(port, method, path, token=None, body=None, headers=None):
    hdrs = dict(headers or {})
    if token:
        hdrs["Authorization"] = f"Bearer {token}"
    data = json.dumps(body).encode() if body is not None else None
    if data is not None:
        hdrs["Content-Type"] = "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=hdrs, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture
def stacks(tmp_path):
    """Per package: its API (roles on) behind its gateway."""
    out, parts = {}, []
    try:
        for pkg, gw_mod in GATEWAYS.items():
            api = make_api(pkg, str(tmp_path / pkg), require_roles=True)
            ra = __import__(f"{gw_mod.__name__.rsplit('.', 1)[0]}.restapi", fromlist=["x"])
            svc = ra.DataXApiService(api, port=0)
            svc.start()
            parts.append((svc, api))
            auth = gw_mod.AuthTable()
            auth.add("rtoken", "reader@contoso", [gw_mod.ROLE_READER])
            auth.add("wtoken", "writer@contoso", [gw_mod.ROLE_READER, gw_mod.ROLE_WRITER])
            auth.add("banned", "evil@contoso", [gw_mod.ROLE_WRITER])
            gw = gw_mod.Gateway(auth, backends={"flow": f"http://127.0.0.1:{svc.port}"},
                                port=0, whitelist=["reader@contoso", "writer@contoso"])
            gw.start()
            parts.append((gw, None))
            out[pkg] = gw
        yield out
    finally:
        for server, api in reversed(parts):
            server.stop()
            if api is not None:
                api.livequery.stop()


CALLS = {
    "unauthenticated": ("GET", "/api/flow/flow/getall", None, None, None),
    "reader_get": ("GET", "/api/flow/flow/getall", "rtoken", None, None),
    "reader_post": ("POST", "/api/flow/flow/save", "rtoken", {"name": "f1"}, None),
    "writer_post": ("POST", "/api/flow/flow/save", "wtoken",
                    {"name": "f1", "displayName": "F1"}, None),
    "whitelist": ("GET", "/api/flow/flow/getall", "banned", None, None),
    "smuggled_roles": ("POST", "/api/flow/flow/save", "rtoken", {"name": "f2"},
                       {"X-DataX-Roles": "DataXWriter"}),
    "unknown_service": ("GET", "/api/nope/x", "rtoken", None, None),
    "not_api": ("GET", "/other", "rtoken", None, None),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_gateway_equals_the_reference(stacks, case):
    method, path, token, body, headers = CALLS[case]
    got = {pkg: _call(gw.port, method, path, token, body, headers)
           for pkg, gw in stacks.items()}
    assert got["torch"] == got["jax"]


def test_statuses_are_the_gateways_contract(stacks):
    port = stacks["torch"].port
    assert [_call(port, *CALLS[c][:2], *CALLS[c][2:])[0] for c in (
        "unauthenticated", "reader_get", "reader_post", "writer_post", "whitelist",
        "smuggled_roles", "unknown_service")] == [401, 200, 403, 200, 403, 403, 404]


def test_backend_unreachable_502():
    gw = tgateway.Gateway(tgateway.AuthTable({"t": ("u", [tgateway.ROLE_READER])}),
                          backends={"flow": "http://127.0.0.1:1"}, port=0)
    gw.start()
    try:
        assert _call(gw.port, "GET", "/api/flow/flow/getall", token="t")[0] == 502
    finally:
        gw.stop()


def test_auth_table_from_file(tmp_path):
    p = tmp_path / "auth.json"
    p.write_text(json.dumps({"tok1": {"user": "a@b", "roles": [tgateway.ROLE_READER]}}))
    table = tgateway.AuthTable.from_file(str(p))
    assert table.resolve("tok1") == ("a@b", [tgateway.ROLE_READER])
    assert table.resolve("nope") is None
    assert trestapi.ROLE_WRITER == tgateway.ROLE_WRITER
