"""The control plane's design-time pieces in the port against the JAX
package's: the design-time flow store and the job registry (local and
over the object store), token templating, the query editor's SQL
analyzer, and the simulated-data generator (equal rows from the same
seed). Each case feeds the same inputs to both packages; everything
compared is exact (strings, ints, dicts)."""

import pytest

from data_accelerator_tpu.core.schema import Schema as JSchema
from data_accelerator_tpu.serve import simulateddata as jsim
from data_accelerator_tpu.serve import sqlanalyzer as jsql
from data_accelerator_tpu.serve import storage as jstorage
from data_accelerator_tpu.serve import templating as jtmpl
from data_accelerator_tpu_torch.core.schema import Schema
from data_accelerator_tpu_torch.serve import simulateddata as tsim
from data_accelerator_tpu_torch.serve import sqlanalyzer as tsql
from data_accelerator_tpu_torch.serve import storage as tstorage
from data_accelerator_tpu_torch.serve import templating as ttmpl
from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreClient, ObjectStoreServer

from test_ingestor_simdata import IOT_SCHEMA
from test_serve_designtime import TestSqlAnalyzer
from test_serve_generation import make_gui

PACKAGES = {"jax": (jstorage, jtmpl, jsql, jsim, JSchema),
            "torch": (tstorage, ttmpl, tsql, tsim, Schema)}


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------
def _design_ops(store) -> list:
    """One sequence of design-store calls; returns what each returned."""
    out = [store.get_by_name("F1"), store.get_all()]
    out.append(store.save({"name": "F1", "gui": make_gui("F1")}))
    out.append(store.save({"name": "F2", "displayName": "two"}))
    out.append(store.save({"name": "F1", "gui": make_gui("F1"), "jobNames": ["j"]}))
    out += [store.get_by_name("F1"), store.get_all(), store.delete("F2"),
            store.delete("F2"), store.get_all()]
    with pytest.raises(ValueError):
        store.save({"displayName": "no name"})
    return out


def _registry_ops(reg) -> list:
    out = [reg.get("j1"), reg.get_all()]
    out.append(reg.upsert({"name": "j1", "state": "idle", "flow": "F"}))
    out.append(reg.upsert({"name": "j1", "state": "running"}))
    out.append(reg.upsert({"name": "j2", "state": "idle"}))
    out += [reg.get("j1"), sorted(j["name"] for j in reg.get_all())]
    reg.delete("j1")
    out += [reg.get("j1"), [j["name"] for j in reg.get_all()]]
    return out


def test_local_design_store_and_registry_equal_the_reference(tmp_path):
    got = {}
    for name, (st, *_rest) in PACKAGES.items():
        design = st.LocalDesignTimeStorage(str(tmp_path / name / "design"))
        runtime = st.LocalRuntimeStorage(str(tmp_path / name / "runtime"))
        got[name] = (_design_ops(design), _registry_ops(st.JobRegistry(runtime)),
                     sorted(runtime.list_files("jobs")))
    assert got["torch"] == got["jax"]


def test_object_design_store_and_registry_equal_the_reference(tmp_path):
    server = ObjectStoreServer(port=0).start()
    try:
        got = {}
        for name, (st, *_rest) in PACKAGES.items():
            # one bucket each: the two packages share the server
            client = ObjectStoreClient(server.endpoint, bucket=f"dxtpu-{name}")
            design = st.ObjectDesignTimeStorage(client)
            runtime = st.ObjectRuntimeStorage(client, scratch_dir=str(tmp_path / name))
            got[name] = (_design_ops(design), _registry_ops(st.JobRegistry(runtime)))
        assert got["torch"] == got["jax"]
    finally:
        server.stop()


def test_path_confinement_equals_the_reference(tmp_path):
    victim = tmp_path / "victim"
    victim.mkdir()
    for name, (st, *_rest) in PACKAGES.items():
        runtime = st.LocalRuntimeStorage(str(tmp_path / name))
        with pytest.raises(ValueError):
            runtime.delete_all(str(victim))
    assert victim.exists()


# ---------------------------------------------------------------------------
# templating
# ---------------------------------------------------------------------------
TEMPLATE_CASES = {
    "plain_and_secret": ({"name": "Flow1", "base": "/data"},
                         ["${base}/${name}", "_S_{name}"]),
    "whole_string_json": ({"windows": [{"name": "w", "windowDuration": "5 s"}]},
                          [{"timeWindows": "_S_{windows}"}]),
    "fixed_point": ({"a": "${b}/x", "b": "base"}, ["${a}"]),
    "unknown_survives": ({}, ["_S_{missing}", {"k": "_S_{missing}"}]),
    "nested_document": ({"n": "F", "c": 4096, "flag": True},
                        [{"job": {"name": "${n}", "cap": "_S_{c}",
                                  "l": ["_S_{flag}", "x-${n}"]}}]),
}


@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_templating_equals_the_reference(case):
    tokens, values = TEMPLATE_CASES[case]
    for v in values:
        want = jtmpl.TokenDictionary(dict(tokens)).replace(v)
        got = ttmpl.TokenDictionary(dict(tokens)).replace(v)
        assert got == want
        assert ttmpl.unresolved_tokens(got) == jtmpl.unresolved_tokens(want)


# ---------------------------------------------------------------------------
# SQL analyzer
# ---------------------------------------------------------------------------
SQL_CASES = {
    "table_graph": (TestSqlAnalyzer.SCRIPT, ["deviceId", "deviceType", "status"]),
    "windowed": ("--DataXQuery--\nW = SELECT deviceId FROM "
                 "DataXProcessedInput_5minutes GROUP BY deviceId;\n", ["deviceId"]),
    "bad_sql": ("--DataXQuery--\nT = SELECTX nope;\n", []),
    "designer_script": (make_gui()["process"]["queries"][0], []),
}


def _analysis(mod, script, cols) -> dict:
    res = mod.SqlAnalyzer().analyze(script, input_columns=cols)
    return {"tables": [(t.name, t.columns, t.depends_on) for t in res.tables],
            "errors": list(res.errors)}


@pytest.mark.parametrize("case", sorted(SQL_CASES))
def test_sql_analyzer_equals_the_reference(case):
    script, cols = SQL_CASES[case]
    assert _analysis(tsql, script, cols) == _analysis(jsql, script, cols)


# ---------------------------------------------------------------------------
# simulated data
# ---------------------------------------------------------------------------
RULES = [{"deviceDetails": {"deviceType": "DoorLock", "status": 0}},
         {"deviceDetails.status": 0}]


@pytest.mark.parametrize("seed", [1, 7])
def test_simulated_batches_equal_the_reference_from_one_seed(seed):
    batches = {}
    for name, (_st, _tm, _sq, sim, schema_cls) in PACKAGES.items():
        svc = sim.SimulatedDataService(
            schema_cls.from_spark_json(IOT_SCHEMA), "127.0.0.1", 9,
            rule_rows=RULES, seed=seed,
        )
        batches[name] = [svc.make_batch(n, 1_000 + 10 * i, with_rules=i % 2 == 0)
                         for i, n in enumerate((5, 3, 8))]
        batches[name].append(svc.rule_events_sent)
    assert batches["torch"] == batches["jax"]


def test_simulated_data_feeds_the_ports_socket_source():
    """The port's generator into the port's ``SocketSource`` at a rate,
    with rule rows overlaid (``test_ingestor_simdata.py``'s case)."""
    import time

    from data_accelerator_tpu_torch.runtime.sources import SocketSource

    src = SocketSource(port=0)
    svc = tsim.SimulatedDataService(
        Schema.from_spark_json(IOT_SCHEMA), "127.0.0.1", src.port,
        events_per_second=2000, rule_period_s=0.0,
        rule_rows=[{"deviceDetails": {"status": 0}}], seed=2,
    )
    try:
        svc.start()
        rows = []
        deadline = time.time() + 5
        while time.time() < deadline and len(rows) < 200:
            got, _ = src.poll(1000)
            rows.extend(got)
            src.ack()
            time.sleep(0.02)
        assert len(rows) >= 200
        assert svc.rule_events_sent > 0
        assert any(r["deviceDetails"]["status"] == 0 for r in rows)
    finally:
        svc.stop()
        src.close()


def test_serve_exports_the_references_less_the_scenarios():
    """``serve/__init__.py`` exports the JAX package's names: since slice
    9b the scenario runner's (``Scenario``, ``ScenarioContext``) too."""
    import data_accelerator_tpu.serve as jserve
    import data_accelerator_tpu_torch.serve as tserve

    assert set(tserve.__all__) == set(jserve.__all__)
    assert {"Scenario", "ScenarioContext"} <= set(tserve.__all__)
    for name in tserve.__all__:
        assert getattr(tserve, name).__module__.startswith("data_accelerator_tpu_torch.")
