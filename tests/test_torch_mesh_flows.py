"""Mesh twins of the JAX package's sharded-flow tests, each flow run four
ways on the same numpy inputs: the port on one CPU device and over 8
virtual CPU shards (``make_mesh(8, devices=("cpu",) * 8)``), and the JAX
package on its 8-device CPU mesh.

- ``test_baseline_configs.py``: config 5, a high-fanout GROUP BY, at 512
  rows and at stress scale (65,536 rows, about 12,000 groups);
- ``test_multisource.py``: the two-stream window join;
- ``test_sql_strings.py``: a string flow (UPPER, NOT LIKE, GROUP BY,
  HAVING, ORDER BY) over the string-op tables;
- ``test_conformance.py``: a mesh batch exports ``Mesh_ICI_Bytes`` and
  ``Mesh_Reshard_Count``, both runtime metrics.

The port's mesh gives its single device's rows in the same order and
equals the JAX package's mesh: ints exactly, floats within rtol 1e-5.
"""

import json

import jax
import numpy as np
import pytest
import torch

from data_accelerator_tpu.compile.planner import TableData as JTableData
from data_accelerator_tpu.constants import MetricName as JMetricName
from data_accelerator_tpu.core.schema import StringDictionary as JStringDictionary
from data_accelerator_tpu.dist import make_mesh as jmake_mesh
from data_accelerator_tpu.dist import row_sharding as jrow_sharding
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu_torch.constants import MetricName
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.core.schema import StringDictionary
from data_accelerator_tpu_torch.dist import make_mesh
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
import test_baseline_configs as baseline
import test_multisource as multisource

CPU8 = ("cpu",) * 8
BASE = 1_700_000_000_000


def _port(conf, mesh, **kw):
    """A port processor over a JAX-package conf's keys: one CPU device,
    or the 8-shard CPU mesh."""
    d = SettingDictionary(dict(conf.dict))
    if mesh:
        return FlowProcessor(d, mesh=make_mesh(8, devices=CPU8), **kw)
    return FlowProcessor(d, device="cpu", **kw)


def _jax_place(t, mesh):
    sh = jrow_sharding(mesh)
    return JTableData({k: jax.device_put(v, sh) for k, v in t.cols.items()},
                      jax.device_put(t.valid, sh))


def _same(got, want):
    """Equal row lists: ints (and strings) exactly, floats within rtol
    1e-5."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k, v in b.items():
            if isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=1e-5), k
            else:
                assert a[k] == v, k


def _by(rows, key):
    return sorted(rows, key=lambda r: r[key])


# -- config 5: high-fanout group-by sharded over the mesh -----------------
def test_config5_high_fanout_groupby_sharded_matches_single(tmp_path):
    transform = (
        "--DataXQuery--\n"
        "Fanout = SELECT deviceId, COUNT(*) AS Cnt, "
        "SUM(temperature) AS SumT FROM DataXProcessedInput "
        "GROUP BY deviceId\n"
    )
    cap = 512
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 200, cap)  # high fanout: ~200 groups
    temps = rng.uniform(0, 100, cap)
    rows = baseline._rows(ids.tolist(), temps.tolist(), [BASE] * cap)
    extra = {"datax.job.process.batchcapacity": str(cap),
             "datax.job.process.groupcapacity": "256"}
    conf = baseline._conf(tmp_path, transform, extra)

    out = {}
    for name, mesh in (("single", False), ("mesh", True)):
        proc = _port(conf, mesh, output_datasets=["Fanout"])
        out[name], _m = proc.process_batch(proc.encode_rows(rows, BASE), BASE)
    jmesh = jmake_mesh(8)
    jproc = JFlowProcessor(conf, output_datasets=["Fanout"], mesh=jmesh)
    jout, _m = jproc.process_batch(_jax_place(jproc.encode_rows(rows, BASE), jmesh), BASE)

    assert out["mesh"]["Fanout"] == out["single"]["Fanout"]
    _same(_by(out["mesh"]["Fanout"], "deviceId"), _by(jout["Fanout"], "deviceId"))
    assert len(out["mesh"]["Fanout"]) == len(set(ids))


def test_config5_stress_high_cardinality_sharded(tmp_path):
    """Config 5 at stress scale: 65,536 rows, ~12,000 distinct groups,
    a conf'd group capacity, over 8 virtual shards."""
    transform = (
        "--DataXQuery--\n"
        "Fanout = SELECT deviceId, COUNT(*) AS Cnt, SUM(temperature) AS S, "
        "MAX(temperature) AS M FROM DataXProcessedInput GROUP BY deviceId\n"
    )
    cap = 65536
    rng = np.random.RandomState(11)
    ids = rng.randint(0, 12_000, cap)
    temps = rng.uniform(0, 100, cap).round(3)
    conf = baseline._conf(tmp_path, transform, {
        "datax.job.process.batchcapacity": str(cap),
        "datax.job.process.maxgroups": "16384",
    })
    cols = {
        "deviceId": ids.astype(np.int32),
        "temperature": temps.astype(np.float32),
        "eventTimeStamp": np.zeros(cap, np.int32),
    }

    out = {}
    for name, mesh in (("single", False), ("mesh", True)):
        proc = _port(conf, mesh, output_datasets=["Fanout"])
        raw = proc.encode_columns({k: v.copy() for k, v in cols.items()}, cap)
        out[name] = proc.process_batch(raw, BASE)
    jmesh = jmake_mesh(8)
    jproc = JFlowProcessor(conf, output_datasets=["Fanout"], mesh=jmesh)
    jd, jm = jproc.process_batch(_jax_place(jproc.encode_columns(cols, cap), jmesh), BASE)

    (d1, m1), (d2, m2) = out["single"], out["mesh"]
    # float64 segment sums over the gathered rows in single-device order
    assert d2["Fanout"] == d1["Fanout"]
    assert len(d2["Fanout"]) == len(set(ids))
    _same(_by(d2["Fanout"], "deviceId"), _by(jd["Fanout"], "deviceId"))
    assert m1["Output_Fanout_GroupsDropped"] == m2["Output_Fanout_GroupsDropped"] == 0.0
    assert jm["Output_Fanout_GroupsDropped"] == 0.0


# -- the two-stream window join --------------------------------------------
def test_two_stream_join_sharded_matches_single(tmp_path):
    rng = np.random.RandomState(3)
    n = 64
    iot = multisource._iot_rows(
        rng.randint(1, 9, n).tolist(),
        rng.uniform(0, 40, n).round(2).tolist(),
        [BASE + 2000] * n,
    )
    wx = multisource._wx_rows(
        rng.randint(1, 9, n).tolist(),
        rng.uniform(0, 80, n).round(2).tolist(),
        [BASE] * n,
    )
    extra = {"datax.job.process.batchcapacity": "64"}

    def rows(proc, place=lambda t: t):
        proc.process_batch({"wx": place(proc.encode_rows(wx, BASE, source="wx"))}, BASE)
        d, _ = proc.process_batch(
            {"default": place(proc.encode_rows(iot, BASE + 2000))}, BASE + 2000)
        return [(r["deviceId"], r["temperature"], r["windSpeed"]) for r in d["Joined"]]

    single = rows(_port(multisource._conf(tmp_path / "s", multisource.JOIN_TRANSFORM, extra),
                        False, output_datasets=["Joined"]))
    sharded = rows(_port(multisource._conf(tmp_path / "m", multisource.JOIN_TRANSFORM, extra),
                         True, output_datasets=["Joined"]))
    jmesh = jmake_mesh(8)
    jproc = JFlowProcessor(multisource._conf(tmp_path / "j", multisource.JOIN_TRANSFORM, extra),
                           output_datasets=["Joined"], mesh=jmesh)
    jsharded = rows(jproc, lambda t: _jax_place(t, jmesh))
    assert sharded == single
    assert len(single) > 0  # the join actually matched across streams
    assert sorted(sharded) == pytest.approx(sorted(jsharded), rel=1e-5)


# -- a string flow: the string-op tables replicate -------------------------
def test_sharded_string_flow_matches_single_device():
    schema = json.dumps({"type": "struct", "fields": [
        {"name": "device", "type": "string", "nullable": False, "metadata": {}},
        {"name": "v", "type": "long", "nullable": False, "metadata": {}},
    ]})
    conf = {
        "datax.job.name": "strshard",
        "datax.job.input.default.blobschemafile": schema,
        "datax.job.process.transform": (
            "--DataXQuery--\n"
            "Agg = SELECT UPPER(device) AS dev, COUNT(*) AS c, SUM(v) AS s "
            "FROM DataXProcessedInput WHERE device NOT LIKE '%skip%' "
            "GROUP BY dev HAVING COUNT(*) >= 2 ORDER BY dev"
        ),
        "datax.job.input.default.batchcapacity": "64",
    }
    rows = [
        {"device": ["alpha", "Beta", "ALPHA", "skip-me", "beta", "gamma"][i % 6],
         "v": i}
        for i in range(40)
    ]
    data = b"\n".join(json.dumps(r).encode() for r in rows) + b"\n"

    def run(proc):
        raw = proc.encode_json_bytes(data, base_ms=0)
        ds, _ = proc.process_batch(raw, batch_time_ms=0)
        return [(r["dev"], r["c"], r["s"]) for r in ds["Agg"]]

    single = run(FlowProcessor(SettingDictionary(conf), dictionary=StringDictionary(),
                               output_datasets=["Agg"], device="cpu"))
    sharded = run(FlowProcessor(SettingDictionary(conf), dictionary=StringDictionary(),
                                output_datasets=["Agg"], mesh=make_mesh(8, devices=CPU8)))
    from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary

    jsharded = run(JFlowProcessor(JSettingDictionary(conf), dictionary=JStringDictionary(),
                                  output_datasets=["Agg"], mesh=jmake_mesh(8)))
    assert sharded == single == jsharded
    assert [d for d, _, _ in single] == sorted(d for d, _, _ in single)


# -- the census as runtime metrics -----------------------------------------
def test_mesh_run_exports_collective_census(tmp_path):
    """The mesh processor exports its step's collective census as the
    Mesh_* registry series, as the JAX package's does."""
    import types

    from test_dist import crafted_raw, make_conf

    proc = FlowProcessor(SettingDictionary(dict(make_conf(tmp_path).dict)),
                         batch_capacity=256, mesh=make_mesh(8, devices=CPU8),
                         output_datasets=["Hot", "PerDevice"])
    cols, valid = crafted_raw(types.SimpleNamespace(
        batch_capacity=proc.batch_capacity, raw_schema=proc.spec.raw_schema))
    from data_accelerator_tpu_torch.compile.planner import TableData

    raw = TableData({k: torch.from_numpy(v) for k, v in cols.items()},
                    torch.from_numpy(valid))
    _, metrics = proc.process_batch(raw, batch_time_ms=BASE)
    assert metrics["Mesh_ICI_Bytes"] > 0
    assert metrics["Mesh_Reshard_Count"] >= 1
    for name in ("Mesh_ICI_Bytes", "Mesh_Reshard_Count", "Conformance_MeshIci_Ratio"):
        assert MetricName.is_runtime_metric(name)
        assert JMetricName.is_runtime_metric(name)
    # off by conf: no census, no series
    quiet = FlowProcessor(
        SettingDictionary({**make_conf(tmp_path).dict,
                           "datax.job.process.mesh.observe": "false"}),
        batch_capacity=256, mesh=make_mesh(8, devices=CPU8),
        output_datasets=["Hot", "PerDevice"])
    _, metrics = quiet.process_batch(raw, batch_time_ms=BASE)
    assert "Mesh_ICI_Bytes" not in metrics and quiet.mesh_collectives is None
