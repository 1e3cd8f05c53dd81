"""The port's designer kernels (``serve/livequery.py``), schema inference
(``serve/schemainference.py``) and runtime storage (``serve/storage.py``)
against the JAX package's.

The same numpy-seeded rows go to both packages' ``KernelService``, the
port's with ``device="cpu"``; results must be equal (headers, rows, ints
exact, floats within ``RTOL``). ``TestLiveQueryWindows`` mirrors
``tests/test_properties_livequery.py``'s, ``TestLiveQuery`` the kernel
tests of ``tests/test_serve_designtime.py``. Then the port's own:
``FlowProcessor.reset_state`` idempotence, the per-processor lock under
threads, the refusal of ``debug``, and the designer path from a sampled
source through the sample blob to an executed query with the anomaly
UDF.
"""

import json
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import chip_smoke
from data_accelerator_tpu.lq import session as jax_session
from data_accelerator_tpu.runtime.sources import FileSource as JaxFileSource
from data_accelerator_tpu.serve import livequery as jax_livequery
from data_accelerator_tpu.serve import schemainference as jax_si
from data_accelerator_tpu.serve import storage as jax_storage
from data_accelerator_tpu.serve.objectstore import ObjectStoreClient as JaxClient
from data_accelerator_tpu.udf.samples import anomalyscore as jax_anomalyscore
from data_accelerator_tpu_torch.core.config import EngineException
from data_accelerator_tpu_torch.lq import session as torch_session
from data_accelerator_tpu_torch.runtime.sources import FileSource
from data_accelerator_tpu_torch.serve import livequery
from data_accelerator_tpu_torch.serve import schemainference as si
from data_accelerator_tpu_torch.serve import storage
from data_accelerator_tpu_torch.serve.objectstore import (
    ObjectStoreClient,
    ObjectStoreServer,
)
from data_accelerator_tpu_torch.udf.samples import anomalyscore

# float32 columns: projections and MAX are exact, AVG sums in float64 in
# the port and float32 in the JAX package, the anomaly score is float32
RTOL = 1e-5
PKGS = ("jax", "torch")
LQ = {"jax": jax_livequery, "torch": livequery}
DEV = {"jax": {}, "torch": {"device": "cpu"}}

SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
    {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
     "metadata": {}},
]})
BASE = 1_700_000_000_000


def _rows(n=2, ts=BASE, seed=0):
    temps = np.round(np.random.RandomState(seed).uniform(0, 100, n), 3)
    return [
        {"deviceId": i, "temperature": float(temps[i]), "eventTimeStamp": ts}
        for i in range(n)
    ]


def service(pkg, **kw):
    return LQ[pkg].KernelService(**DEV[pkg], **kw)


def same_result(port, ref, rtol=RTOL):
    assert port["headers"] == ref["headers"]
    assert port.get("table") == ref.get("table")
    assert len(port["result"]) == len(ref["result"])
    for p, r in zip(port["result"], ref["result"]):
        assert p.keys() == r.keys()
        for k, pv in p.items():
            rv = r[k]
            if isinstance(rv, float):
                assert isinstance(pv, float) and pv == pytest.approx(rv, rel=rtol), k
            else:
                assert pv == rv, k


def both(rows, queries, schema=SCHEMA, **create):
    """Each query on one kernel of each package; the port's results,
    each held equal to the JAX package's."""
    out = {}
    for pkg in PKGS:
        svc = service(pkg)
        kid = svc.create_kernel("LQFlow", schema, sample_rows=rows, **create)
        out[pkg] = [svc.execute(kid, q) for q in queries]
    for p, r in zip(out["torch"], out["jax"]):
        same_result(p, r)
    return out["torch"]


class TestLiveQueryWindows:
    def test_timewindow_honors_sample_time_axis(self):
        rows = _rows(3, ts=BASE) + _rows(2, ts=BASE - 8_000, seed=1)
        w, a = both(rows, [
            "W = SELECT COUNT(*) AS Cnt FROM DataXProcessedInput_5seconds",
            "A = SELECT COUNT(*) AS Cnt FROM DataXProcessedInput",
        ])
        assert w["result"][0]["Cnt"] == 3 and a["result"][0]["Cnt"] == 5

    def test_timewindow_minutes_unit(self):
        rows = _rows(2, ts=BASE) + _rows(1, ts=BASE - 3 * 60_000, seed=1)
        (w,) = both(rows, [
            "W = SELECT COUNT(*) AS Cnt FROM DataXProcessedInput_2minutes"])
        assert w["result"][0]["Cnt"] == 2

    def test_repeated_execute_is_idempotent(self):
        q = "W = SELECT COUNT(*) AS Cnt FROM DataXProcessedInput_5seconds"
        first, second = both(_rows(3, ts=BASE), [q, q])
        assert first["result"][0]["Cnt"] == second["result"][0]["Cnt"] == 3

    def test_unparseable_window_name_falls_back_to_alias(self):
        rows = _rows(2, ts=BASE) + _rows(1, ts=BASE - 60_000, seed=1)
        (w,) = both(rows, [
            "W = SELECT COUNT(*) AS Cnt FROM DataXProcessedInput_Window"])
        assert w["result"][0]["Cnt"] == 3


# -- tests/test_serve_designtime.py's kernels ---------------------------------
DT_SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "deviceId", "type": "long", "nullable": False,
         "metadata": {"allowedValues": [1, 2, 3]}},
        {"name": "deviceType", "type": "string", "nullable": False,
         "metadata": {"allowedValues": ["DoorLock", "Heating"]}},
        {"name": "status", "type": "long", "nullable": False,
         "metadata": {"allowedValues": [0, 1]}},
    ],
})
SAMPLE = [
    {"deviceId": 1, "deviceType": "DoorLock", "status": 0},
    {"deviceId": 2, "deviceType": "DoorLock", "status": 1},
    {"deviceId": 3, "deviceType": "Heating", "status": 1},
    {"deviceId": 1, "deviceType": "DoorLock", "status": 0},
]


class TestLiveQuery:
    def test_execute_query(self):
        (out,) = both(SAMPLE, [
            "OpenDoors = SELECT deviceId, status FROM DataXProcessedInput "
            "WHERE deviceType = 'DoorLock' AND status = 0"], schema=DT_SCHEMA)
        assert out["table"] == "OpenDoors"
        assert out["headers"] == ["deviceId", "status"]
        assert sorted(r["deviceId"] for r in out["result"]) == [1, 1]

    def test_bare_select_and_aggregation(self):
        (out,) = both(SAMPLE, [
            "SELECT deviceType, COUNT(*) AS Cnt FROM DataXProcessedInput "
            "GROUP BY deviceType"], schema=DT_SCHEMA)
        assert {r["deviceType"]: r["Cnt"] for r in out["result"]} == {
            "DoorLock": 3, "Heating": 1}

    def test_windowed_table_aliases_to_sample(self):
        (out,) = both(SAMPLE, [
            "W = SELECT deviceId, COUNT(*) AS Cnt "
            "FROM DataXProcessedInput_5minutes GROUP BY deviceId"], schema=DT_SCHEMA)
        assert {r["deviceId"]: r["Cnt"] for r in out["result"]} == {1: 2, 2: 1, 3: 1}

    def test_processor_cache_reused(self):
        q = "T = SELECT deviceId FROM DataXProcessedInput"
        for pkg in PKGS:
            svc = service(pkg)
            kid = svc.create_kernel("LQFlow", DT_SCHEMA, sample_rows=SAMPLE)
            svc.execute(kid, q)
            svc.execute(kid, q)
            assert len(svc.get(kid)._processors) == 1

    def test_kernel_gc_ttl_and_capacity(self):
        clock = [0.0]
        for pkg, session in (("jax", jax_session), ("torch", torch_session)):
            mgr = session.SessionManager(ttl_s=10.0, now_fn=lambda: clock[0])
            svc = service(pkg, max_kernels=2, session_manager=mgr)
            clock[0] = 0.0
            k1 = svc.create_kernel("F", DT_SCHEMA, sample_rows=SAMPLE)
            clock[0] = 11.0
            k2 = svc.create_kernel("F", DT_SCHEMA, sample_rows=SAMPLE)
            assert [k["id"] for k in svc.list_kernels()] == [k2]
            with pytest.raises(KeyError):
                svc.get(k1)
            k3 = svc.create_kernel("F", DT_SCHEMA, sample_rows=SAMPLE)
            clock[0] = 12.0
            svc.create_kernel("F", DT_SCHEMA, sample_rows=SAMPLE)
            # the cap recycles the oldest-idle kernel, k2
            ids = [k["id"] for k in svc.list_kernels()]
            assert len(ids) == 2 and k2 not in ids and k3 in ids

    def test_delete_kernels_per_flow(self):
        for pkg in PKGS:
            svc = service(pkg)
            svc.create_kernel("A", DT_SCHEMA, sample_rows=SAMPLE)
            svc.create_kernel("B", DT_SCHEMA, sample_rows=SAMPLE)
            assert svc.delete_kernels("A") == 1
            assert [k["flow"] for k in svc.list_kernels()] == ["B"]

    def test_sample_loaded_from_storage(self, tmp_path):
        out = {}
        for pkg, st in (("jax", jax_storage), ("torch", storage)):
            runtime = st.LocalRuntimeStorage(str(tmp_path / pkg))
            runtime.save_file("SFlow/samples/sample.json",
                              "\n".join(json.dumps(r) for r in SAMPLE))
            svc = service(pkg, runtime_storage=runtime)
            assert svc.has_sample("SFlow") and not svc.has_sample("Other")
            kid = svc.create_kernel("SFlow", DT_SCHEMA)
            out[pkg] = svc.execute(kid, "T = SELECT deviceId FROM DataXProcessedInput")
        same_result(out["torch"], out["jax"])
        assert len(out["torch"]["result"]) == 4


# -- the port's own kernel semantics ------------------------------------------
class TestPortKernel:
    def test_reset_state_makes_executes_idempotent(self):
        """Three executes of a windowed query on one kernel: equal rows
        each time, the same rings zeroed in place, and one step build."""
        rows = _rows(6, ts=BASE) + _rows(3, ts=BASE - 2_000, seed=3)
        q = ("W = SELECT deviceId, COUNT(*) AS Cnt, MAX(temperature) AS T "
             "FROM DataXProcessedInput_5seconds GROUP BY deviceId")
        svc = service("torch")
        kid = svc.create_kernel("LQFlow", SCHEMA, sample_rows=rows)
        results = [svc.execute(kid, q) for _ in range(3)]
        assert results[0] == results[1] == results[2]
        (proc,) = svc.get(kid)._processors.values()
        ring = next(iter(proc.window_buffers.values()))
        valid = ring.valid
        assert int(ring.valid.sum()) == len(rows)
        proc.reset_state()
        assert ring.valid is valid and not bool(valid.any())
        assert all(not bool(a.any()) for a in ring.cols.values())
        assert proc._slot_counter == 0 and proc._base_ms is None
        assert proc.transfer_ewma == {} and proc._step_cache_size() == 1
        (ref,) = both(rows, [q])
        same_result(results[0], ref)

    def test_threads_on_one_kernel_equal_a_serial_run(self, monkeypatch):
        """Executes of one query from many threads at once, with a short
        switch interval and a pause after each encode that widens the
        window for another thread's reset: each caller's rows equal a
        serial run's (one lock per processor across reset, encode and
        step)."""
        import time

        from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

        encode = FlowProcessor.encode_rows

        def slow_encode(self, *a, **k):
            raw = encode(self, *a, **k)
            time.sleep(0.0005)
            return raw

        rows = _rows(40, ts=BASE) + _rows(20, ts=BASE - 9_000, seed=4)
        queries = [
            "W = SELECT deviceId, COUNT(*) AS Cnt FROM "
            "DataXProcessedInput_5seconds GROUP BY deviceId",
            "A = SELECT deviceId, MAX(temperature) AS T FROM "
            "DataXProcessedInput GROUP BY deviceId",
        ]
        svc = service("torch")
        kid = svc.create_kernel("LQFlow", SCHEMA, sample_rows=rows)
        serial = {q: svc.execute(kid, q) for q in queries}
        monkeypatch.setattr(FlowProcessor, "encode_rows", slow_encode)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with ThreadPoolExecutor(12) as ex:
                futs = [(q, ex.submit(svc.execute, kid, q))
                        for q in queries * 48]
                got = [(q, f.result(timeout=60)) for q, f in futs]
        finally:
            sys.setswitchinterval(old)
        assert len(got) == 96
        for q, r in got:
            assert r == serial[q]
        assert len(svc.get(kid)._processors) == 2

    @pytest.mark.parametrize("debug", [True, {"nans": "true"}])
    def test_debug_is_refused_at_the_first_execute(self, debug):
        svc = service("torch")
        kid = svc.create_kernel("DbgFlow", SCHEMA, sample_rows=_rows(2),
                                debug=debug)
        with pytest.raises(EngineException,
                           match=r"debug guards \(process.debug.\*\) is not ported"):
            svc.execute(kid, "S = SELECT deviceId FROM DataXProcessedInput")
        # the same kernel without debug runs
        kid2 = svc.create_kernel("DbgFlow", SCHEMA, sample_rows=_rows(2))
        assert len(svc.execute(kid2, "S = SELECT deviceId FROM "
                                     "DataXProcessedInput")["result"]) == 2

    def test_kernel_builds_on_its_device(self):
        svc = service("torch")
        kid = svc.create_kernel("LQFlow", SCHEMA, sample_rows=_rows(3))
        svc.execute(kid, "S = SELECT deviceId FROM DataXProcessedInput")
        kernel = svc.get(kid)
        assert kernel.device == "cpu"
        (proc,) = kernel._processors.values()
        assert proc.device.type == "cpu" and proc.batch_capacity == 64


# -- schema inference ----------------------------------------------------------
EVENT_SETS = {
    "scalars": [{"a": 1, "b": 2.5, "c": "x", "d": True}],
    "widen": [{"v": 1}, {"v": 2.5}],
    "conflict": [{"v": 1}, {"v": "x"}],
    "missing": [{"a": 1, "b": 2}, {"a": 3}],
    "nested": [{"device": {"id": 1, "type": "DoorLock"}},
               {"device": {"id": 2, "temp": 21.5}}],
    "array": [{"xs": [1, 2]}, {"xs": [3.5]}],
    "nulls": [{"v": None}, {"v": 3}, {"w": [None, {"k": "s"}]}],
}


@pytest.mark.parametrize("name", sorted(EVENT_SETS))
def test_infer_schema_equals_the_jax_package(name):
    events = EVENT_SETS[name]
    assert json.dumps(si.infer_schema(events)) == json.dumps(
        jax_si.infer_schema(events))


def _payload_events(seed, n):
    return [json.loads(ln) for ln in
            chip_smoke.make_json_payload(np.random.RandomState(seed), n)
            .decode().splitlines()]


def test_infer_schema_of_the_iot_payload_equals_the_jax_package():
    events = _payload_events(5, 300)
    schema = si.infer_schema(events)
    assert json.dumps(schema) == json.dumps(jax_si.infer_schema(events))
    by = {f["name"]: f for f in schema["fields"]}
    inner = {f["name"]: f for f in by["deviceDetails"]["type"]["fields"]}
    assert inner["deviceType"]["metadata"] == {
        "allowedValues": sorted(chip_smoke.DEVICE_TYPES)}
    assert by["eventTimeStamp"]["type"] == "long"


def test_sample_blob_from_a_polled_source_equals_the_jax_package(tmp_path):
    """Both managers poll the same newline-JSON file through their
    package's ``FileSource`` (the default 1,000 events) and write the
    sample blob through their ``LocalRuntimeStorage``: byte for byte
    equal, and equal results."""
    path = tmp_path / "in.json"
    path.write_bytes(chip_smoke.make_json_payload(np.random.RandomState(6), 1200))
    out = {}
    for pkg, mod, st, src in (("jax", jax_si, jax_storage, JaxFileSource),
                              ("torch", si, storage, FileSource)):
        runtime = st.LocalRuntimeStorage(str(tmp_path / pkg))
        res = mod.SchemaInferenceManager(runtime).get_input_schema(
            source=src([str(path)]), flow_name="IotFlow")
        blob = (tmp_path / pkg / "IotFlow" / "samples" / "sample.json").read_bytes()
        out[pkg] = (res["Schema"], res["EventsSampled"], res["Samples"], blob)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 1000


def test_designer_path_from_the_sample_blob(tmp_path, monkeypatch):
    """The designer path on both packages: 1,000 sampled events written
    as the blob, a kernel built from it with the config-1 flow's schema
    and normalization and the anomaly UDF, then DoorEvents, OpenDoors,
    HeatAvg over the 5 s window and the anomaly query. The clock both
    kernels read for a timestamp-less sample is pinned, so
    ``current_timestamp()`` agrees."""
    pinned = types.SimpleNamespace(time=lambda: 1_792_000_000.25)
    monkeypatch.setattr(jax_livequery, "time", pinned)
    monkeypatch.setattr(livequery, "time", pinned)
    conf = chip_smoke.flow_conf()
    events = _payload_events(7, 1000)
    queries = chip_smoke.designer_queries()
    out = {}
    for pkg, st, udf in (("jax", jax_storage, jax_anomalyscore),
                         ("torch", storage, anomalyscore)):
        runtime = st.LocalRuntimeStorage(str(tmp_path / pkg))
        {"jax": jax_si, "torch": si}[pkg].SchemaInferenceManager(
            runtime).get_input_schema(events=events, flow_name="Designer")
        svc = service(pkg, runtime_storage=runtime)
        kid = svc.create_kernel(
            "Designer", conf["datax.job.input.default.blobschemafile"],
            normalization=conf["datax.job.process.projection"],
            udfs={"anomalyscore": udf()},
        )
        out[pkg] = {n: svc.execute(kid, q, max_rows=1000) for n, q in queries.items()}
    for n in queries:
        same_result(out["torch"][n], out["jax"][n])
    got = out["torch"]
    assert len(got["DoorEvents"]["result"]) == 1000
    assert {r["eventTimeStamp"] for r in got["DoorEvents"]["result"]} == {1_792_000_000_250}
    assert 0 < len(got["OpenDoors"]["result"]) < 1000
    assert sum(r["Cnt"] for r in got["HeatAvg"]["result"]) == 1000
    scores = [r["score"] for r in got["Scored"]["result"]]
    assert len(scores) == 1000 and all(0.5 <= s <= 1.0 for s in scores)


# -- runtime storage -------------------------------------------------------------
def _storage_ops(runtime):
    """The RuntimeStorage surface the designer and the engine use."""
    saved = runtime.save_file("flowA/samples/sample.json", '{"a": 1}\n{"a": 2}')
    runtime.save_file("flowA/conf/job.conf", "datax.job.name=A\n")
    runtime.save_file("flowA2/x.txt", "sibling")
    out = {
        "read": runtime.read_file("flowA/samples/sample.json"),
        "exists": (runtime.exists("flowA/samples/sample.json"),
                   runtime.exists("flowA/none.json")),
        "list": runtime.list_files("flowA"),
        "file": runtime.list_files("flowA/conf/job.conf"),
    }
    runtime.delete_all("flowA")
    out["after"] = (runtime.list_files("flowA"), runtime.list_files("flowA2"))
    return saved, out


def test_local_runtime_storage_equals_the_jax_package(tmp_path):
    out = {}
    for pkg, st in (("jax", jax_storage), ("torch", storage)):
        root = tmp_path / pkg
        saved, ops = _storage_ops(st.LocalRuntimeStorage(str(root)))
        assert saved == str(root / "flowA" / "samples" / "sample.json")
        with pytest.raises(ValueError, match="outside runtime root"):
            st.LocalRuntimeStorage(str(root)).delete_all("../elsewhere")
        out[pkg] = ops
    assert out["torch"] == out["jax"]
    assert out["torch"]["list"] == ["flowA/conf/job.conf", "flowA/samples/sample.json"]
    assert out["torch"]["after"] == ([], ["flowA2/x.txt"])


def test_object_runtime_storage_equals_the_jax_package(tmp_path):
    server = ObjectStoreServer(port=0).start()
    try:
        out = {}
        for pkg, st, client in (("jax", jax_storage, JaxClient),
                                ("torch", storage, ObjectStoreClient)):
            runtime = st.ObjectRuntimeStorage(
                client(server.endpoint, bucket=f"b-{pkg}"),
                scratch_dir=str(tmp_path / pkg))
            saved, ops = _storage_ops(runtime)
            assert saved.startswith("objstore://")
            with pytest.raises(FileNotFoundError):
                runtime.read_file("flowA/samples/sample.json")
            out[pkg] = (saved.replace(f"b-{pkg}", "b"), ops)
        assert out["torch"] == out["jax"]
        # a kernel service reads its sample blob through the object store
        runtime = storage.ObjectRuntimeStorage(
            ObjectStoreClient(server.endpoint, bucket="lq"))
        runtime.save_file("SFlow/samples/sample.json",
                          "\n".join(json.dumps(r) for r in SAMPLE))
        svc = service("torch", runtime_storage=runtime)
        kid = svc.create_kernel("SFlow", DT_SCHEMA)
        assert len(svc.execute(kid, "T = SELECT deviceId FROM "
                                    "DataXProcessedInput")["result"]) == 4
    finally:
        server.stop()


def test_sample_events_stops_at_max_events():
    class Source:
        def __init__(self):
            self.acks = 0
            self.lock = threading.Lock()

        def poll(self, n):
            return [{"i": k} for k in range(min(n, 7))], {}

        def ack(self):
            self.acks += 1

    for mod in (jax_si, si):
        src = Source()
        events = mod.SchemaInferenceManager().sample_events(src, seconds=5.0,
                                                            max_events=20)
        assert [e["i"] for e in events] == [0, 1, 2, 3, 4, 5, 6] * 2 + list(range(6))
        assert src.acks == 3
