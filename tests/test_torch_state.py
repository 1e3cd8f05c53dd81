"""State tables and partitioned state in the PyTorch port against the JAX
package, on the CPU, with inputs made by numpy from a seed: BASELINE
config 3 (the accumulator plus the window self-join) batch for batch,
the restart and torn-write cases of ``test_recovery.py``, the pipelined
accumulator of ``test_pipelined.py``, the two-replica -> one-successor
handoff of ``chip_smoke.py``'s ``state`` phase through an in-process
object store, snapshots each package writes loading in the other, and
the DX530/DX531 load fallbacks as ``state/fallback`` telemetry events.
"""

import functools
import io
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from data_accelerator_tpu.compile.planner import TableData as JTableData
from data_accelerator_tpu.compile.planner import ViewSchema as JViewSchema
from data_accelerator_tpu.core.config import SettingDictionary as JSD
from data_accelerator_tpu.core.schema import StringDictionary as JStringDictionary
from data_accelerator_tpu.obs import telemetry as jtelemetry
from data_accelerator_tpu.runtime import host as jhost_mod
from data_accelerator_tpu.runtime import sinks as jsinks
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu.runtime.statetable import StateTable as JStateTable
from data_accelerator_tpu_torch.compile.planner import TableData, ViewSchema
from data_accelerator_tpu_torch.constants import MetricName
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.core.schema import StringDictionary
from data_accelerator_tpu_torch.obs import telemetry as ttelemetry
from data_accelerator_tpu_torch.runtime import host as thost_mod
from data_accelerator_tpu_torch.runtime import sinks as tsinks
from data_accelerator_tpu_torch.runtime import statetable as tstatetable
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from data_accelerator_tpu_torch.runtime.statepartition import LocalSnapshotStore, partition_of
from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreServer
from test_torch_host import _BytesSource, _Clock, _RecordingSink

StateTable = functools.partial(tstatetable.StateTable, device="cpu")
BASE_MS = 1_700_000_000_000

IOT_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
    {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
     "metadata": {"useCurrentTimeMillis": True}},
]})
KV_SCHEMA = chip_smoke.STATE_SCHEMA
# BASELINE config 3 (tests/test_baseline_configs.py): device peaks
# accumulated across batches, the batch joined against its 5 s window
CONFIG3_TRANSFORM = (
    "--DataXQuery--\n"
    "peaks_in = SELECT deviceId, temperature AS peak "
    "FROM DataXProcessedInput WHERE temperature > 50\n"
    "--DataXQuery--\n"
    "merged = SELECT deviceId, peak FROM peaks_in "
    "UNION ALL SELECT deviceId, peak FROM peaks\n"
    "--DataXQuery--\n"
    "peaks = SELECT deviceId, MAX(peak) AS peak FROM merged "
    "GROUP BY deviceId\n"
    "--DataXQuery--\n"
    "Joined = SELECT a.deviceId, a.temperature, b.temperature AS prior "
    "FROM DataXProcessedInput a INNER JOIN "
    "DataXProcessedInput_5seconds b ON a.deviceId = b.deviceId "
    "WHERE b.temperature < a.temperature\n"
)


def _config3(tmp_path, pkg):
    t = tmp_path / "config3.transform"
    t.write_text(CONFIG3_TRANSFORM)
    return {
        "datax.job.name": "BaselineCfg3",
        "datax.job.input.default.blobschemafile": IOT_SCHEMA,
        "datax.job.process.transform": str(t),
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.batchcapacity": "32",
        "datax.job.process.timewindow.DataXProcessedInput_5seconds"
        ".windowduration": "5 seconds",
        "datax.job.process.statetable.peaks.schema": "deviceId long, peak double",
        "datax.job.process.statetable.peaks.location": str(tmp_path / pkg / "state"),
    }


def _iot_rows(rs, n, t_ms):
    return [{"deviceId": int(rs.randint(0, 8)),
             "temperature": float(np.float32(rs.uniform(0, 100))),
             "eventTimeStamp": t_ms} for _ in range(n)]


def _as_map(t, key, value):
    valid = np.asarray(t.valid)
    return dict(zip(np.asarray(t.cols[key])[valid].tolist(),
                    np.asarray(t.cols[value])[valid].tolist()))


def _state_metrics(metrics):
    """The State_* metrics a run must match across packages: all but the
    handoff's wall-clock time."""
    return {k: v for k, v in metrics.items()
            if k.startswith("State_") and k != "State_Handoff_Ms"}


# -- BASELINE config 3 -------------------------------------------------------------
@pytest.mark.parametrize("depth", [1, 2])
def test_config3_accumulator_and_window_join_match_jax(tmp_path, depth):
    """Batch for batch: equal Joined rows, equal State_* metrics, equal
    loaded state. At depth 2 the port dispatches each batch before the
    previous one lands; every batch still overwrites its own state."""
    jproc = JFlowProcessor(JSD(_config3(tmp_path, "jax")), output_datasets=["Joined"])
    tproc = FlowProcessor(SettingDictionary(_config3(tmp_path, "torch")),
                          output_datasets=["Joined"], device="cpu")
    rs = np.random.RandomState(3)
    batches = [(BASE_MS + 1000 * b, _iot_rows(rs, 20, BASE_MS + 1000 * b))
               for b in range(6)]
    want = []
    for t_ms, rows in batches:
        ds, m = jproc.process_batch(jproc.encode_rows(rows, t_ms), t_ms)
        jproc.commit()
        want.append((ds["Joined"], _state_metrics(m)))
    got, pending = [], []
    for t_ms, rows in batches:
        pending.append(tproc.dispatch_batch(tproc.encode_rows(rows, t_ms), t_ms))
        if len(pending) == depth:
            ds, m = pending.pop(0).collect()
            tproc.commit()
            got.append((ds["Joined"], _state_metrics(m)))
    for h in pending:
        ds, m = h.collect()
        tproc.commit()
        got.append((ds["Joined"], _state_metrics(m)))
    assert sum(len(rows) for rows, _m in want) > 0
    assert got == want
    jpeaks = _as_map(jproc.state_tables["peaks"].load(jproc.dictionary), "deviceId", "peak")
    tpeaks = _as_map(tproc.state_tables["peaks"].load(tproc.dictionary), "deviceId", "peak")
    assert tpeaks == jpeaks
    every = [r for _t, rows in batches for r in rows if r["temperature"] > 50]
    assert tpeaks == {k: max(np.float32(r["temperature"]) for r in every if r["deviceId"] == k)
                      for k in {r["deviceId"] for r in every}}
    # the state the step carries is the GROUP BY's, on the processor's device
    assert tproc.state_data["peaks"].valid.device.type == "cpu"


# -- restart and torn writes (test_recovery.py) ------------------------------------
def _recovery_conf(tmp_path, pkg):
    t = tmp_path / "t.transform"
    t.write_text(
        "--DataXQuery--\n"
        "merged = SELECT k, v FROM DataXProcessedInput "
        "UNION ALL SELECT k, v FROM seen\n"
        "--DataXQuery--\n"
        "seen = SELECT k, MAX(v) AS v FROM merged GROUP BY k\n"
        "--DataXQuery--\n"
        "Out = SELECT k, v FROM DataXProcessedInput\n"
    )
    return {
        "datax.job.name": "StateRecFlow",
        "datax.job.input.default.inputtype": "file",
        "datax.job.input.default.blobpathregex": str(tmp_path / pkg / "in" / "*.json"),
        "datax.job.input.default.blobschemafile": KV_SCHEMA,
        "datax.job.input.default.eventhub.maxrate": "100",
        "datax.job.input.default.eventhub.checkpointdir": str(tmp_path / pkg / "ckpt"),
        "datax.job.input.default.eventhub.checkpointinterval": "0 second",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.transform": str(t),
        "datax.job.process.batchcapacity": "16",
        "datax.job.process.statetable.seen.schema": "k long, v double",
        "datax.job.process.statetable.seen.location": str(tmp_path / pkg / "state"),
        "datax.job.process.pilot.enabled": "false",
        "datax.job.output.Out.console.maxrows": "0",
    }


def _write_events(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)


def _seen(host):
    proc = host.processor
    return _as_map(proc.state_tables["seen"].load(proc.dictionary), "k", "v")


def test_restart_resumes_offsets_and_state_like_jax(tmp_path):
    """Kill the host after batch 1 and start a fresh one: the file
    source resumes past consumed files and the A/B state table reloads
    the accumulated rows, on both packages alike."""
    rs = np.random.RandomState(5)
    first = [{"k": int(k), "v": float(np.float32(v))}
             for k, v in zip(rs.randint(0, 4, 6), rs.uniform(0, 10, 6))]
    second = [{"k": int(k), "v": float(np.float32(v))}
              for k, v in zip(rs.randint(0, 6, 5), rs.uniform(0, 10, 5))]
    out = {}
    for pkg, mod, SD, kw in (("jax", jhost_mod, JSD, {}),
                             ("torch", thost_mod, SettingDictionary, {"device": "cpu"})):
        _write_events(str(tmp_path / pkg / "in" / "a.json"), first)
        host1 = mod.StreamingHost(SD(_recovery_conf(tmp_path, pkg)), **kw)
        m1 = host1.run_batch()
        host1.stop()
        assert os.path.exists(tmp_path / pkg / "ckpt" / "offsets.txt")
        seen1 = _seen(host1)
        _write_events(str(tmp_path / pkg / "in" / "b.json"), second)
        host2 = mod.StreamingHost(SD(_recovery_conf(tmp_path, pkg)), **kw)
        m2 = host2.run_batch()
        host2.stop()
        out[pkg] = (seen1, _seen(host2), m2["Input_DataXProcessedInput_Events_Count"],
                    _state_metrics(m1), _state_metrics(m2))
    assert out["torch"] == out["jax"]
    seen1, seen2, n_in, _m1, _m2 = out["torch"]
    assert n_in == len(second)  # a.json was not replayed
    want = {}
    for r in first + second:
        want[r["k"]] = max(want.get(r["k"], -1.0), r["v"])
    assert seen2 == want


def test_state_table_writes_survive_torn_write(tmp_path, monkeypatch):
    """table.npz, meta.json and the pointer commit are fsynced (file and
    directory) through _durable_replace, and a torn active-side write
    falls back to the standby commit, as in the JAX package."""
    synced = []
    real_fsync = os.fsync

    def spy_fsync(fd):
        try:
            synced.append(os.readlink(f"/proc/self/fd/{fd}"))
        except OSError:
            synced.append("<unknown>")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy_fsync)
    schema = ViewSchema({"k": "long", "v": "double"})
    d = StringDictionary()

    def table(v):
        return TableData({"k": torch.tensor([7], dtype=torch.int32),
                          "v": torch.tensor([v], dtype=torch.float32)},
                         torch.tensor([True]))

    st = StateTable("seen", schema, 4, str(tmp_path / "st"), partitions=2)
    st.overwrite(table(1.0), d)
    st.persist()
    assert any(p.endswith("table.npz.tmp") for p in synced), synced
    assert any(p.endswith("meta.json.tmp") for p in synced), synced
    assert any(p.endswith("pointer.tmp") for p in synced), synced
    assert any(p.rstrip("/").endswith(f"st/p{partition_of(7, 2):02d}") for p in synced), synced
    st.overwrite(table(2.0), d)
    st.persist()
    p = partition_of(7, 2)
    active = LocalSnapshotStore(str(tmp_path / "st")).get_pointer(f"p{p:02d}")
    path = tmp_path / "st" / f"p{p:02d}" / active / "table.npz"
    path.write_bytes(path.read_bytes()[:8])
    stats = {}
    loaded = StateTable("seen", schema, 4, str(tmp_path / "st"), partitions=2,
                        stats=stats).load(StringDictionary())
    assert _as_map(loaded, "k", "v") == {7: 1.0}
    assert stats["LoadFallback_Count"] >= 1
    # the JAX package reads the same torn directory the same way
    jloaded = JStateTable("seen", JViewSchema({"k": "long", "v": "double"}), 4,
                          str(tmp_path / "st"), partitions=2).load(JStringDictionary())
    assert _as_map(jloaded, "k", "v") == {7: 1.0}


def test_overwrite_refuses_device_tensors_it_would_have_to_sync_for():
    """overwrite() takes host arrays: a tensor on another device than the
    CPU raises instead of reading back (here a meta tensor stands in for
    a CUDA one)."""
    st = StateTable("seen", ViewSchema({"k": "long", "v": "double"}), 4, "/nonexistent",
                    partitions=1, owned=[])
    meta = TableData({"k": torch.empty(4, dtype=torch.int32, device="meta"),
                      "v": torch.empty(4, device="meta")},
                     torch.empty(4, dtype=torch.bool, device="meta"))
    with pytest.raises((TypeError, RuntimeError, NotImplementedError)):
        st.overwrite(meta, StringDictionary())


# -- the pipelined accumulator (test_pipelined.py) ---------------------------------
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pipelined_overwrite_uses_its_own_batch_state(tmp_path, pkg):
    """Batch N's A/B overwrite sees N's accumulation, not N+1's, even
    when N+1 was dispatched before N collected."""
    t = tmp_path / "t.transform"
    t.write_text(
        "--DataXQuery--\n"
        "merged = SELECT k, v FROM DataXProcessedInput "
        "UNION ALL SELECT k, v FROM acc\n"
        "--DataXQuery--\n"
        "acc = SELECT k, v FROM merged\n"
        "--DataXQuery--\n"
        "Out = SELECT k, v FROM DataXProcessedInput\n"
    )
    conf = {
        "datax.job.name": "StateFlow",
        "datax.job.input.default.blobschemafile": KV_SCHEMA,
        "datax.job.process.transform": str(t),
        "datax.job.process.batchcapacity": "16",
        "datax.job.process.statetable.acc.schema": "k long, v double",
        "datax.job.process.statetable.acc.location": str(tmp_path / "st"),
    }
    proc = (JFlowProcessor(JSD(conf), output_datasets=["Out"]) if pkg == "jax" else
            FlowProcessor(SettingDictionary(conf), output_datasets=["Out"], device="cpu"))
    h1 = proc.dispatch_batch(proc.encode_rows([{"k": 1, "v": 2.0}], 0), 1000)
    h2 = proc.dispatch_batch(proc.encode_rows([{"k": 1, "v": 3.0}], 0), 2000)
    h1.collect()
    proc.commit()
    h2.collect()
    proc.commit()
    loaded = proc.state_tables["acc"].load(proc.dictionary)
    valid = np.asarray(loaded.valid)
    assert sorted(np.asarray(loaded.cols["v"])[valid].tolist()) == [2.0, 3.0]


# -- the handoff: two replicas, then one successor ---------------------------------
HANDOFF_ROWS, HANDOFF_KEYS, HANDOFF_PARTITIONS = 64, 16, 4
PKGS = {
    "jax": (jhost_mod, jsinks, JSD, {}),
    "torch": (thost_mod, tsinks, SettingDictionary, {"device": "cpu"}),
}


def _handoff_conf(hostdir, url, pkg, **kw):
    conf = chip_smoke.state_conf(hostdir, url, capacity=HANDOFF_ROWS,
                                 partitions=HANDOFF_PARTITIONS, **kw)
    if pkg == "jax":
        conf["datax.job.process.observability.calibration"] = "false"
    return conf


class _SecondClock(_Clock):
    """A poll moves the clock one second: every batch of the state hosts
    takes a window checkpoint (interval 1 s), as on the card."""

    def tick(self):
        self.now += 1.0


def _state_host(pkg, conf, payloads, clock, monkeypatch):
    mod, sinks, SD, kw = PKGS[pkg]
    monkeypatch.setattr(mod, "time", clock.module())
    lines = [ln for p in payloads for ln in p.splitlines()]
    host = mod.StreamingHost(SD(conf), source=_BytesSource(lines, clock), **kw)
    sink = _RecordingSink()
    host.dispatcher = sinks.OutputDispatcher(
        {"Win": sinks.OutputOperator("Win", [sink])}, host.metric_logger)
    return host, sink


def _handoff(pkg, tmp_path, monkeypatch, url, payloads):
    """Replicas 1 and 2 of two (replica 2 a second later, its own time
    base), each fed the same four batches and stopped; then one
    successor on fresh directories runs the fifth. Returns what the
    checks compare."""
    preds = []
    for idx in (1, 2):
        clock = _SecondClock()
        clock.now += idx - 1
        host, _sink = _state_host(pkg, _handoff_conf(
            str(tmp_path / pkg / f"pred{idx}"), url, pkg, replica_index=idx,
            replica_count=2), payloads[:4], clock, monkeypatch)
        preds.append([host.run_batch() for _ in range(4)])
        host.stop()
    clock = _SecondClock()
    clock.now += 5
    succ, sink = _state_host(pkg, _handoff_conf(str(tmp_path / pkg / "succ"), url, pkg),
                             payloads[4:], clock, monkeypatch)
    seen = _as_map(succ.processor.state_data["seen"], "k", "v")
    restored = succ.window_restored_from
    m = succ.run_batch()
    succ.stop()
    (win,) = [rows for (_t, name), rows in sink.rows.items() if name == "Win"]
    return {"preds": preds, "seen": seen, "restored": restored, "metrics": m,
            "win": sorted(win, key=lambda r: r["k"])}


def _single(pkg, tmp_path, monkeypatch, payloads):
    """One replica fed all five batches: the window the successor must
    reproduce."""
    host, sink = _state_host(pkg, _handoff_conf(str(tmp_path / pkg / "single"), None, pkg),
                             payloads, _SecondClock(), monkeypatch)
    for _ in payloads:
        host.run_batch()
    host.stop()
    last = max(t for t, _name in sink.rows)
    return sorted(sink.rows[(last, "Win")], key=lambda r: r["k"])


def _mirror_files(server, bucket, prefix):
    out = {}
    for key in server.store_list(bucket, prefix + "/"):
        data = server.store_get(bucket, key)
        if key.endswith(".npz"):
            with np.load(io.BytesIO(data)) as z:
                data = {n: z[n].tolist() for n in z.files}
        out[key[len(prefix) + 1:]] = data
    return out


def _disk_snapshots(root):
    """Every file of a state directory: npz files as their arrays, the
    rest as bytes."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            if fn.endswith(".npz"):
                with np.load(path) as z:
                    data = {n: z[n].tolist() for n in z.files}
            else:
                with open(path, "rb") as f:
                    data = f.read()
            out[os.path.relpath(path, root)] = data
    return out


def test_two_replicas_hand_their_state_to_one_successor_like_jax(tmp_path, monkeypatch):
    rs = np.random.RandomState(17)
    batches = [chip_smoke.state_batch(rs, HANDOFF_ROWS, HANDOFF_KEYS) for _ in range(5)]
    payloads = [b[0] for b in batches]
    server = ObjectStoreServer(port=0).start()
    try:
        runs = {pkg: _handoff(pkg, tmp_path, monkeypatch,
                              f"objstore://127.0.0.1:{server.port}/b/{pkg}", payloads)
                for pkg in PKGS}
        mirrors = {pkg: _mirror_files(server, "b", pkg) for pkg in PKGS}
    finally:
        server.stop()
    singles = {pkg: _single(pkg, tmp_path, monkeypatch, payloads) for pkg in PKGS}
    want_seen = chip_smoke.max_per_key([b[1] for b in batches[:4]], [b[2] for b in batches[:4]])
    for pkg, run in runs.items():
        filtered = [sum(m.get("State_IngestFiltered_Count", 0.0) for m in ms)
                    for ms in run["preds"]]
        assert sum(filtered) == 4 * HANDOFF_ROWS and all(filtered), (pkg, filtered)
        assert run["seen"] == want_seen, pkg
        assert run["restored"] == "partitions", pkg
        assert run["win"] == singles[pkg], pkg
        assert sum(r["c"] for r in run["win"]) == 5 * HANDOFF_ROWS
        assert run["metrics"]["State_Snapshot_Pull_Count"] > 0
    t, j = runs["torch"], runs["jax"]
    assert t["win"] == j["win"] and t["seen"] == j["seen"]
    assert ([[_state_metrics(m) for m in ms] for ms in t["preds"]]
            == [[_state_metrics(m) for m in ms] for ms in j["preds"]])
    assert _state_metrics(t["metrics"]) == _state_metrics(j["metrics"])
    emitted = {k for m in [t["metrics"], *t["preds"][0], *t["preds"][1]] for k in m
                if k.startswith("State_")}
    assert emitted <= set(MetricName.STATE_METRICS)
    assert {"State_Handoff_Ms", "State_IngestFiltered_Count"} <= emitted
    # identical snapshots: the mirror's partitions and each replica's disk
    assert mirrors["torch"] == mirrors["jax"]
    assert any(k.startswith("seen/p") for k in mirrors["torch"])
    assert any(k.startswith("__window__/p") for k in mirrors["torch"])
    for host in ("pred1", "pred2", "succ"):
        assert (_disk_snapshots(tmp_path / "torch" / host / "state")
                == _disk_snapshots(tmp_path / "jax" / host / "state")), host


def test_filter_counts_survive_a_decode_and_a_landing_thread(tmp_path, monkeypatch):
    """The ingest filter counts on the decode-ahead thread while the
    landing thread persists state and drains the counts: under a short
    switch interval, at depth 2 with background landing, the counts the
    metrics report add up to every row the replica does not own."""
    import sys

    rs = np.random.RandomState(29)
    batches = [chip_smoke.state_batch(rs, HANDOFF_ROWS, 4 * HANDOFF_ROWS) for _ in range(12)]
    conf = _handoff_conf(str(tmp_path / "pred"), None, "torch", replica_index=2,
                         replica_count=3)
    host, _sink = _state_host("torch", conf, [b[0] for b in batches], _SecondClock(),
                              monkeypatch)
    sent = []
    send = host.metric_logger.send_batch_metrics
    host.metric_logger.send_batch_metrics = lambda m, ts: (sent.append(dict(m)), send(m, ts))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        host.run_pipelined(max_batches=len(batches), depth=2)
    finally:
        sys.setswitchinterval(interval)
        host.stop()
    owned = set(host.processor.state_owned)
    keys = np.concatenate([b[1] for b in batches])
    want = sum(partition_of(int(k), HANDOFF_PARTITIONS) not in owned for k in keys)
    assert len(sent) == len(batches)
    assert sum(m.get("State_IngestFiltered_Count", 0.0) for m in sent) == want


# -- snapshots across packages ---------------------------------------------------
def _kv_table(pkg, kind, dictionary, rs):
    """12 rows, unique keys, some invalid, on ``pkg``'s arrays."""
    n = 12
    ids = rs.permutation(40)[:n]
    if kind == "string":
        keys = np.array([dictionary.encode(f"dev-{i}") for i in ids], np.int32)
    else:
        keys = ids.astype(np.int32)
    v = rs.uniform(0, 10, n).astype(np.float32)
    valid = rs.rand(n) < 0.8
    if pkg == "jax":
        import jax.numpy as jnp

        return JTableData({"k": jnp.asarray(keys), "v": jnp.asarray(v)}, jnp.asarray(valid))
    return TableData({"k": torch.from_numpy(keys), "v": torch.from_numpy(v)},
                     torch.from_numpy(valid))


@pytest.mark.parametrize("kind", ["long", "string"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_a_snapshot_loads_in_the_other_package(tmp_path, writer, reader, kind):
    """Partitions one package writes load in the other, string keys
    remapped through the reader's own dictionary (its ids shifted)."""
    types = {"k": kind, "v": "double"}
    make = {"jax": (lambda: JStateTable("acc", JViewSchema(types), 32, str(tmp_path),
                                        partitions=4), JStringDictionary),
            "torch": (lambda: StateTable("acc", ViewSchema(types), 32, str(tmp_path),
                                         partitions=4), StringDictionary)}
    new_table, new_dict = make[writer]
    wdict = new_dict()
    table = _kv_table(writer, kind, wdict, np.random.RandomState(23))
    st = new_table()
    st.overwrite(table, wdict)
    st.persist()
    new_table, new_dict = make[reader]
    rdict = new_dict()
    rdict.encode("taken-first")
    loaded = new_table().load(rdict)

    def decoded(t, d):
        m = _as_map(t, "k", "v")
        return {d.decode(k) if kind == "string" else k: v for k, v in m.items()}

    want = decoded(table, wdict)
    assert len(want) >= 6
    assert decoded(loaded, rdict) == want
    assert str(loaded.cols["v"].dtype).endswith("float32")
    assert int(np.asarray(loaded.valid).shape[0]) == 32


# -- DX530/DX531 as telemetry events ---------------------------------------------
@pytest.mark.parametrize("code", ["DX530", "DX531"])
def test_load_fallbacks_arrive_as_state_fallback_events(tmp_path, monkeypatch, code):
    """A torn active side (DX530) or both sides torn (DX531) at a host's
    init: each package's host flight-records the same state/fallback
    events and reports the same State_LoadFallback_Count."""
    def torn_state(pkg):
        loc = tmp_path / pkg / "state"
        st = StateTable("seen", ViewSchema({"k": "long", "v": "double"}), 64, str(loc),
                        partitions=4)
        for v in (1.0, 2.0):
            st.overwrite(TableData({"k": torch.tensor([3], dtype=torch.int32),
                                    "v": torch.tensor([v])}, torch.tensor([True])),
                         StringDictionary())
            st.persist()
        p = partition_of(3, 4)
        active = LocalSnapshotStore(str(loc)).get_pointer(f"p{p:02d}")
        sides = [active] if code == "DX530" else ["A", "B"]
        for side in sides:
            f = loc / f"p{p:02d}" / side / "table.npz"
            f.write_bytes(f.read_bytes()[:10])
        return loc

    out = {}
    for pkg, mod, SD, kw, tel in (
            ("jax", jhost_mod, JSD, {}, jtelemetry),
            ("torch", thost_mod, SettingDictionary, {"device": "cpu"}, ttelemetry)):
        loc = torn_state(pkg)
        events = []
        real = tel.TelemetryLogger.track_event

        def record(self, name, props=None, *a, _real=real, _events=events, **k):
            if name == "state/fallback":
                _events.append((props["code"], props["table"], props["partition"],
                                props["side"]))
            return _real(self, name, props, *a, **k)

        monkeypatch.setattr(tel.TelemetryLogger, "track_event", record)
        conf = _recovery_conf(tmp_path, pkg)
        conf["datax.job.process.statetable.seen.location"] = str(loc)
        conf["datax.job.process.state.partitions"] = "4"
        _write_events(str(tmp_path / pkg / "in" / "a.json"), [{"k": 5, "v": 1.0}])
        host = mod.StreamingHost(SD(conf), **kw)
        m = host.run_batch()
        host.stop()
        out[pkg] = (events, m.get("State_LoadFallback_Count"), _seen(host))
    assert out["torch"] == out["jax"]
    events, count, seen = out["torch"]
    assert [e[0] for e in events] == (["DX530"] if code == "DX530" else ["DX530", "DX531"])
    assert count == (1.0 if code == "DX530" else 2.0)
    assert seen == ({3: 1.0, 5: 1.0} if code == "DX530" else {5: 1.0})


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_config3_on_the_card_matches_the_cpu_with_no_host_sync(card, tmp_path):
    """BASELINE config 3 at depth 2 on the card: rows and persisted state
    equal the CPU run's, the state loads onto the card, and encode plus
    dispatch make no host sync (the state leaves the card with the
    outputs, and the landing thread overwrites from host memory)."""
    import warnings

    procs = {dev: FlowProcessor(SettingDictionary(_config3(tmp_path, dev)),
                                output_datasets=["Joined"], device=dev)
             for dev in ("cpu", "cuda")}
    assert procs["cuda"].state_data["peaks"].valid.is_cuda
    rs = np.random.RandomState(9)
    batches = [(BASE_MS + 1000 * b, _iot_rows(rs, 20, BASE_MS + 1000 * b)) for b in range(6)]
    out = {}
    for dev, proc in procs.items():
        got, pending, syncs = [], [], 0
        for t_ms, rows in batches:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    pending.append(proc.dispatch_batch(proc.encode_rows(rows, t_ms), t_ms))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs += sum("synchroniz" in str(w.message) for w in caught)
            if len(pending) == 2:
                got.append(pending.pop(0).collect()[0]["Joined"])
                proc.commit()
        for h in pending:
            got.append(h.collect()[0]["Joined"])
            proc.commit()
        loaded = proc.state_tables["peaks"].load(proc.dictionary)
        out[dev] = (got, _as_map(TableData({c: v.cpu() for c, v in loaded.cols.items()},
                                           loaded.valid.cpu()), "deviceId", "peak"))
        if dev == "cuda":
            assert syncs == 0
    assert out["cuda"] == out["cpu"]
