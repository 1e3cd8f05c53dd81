"""The port's host loop against the JAX package's: ``StreamingHost`` of
both packages runs the config-1 + anomaly flow at capacity 64 on the
same deterministic source under the same pinned clock, with the pilot
off, through ``run`` and ``run_pipelined`` at depths 1 and 2, from JSON
bytes (the decoder path) and from ``LocalSource`` columns
(``encode_columns``). Per-batch sink rows must match (ints and ids
exactly, floats within rtol 1e-5, as ``test_torch_flow.py``), the set
of metric names must match, and so must the values of the count-valued
metrics, the boot audit's ``Conf_*`` gauges among them.

Also here: the processor repairs the host needs (``source=`` on the
encoders, ``SourceSpec.conf`` and ``specs``, the attributes the host
reads, one consistent window snapshot under a concurrent dispatch), the
host feature refused by conf, the ``Calib_*`` and ``Profiler_*``
families and ``/profile`` against the JAX host's, the entry point, the
cross-package ``window.npz`` round trip, and on the card the host at
depth 2 and a snapshot taken under an in-flight batch.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.runtime import host as jhost_mod
from data_accelerator_tpu.runtime import sinks as jsinks
from data_accelerator_tpu.runtime import sources as jsources
from data_accelerator_tpu.runtime.checkpoint import (
    WindowStateCheckpointer as JWindowStateCheckpointer,
)
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu_torch.core.config import EngineException, SettingDictionary
from data_accelerator_tpu_torch.runtime import host as thost_mod
from data_accelerator_tpu_torch.runtime import sinks as tsinks
from data_accelerator_tpu_torch.runtime import sources as tsources
from data_accelerator_tpu_torch.runtime.batchhost import BatchHost
from data_accelerator_tpu_torch.runtime.checkpoint import WindowStateCheckpointer
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from test_torch_flow import (
    BASE_MS,
    OUTPUTS,
    PORT_GROUP_METRICS,
    _as_jax_metrics,
    TYPES,
    _assert_same_rows,
    _batch_columns,
    _conf,
)
from test_torch_ingest import _payload

torch.set_num_threads(2)

CAPACITY = 64
# 0.5 s apart under the pipelined loops, 1 s apart under the paced one:
# enough to fill and evict the 5 s window
BATCHES = 12
ANOMALY_CLASSES = {
    "jax": "data_accelerator_tpu.udf.samples:anomalyscore",
    "torch": "data_accelerator_tpu_torch.udf.samples:anomalyscore",
}
# metrics whose value measures wall clock (the machine profile's probes
# among them), or depends on when the landing thread finished a batch
# relative to later dispatches
TIMING_METRICS = (
    "Calib_", "Latency-", "Pipeline_Stall_Ms", "Transfer_Background_",
    "Decode_RowsPerSec", "Decode_BufferReuse_Count", "Transfer_D2HBytes",
    "Transfer_Efficiency", "Transfer_SlotContended_Count",
    "Transfer_Overflow_Count",
)
# the JAX package measures a link between the tests' 8 virtual CPU
# devices; the port's probe needs two distinct cards and is None on the
# CPU (obs/calibrate.py)
ICI_GAUGE = "Calib_IciGBps"
# names that appear only when the landing thread's timing allows
OPTIONAL_METRICS = ("Decode_BufferReuse_Count", "Transfer_SlotContended_Count",
                    "Transfer_Overflow_Count")


def _host_conf(name, pkg, extra=None):
    conf = _conf(**{
        "datax.job.name": name,
        "datax.job.process.batchcapacity": str(CAPACITY),
        "datax.job.input.default.eventhub.maxrate": str(CAPACITY),
        "datax.job.process.pilot.enabled": "false",
        "datax.job.process.jar.udf.anomalyscore.class": ANOMALY_CLASSES[pkg],
    })
    for out in OUTPUTS:
        conf[f"datax.job.output.{out}.console.maxrows"] = "0"
    conf.update(extra or {})
    return conf


class _Clock:
    """The host modules' ``time``: ``time()`` reads a clock that only a
    poll (half an interval) and the paced loop's ``sleep`` move, so both
    hosts see the same batch times wherever their polls run. A loop
    iteration spans at most two polls, one interval, so the adaptive
    backpressure never halves the rate in either host."""

    def __init__(self):
        self.now = BASE_MS / 1000.0 + 0.25

    def __call__(self):
        return self.now

    def tick(self):
        self.now += 0.5

    def sleep(self, seconds):
        self.now += max(0.0, seconds)

    def module(self):
        return types.SimpleNamespace(time=self, sleep=self.sleep)


class _BytesSource:
    """A deterministic newline-JSON source with the raw fast path (the
    native decoder) and an in-order un-acked FIFO."""

    name = "bytes"

    def __init__(self, lines, clock):
        self.lines, self.clock = lines, clock
        self.pos, self.unacked, self.redeliver = 0, [], []

    def start(self, positions):
        pass

    def poll_raw(self, max_events):
        if self.redeliver:
            frm, lines = self.redeliver.pop(0)
        else:
            frm = self.pos
            lines = self.lines[frm:frm + max_events]
            self.pos += len(lines)
        self.unacked.append((frm, lines))
        self.clock.tick()
        blob = b"".join(ln + b"\n" for ln in lines)
        return blob, len(lines), {(self.name, 0): (frm, frm + len(lines))}

    def ack(self):
        self.unacked.pop(0)

    def requeue_unacked(self):
        self.redeliver, self.unacked = self.unacked + self.redeliver, []

    def close(self):
        pass


def _local_source(pkg_sources, batches, clock):
    """The package's ``LocalSource`` serving fixed column batches (the
    ``encode_columns`` path) under the pinned clock."""

    class Fixed(pkg_sources.LocalSource):
        def __init__(self):
            self.name, self.batches, self._seq = "local", list(batches), 0

        def poll_columns(self, max_events, dictionary):
            now_ms = int(clock() * 1000)
            cols = self.batches.pop(0)
            clock.tick()
            frm, self._seq = self._seq, self._seq + max_events
            return cols, now_ms, {(self.name, 0): (frm, self._seq)}

    return Fixed()


class _RecordingSink(tsinks.Sink):
    kind = "recording"

    def __init__(self):
        self.rows = {}  # (batch_time_ms, dataset) -> rows

    def write(self, dataset, rows, batch_time_ms):
        self.rows[(batch_time_ms, dataset)] = rows
        return len(rows)


def _drive(pkg, mode, depth, feed, monkeypatch, name):
    """One host of ``pkg`` over ``BATCHES`` batches; returns (sink rows,
    per-batch metrics, metric names in the store)."""
    clock = _Clock()
    mod, sinks, sources, SD = {
        "jax": (jhost_mod, jsinks, jsources, JSettingDictionary),
        "torch": (thost_mod, tsinks, tsources, SettingDictionary),
    }[pkg]
    monkeypatch.setattr(mod, "time", clock.module())
    conf = _host_conf(name, pkg, {"datax.job.process.pipeline.depth": str(depth)})
    kind, data = feed
    if kind == "bytes":
        src = _BytesSource(list(data), clock)
    else:
        src = _local_source(sources, [{c: a.copy() for c, a in cols.items()}
                                      for cols in data], clock)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    host = mod.StreamingHost(SD(conf), source=src, **kw)
    sink = _RecordingSink()
    host.dispatcher = sinks.OutputDispatcher(
        {n: sinks.OutputOperator(n, [sink]) for n in OUTPUTS}, host.metric_logger
    )
    per_batch = []
    send = host.metric_logger.send_batch_metrics

    def spy(metrics, ts):
        per_batch.append((ts, dict(metrics) if pkg == "jax"
                          else _as_jax_metrics(metrics, host.processor)))
        return send(metrics, ts)

    host.metric_logger.send_batch_metrics = spy
    try:
        if mode == "run":
            host.run(max_batches=BATCHES)
        else:
            host.run_pipelined(max_batches=BATCHES)
    finally:
        host.stop()
        monkeypatch.undo()
    assert host.batches_processed == BATCHES
    names = {k.split(":", 1)[1] for k in host.metric_logger.store.keys(f"DATAX-{name}:")}
    return sink.rows, sorted(per_batch, key=lambda p: p[0]), names


def _feed(kind):
    rs = np.random.RandomState(11)
    if kind == "bytes":
        lines = []
        for b in range(BATCHES):
            lines += _payload(rs, CAPACITY, malformed=b % 2).rstrip(b"\n").split(b"\n")
        return kind, lines
    # LocalSource columns: the dictionary ids both hosts give the device
    # types (flow compile encodes nothing else first)
    ids = np.array([1 + i for i in range(len(TYPES))], np.int32)
    return kind, [_batch_columns(rs, ids, CAPACITY) for _ in range(BATCHES)]


def _timing(name):
    return name.startswith(TIMING_METRICS)


def _ingest_counter(name):
    """Host-side ingest counters (``Input_malformed_rows_Count``...):
    drained at a batch's landing, so with decode-ahead the batch they
    land in depends on timing; their totals over the run do not."""
    return (name.startswith("Input_") and name.endswith("_Count")
            and not name.endswith("_Events_Count"))


def _per_batch(name):
    return not _timing(name) and not _ingest_counter(name)


@pytest.mark.parametrize("kind", ["bytes", "local"])
@pytest.mark.parametrize("mode,depth", [("run", 1), ("pipelined", 1), ("pipelined", 2)])
def test_host_matches_jax_host(kind, mode, depth, monkeypatch):
    feed = _feed(kind)
    flow = f"HostParity{kind}{mode}{depth}"
    jrows, jmetrics, jnames = _drive("jax", mode, depth, feed, monkeypatch, flow)
    trows, tmetrics, tnames = _drive("torch", mode, depth, feed, monkeypatch, flow)

    # the same batches, at the same batch times, with the same rows
    assert set(trows) == set(jrows)
    step = 1000 if mode == "run" else 500
    assert {t for t, _d in trows} == {BASE_MS + 250 + step * b for b in range(BATCHES)}
    for key in sorted(jrows):
        _assert_same_rows(jrows[key], trows[key], key)
    assert sum(len(r) for (_t, d), r in trows.items() if d == "AnomalyAlerts")

    # metric names: the JAX host's, the machine profile's among them
    assert any(n.startswith("Calib_") for n in jnames)
    assert tnames - set(OPTIONAL_METRICS) - PORT_GROUP_METRICS == \
        jnames - set(OPTIONAL_METRICS) - {ICI_GAUGE}
    # and the port's own counters of the flow's windowed GROUP BY
    assert PORT_GROUP_METRICS <= tnames

    # count-valued metrics, batch for batch; ingest counters in total
    assert [t for t, _m in tmetrics] == [t for t, _m in jmetrics]
    totals = {"jax": {}, "torch": {}}
    for (t, tm), (_t, jm) in zip(tmetrics, jmetrics):
        assert {k for k in tm if _per_batch(k)} == {k for k in jm if _per_batch(k)}
        for k, v in tm.items():
            if _per_batch(k):
                assert v == jm[k], (t, k, jm[k], v)
        for pkg, m in (("jax", jm), ("torch", tm)):
            for k, v in m.items():
                if _ingest_counter(k):
                    totals[pkg][k] = totals[pkg].get(k, 0.0) + v
    assert totals["torch"] == totals["jax"]
    if kind == "bytes":
        assert totals["torch"]["Input_malformed_rows_Count"] == BATCHES // 2


# -- repairs of the processor the host needs ---------------------------------
def _proc(extra=None, capacity=16):
    return FlowProcessor(SettingDictionary(_host_conf("HostRepair", "torch", extra)),
                         batch_capacity=capacity, output_datasets=OUTPUTS,
                         device="cpu")


def test_encoders_take_a_source_name():
    proc = _proc()
    rows = [{"deviceDetails": {"deviceId": 3, "deviceType": "DoorLock",
                               "homeId": 1, "status": 0, "temperature": 2.5}}]
    for source in (None, "default"):
        t = proc.encode_rows(rows, BASE_MS, source=source)
        assert int(t.valid.sum()) == 1
        cols = {"deviceDetails.deviceId": np.array([1, 2], np.int32)}
        t = proc.encode_columns(cols, 2, source=source)
        assert t.valid.tolist()[:3] == [True, True, False]
    with pytest.raises(EngineException, match="unknown source"):
        proc.encode_rows(rows, BASE_MS, source="weather")
    with pytest.raises(EngineException, match="unknown source"):
        proc.encode_columns({}, 0, source="weather")


def test_source_spec_carries_its_conf_and_specs_by_name():
    proc = _proc({"datax.job.input.default.socket.port": "0",
                  "datax.job.input.default.inputtype": "socket"})
    assert proc.specs == {"default": proc.spec}
    conf = proc.specs["default"].conf
    assert conf.get("inputtype") == "socket"
    src = tsources.make_source(conf, proc.spec.schema, source="default")
    try:
        assert isinstance(src, tsources.SocketSource)
    finally:
        src.close()


def test_host_facing_attributes():
    proc = _proc()
    assert proc.commit() is None
    assert proc.device_memory_stats() is None  # the CPU reports none
    assert proc.state_events == []
    assert proc.state_mirror is None and proc.buffer_sanitizer is None
    assert proc.mesh is None


class _InterleavingCols(dict):
    """Ring columns whose iteration, after the first column, starts a
    dispatch on another thread and waits until it has either finished or
    reached the dispatch lock."""

    def __init__(self, cols, proc, cols_np):
        super().__init__(cols)
        self.proc, self.cols_np = proc, cols_np
        self.progress = threading.Event()
        self.thread = None

    def items(self):
        for i, kv in enumerate(list(super().items())):
            yield kv
            if i == 0 and self.thread is None:
                def dispatch():
                    h = self.proc.dispatch_batch(
                        self.proc.encode_columns(self.cols_np, 16), BASE_MS + 3000)
                    h.collect()
                    self.progress.set()

                self.progress.clear()
                self.thread = threading.Thread(target=dispatch, daemon=True)
                self.thread.start()
                assert self.progress.wait(timeout=30)


class _SignallingLock:
    def __init__(self, lock, reached):
        self.lock, self.reached = lock, reached

    def __enter__(self):
        self.reached.set()
        return self.lock.__enter__()

    def __exit__(self, *exc):
        return self.lock.__exit__(*exc)

    def acquire(self, *a, **k):
        self.reached.set()
        return self.lock.acquire(*a, **k)

    def release(self):
        return self.lock.release()


def test_snapshot_is_one_cut_under_interleaved_dispatch():
    """A dispatch from another thread between the copies of two ring
    columns: the snapshot must be one cut, equal to the state before that
    dispatch (columns, ``valid`` and the slot counter alike)."""
    proc = _proc()
    ids = np.array([proc.dictionary.encode(t) for t in TYPES], np.int32)
    rs = np.random.RandomState(5)
    for b in range(3):
        proc.dispatch_batch(proc.encode_columns(_batch_columns(rs, ids, 16), 16),
                            BASE_MS + 1000 * b).collect()
    before = proc.snapshot_window_state()
    assert before["slot_counter"] == 3

    (table, buf), = proc.window_buffers.items()
    hook = _InterleavingCols(buf.cols, proc, _batch_columns(rs, ids, 16))
    buf.cols = hook
    lock = getattr(proc, "_dispatch_lock", None)
    if lock is not None:
        proc._dispatch_lock = _SignallingLock(lock, hook.progress)
    snap = proc.snapshot_window_state()
    hook.thread.join(timeout=30)
    assert not hook.thread.is_alive()

    assert snap["slot_counter"] == before["slot_counter"]
    assert snap["base_ms"] == before["base_ms"]
    got, want = snap["rings"][table], before["rings"][table]
    assert np.array_equal(got["valid"], want["valid"])
    for c in want["cols"]:
        assert np.array_equal(got["cols"][c], want["cols"][c]), c
    # the dispatch then ran: the next snapshot is the cut after it
    assert proc.snapshot_window_state()["slot_counter"] == 4


def test_snapshots_stay_consistent_under_concurrent_dispatch():
    """Stress: snapshot threads (more of them than cores, the switch
    interval shortened) race one dispatch thread; every snapshot must be
    one cut. Batch b writes deviceId == b into ring slot b % slots, so a
    cut at counter c holds, in each slot, the last batch before c that
    went there."""
    import os
    import sys

    proc = _proc()
    (table, buf), = proc.window_buffers.items()
    slots = buf.slots
    col = "deviceDetails.deviceId"
    done, bad, taken = threading.Event(), [], [0]

    def dispatch():
        try:
            for b in range(3 * slots):
                cols = {col: np.full(16, b, np.int32)}
                proc.dispatch_batch(proc.encode_columns(cols, 16),
                                    BASE_MS + 1000 * b).collect()
        finally:
            done.set()

    def snapshot():
        while not done.is_set():
            snap = proc.snapshot_window_state()
            c = snap["slot_counter"]
            ring = snap["rings"][table]
            for s in range(slots):
                last = max((b for b in range(c) if b % slots == s), default=None)
                ids, valid = ring["cols"][col][s], ring["valid"][s]
                ok = (not valid.any()) if last is None else (
                    valid.all() and (ids == last).all())
                if not ok:
                    bad.append((c, s, ids.tolist()))
            taken[0] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=snapshot, daemon=True)
                   for _ in range(len(os.sched_getaffinity(0)) + 1)]
        for w in workers:
            w.start()
        dispatch()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert taken[0] > 0 and not bad, bad[:3]


# -- refusals, the observability families, entry points ---------------------
@pytest.mark.parametrize("key,value,feature", [
    ("datax.job.process.mesh.model", '{"totals": {}}', "dist/"),
])
def test_unported_host_features_are_refused(key, value, feature):
    """Nothing is refused any more: a conf with a sharding model builds
    a host in both packages, and their conformance monitors read the
    model alike (an empty one arms nothing; its totals arm DX510/511).
    The census it is held against comes from ``dist/mesh.py``."""
    assert feature + "mesh.py" in thost_mod.__doc__
    full = json.dumps({"totals": {"iciWireBytesPerBatch": 1000.0,
                                  "reshardCount": 2, "chips": 4}})
    for text, armed in ((value, False), (full, True)):
        monitors = []
        for pkg, mod, SD, kw in (("jax", jhost_mod, JSettingDictionary, {}),
                                 ("torch", thost_mod, SettingDictionary,
                                  {"device": "cpu"})):
            conf = _host_conf("HostMeshModel", pkg, {key: text})
            host = mod.StreamingHost(SD(conf), **kw)
            try:
                monitors.append(host.conformance)
            finally:
                host.stop()
        jmon, tmon = monitors
        assert (tmon is not None) == (jmon is not None) == armed
        if armed:
            assert tmon.model.ici_wire_bytes_per_batch == 1000.0
            assert tmon.model.reshard_count == 2
            assert tmon.ici_ratio_high == jmon.ici_ratio_high == 8.0


def _profile_request(base, method, seconds=None):
    """``(status, payload)`` of ``/profile`` on a host's port."""
    url = base + "/profile" + (f"?seconds={seconds}" if seconds else "")
    req = urllib.request.Request(url, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _profiled_run(host, store_prefix):
    """A capture armed over ``/profile`` while the host runs two
    batches, drained by two more: the ``/profile`` answers, the
    ``Profiler_Captures_Count`` points and the metric names."""
    base = f"http://127.0.0.1:{host.obs_server.port}"
    armed = _profile_request(base, "POST", seconds=0.2)
    busy = _profile_request(base, "POST", seconds=0.2)
    host.run_pipelined(max_batches=2)  # its end closes the capture
    deadline = time.monotonic() + 30  # the JAX package's stop may be the timer's
    while host.profiler.captures_count == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    host.run_pipelined(max_batches=4)  # a batch tail drains it
    state = _profile_request(base, "GET")
    captures = [p["val"] for p in host.metric_logger.store.points(
        store_prefix + "Profiler_Captures_Count")]
    names = {k.split(":", 1)[1] for k in host.metric_logger.store.keys(store_prefix)}
    return armed, busy, state, captures, names


def test_absent_families_and_profile_endpoint(tmp_path):
    """The ``Calib_*`` gauges and ``Profiler_Captures_Count`` appear as
    on the JAX host, and ``/profile`` answers as the JAX host's: a POST
    arms a capture (200, its path under ``profilerdir``), a second POST
    during it conflicts (409), and GET reports the surface. The boot
    conf audit's ``Conf_*`` gauges equal the JAX host's on the same
    conf."""
    conf = _host_conf("HostAbsent", "torch", {
        "datax.job.process.observability.port": "0",
        # one key no registry row governs, one out of its bounds
        "datax.job.process.nosuchknob": "1",
        "datax.job.process.pilot.maxdepth": "0",
    })
    prefix = "DATAX-HostAbsent:"
    runs = {}
    for pkg, mod, SD, kw in (("jax", jhost_mod, JSettingDictionary, {}),
                             ("torch", thost_mod, SettingDictionary, {"device": "cpu"})):
        pconf = dict(conf, **{
            "datax.job.process.jar.udf.anomalyscore.class": ANOMALY_CLASSES[pkg],
            "datax.job.process.observability.profilerdir": str(tmp_path / pkg),
        })
        host = mod.StreamingHost(SD(pconf), **kw)
        try:
            conf_gauges = {
                k.split(":", 1)[1]: host.metric_logger.store.points(k)[-1]["val"]
                for k in host.metric_logger.store.keys(prefix)
                if k.split(":", 1)[1].startswith("Conf_") and k.endswith("_Count")}
            runs[pkg] = (host, conf_gauges, *_profiled_run(host, prefix))
        finally:
            host.stop()
        host.metric_logger.store.clear()
    (jhost, jconf_gauges, *jrun), (host, tconf_gauges, *trun) = runs["jax"], runs["torch"]
    assert set(jconf_gauges) == {"Conf_Audited_Count", "Conf_Unknown_Count",
                                 "Conf_OutOfBounds_Count"}
    assert jconf_gauges["Conf_Unknown_Count"] >= 1
    assert tconf_gauges == jconf_gauges
    assert host.conf_audit.metric_deltas() == jhost.conf_audit.metric_deltas()
    assert host.conf_audit.events() == jhost.conf_audit.events()
    for pkg, (armed, busy, state, captures, names) in (("jax", jrun), ("torch", trun)):
        assert armed[0] == 200 and armed[1]["path"].startswith(str(tmp_path / pkg))
        assert armed[1]["seconds"] == 0.2 and armed[1]["active"] is True
        assert busy == (409, {"error": "capture already in progress",
                              "path": armed[1]["path"]})
        assert state == (200, {"available": True, "active": None, "captures": 1})
        assert captures and set(captures) == {1.0}
        assert "Output_HeatAvg_Events_Count" in names
    assert {n for n in trun[4] if n.startswith(("Calib_", "Profiler_"))} == \
        {n for n in jrun[4] if n.startswith(("Calib_", "Profiler_"))} - {ICI_GAUGE}
    assert "Calib_HbmReadGBps" in trun[4] and ICI_GAUGE not in trun[4]
    # the port's capture is a Chrome trace of the process
    assert (Path(trun[0][1]["path"]) / "trace.json").stat().st_size > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_entry_points_need_the_card_without_device_cpu(tmp_path):
    conf = _host_conf("HostNoCard", "torch")
    with pytest.raises(EngineException, match="no CUDA device"):
        thost_mod.StreamingHost(SettingDictionary(conf))
    with pytest.raises(EngineException, match="no CUDA device"):
        BatchHost(SettingDictionary(conf))
    path = _write_conf(tmp_path, conf)
    with pytest.raises(EngineException, match="no CUDA device"):
        thost_mod.main([f"conf={path}", "batches=1"])


def _write_conf(tmp_path, conf):
    """A flat ``.conf`` file of ``conf``; multi-line values escaped as the
    flattener writes them."""
    path = tmp_path / "flow.conf"
    path.write_text("".join(
        f"{k}={v.replace(chr(92), chr(92) * 2).replace(chr(10), chr(92) + 'n')}\n"
        for k, v in conf.items()
    ))
    return path


def test_main_runs_a_conf_file_on_the_cpu(tmp_path):
    conf = _host_conf("HostMain", "torch", {
        "datax.job.process.pilot.enabled": "true",
        "datax.job.input.default.eventhub.checkpointdir": str(tmp_path / "ck"),
        "datax.job.input.default.eventhub.checkpointinterval": "0 second",
    })
    # an unpaced loop: a 1 ms interval at a rate that fills a batch
    conf["datax.job.input.default.streaming.intervalinseconds"] = "0.001"
    conf["datax.job.input.default.eventhub.maxrate"] = str(CAPACITY * 1000)
    host = thost_mod.main([f"conf={_write_conf(tmp_path, conf)}", "batches=3",
                           "device=cpu"])
    assert host.batches_processed == 3
    assert host.pilot is not None  # the default pilot
    assert host.processor.udfs["anomalyscore"].name == "anomalyscore"
    keys = host.metric_logger.store.keys("DATAX-HostMain:")
    assert "DATAX-HostMain:Output_HeatAvg_Events_Count" in keys
    assert (tmp_path / "ck" / "offsets.txt").exists()
    assert (tmp_path / "ck" / "window.npz").exists()


@pytest.mark.parametrize("loop", ["main", "pipelined"])
def test_a_stopped_host_frees_its_processor_without_the_collector(tmp_path, loop):
    """With the cyclic collector off, a stopped host that goes frees its
    processor and its window rings by reference counting: nothing the
    host owns (the pilot's depth callbacks, the worker threads'
    initializers) holds the host in a cycle, so on the card its tensors
    go at once, before a successor host allocates its own."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        if loop == "main":
            conf_path = chip_smoke.materialize_generated_conf(tmp_path)
            # under a name of its own: the metric store and the latency
            # histograms are per flow and process-wide, and
            # test_torch_genconf.py reads the generated flow's from them
            conf_path.write_text(conf_path.read_text(encoding="utf-8").replace(
                "datax.job.name=GenConfig1\n", "datax.job.name=GenConfigFreed\n"),
                encoding="utf-8")
            host = thost_mod.main([f"conf={conf_path}", "batches=2", "device=cpu"])
            assert host.health.flow == "GenConfigFreed"
        else:
            clock = _Clock()
            conf = _host_conf("HostFreed", "torch", {
                "datax.job.process.pilot.enabled": "true",
                "datax.job.input.default.eventhub.checkpointdir": str(tmp_path / "ck"),
            })
            host = thost_mod.StreamingHost(
                SettingDictionary(conf), source=_BytesSource(list(_feed("bytes")[1]), clock),
                device="cpu")
            host.run_pipelined(max_batches=3, depth=2)
            host.stop()
        assert host.pilot is not None and host.batches_processed >= 2
        proc = weakref.ref(host.processor)
        ring = weakref.ref(next(iter(host.processor.window_buffers.values())).valid)
        del host
        assert proc() is None and ring() is None
    finally:
        gc.enable()


# -- window.npz across packages ------------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_window_checkpoint_round_trips_across_packages(tmp_path, writer):
    """Each package restores the other's ``window.npz``: the rings, slot
    counter, time base and dictionary, and the next batch's rows then
    agree."""
    conf = _host_conf("HostNpz", "torch")
    jconf = _host_conf("HostNpz", "jax")
    jp = JFlowProcessor(JSettingDictionary(jconf), batch_capacity=CAPACITY,
                        output_datasets=OUTPUTS)
    tp = FlowProcessor(SettingDictionary(conf), batch_capacity=CAPACITY,
                       output_datasets=OUTPUTS, device="cpu")
    src, dst = (jp, tp) if writer == "jax" else (tp, jp)
    src_ck = (JWindowStateCheckpointer if writer == "jax" else WindowStateCheckpointer)
    dst_ck = (WindowStateCheckpointer if writer == "jax" else JWindowStateCheckpointer)
    rs = np.random.RandomState(2)
    ids = np.array([src.dictionary.encode(t) for t in TYPES], np.int32)
    for b in range(3):
        src.dispatch_batch(src.encode_columns(_batch_columns(rs, ids, 40), 40),
                           BASE_MS + 1000 * b).collect()
    src_ck(str(tmp_path / "ck")).save(src.snapshot_window_state())
    snap = dst_ck(str(tmp_path / "ck")).load()
    assert dst.restore_window_state(snap)
    a, b_ = src.snapshot_window_state(), dst.snapshot_window_state()
    assert (a["slot_counter"], a["base_ms"]) == (b_["slot_counter"], b_["base_ms"])
    assert a["dictionary"] == b_["dictionary"]
    for table, ring in a["rings"].items():
        assert np.array_equal(np.asarray(ring["valid"]),
                              np.asarray(b_["rings"][table]["valid"]))
        for c, v in ring["cols"].items():
            assert np.array_equal(np.asarray(v), np.asarray(b_["rings"][table]["cols"][c]))
    cols = _batch_columns(rs, ids, 40)
    t_ms = BASE_MS + 3000
    ds, _ = src.dispatch_batch(src.encode_columns(cols, 40), t_ms).collect()
    dd, _ = dst.dispatch_batch(dst.encode_columns({c: a.copy() for c, a in cols.items()},
                                                  40), t_ms).collect()
    _assert_same_rows(ds["HeatAvg"], dd["HeatAvg"], "HeatAvg after restore")


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_depth2_on_the_card_matches_the_cpu(card, monkeypatch):
    feed = _feed("bytes")

    def drive(device):
        clock = _Clock()
        monkeypatch.setattr(thost_mod, "time", clock.module())
        host = thost_mod.StreamingHost(
            SettingDictionary(_host_conf(f"HostCard{device}", "torch")),
            source=_BytesSource(list(feed[1]), clock), device=device)
        sink = _RecordingSink()
        host.dispatcher = tsinks.OutputDispatcher(
            {n: tsinks.OutputOperator(n, [sink]) for n in OUTPUTS}, host.metric_logger)
        try:
            host.run_pipelined(max_batches=BATCHES, depth=2)
        finally:
            host.stop()
            monkeypatch.undo()
        return host, sink.rows

    gpu, grows = drive("cuda")
    _cpu, crows = drive("cpu")
    assert set(grows) == set(crows)
    for key in crows:
        _assert_same_rows(crows[key], grows[key], key)
    assert gpu.processor.udfs["anomalyscore"].launches == BATCHES


@pytest.mark.cuda
def test_snapshot_under_an_in_flight_batch_equals_a_synchronized_one(card):
    proc = FlowProcessor(SettingDictionary(_host_conf("HostSnapCard", "torch")),
                         batch_capacity=4096, output_datasets=OUTPUTS, device="cuda")
    ids = np.array([proc.dictionary.encode(t) for t in TYPES], np.int32)
    rs = np.random.RandomState(8)
    for b in range(3):
        proc.dispatch_batch(proc.encode_columns(_batch_columns(rs, ids, 4096), 4096),
                            BASE_MS + 1000 * b).collect()
    h = proc.dispatch_batch(proc.encode_columns(_batch_columns(rs, ids, 4096), 4096),
                            BASE_MS + 3000)
    snap = proc.snapshot_window_state()  # batch 3 may still run
    nxt = proc.dispatch_batch(proc.encode_columns(_batch_columns(rs, ids, 4096), 4096),
                              BASE_MS + 4000)
    torch.cuda.synchronize()
    h.collect()
    nxt.collect()
    # the synchronized cut after batch 3: replay batches 0-3 on a fresh
    # processor and snapshot it with nothing in flight
    ref = FlowProcessor(SettingDictionary(_host_conf("HostSnapCard", "torch")),
                        batch_capacity=4096, output_datasets=OUTPUTS, device="cuda")
    rs = np.random.RandomState(8)
    for b in range(4):
        ref.dispatch_batch(ref.encode_columns(_batch_columns(rs, ids, 4096), 4096),
                           BASE_MS + 1000 * b).collect()
    torch.cuda.synchronize()
    want = ref.snapshot_window_state()
    assert snap["slot_counter"] == want["slot_counter"] == 4
    for table, ring in want["rings"].items():
        assert np.array_equal(snap["rings"][table]["valid"], ring["valid"])
        for c, v in ring["cols"].items():
            assert np.array_equal(snap["rings"][table]["cols"][c], v), c
