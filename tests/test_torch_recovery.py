"""Restart and recovery of the port's host loop, the mirror of
``test_recovery.py`` on ``data_accelerator_tpu_torch`` with
``device="cpu"``: offset and window checkpoints resume a restarted host,
both checkpoint files survive power loss (fsyncs) and torn writes,
backpressure halves the rate on an overrun, and the depth-N in-flight
window keeps FIFO commit and at-least-once requeue at depths 1/2/4 under
a sink, dispatch or background-landing failure, with the pooled ingest
matrices safe under the window and a UDF refresh mid-window.

Not mirrored, with their modules: the state-table cases (slice 4), the
profiler hook (``obs/profiler.py``) and the protocol monitor
(``runtime/protocolmonitor.py``), which the port refuses by conf; the
reference arms the buffer sanitizer and the protocol monitor in its
depth drills, which this port does not have.
"""

import functools
import json
import os
import socket
import threading
import time as _time

import numpy as np
import pytest
import torch

from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.runtime import host as host_mod
from data_accelerator_tpu_torch.runtime import processor as processor_mod
from data_accelerator_tpu_torch.runtime.sources import SocketSource

# the tests ask for the CPU; the entry points default to the card
StreamingHost = functools.partial(host_mod.StreamingHost, device="cpu")

SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
]})


def _write_events(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _conf(tmp_path, extra=None):
    """A file-sourced flow whose window (``W``) counts rows by key over
    5 s: the state a restart must carry over."""
    t = tmp_path / "t.transform"
    if not t.exists():
        t.write_text(
            "--DataXQuery--\n"
            "W = SELECT k, COUNT(*) AS c FROM DataXProcessedInput_5seconds "
            "GROUP BY k\n"
            "--DataXQuery--\n"
            "Out = SELECT k, v FROM DataXProcessedInput\n"
        )
    d = {
        "datax.job.name": "RecFlow",
        "datax.job.input.default.inputtype": "file",
        "datax.job.input.default.blobpathregex": str(tmp_path / "in" / "*.json"),
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.input.default.eventhub.maxrate": "100",
        "datax.job.input.default.eventhub.checkpointdir": str(tmp_path / "ckpt"),
        "datax.job.input.default.eventhub.checkpointinterval": "0 second",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.transform": str(t),
        "datax.job.process.batchcapacity": "16",
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.projection": (
            "current_timestamp() AS eventTimeStamp\nRaw.*"),
        "datax.job.process.timewindow.DataXProcessedInput_5seconds"
        ".windowduration": "5 seconds",
        "datax.job.output.Out.console.maxrows": "0",
        "datax.job.output.W.console.maxrows": "0",
    }
    d.update(extra or {})
    return SettingDictionary(d)


class _Rows:
    kind = "rows"

    def __init__(self):
        self.rows = []

    def write(self, dataset, rows, batch_time_ms):
        self.rows.append(rows)
        return len(rows)


def test_restart_resumes_offsets_and_window(tmp_path):
    """Kill the host after batch 1, start a fresh one: the file source
    resumes past consumed files (offsets.txt) and the window rings reload
    from window.npz, so the window counts span the restart."""
    _write_events(str(tmp_path / "in" / "a.json"),
                  [{"k": 1, "v": 5.0}, {"k": 2, "v": 7.0}, {"k": 1, "v": 1.0}])
    host1 = StreamingHost(_conf(tmp_path))
    host1.run_batch()
    host1.stop()
    assert os.path.exists(tmp_path / "ckpt" / "offsets.txt")
    assert os.path.exists(tmp_path / "ckpt" / "window.npz")
    assert host1.window_restored_from is None

    # second file arrives; a NEW host process takes over
    _write_events(str(tmp_path / "in" / "b.json"), [{"k": 1, "v": 9.0}])
    host2 = StreamingHost(_conf(tmp_path))
    assert host2.window_restored_from == "local"
    sink = _Rows()
    host2.dispatcher.operators["W"].sinks.append(sink)
    m = host2.run_batch()
    host2.stop()
    # only the new file's rows were ingested (a.json not replayed)
    assert m["Input_DataXProcessedInput_Events_Count"] == 1.0
    # the window spans the restart: a.json's rows plus b.json's
    assert {r["k"]: r["c"] for r in sink.rows[0]} == {1: 3, 2: 1}


def test_write_offsets_fsyncs_file_and_directory(tmp_path, monkeypatch):
    """The offsets checkpoint must survive POWER LOSS: the tmp file is
    fsynced before os.replace and the directory entry after it."""
    from data_accelerator_tpu_torch.runtime.checkpoint import (
        OffsetCheckpointer,
        PartitionOffset,
    )

    synced = []
    real_fsync = os.fsync

    def spy_fsync(fd):
        try:
            synced.append(os.readlink(f"/proc/self/fd/{fd}"))
        except OSError:
            synced.append("<unknown>")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy_fsync)
    ck = OffsetCheckpointer(str(tmp_path / "ck"))
    ck.write_offsets([PartitionOffset(1, "default", 0, 0, 42)])
    assert any(p.endswith("offsets.txt.tmp") for p in synced), synced
    assert any(p.rstrip("/").endswith("ck") for p in synced), synced
    assert ck.read_offsets() == [PartitionOffset(1, "default", 0, 0, 42)]
    assert ck.starting_positions() == {("default", 0): 42}


def test_window_save_fsyncs_file_and_directory(tmp_path, monkeypatch):
    from data_accelerator_tpu_torch.runtime.checkpoint import WindowStateCheckpointer

    synced = []
    real_fsync = os.fsync

    def spy_fsync(fd):
        synced.append(os.readlink(f"/proc/self/fd/{fd}"))
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy_fsync)
    ck = WindowStateCheckpointer(str(tmp_path / "ck"))
    ck.save({"rings": {"T": {"cols": {"k": np.zeros((2, 4), np.int32)},
                             "valid": np.zeros((2, 4), bool)}},
             "slot_counter": 1, "base_ms": 1000})
    assert any(".tmp" in p for p in synced), synced
    assert any(p.rstrip("/").endswith("ck") for p in synced), synced


def test_window_checkpoint_restores_previous_on_truncated_tmp(tmp_path):
    """A crash mid-save leaves a torn ``window.npz.tmp`` behind: restore
    comes from the previous COMPLETE checkpoint; a torn main file falls
    back to the ``.old`` backup."""
    from data_accelerator_tpu_torch.runtime.checkpoint import WindowStateCheckpointer

    ck = WindowStateCheckpointer(str(tmp_path / "ck"))
    snap = {
        "rings": {"T": {
            "cols": {"k": np.arange(8, dtype=np.int32).reshape(2, 4)},
            "valid": np.ones((2, 4), bool),
        }},
        "slot_counter": 5,
        "base_ms": 123_000,
    }
    ck.save(snap)
    good = open(ck.path, "rb").read()
    with open(ck.path + ".tmp", "wb") as f:
        f.write(good[: len(good) // 3])
    restored = WindowStateCheckpointer(str(tmp_path / "ck")).load()
    assert restored is not None
    assert restored["slot_counter"] == 5
    assert (restored["rings"]["T"]["cols"]["k"]
            == snap["rings"]["T"]["cols"]["k"]).all()

    ck.save({**snap, "slot_counter": 6})  # rotates the good one to .old
    with open(ck.path, "wb") as f:
        f.write(good[: len(good) // 3])
    restored = WindowStateCheckpointer(str(tmp_path / "ck")).load()
    assert restored is not None and restored["slot_counter"] == 5


def test_backpressure_halves_rate_on_overrun(tmp_path):
    _write_events(str(tmp_path / "in" / "a.json"), [{"k": 1, "v": 1.0}])
    host = StreamingHost(_conf(tmp_path, {
        "datax.job.input.default.streaming.intervalinseconds": "0.001",
    }))
    host.run_batch()  # any real batch overruns a 1 ms interval
    assert host._rate_scale == 0.5
    host.stop()


# ---------------------------------------------------------------------------
# depth-N in-flight window: failure injection at depths 1/2/4
# ---------------------------------------------------------------------------
class _RecordingSink:
    """Records successful writes in arrival order; raises (BEFORE
    recording) on any batch containing a poisoned k value while armed.
    Also records which thread each write ran on, and optionally sleeps
    first so landings genuinely queue behind the dispatch loop."""

    kind = "recording"

    def __init__(self):
        self.batches = []  # (batch_time_ms, [k...]) per successful write
        self.poison_k = None
        self.threads = []
        self.delay_s = 0.0

    def write(self, dataset, rows, batch_time_ms):
        self.threads.append(threading.current_thread().name)
        if self.delay_s:
            _time.sleep(self.delay_s)
        ks = [r["k"] for r in rows]
        if self.poison_k is not None and self.poison_k in ks:
            raise RuntimeError(f"poisoned batch (k={self.poison_k})")
        self.batches.append((batch_time_ms, ks))
        return len(rows)


@pytest.fixture(scope="module", autouse=True)
def _decoder_built():
    """Build (or load) the native decoder before any loop runs: its
    first g++ build takes seconds, and inside a loop iteration it would
    trip the host's adaptive backpressure (an iteration longer than the
    interval halves the next poll), which these drills do not test."""
    from data_accelerator_tpu_torch.native import decoder

    decoder._load()


def _depth_host(tmp_path, depth):
    """StreamingHost over a SocketSource (the UnackedFifo source) with a
    recording sink on its one output; 4 events per poll."""
    from data_accelerator_tpu_torch.runtime.sinks import OutputDispatcher, OutputOperator

    t = tmp_path / "depth.transform"
    t.write_text(
        "--DataXQuery--\n"
        "Out = SELECT k, v FROM DataXProcessedInput\n"
    )
    conf = SettingDictionary({
        "datax.job.name": f"Depth{depth}",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.input.default.eventhub.maxrate": "4",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.transform": str(t),
        "datax.job.process.batchcapacity": "4",
        "datax.job.process.pipeline.depth": str(depth),
        "datax.job.output.Out.console.maxrows": "0",
    })
    src = SocketSource(port=0)
    host = StreamingHost(conf, source=src)
    sink = _RecordingSink()
    host.dispatcher = OutputDispatcher(
        {"Out": OutputOperator("Out", [sink])}, host.metric_logger
    )
    return host, src, sink


def _feed_socket(src, n_events):
    conn = socket.create_connection(("127.0.0.1", src.port), timeout=5)
    payload = b"".join(
        json.dumps({"k": i, "v": float(i)}).encode() + b"\n"
        for i in range(n_events)
    )
    conn.sendall(payload)
    conn.close()
    deadline = _time.time() + 5
    while _time.time() < deadline and len(src._buf) < n_events:
        _time.sleep(0.01)
    assert len(src._buf) == n_events


def _delivered_ks(blob):
    return [json.loads(ln)["k"] for ln in blob.splitlines() if ln.strip()]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_depth_window_sink_failure_fifo_and_requeue(tmp_path, depth):
    """A sink failure anywhere in the window: batches already finished
    stay committed in FIFO order, the failed batch and EVERY un-acked
    batch behind it requeue in order, and a rerun delivers all events
    exactly once through the sink."""
    host, src, sink = _depth_host(tmp_path, depth)
    try:
        _feed_socket(src, 16)  # batches B1(k 0-3) .. B4(k 12-15)
        sink.poison_k = 9  # B3's finish fails at the sink
        with pytest.raises(RuntimeError, match="poisoned"):
            host.run_pipelined(max_batches=4)
        assert [ks for _t, ks in sink.batches] == [
            [0, 1, 2, 3], [4, 5, 6, 7],
        ]
        times = [t for t, _ks in sink.batches]
        assert times == sorted(times)
        assert host.batches_processed == 2

        b3, _n3, _ = src.poll_raw(4)
        assert _delivered_ks(b3) == [8, 9, 10, 11]
        b4, _n4, _ = src.poll_raw(4)
        assert _delivered_ks(b4) == [12, 13, 14, 15]
        src.requeue_unacked()

        sink.poison_k = None
        host.run_pipelined(max_batches=4)
        assert host.batches_processed == 4
        all_ks = [k for _t, ks in sink.batches for k in ks]
        assert all_ks == list(range(16))  # no loss, no duplication
    finally:
        host.stop()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_depth_window_dispatch_failure_requeues_window(tmp_path, depth):
    """A dispatch failure mid-window: nothing is acked past the oldest
    committed batch, every polled-but-unfinished batch requeues in
    order, and a rerun completes with exactly-once sink delivery."""
    host, src, sink = _depth_host(tmp_path, depth)
    try:
        _feed_socket(src, 16)
        real_dispatch = host.processor.dispatch_batch
        calls = {"n": 0}

        def failing_dispatch(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("dispatch boom")
            return real_dispatch(*a, **kw)

        host.processor.dispatch_batch = failing_dispatch
        with pytest.raises(RuntimeError, match="dispatch boom"):
            host.run_pipelined(max_batches=4)
        finished = [ks for _t, ks in sink.batches]
        assert finished == [[0, 1, 2, 3]][: len(finished)]
        n_done = host.batches_processed

        redelivered = []
        for _ in range(4 - n_done):
            blob, n, _ = src.poll_raw(4)
            assert n == 4
            redelivered.extend(_delivered_ks(blob))
        assert redelivered == list(range(n_done * 4, 16))
        src.requeue_unacked()

        host.processor.dispatch_batch = real_dispatch
        host.run_pipelined(max_batches=4)
        assert host.batches_processed == 4
        all_ks = [k for _t, ks in sink.batches for k in ks]
        assert all_ks == list(range(16))
    finally:
        host.stop()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_background_landing_failure_drains_and_requeues(tmp_path, depth):
    """Sinks run on the BACKGROUND landing thread and throw while later
    batches' transfers are in flight: the whole un-acked window requeues,
    pending landings are drained, FIFO commit order holds, and a healed
    rerun delivers every event exactly once."""
    host, src, sink = _depth_host(tmp_path, depth)
    try:
        assert host.background_transfer  # default on
        tail_threads = []
        orig_tail = host._finish_tail

        def spy_tail(*a, **kw):
            tail_threads.append(threading.current_thread().name)
            return orig_tail(*a, **kw)

        host._finish_tail = spy_tail
        sink.delay_s = 0.05  # landings queue while the loop dispatches
        _feed_socket(src, 16)
        sink.poison_k = 9  # B3's landing fails at the sink
        with pytest.raises(RuntimeError, match="poisoned"):
            host.run_pipelined(max_batches=4)
        assert tail_threads and all(
            t.startswith("landing") for t in tail_threads
        )
        assert len(host._landings) == 0
        assert host._landing_failed is not None
        assert [ks for _t, ks in sink.batches] == [
            [0, 1, 2, 3], [4, 5, 6, 7],
        ]
        assert host.batches_processed == 2
        redelivered = []
        for _ in range(2):
            blob, n, _ = src.poll_raw(4)
            assert n == 4
            redelivered.extend(_delivered_ks(blob))
        assert redelivered == list(range(8, 16))
        src.requeue_unacked()

        sink.poison_k = None
        sink.delay_s = 0.0
        host.run_pipelined(max_batches=4)
        assert host._landing_failed is None
        assert host.batches_processed == 4
        all_ks = [k for _t, ks in sink.batches for k in ks]
        assert all_ks == list(range(16))
    finally:
        host.stop()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_decode_buffer_pool_safe_under_pipelined_window(tmp_path, depth):
    """The pooled ingest matrices under decode-ahead at depths 1/2/4 with
    failure-requeue: the pool hands a matrix to a new decode ONLY after
    its owning batch released it, never while the batch is in flight;
    after a poisoned-sink failure plus requeue every event lands exactly
    once with correct values."""
    host, src, sink = _depth_host(tmp_path, depth)
    try:
        outstanding = set()
        violations = []
        orig_encode = host.processor._encode_packed_native

        def spy_encode(decoder, data, base_ms, spec, fmt, to_device):
            pr = orig_encode(decoder, data, base_ms, spec, fmt, to_device)
            pool, mat = pr.ingest_slot
            if id(mat) in outstanding:
                violations.append(id(mat))
            outstanding.add(id(mat))
            orig_release = pool.release

            def tracked_release(m, *a, _orig=orig_release, **k):
                outstanding.discard(id(m))
                _orig(m, *a, **k)

            pool.release = tracked_release
            return pr

        host.processor._encode_packed_native = spy_encode

        _feed_socket(src, 16)
        sink.poison_k = 9  # B3 fails at the sink mid-window
        with pytest.raises(RuntimeError, match="poisoned"):
            host.run_pipelined(max_batches=4)
        src.requeue_unacked()
        sink.poison_k = None
        host.run_pipelined(max_batches=4)

        assert not violations, (
            "ingest pool handed out a matrix still owned by an "
            "in-flight batch"
        )
        all_ks = [k for _t, ks in sink.batches for k in ks]
        assert all_ks == list(range(16))
        pools = host.processor._ingest_pools.values()
        assert sum(p.reuse_count for p in pools) > 0
        assert all(p.alloc_count <= depth + 4 for p in pools)
        assert not outstanding
    finally:
        host.stop()


def test_udf_refresh_mid_window_uses_snapshotted_pipeline(tmp_path):
    """A UDF on_interval refresh while earlier batches are still in
    flight: each PendingBatch decodes against the pipeline of the step
    that produced it, collected FIFO across the window."""
    from data_accelerator_tpu_torch.udf import TorchUdf

    state = {"factor": 2.0, "pending": False}

    def refresh(ts):
        if state["pending"]:
            state["factor"] = 3.0
            state["pending"] = False
            return True
        return False

    u = TorchUdf(
        "dynscale",
        lambda x: x.to(torch.float32) * state["factor"],
        out_type="double",
        on_interval=refresh,
    )
    t = tmp_path / "udf.transform"
    t.write_text(
        "--DataXQuery--\n"
        "T = SELECT k, dynscale(v) AS s FROM DataXProcessedInput\n"
    )
    proc = processor_mod.FlowProcessor(
        SettingDictionary({
            "datax.job.name": "RefreshWindow",
            "datax.job.input.default.blobschemafile": SCHEMA,
            "datax.job.process.transform": str(t),
            "datax.job.process.batchcapacity": "8",
            "datax.job.process.pipeline.depth": "4",
        }),
        udfs={"dynscale": u},
        output_datasets=["T"],
        device="cpu",
    )
    rows = [{"k": 1, "v": 5.0}]
    h1 = proc.dispatch_batch(proc.encode_rows(rows, 0), 1000)
    h2 = proc.dispatch_batch(proc.encode_rows(rows, 0), 2000)
    state["pending"] = True  # the NEXT dispatch's refresh rebuilds
    h3 = proc.dispatch_batch(proc.encode_rows(rows, 0), 3000)
    d1, _ = h1.collect()
    d2, _ = h2.collect()
    d3, _ = h3.collect()
    assert d1["T"][0]["s"] == 10.0
    assert d2["T"][0]["s"] == 10.0
    assert d3["T"][0]["s"] == 15.0
