"""The port's spans for the source, the loop's tail and pacing, the blob
sink's encode and write, and the device step, as the flight recorder
holds them: ``poll`` (in ``decode``) and ``source/wait`` over a
``SocketSource``, ``tail`` after the acks, ``streaming/pace`` outside
every batch, ``read`` in the ``batch/chunk`` trace its rows go to,
``sink/file/encode|write`` under ``sink/file``; the socket source's
arrival stamps, a requeue among them; the benchmark's wrappers around
the host still seeing every call; the telemetry writers' repairs (a log
without INFO serialises nothing, the flight recorder keeps one handle
and never splits a record); and on the card, ``device-step`` timed by
CUDA events."""

import functools
import json
import logging
import socket
import time

import pytest

from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.obs import telemetry
from data_accelerator_tpu_torch.obs.__main__ import load_spans
from data_accelerator_tpu_torch.runtime import batchhost as batchhost_mod
from data_accelerator_tpu_torch.runtime import host as host_mod
from data_accelerator_tpu_torch.runtime.sources import SocketSource

StreamingHost = functools.partial(host_mod.StreamingHost, device="cpu")

SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
]})
TRANSFORM = "--DataXQuery--\nHot = SELECT k, v FROM DataXProcessedInput WHERE v > 5\n"


def _lines(n, start=0):
    return b"".join(
        json.dumps({"k": i % 3, "v": float(i % 10)}).encode() + b"\n"
        for i in range(start, start + n)
    )


def _wait_buffered(src, n, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and len(src._buf) < n:
        time.sleep(0.005)
    assert len(src._buf) >= n


def _stream_conf(tmp_path, name):
    (tmp_path / "t.transform").write_text(TRANSFORM)
    return SettingDictionary({
        "datax.job.name": name,
        "datax.job.input.default.inputtype": "socket",
        "datax.job.input.default.socket.port": "0",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.input.default.eventhub.maxrate": "4000",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.input.default.streaming.checkpointdir": str(tmp_path / "ckpt"),
        "datax.job.process.transform": str(tmp_path / "t.transform"),
        "datax.job.process.batchcapacity": "1024",
        "datax.job.output.Hot.blob.group.main.folder": str(tmp_path / "out"),
        "datax.job.output.Hot.blob.compressiontype": "gzip",
        "datax.job.process.telemetry.tracefile": str(tmp_path / "trace.jsonl"),
    })


def _by_trace(spans):
    out = {}
    for s in spans:
        out.setdefault(s["trace"], []).append(s)
    return out


def _one(spans, name):
    got = [s for s in spans if s["name"] == name]
    assert len(got) == 1, (name, [s["name"] for s in spans])
    return got[0]


def _end(s):
    return s["startTs"] + s["durationMs"] / 1000.0


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """Three paced batches of a streaming host over a socket source:
    256 lines buffered before the first poll, 256 more before the
    second (so its oldest line has a stamp of its own), none for the
    third; the host's acks timed."""
    tmp = tmp_path_factory.mktemp("stream")
    host = StreamingHost(_stream_conf(tmp, "SpanFlow"))
    acks, ack = [], host.source.ack

    def timed_ack():
        ack()
        acks.append(time.time())

    host.source.ack = timed_ack
    conn = socket.create_connection(("127.0.0.1", host.source.port), timeout=5)
    sent = [time.time()]
    conn.sendall(_lines(256))
    _wait_buffered(host.source, 256)
    polls = []
    run_batch = host.run_batch

    def batch():
        if len(polls) == 1:
            sent.append(time.time())
            conn.sendall(_lines(256, 256))
            _wait_buffered(host.source, 256)
        polls.append(time.time())
        return run_batch()

    host.run_batch = batch
    try:
        host.run(max_batches=3)
    finally:
        conn.close()
        host.stop()
    spans = load_spans(str(tmp / "trace.jsonl"))
    traces = _by_trace(spans)
    batches = [t for t in traces.values()
               if any(s["name"] == "streaming/batch" for s in t)]
    batches.sort(key=lambda t: _one(t, "streaming/batch")["startTs"])
    return {"spans": spans, "traces": traces, "batches": batches,
            "acks": acks, "sent": sent, "polls": polls}


def test_poll_nests_in_decode_with_its_props(streamed):
    lines = []
    for t in streamed["batches"]:
        decode, poll = _one(t, "decode"), _one(t, "poll")
        assert poll["parent"] == decode["span"]
        assert decode["parent"] == _one(t, "streaming/batch")["span"]
        assert decode["startTs"] <= poll["startTs"] and _end(poll) <= _end(decode) + 1e-3
        props = poll["properties"]
        assert set(props) == {"lines", "buffered", "reader_cpu_ms"}
        assert props["buffered"] == 0 and props["reader_cpu_ms"] >= 0.0
        lines.append(props["lines"])
    assert lines == [256, 256, 0]


def test_source_wait_runs_from_the_oldest_arrival_to_the_poll(streamed):
    for i, t in enumerate(streamed["batches"][:2]):
        wait, poll = _one(t, "source/wait"), _one(t, "poll")
        root = _one(t, "streaming/batch")
        assert wait["parent"] == root["span"]
        # stamped when the first line arrived, after it was sent and
        # before the poll drained it
        assert streamed["sent"][i] - 1e-3 <= wait["startTs"] <= poll["startTs"]
        assert wait["startTs"] <= _end(wait) <= _end(poll) + 1e-3
        assert wait["durationMs"] >= 0.0
    # a poll that drained nothing has no oldest event
    assert not [s for s in streamed["batches"][2] if s["name"] == "source/wait"]


def test_tail_follows_the_acks_and_holds_the_checkpoint(streamed):
    for t, acked in zip(streamed["batches"], streamed["acks"]):
        root, tail = _one(t, "streaming/batch"), _one(t, "tail")
        assert tail["parent"] == root["span"]
        assert tail["startTs"] >= acked - 1e-3
        assert _end(tail) <= _end(root) + 1e-3
        sinks = _one(t, "sinks")
        assert _end(sinks) <= tail["startTs"] + 1e-3
    first = streamed["batches"][0]
    assert _one(first, "checkpoint")["parent"] == _one(first, "tail")["span"]


def test_pace_is_a_trace_of_its_own_outside_every_batch(streamed):
    paces = [t for t in streamed["traces"].values()
             if any(s["name"] == "streaming/pace" for s in t)]
    # the loop sleeps between batches, not after the last
    assert len(paces) == 2
    batch_traces = {t[0]["trace"] for t in streamed["batches"]}
    for t in paces:
        assert len(t) == 1 and t[0]["parent"] is None
        assert t[0]["trace"] not in batch_traces
        assert 0.0 < t[0]["properties"]["plannedMs"] <= 1000.0
    roots = [_one(t, "streaming/batch") for t in streamed["batches"]]
    for p in paces:
        s = p[0]
        assert not any(r["startTs"] < s["startTs"] < _end(r) - 1e-3 for r in roots)


def test_blob_encode_and_write_sit_under_sink_file(streamed):
    for t in streamed["batches"][:2]:
        sink = _one(t, "sink/file")
        enc, wr = _one(t, "sink/file/encode"), _one(t, "sink/file/write")
        assert enc["parent"] == sink["span"] and wr["parent"] == sink["span"]
        assert enc["properties"]["rows"] == wr["properties"]["rows"] == sink["properties"]["rows"] > 0
        assert enc["properties"]["bytes"] == wr["properties"]["bytes"] > 0
        assert enc["startTs"] <= wr["startTs"]
        assert enc["durationMs"] + wr["durationMs"] <= sink["durationMs"] + 1e-3


def test_device_step_keeps_its_host_clock_meaning_on_the_cpu(streamed):
    for t in streamed["batches"]:
        step, dispatch = _one(t, "device-step"), _one(t, "dispatch")
        # from dispatch return to the end of the counts sync
        assert step["startTs"] >= _end(dispatch) - 1e-3
        assert _end(step) <= _end(_one(t, "sync")) + 1e-3


def test_arrival_stamps_every_256_lines_and_a_requeue_keeps_its_first():
    src = SocketSource(port=0)
    conn = socket.create_connection(("127.0.0.1", src.port), timeout=5)
    try:
        t_first = time.time()
        conn.sendall(_lines(300))
        _wait_buffered(src, 300)
        t_second = time.time()
        conn.sendall(_lines(300, 300))
        _wait_buffered(src, 600)
        assert [seq for seq, _t in src._stamps] == [0, 256, 512]
        _b, n1, _o = src.poll_raw(200)
        first = dict(src.last_poll)
        assert n1 == 200 and first["buffered"] == 400
        assert t_first <= first["arrival"] <= first["polled"]
        # line 200's stamp is line 0's: the latest at or before it
        _b, n2, _o = src.poll_raw(400)
        second = dict(src.last_poll)
        assert n2 == 400 and second["buffered"] == 0
        assert second["arrival"] == first["arrival"]
        src.requeue_unacked()
        time.sleep(0.01)
        src.poll_raw(200)
        again = dict(src.last_poll)
        assert again["arrival"] == first["arrival"] and again["polled"] > first["polled"]
        src.poll_raw(400)
        assert src.last_poll["arrival"] == second["arrival"]
        src.ack()
        src.ack()
        conn.sendall(_lines(10, 600))
        _wait_buffered(src, 10)
        _b, n3, _o = src.poll_raw(100)
        # line 600's stamp is line 512's, taken after the second send
        assert n3 == 10
        assert t_second <= src.last_poll["arrival"] <= src.last_poll["polled"]
        assert src.last_poll["reader_cpu_ms"] >= 0.0
        _b, n4, _o = src.poll_raw(100)
        assert n4 == 0 and src.last_poll["arrival"] is None
    finally:
        conn.close()
        src.close()


def test_stamps_hold_under_concurrent_readers_and_polls():
    """Eight connections' readers against a polling thread, with a short
    switch interval: every line is polled once, each poll's arrival is
    no later than its drain and no earlier than the previous poll's, and
    the readers' CPU never runs backwards."""
    import sys

    src = SocketSource(port=0)
    conns = [socket.create_connection(("127.0.0.1", src.port), timeout=5)
             for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i, c in enumerate(conns):
            c.sendall(_lines(2000, 2000 * i))
        polled, last_arrival = 0, 0.0
        deadline = time.time() + 60
        while polled < 16000 and time.time() < deadline:
            _b, n, offsets = src.poll_raw(1000)
            src.ack()
            lp = src.last_poll
            assert offsets[("socket", 0)] == (polled, polled + n)
            assert lp["reader_cpu_ms"] >= 0.0
            if n:
                assert last_arrival <= lp["arrival"] <= lp["polled"]
                last_arrival = lp["arrival"]
            polled += n
        assert polled == 16000
        assert all(seq % 256 == 0 for seq, _t in src._stamps)
    finally:
        sys.setswitchinterval(interval)
        for c in conns:
            c.close()
        src.close()


def _batch_conf(tmp_path):
    (tmp_path / "t.transform").write_text(TRANSFORM)
    return SettingDictionary({
        "datax.job.name": "SpanBatch",
        "datax.job.input.default.inputtype": "file",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": str(tmp_path / "t.transform"),
        "datax.job.process.batchcapacity": "64",
        "datax.job.input.batch.blob.0.path": str(tmp_path / "in" / "*.json"),
        "datax.job.output.Hot.blob.group.main.folder": str(tmp_path / "out"),
        "datax.job.output.Hot.blob.compressiontype": "none",
        "datax.job.process.telemetry.tracefile": str(tmp_path / "trace.jsonl"),
    })


# rows a file: the first chunk (64 rows) completes in b, the second in
# c, which also gives the third chunk its first rows
FILES = {"a.json": 40, "b.json": 40, "c.json": 100}


def _batch_files(tmp_path):
    (tmp_path / "in").mkdir()
    start = 0
    for name, n in FILES.items():
        (tmp_path / "in" / name).write_bytes(_lines(n, start))
        start += n


def test_each_read_sits_in_the_chunk_trace_its_rows_go_to(tmp_path):
    _batch_files(tmp_path)
    host = batchhost_mod.BatchHost(_batch_conf(tmp_path), device="cpu")
    host.run()
    spans = load_spans(str(tmp_path / "trace.jsonl"))
    traces = _by_trace(spans)
    chunks = sorted((t for t in traces.values()
                     if any(s["name"] == "batch/chunk" for s in t)),
                    key=lambda t: _one(t, "batch/chunk")["startTs"])
    assert len(chunks) == 3
    reads = [s for s in spans if s["name"] == "read"]
    assert [s["properties"]["file"].rsplit("/", 1)[-1] for s in reads] == list(FILES)
    assert [s["properties"]["lines"] for s in reads] == list(FILES.values())
    # the chunk that takes each file's first row
    before, want = 0, []
    for n in FILES.values():
        want.append(before // 64)
        before += n
    got = [next(i for i, t in enumerate(chunks) if s in t) for s in reads]
    assert got == want == [0, 0, 1]
    for t in chunks:
        root = _one(t, "batch/chunk")
        for s in t:
            if s is not root:
                assert s["parent"] is not None
        # the chunk's trace opens at its first row's read, and every
        # read of it lies inside the root
        for r in (s for s in t if s["name"] == "read"):
            assert r["parent"] == root["span"]
            assert root["startTs"] <= r["startTs"] and _end(r) <= _end(root) + 1e-3
        assert _one(t, "decode")["startTs"] >= max(
            [_end(r) for r in t if r["name"] == "read"] or [root["startTs"]]) - 1e-3
    # the blob sink's two halves under its span in the batch host too
    for s in (x for x in spans if x["name"] in ("sink/file/encode", "sink/file/write")):
        parent = next(x for x in spans if x["trace"] == s["trace"] and x["span"] == s["parent"])
        assert parent["name"] == "sink/file"


def test_the_benchmarks_wrappers_still_see_every_call(tmp_path):
    from streambench.loops.batch import Recorder
    from streambench.loops.stream import Framing

    (tmp_path / "s").mkdir()
    host = StreamingHost(_stream_conf(tmp_path / "s", "SpanWrapped"))
    framing = Framing(host)
    conn = socket.create_connection(("127.0.0.1", host.source.port), timeout=5)
    try:
        conn.sendall(_lines(100))
        _wait_buffered(host.source, 100)
        host.run(max_batches=2)
    finally:
        conn.close()
        host.stop()
    assert [(r["frm"], r["to"]) for r in framing.polls] == [(0, 100), (100, 100)]
    assert all(r["bt"] is not None and r["ack"] is not None for r in framing.polls)

    (tmp_path / "b").mkdir()
    _batch_files(tmp_path / "b")
    bhost = batchhost_mod.BatchHost(_batch_conf(tmp_path / "b"), device="cpu")
    rec = Recorder(bhost, batchhost_mod)
    rec.passes.append({"bt": None, "chunks": []})
    try:
        bhost.run()
    finally:
        rec.restore()
    assert len(rec.parse) == len(FILES)
    assert [c["rows"] for c in rec.passes[0]["chunks"]] == [64, 64, 52]
    assert rec.passes[0]["bt"] is not None


class _Unserialisable:
    calls = 0

    def __str__(self):
        type(self).calls += 1
        return "serialised"


def test_the_log_writer_serialises_nothing_without_info(caplog):
    w = telemetry.LogWriter()
    with caplog.at_level(logging.WARNING, logger=telemetry.logger.name):
        w.write({"type": "span", "name": "poll", "x": _Unserialisable()})
    assert _Unserialisable.calls == 0 and not caplog.records
    with caplog.at_level(logging.INFO, logger=telemetry.logger.name):
        w.write({"type": "span", "name": "poll", "x": _Unserialisable()})
    assert _Unserialisable.calls == 1
    assert json.loads(caplog.records[-1].getMessage())["x"] == "serialised"


@pytest.mark.parametrize("compress", [False, True])
def test_the_flight_recorder_keeps_one_handle_and_never_splits_a_record(tmp_path, compress):
    import gzip

    path = tmp_path / "t.jsonl"
    w = telemetry.JsonlWriter(str(path), max_bytes=600, keep=50, compress=compress)
    opened = []
    for i in range(60):
        w.write({"type": "span", "name": "read", "i": i, "pad": "x" * (i % 7)})
        opened.append(id(w._f))
        # visible to a reader at once: flushed per record
        assert path.read_text().splitlines()[-1].endswith("}")
    rotated = sorted(tmp_path.glob("t.jsonl.*"))
    assert len(rotated) > 3
    # one handle between rotations: fewer opens than records
    assert len(set(opened)) <= len(rotated) + 1
    records = []
    for p in rotated + [path]:
        with (gzip.open if p.suffix == ".gz" else open)(p, "rt") as f:
            records += [json.loads(line)["i"] for line in f]
    assert sorted(records) == list(range(60))
    # another writer of the same path rotated it: the handle follows
    path.rename(tmp_path / "moved.jsonl")
    w.write({"type": "span", "name": "read", "i": 60})
    assert json.loads(path.read_text())["i"] == 60
    w.close()


@pytest.fixture
def card():
    """Skip where there is no CUDA card (decided inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_device_step_is_the_cards_time_between_the_steps_events(card, tmp_path):
    import torch

    from data_accelerator_tpu_torch.obs.tracing import Tracer
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor, record_device_step

    (tmp_path / "t.transform").write_text(TRANSFORM)
    proc = FlowProcessor(SettingDictionary({
        "datax.job.name": "SpanCard",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": str(tmp_path / "t.transform"),
        "datax.job.process.batchcapacity": "4096",
    }), output_datasets=["Hot"], device="cuda")
    blob = _lines(4096)
    records = []

    class _Keep(telemetry.TelemetryWriter):
        def write(self, record):
            records.append(record)

    for b in range(3):
        raw = proc.encode_json_bytes(blob, 1_700_000_000_000 + 1000 * b, to_device=False)
        trace = Tracer(telemetry.TelemetryLogger("t", [_Keep()])).begin("streaming/batch")
        t0 = time.time()
        handle = proc.dispatch_batch(raw, 1_700_000_000_000 + 1000 * b)
        trace.mark("dispatch-done")
        assert handle.device_step() is None  # not before the counts landed
        handle.collect_counts()
        t1 = time.time()
        enqueued, ms = handle.device_step()
        started, _ts = handle._step_start
        assert ms == started.elapsed_time(handle._step_done)
        assert t0 <= enqueued <= t1
        assert 0.0 < ms <= (t1 - t0) * 1000.0
        record_device_step(handle, trace)
        step = next(r for r in records if r["name"] == "device-step")
        assert step["durationMs"] == round(ms, 4) and step["startTs"] == enqueued
        records.clear()
        handle.collect()
    torch.cuda.synchronize()
