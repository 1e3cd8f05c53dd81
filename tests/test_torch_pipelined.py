"""The port's pipelined dispatch/collect path and its host loop, the
mirror of ``test_pipelined.py`` on ``data_accelerator_tpu_torch`` with
``device="cpu"``: results match the synchronous path, the streaming host
runs at depth 2 with the pipeline/transfer metric family, the socket
source holds two un-acked batches, and the decode-ahead never polls a
batch it will not dispatch. The reference's state-table case is in
``test_torch_state.py``, against the JAX package."""

import functools
import json
import socket
import time

from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.runtime import host as host_mod
from data_accelerator_tpu_torch.runtime import processor as processor_mod
from data_accelerator_tpu_torch.runtime.sources import SocketSource

# the tests ask for the CPU; the entry points default to the card
StreamingHost = functools.partial(host_mod.StreamingHost, device="cpu")
FlowProcessor = functools.partial(processor_mod.FlowProcessor, device="cpu")

SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False,
     "metadata": {"allowedValues": [1, 2]}},
    {"name": "v", "type": "double", "nullable": False,
     "metadata": {"minValue": 0, "maxValue": 10}},
]})


def _proc(tmp_path, transform_text, outputs):
    tmp_path.mkdir(parents=True, exist_ok=True)
    t = tmp_path / "t.transform"
    t.write_text(transform_text)
    return FlowProcessor(
        SettingDictionary({
            "datax.job.name": "PipeFlow",
            "datax.job.input.default.blobschemafile": SCHEMA,
            "datax.job.process.transform": str(t),
            "datax.job.process.batchcapacity": "16",
        }),
        output_datasets=outputs,
    )


def test_two_in_flight_matches_sequential(tmp_path):
    transform = (
        "--DataXQuery--\n"
        "Big = SELECT k, v FROM DataXProcessedInput WHERE v > 5\n"
    )
    rows1 = [{"k": 1, "v": 7.0}, {"k": 2, "v": 1.0}, {"k": 1, "v": 9.0}]
    rows2 = [{"k": 2, "v": 6.0}]

    seq = _proc(tmp_path / "a", transform, ["Big"])
    d1, m1 = seq.process_batch(seq.encode_rows(rows1, 0), 1000)
    d2, m2 = seq.process_batch(seq.encode_rows(rows2, 0), 2000)

    pipe = _proc(tmp_path / "b", transform, ["Big"])
    h1 = pipe.dispatch_batch(pipe.encode_rows(rows1, 0), 1000)
    h2 = pipe.dispatch_batch(pipe.encode_rows(rows2, 0), 2000)
    p1, pm1 = h1.collect()
    p2, pm2 = h2.collect()

    assert p1["Big"] == d1["Big"]
    assert p2["Big"] == d2["Big"]
    assert pm1["Output_Big_Events_Count"] == m1["Output_Big_Events_Count"] == 2.0
    assert pm2["Output_Big_Events_Count"] == 1.0


def _local_conf(tmp_path, name, extra=None):
    (tmp_path / "t.transform").write_text(
        "--DataXQuery--\n"
        "Hot = SELECT k, v FROM DataXProcessedInput WHERE v > 5\n"
    )
    d = {
        "datax.job.name": name,
        "datax.job.input.default.inputtype": "local",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.input.default.eventhub.maxrate": "64",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.transform": str(tmp_path / "t.transform"),
        "datax.job.process.batchcapacity": "64",
        "datax.job.output.Hot.console.maxrows": "0",
    }
    d.update(extra or {})
    return SettingDictionary(d)


def test_streaming_host_run_pipelined(tmp_path):
    host = StreamingHost(_local_conf(tmp_path, "HostPipe"))
    try:
        host.run_pipelined(max_batches=3)
    finally:
        host.stop()
    assert host.batches_processed == 3


def test_streaming_host_depth2_smoke(tmp_path):
    """The streaming host at an explicit in-flight depth of 2 (conf
    process.pipeline.depth) runs a handful of batches with sized
    transfer on, emitting the pipeline/transfer metric family."""
    host = StreamingHost(_local_conf(tmp_path, "Depth2Smoke", {
        "datax.job.process.pipeline.depth": "2",
    }))
    assert host.processor.pipeline_depth == 2
    seen = {}
    orig = host.metric_logger.send_batch_metrics

    def spy(metrics, ts):
        seen.update(metrics)
        return orig(metrics, ts)

    host.metric_logger.send_batch_metrics = spy
    try:
        host.run_pipelined(max_batches=5)
    finally:
        host.stop()
    assert host.batches_processed == 5
    assert "Pipeline_Depth" in seen and seen["Pipeline_Depth"] >= 1.0
    assert "Pipeline_Stall_Ms" in seen
    assert "Transfer_D2HBytes" in seen
    assert 0.0 < seen["Transfer_Efficiency"] <= 1.0


def test_socket_source_depth2_inflight_ack_and_requeue():
    """A pipelined host holds two un-acked batches: polls must deliver
    NEW data (no duplicates), acks release oldest-first, and
    requeue_unacked re-delivers every un-acked batch in order."""
    src = SocketSource(port=0)
    try:
        conn = socket.create_connection(("127.0.0.1", src.port), timeout=5)
        conn.sendall(b'{"a": 1}\n{"a": 2}\n{"a": 3}\n{"a": 4}\n')
        deadline = time.time() + 5
        while time.time() < deadline and len(src._buf) < 4:
            time.sleep(0.01)

        b1, n1, _ = src.poll_raw(2)   # batch 1: a=1,2
        b2, n2, _ = src.poll_raw(2)   # batch 2: a=3,4 (NOT a repeat of 1)
        assert (n1, n2) == (2, 2)
        assert b1 != b2 and b'"a": 1' in b1 and b'"a": 3' in b2

        # failure with both in flight: requeue, then re-poll in order
        src.requeue_unacked()
        r1, _, _ = src.poll_raw(2)
        r2, _, _ = src.poll_raw(2)
        assert r1 == b1 and r2 == b2

        src.ack()   # releases batch 1
        src.ack()   # releases batch 2
        src.requeue_unacked()
        _b3, n3, _ = src.poll_raw(2)
        assert n3 == 0  # nothing left to re-deliver
        conn.close()
    finally:
        src.close()


def test_run_pipelined_polls_exactly_max_batches(tmp_path):
    """The decode-ahead prefetch must not poll a batch it will never
    dispatch: an orphaned poll sits in the un-acked FIFO, where a later
    in-order ack would release (for Kafka: commit) it unprocessed."""
    host = StreamingHost(_local_conf(tmp_path, "PollCount", {
        "datax.job.process.batchcapacity": "16",
    }))
    src = host.source
    polls = {"n": 0}
    orig = src.poll_columns

    def counting_poll(*a, **k):
        polls["n"] += 1
        return orig(*a, **k)

    src.poll_columns = counting_poll
    try:
        host.run_pipelined(max_batches=3)
    finally:
        host.stop()
    assert host.batches_processed == 3
    assert polls["n"] == 3  # not 4: no orphaned prefetch
