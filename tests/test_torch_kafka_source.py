"""The port's Kafka input, the mirror of ``test_kafka_source.py`` on
``data_accelerator_tpu_torch``, with an injected consumer: no broker or
client library needed (the broker names are local addresses).
"""

import builtins
import json

from data_accelerator_tpu_torch.runtime.sources import KafkaSource


class FakeMessage:
    def __init__(self, topic, partition, offset, value):
        self._t, self._p, self._o, self._v = topic, partition, offset, value

    def topic(self):
        return self._t

    def partition(self):
        return self._p

    def offset(self):
        return self._o

    def value(self):
        return self._v

    def error(self):
        return None


class FakeConsumer:
    """confluent-style poll(timeout) -> one message or None."""

    def __init__(self, messages):
        self.messages = list(messages)
        self.commits = []
        self.seeks = []
        self.closed = False

    def poll(self, timeout):
        return self.messages.pop(0) if self.messages else None

    def commit(self, offsets=None, asynchronous=False):
        self.commits.append(offsets)

    def seek(self, topic, partition, seq):
        self.seeks.append((topic, partition, seq))

    def close(self):
        self.closed = True


def _msgs(n, topic="t1", partition=0, start=0):
    return [
        FakeMessage(topic, partition, start + i, json.dumps({"a": i}).encode())
        for i in range(n)
    ]


def test_kafka_poll_rows_and_offsets():
    msgs = [
        FakeMessage("t1", 0, 5, json.dumps({"a": 1}).encode()),
        FakeMessage("t1", 0, 6, json.dumps({"a": 2}).encode()),
        FakeMessage("t1", 1, 40, json.dumps({"a": 3}).encode()),
    ]
    src = KafkaSource("127.0.0.1:9092", ["t1"], consumer=FakeConsumer(msgs))
    rows, offsets = src.poll(10)
    assert [r["a"] for r in rows] == [1, 2, 3]
    assert offsets[("t1", 0)] == (5, 7)
    assert offsets[("t1", 1)] == (40, 41)


def test_kafka_poll_respects_max_events():
    src = KafkaSource("b", ["t1"], consumer=FakeConsumer(_msgs(5)))
    rows, _ = src.poll(2)
    assert len(rows) == 2
    rows, _ = src.poll(10)
    assert len(rows) == 3  # remainder on the next poll


def test_kafka_ack_commits_only_oldest_batch():
    """Depth-2 in flight: ack() releases + commits the OLDEST batch's
    end offsets, never the consumer's read position."""
    src = KafkaSource("b", ["t1"], consumer=FakeConsumer(_msgs(4)))
    fc = src._consumer
    _r1, o1 = src.poll(2)   # offsets 0..2
    _r2, o2 = src.poll(2)   # offsets 2..4
    src.ack()
    assert fc.commits == [o1]
    src.ack()
    assert fc.commits == [o1, o2]
    src.ack()               # nothing in flight: no commit
    assert len(fc.commits) == 2


def test_kafka_requeue_redelivers_unacked_in_order():
    src = KafkaSource("b", ["t1"], consumer=FakeConsumer(_msgs(4)))
    r1, o1 = src.poll(2)
    r2, o2 = src.poll(2)
    src.requeue_unacked()
    rr1, ro1 = src.poll(2)
    rr2, ro2 = src.poll(2)
    assert (rr1, ro1) == (r1, o1)
    assert (rr2, ro2) == (r2, o2)
    # consumer NOT re-polled for redelivered batches
    assert src._consumer.messages == []


def test_kafka_start_seeks_checkpointed_positions():
    src = KafkaSource("b", ["t1"], consumer=FakeConsumer([]))
    src.start({("t1", 0): 100, ("t1", 3): 7})
    assert sorted(src._consumer.seeks) == [("t1", 0, 100), ("t1", 3, 7)]


def test_kafka_ack_close():
    fc = FakeConsumer(_msgs(1))
    src = KafkaSource("b", ["t1"], consumer=fc)
    src.poll(5)
    src.ack()
    assert len(fc.commits) == 1
    src.close()
    assert fc.closed


def test_kafka_malformed_values_counted_not_fatal():
    """Satellite: a record value that isn't JSON must not kill the
    poll (it used to raise out of json.loads, poisoning the batch loop
    into an infinite requeue) — it is dropped and COUNTED so the
    host's ingest_stats/malformed_rows_total (and the pilot's flood
    signal) see Kafka garbage."""
    msgs = [
        FakeMessage("t1", 0, 0, json.dumps({"a": 1}).encode()),
        FakeMessage("t1", 0, 1, b"{definitely not json"),
        FakeMessage("t1", 0, 2, json.dumps({"a": 3}).encode()),
    ]
    src = KafkaSource("b", ["t1"], consumer=FakeConsumer(msgs))
    rows, offsets = src.poll(10)
    assert [r["a"] for r in rows] == [1, 3]
    # the bad record's offset still advances (it is consumed, not stuck)
    assert offsets[("t1", 0)] == (0, 3)
    stats = src.take_ingest_stats()
    assert stats == {"malformed_rows": 1}
    # drained: a second take is empty
    assert src.take_ingest_stats() == {}


def test_kafka_without_client_library_uses_wire_client(monkeypatch):
    """No client library installed -> the built-in wire-protocol client
    (runtime/kafka_wire.py) takes over instead of raising."""
    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name in ("confluent_kafka", "kafka"):
            raise ImportError(f"{name} blocked for test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", blocked)
    src = KafkaSource("127.0.0.1:9", ["t1"])
    assert src._flavor == "wire"
    src.close()


def test_make_source_kafka_conf(monkeypatch):
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime import sources as S

    captured = {}

    class Probe(S.KafkaSource):
        def __init__(self, brokers, topics, group_id="dxtpu", **kw):
            captured.update(brokers=brokers, topics=topics, group=group_id)

    monkeypatch.setattr(S, "KafkaSource", Probe)
    conf = SettingDictionary({
        "inputtype": "kafka",
        "kafka.bootstrapservers": "127.0.0.1:9092",
        "kafka.topics": "events;alerts",
        "kafka.groupid": "flow1",
    })
    S.make_source(conf, schema=None)
    assert captured == {
        "brokers": "127.0.0.1:9092", "topics": ["events", "alerts"], "group": "flow1"
    }
