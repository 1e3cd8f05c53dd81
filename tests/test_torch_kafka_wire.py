"""The port's wire-level Kafka ingest, the mirror of
``test_kafka_wire.py`` on ``data_accelerator_tpu_torch``: its copy of
the dependency-free protocol client (``runtime/kafka_wire.py``) against
an in-process fake broker serving real Kafka protocol bytes over a local
TCP socket (Metadata v1, ListOffsets v1, Fetch v4 with v2 record
batches, the SASL PLAIN handshake, Produce v3), and the port's
``StreamingHost`` on the CPU decoding raw record batches through its
native decoder.
"""

import json
import socket
import struct
import threading

import pytest

from data_accelerator_tpu_torch.runtime.kafka_wire import (
    API_FETCH,
    API_LIST_OFFSETS,
    API_METADATA,
    API_PRODUCE,
    API_SASL_HANDSHAKE,
    Reader,
    WireKafkaConsumer,
    WireKafkaProducer,
    enc_array,
    enc_i8,
    enc_i16,
    enc_i32,
    enc_i64,
    enc_str,
    encode_record_batch,
)
from data_accelerator_tpu_torch.runtime.sources import KafkaSource


class FakeBroker:
    """Single-node broker over a real socket. Topics: {name: {partition:
    [value bytes, ...]}} — offsets are list indices."""

    def __init__(self, topics, sasl=None, compressed=False):
        self.topics = topics
        self.sasl = sasl  # (user, pass) to require the PLAIN exchange
        self.compressed = compressed
        self.requests = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self._closing = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def close(self):
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass

    # -- plumbing --------------------------------------------------------
    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    @staticmethod
    def _recv_n(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError
            buf += chunk
        return buf

    def _serve(self, conn):
        authed = self.sasl is None
        awaiting_token = False
        try:
            while True:
                (size,) = struct.unpack(">i", self._recv_n(conn, 4))
                payload = self._recv_n(conn, size)
                if awaiting_token:
                    # raw SASL PLAIN token: \0user\0pass
                    _z, user, pw = payload.split(b"\0")
                    if (user.decode(), pw.decode()) != self.sasl:
                        conn.close()
                        return
                    authed = True
                    awaiting_token = False
                    conn.sendall(struct.pack(">i", 4) + b"\0\0\0\0")
                    continue
                r = Reader(payload)
                api_key = r.i16()
                r.i16()  # api version
                corr = r.i32()
                r.string()  # client id
                self.requests.append(api_key)
                if api_key == API_SASL_HANDSHAKE:
                    body = enc_i16(0) + enc_array([enc_str("PLAIN")])
                    awaiting_token = True
                elif not authed:
                    conn.close()
                    return
                elif api_key == API_METADATA:
                    body = self._metadata()
                elif api_key == API_LIST_OFFSETS:
                    body = self._list_offsets(r)
                elif api_key == API_FETCH:
                    body = self._fetch(r)
                elif api_key == API_PRODUCE:
                    body = self._produce(r)
                else:
                    conn.close()
                    return
                resp = enc_i32(corr) + body
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        except (ConnectionError, OSError, struct.error):
            pass

    # -- api bodies ------------------------------------------------------
    def _metadata(self):
        brokers = enc_array([
            enc_i32(0) + enc_str("127.0.0.1") + enc_i32(self.port)
            + enc_str(None)
        ])
        topics = enc_array([
            enc_i16(0) + enc_str(t) + enc_i8(0) + enc_array([
                enc_i16(0) + enc_i32(p) + enc_i32(0)
                + enc_array([enc_i32(0)]) + enc_array([enc_i32(0)])
                for p in sorted(parts)
            ])
            for t, parts in self.topics.items()
        ])
        return brokers + enc_i32(0) + topics

    def _list_offsets(self, r):
        r.i32()  # replica
        out_topics = []
        for _ in range(r.i32()):
            t = r.string()
            parts = []
            for _ in range(r.i32()):
                p = r.i32()
                ts = r.i64()
                log = self.topics.get(t, {}).get(p, [])
                off = len(log) if ts == -1 else 0
                parts.append(
                    enc_i32(p) + enc_i16(0) + enc_i64(-1) + enc_i64(off)
                )
            out_topics.append(enc_str(t) + enc_array(parts))
        # v1: NO throttle_time_ms (that field arrived in v2)
        return enc_array(out_topics)

    def _produce(self, r):
        from data_accelerator_tpu_torch.runtime.kafka_wire import (
            decode_record_batches,
        )

        r.string()  # transactional id (nullable)
        r.i16()  # acks
        r.i32()  # timeout
        out_topics = []
        for _ in range(r.i32()):
            t = r.string()
            parts = []
            for _ in range(r.i32()):
                p = r.i32()
                records = r.bytes_() or b""
                log = self.topics.setdefault(t, {}).setdefault(p, [])
                base = len(log)
                recs, _next = decode_record_batches(records)
                log.extend(v for _o, _ts, v in recs)
                parts.append(
                    enc_i32(p) + enc_i16(0) + enc_i64(base) + enc_i64(-1)
                )
            out_topics.append(enc_str(t) + enc_array(parts))
        # Produce v1+: throttle_time_ms LAST
        return enc_array(out_topics) + enc_i32(0)

    def _fetch(self, r):
        r.i32()  # replica
        r.i32()  # max wait
        r.i32()  # min bytes
        r.i32()  # max bytes
        r.i8()   # isolation
        out_topics = []
        for _ in range(r.i32()):
            t = r.string()
            parts = []
            for _ in range(r.i32()):
                p = r.i32()
                pos = r.i64()
                r.i32()  # partition max bytes
                log = self.topics.get(t, {}).get(p, [])
                if pos < len(log):
                    records = encode_record_batch(pos, log[pos:])
                    if self.compressed:
                        # flip the compression bits in attributes (byte
                        # offset: 8 base_offset + 4 len + 4 epoch +
                        # 1 magic + 4 crc = 21)
                        records = (
                            records[:21]
                            + struct.pack(">h", 1)  # gzip
                            + records[23:]
                        )
                else:
                    records = b""
                parts.append(
                    enc_i32(p) + enc_i16(0) + enc_i64(len(log))
                    + enc_i64(len(log)) + enc_array([])
                    + enc_i32(len(records)) + records
                )
            out_topics.append(enc_str(t) + enc_array(parts))
        return enc_i32(0) + enc_array(out_topics)


def _rows(tag, n):
    return [
        json.dumps({"tag": tag, "n": i}).encode() for i in range(n)
    ]


@pytest.fixture
def broker():
    b = FakeBroker({"events": {0: _rows("p0", 3), 1: _rows("p1", 2)}})
    yield b
    b.close()


class TestWireConsumer:
    def test_consume_all_partitions_over_socket(self, broker):
        c = WireKafkaConsumer(f"127.0.0.1:{broker.port}", ["events"])
        got = []
        for _ in range(10):
            m = c.poll(0.2)
            if m is None:
                break
            got.append((m.topic(), m.partition(), m.offset(),
                        json.loads(m.value())))
        c.close()
        assert len(got) == 5
        p0 = [(o, v["n"]) for t, p, o, v in got if p == 0]
        assert p0 == [(0, 0), (1, 1), (2, 2)]  # offsets line up
        assert API_METADATA in broker.requests
        assert API_LIST_OFFSETS in broker.requests
        assert API_FETCH in broker.requests

    def test_seek_skips_consumed(self, broker):
        c = WireKafkaConsumer(f"127.0.0.1:{broker.port}", ["events"])
        c.seek("events", 0, 2)
        c.seek("events", 1, 2)  # past the end: nothing from p1
        got = []
        for _ in range(5):
            m = c.poll(0.2)
            if m is None:
                break
            got.append((m.partition(), m.offset()))
        c.close()
        assert got == [(0, 2)]

    def test_sasl_plain_exchange(self):
        b = FakeBroker(
            {"t": {0: _rows("x", 1)}},
            sasl=("$ConnectionString", "Endpoint=sb://ns/..."),
        )
        try:
            c = WireKafkaConsumer(
                f"127.0.0.1:{b.port}", ["t"],
                security="sasl_plaintext",
                username="$ConnectionString",
                password="Endpoint=sb://ns/...",
            )
            m = c.poll(0.2)
            assert m is not None and json.loads(m.value())["tag"] == "x"
            c.close()
            # wrong password: broker hangs up, poll degrades to None
            bad = WireKafkaConsumer(
                f"127.0.0.1:{b.port}", ["t"],
                security="sasl_plaintext",
                username="$ConnectionString", password="wrong",
            )
            assert bad.poll(0.2) is None
            bad.close()
        finally:
            b.close()

    def test_compressed_batches_fail_loud(self):
        b = FakeBroker({"t": {0: _rows("x", 2)}}, compressed=True)
        try:
            c = WireKafkaConsumer(f"127.0.0.1:{b.port}", ["t"])
            with pytest.raises(NotImplementedError, match="compressed"):
                c.poll(0.2)
            c.close()
        finally:
            b.close()


class TestKafkaSourceOverWire:
    def test_source_polls_through_wire_client(self, broker):
        """No client library installed -> KafkaSource falls back to the
        wire client; rows + offset ledger come from real protocol
        bytes."""
        src = KafkaSource(f"127.0.0.1:{broker.port}", ["events"])
        assert src._flavor == "wire"
        rows, offsets = src.poll(10)
        src.ack()
        src.close()
        assert {r["tag"] for r in rows} == {"p0", "p1"}
        assert offsets[("events", 0)] == (0, 3)
        assert offsets[("events", 1)] == (0, 2)

    def test_source_resumes_from_checkpoint_positions(self, broker):
        src = KafkaSource(f"127.0.0.1:{broker.port}", ["events"])
        src.start({("events", 0): 1, ("events", 1): 1})
        rows, offsets = src.poll(10)
        src.close()
        assert offsets[("events", 0)] == (1, 3)
        assert offsets[("events", 1)] == (1, 2)
        assert len(rows) == 3

    def test_streaming_host_routes_kafka_through_native_fast_path(
        self, broker, tmp_path,
    ):
        """E2E tentpole: a StreamingHost over the wire KafkaSource
        polls RAW record batches (poll_raw) and decodes them through
        encode_json_bytes(fmt="kafka-v2") — the native packed path
        when the library is built — landing every record in the sink
        exactly once."""
        from data_accelerator_tpu_torch.core.config import SettingDictionary
        from data_accelerator_tpu_torch.runtime.host import StreamingHost
        from data_accelerator_tpu_torch.runtime.sinks import (
            OutputDispatcher,
            OutputOperator,
        )

        schema = json.dumps({"type": "struct", "fields": [
            {"name": "tag", "type": "string", "nullable": False,
             "metadata": {}},
            {"name": "n", "type": "long", "nullable": False,
             "metadata": {}},
        ]})
        t = tmp_path / "k.transform"
        t.write_text(
            "--DataXQuery--\n"
            "Out = SELECT tag, n FROM DataXProcessedInput\n"
        )
        conf = SettingDictionary({
            "datax.job.name": "KafkaE2E",
            "datax.job.input.default.inputtype": "kafka",
            "datax.job.input.default.kafka.bootstrapservers":
                f"127.0.0.1:{broker.port}",
            "datax.job.input.default.kafka.topics": "events",
            "datax.job.input.default.blobschemafile": schema,
            "datax.job.input.default.eventhub.maxrate": "100",
            "datax.job.input.default.streaming.intervalinseconds": "1",
            "datax.job.process.transform": str(t),
            "datax.job.process.batchcapacity": "16",
            "datax.job.output.Out.console.maxrows": "0",
        })
        host = StreamingHost(conf, device="cpu")
        try:
            src = host.source
            assert src._flavor == "wire"
            assert hasattr(src, "poll_raw")

            class Rec:
                kind = "rec"

                def __init__(self):
                    self.rows = []

                def write(self, dataset, rows, batch_time_ms):
                    self.rows.extend(rows)
                    return len(rows)

            sink = Rec()
            host.dispatcher = OutputDispatcher(
                {"Out": OutputOperator("Out", [sink])}, host.metric_logger
            )
            host.run_batch()
            assert sorted(
                (r["tag"], r["n"]) for r in sink.rows
            ) == [("p0", 0), ("p0", 1), ("p0", 2), ("p1", 0), ("p1", 1)]
            # the port has no Python decoder: always the native one
            assert host.processor.last_decoder_path == "native-sharded"
        finally:
            host.stop()

    def test_make_source_eventhub_kafka_conf(self):
        from data_accelerator_tpu_torch.core.config import SettingDictionary
        from data_accelerator_tpu_torch.core.schema import Schema
        from data_accelerator_tpu_torch.runtime.sources import make_source

        schema = Schema.from_spark_json(json.dumps({
            "type": "struct",
            "fields": [{"name": "n", "type": "long", "nullable": False,
                        "metadata": {}}],
        }))
        conf = SettingDictionary({
            "inputtype": "eventhub-kafka",
            "kafka.bootstrapservers": "127.0.0.1:9093",
            "kafka.topics": "hub1",
            "eventhub.connectionstring": "Endpoint=sb://ns/...",
        })
        src = make_source(conf, schema, source="default")
        assert src._flavor == "wire"
        assert src._consumer.security == "sasl_ssl"
        assert src._consumer.username == "$ConnectionString"
        assert src._consumer.password == "Endpoint=sb://ns/..."
        src.close()


def _set_attributes(batch: bytes, attributes: int) -> bytes:
    """Rewrite a batch's attributes field AND recompute its CRC-32C
    (attributes live inside the CRC region — a bare flip would trip
    the corruption check, which is its own test below)."""
    from data_accelerator_tpu_torch.runtime.kafka_wire import _crc32c

    b = bytearray(batch)
    b[21:23] = struct.pack(">h", attributes)
    b[17:21] = struct.pack(">I", _crc32c(bytes(b[21:])))
    return bytes(b)


def test_control_batches_skipped():
    """Transaction markers (control batches, attributes bit 5) are
    metadata, not data — they must not surface as messages."""
    from data_accelerator_tpu_torch.runtime.kafka_wire import decode_record_batches

    data_batch = encode_record_batch(0, [b'{"n":1}'])
    marker = _set_attributes(
        encode_record_batch(1, [b"\x00\x00\x00\x01"]), 0x20
    )
    records, next_off = decode_record_batches(bytes(data_batch) + marker)
    assert [(o, v) for o, _ts, v in records] == [(0, b'{"n":1}')]
    # the position must advance PAST the skipped marker, or a marker at
    # the log tail would be refetched in a hot loop forever
    assert next_off == 2


def test_corrupt_batch_skipped_and_counted():
    """Satellite: a batch whose CRC-32C does not verify is skipped
    WHOLE and counted — its fields are never trusted (a bit flip in
    the length/count region would otherwise mis-parse every later
    batch into garbage rows). The position advances only past the
    corrupt frame."""
    from data_accelerator_tpu_torch.runtime.kafka_wire import decode_record_batches

    good = encode_record_batch(0, [b'{"n":1}', b'{"n":2}'])
    bad = bytearray(encode_record_batch(2, [b'{"n":3}']))
    bad[70 % len(bad)] ^= 0xFF  # flip a byte inside the CRC region
    good2 = encode_record_batch(3, [b'{"n":4}'])
    stats = {}
    records, next_off = decode_record_batches(
        good + bytes(bad) + good2, stats=stats
    )
    assert [json.loads(v)["n"] for _o, _ts, v in records] == [1, 2, 4]
    assert stats["corrupt_batches"] == 1
    assert next_off == 4


def test_compressed_error_names_codec():
    from data_accelerator_tpu_torch.runtime.kafka_wire import (
        UnsupportedCodecError,
        decode_record_batches,
    )

    batch = _set_attributes(encode_record_batch(0, [b'{"n":1}']), 2)
    with pytest.raises(UnsupportedCodecError, match="snappy") as ei:
        decode_record_batches(batch)
    assert ei.value.codec == "snappy"


def test_wire_fetch_raw_serves_record_batches(broker):
    """The binary fast path's fetch surface: raw v2 record-batch bytes
    per partition with positions advanced from the frame headers —
    and the bytes round-trip through the Python walker."""
    from data_accelerator_tpu_torch.runtime.kafka_wire import decode_record_batches

    c = WireKafkaConsumer(f"127.0.0.1:{broker.port}", ["events"])
    got = c.fetch_raw(0.2)
    by_part = {(t, p): (pos, records, next_off)
               for t, p, pos, records, next_off in got}
    assert set(by_part) == {("events", 0), ("events", 1)}
    pos0, records0, next0 = by_part[("events", 0)]
    assert pos0 == 0 and next0 == 3
    recs, _n = decode_record_batches(records0)
    assert [json.loads(v)["n"] for _o, _ts, v in recs] == [0, 1, 2]
    # positions advanced: a second raw fetch returns nothing new
    assert c.fetch_raw(0.2) == []
    c.close()


class TestWireProducer:
    def test_produce_then_consume_roundtrip(self):
        """Rows produced over the wire land in the broker log and come
        back through the wire consumer — the full egress->ingress loop
        a chained flow pair rides."""
        b = FakeBroker({"out": {0: []}})
        try:
            prod = WireKafkaProducer(f"127.0.0.1:{b.port}", "out")
            prod.send([b'{"n":1}', b'{"n":2}'])
            prod.send([b'{"n":3}'])
            prod.close()
            c = WireKafkaConsumer(f"127.0.0.1:{b.port}", ["out"])
            got = []
            for _ in range(5):
                m = c.poll(0.2)
                if m is None:
                    break
                got.append((m.offset(), json.loads(m.value())["n"]))
            c.close()
            assert got == [(0, 1), (1, 2), (2, 3)]
        finally:
            b.close()

    def test_kafka_sink_writes_rows(self):
        from data_accelerator_tpu_torch.runtime.sinks import KafkaSink

        b = FakeBroker({"alerts": {0: []}})
        try:
            sink = KafkaSink(f"127.0.0.1:{b.port}", "alerts")
            n = sink.write("Alerts", [{"deviceId": 7}, {"deviceId": 9}], 0)
            assert n == 2
            sink.close()
            assert [json.loads(v)["deviceId"]
                    for v in b.topics["alerts"][0]] == [7, 9]
        finally:
            b.close()


def test_eventhub_kafka_sink_conf_spelling():
    """The documented hyphenated namespace builds the SASL-defaulted
    sink (a silent drop here would discard output rows)."""
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.obs.metrics import MetricLogger
    from data_accelerator_tpu_torch.runtime.sinks import (
        KafkaSink,
        build_output_operators,
    )

    d = SettingDictionary({
        "datax.job.output.Alerts.eventhub-kafka.bootstrapservers":
            "127.0.0.1:9093",
        "datax.job.output.Alerts.eventhub-kafka.topic": "hub1",
        "datax.job.output.Alerts.eventhub-kafka.connectionstring":
            "Endpoint=sb://ns/...",
    })
    ops = build_output_operators(d, MetricLogger([]), {"Alerts": ["Alerts"]})
    [sink] = ops["Alerts"].sinks
    assert isinstance(sink, KafkaSink)
    assert sink._producer.security == "sasl_ssl"
    assert sink._producer.username == "$ConnectionString"
    assert sink._producer.password == "Endpoint=sb://ns/..."
