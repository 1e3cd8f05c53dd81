"""Streaming/batch input sources.

reference: datax-host input/ package —
- LocalStreamingSource.scala:19-41: random JSON from the input schema (the
  no-cloud "one-box" source) -> ``LocalSource`` here, with a vectorized
  column fast path for high event rates.
- BlobBatchingHost.scala:28-53: ``{yyyy-MM-dd}`` path-pattern expansion
  over a time window for batch jobs -> ``expand_time_patterns`` +
  ``FileSource`` (local filesystem stands in for WASB/ADLS).
- EventHub/Kafka direct streams -> ``SocketSource`` (newline-JSON over
  TCP, the DCN ingest path) and a Kafka stub gated on library presence.

Sources produce (events, consumed-offsets); offsets feed the
OffsetCheckpointer for at-least-once resume.

Copy of the JAX package's ``runtime/sources.py``, less two unused
imports; its relative imports resolve to the port's modules.
"""

from __future__ import annotations

import glob
import json
import re
import socket
import threading
import time
from collections import deque
from datetime import datetime, timedelta, timezone
from typing import Deque, Dict, List, Optional, Tuple

from ..core.schema import Schema, StringDictionary
from ..utils import fs
from ..utils.datagen import DataGenerator

Offsets = Dict[Tuple[str, int], Tuple[int, int]]


class UnackedFifo:
    """The at-least-once delivery ledger shared by buffering sources:
    every delivered batch is held until its in-order ``ack``; a failure
    puts all un-acked batches back for re-delivery. Thread-safe — the
    pipelined host acks from the same thread it polls, but socket
    readers touch adjacent state under the same discipline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: List = []
        self._redeliver: List = []

    def next_redelivery(self):
        """The oldest requeued batch, or None (caller then polls fresh
        data; either way the result must be ``deliver``-ed)."""
        with self._lock:
            return self._redeliver.pop(0) if self._redeliver else None

    def deliver(self, item) -> None:
        with self._lock:
            self._inflight.append(item)

    def ack_oldest(self):
        """Release and return the oldest in-flight batch (None if empty)."""
        with self._lock:
            return self._inflight.pop(0) if self._inflight else None

    def requeue_all(self) -> None:
        with self._lock:
            self._redeliver = self._inflight + self._redeliver
            self._inflight = []


class StreamingSource:
    """Interface: poll() returns (rows, consumed offsets)."""

    name: str = "source"

    def start(self, positions: Dict[Tuple[str, int], int]) -> None:
        """Apply checkpointed starting positions (source, partition)->seq."""

    def poll(self, max_events: int) -> Tuple[List[dict], Offsets]:
        raise NotImplementedError

    def ack(self) -> None:
        """Oldest un-acked batch fully processed + sunk: the source may
        release events it retained for retry. Called once per polled
        batch, in order — a pipelined host may hold several un-acked
        batches in flight."""

    def requeue_unacked(self) -> None:
        """A batch failed: put every un-acked batch back so the next
        polls re-deliver them in order (at-least-once within process)."""

    def close(self) -> None:
        pass


class LocalSource(StreamingSource):
    """Schema-driven random event generator (one-box source).

    reference: LocalStreamingSource.scala:19-41 (500 ms cadence there;
    here rate-controlled by maxRate like the EventHub path's rate limiter,
    EventHubStreamingFactory.scala:43).
    """

    def __init__(self, schema: Schema, name: str = "local", seed: Optional[int] = None):
        self.name = name
        self.schema = schema
        self.gen = DataGenerator(schema, seed)
        self._seq = 0

    def start(self, positions) -> None:
        self._seq = positions.get((self.name, 0), 0)

    def poll(self, max_events: int) -> Tuple[List[dict], Offsets]:
        now_ms = int(time.time() * 1000)
        rows = self.gen.random_rows(max_events, now_ms=now_ms)
        frm = self._seq
        self._seq += len(rows)
        return rows, {(self.name, 0): (frm, self._seq)}

    def poll_columns(self, max_events: int, dictionary: StringDictionary):
        """Vectorized fast path: encoded numpy columns, no row dicts."""
        now_ms = int(time.time() * 1000)
        cols = self.gen.random_columns(max_events, dictionary, now_ms=now_ms)
        frm = self._seq
        self._seq += max_events
        return cols, now_ms, {(self.name, 0): (frm, self._seq)}


_TIME_TOKEN_RE = re.compile(r"\{([^}]+)\}")

_FMT_MAP = [
    ("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
]


def _java_fmt_to_strftime(fmt: str) -> str:
    for java, py in _FMT_MAP:
        fmt = fmt.replace(java, py)
    return fmt


def expand_time_patterns(
    pattern: str, start: datetime, end: datetime, increment: timedelta
) -> List[str]:
    """Expand ``.../{yyyy-MM-dd}/{HH}/...`` over [start, end].

    reference: BlobBatchingHost.scala:28-53 getInputBlobPathPrefixes.
    """
    out: List[str] = []
    seen = set()
    t = start
    while t <= end:
        path = _TIME_TOKEN_RE.sub(
            lambda m: t.strftime(_java_fmt_to_strftime(m.group(1))), pattern
        )
        if path not in seen:
            seen.add(path)
            out.append(path)
        t = t + increment
    return out


def read_json_file(path: str) -> List[dict]:
    """Read newline-delimited JSON via the fs chokepoint (gzip-aware,
    HadoopClient.scala gzip read)."""
    return [
        json.loads(line)
        for line in fs.read_lines(path)
        if line.strip()
    ]


class FileSource(StreamingSource):
    """Batch/streaming source over local files matching glob patterns
    (the blob-input analog). In streaming mode remembers which files were
    already consumed (sequence number = file index in sorted order)."""

    def __init__(self, patterns: List[str], name: str = "files"):
        self.name = name
        self.patterns = patterns
        self._consumed: set = set()
        self._leftover: List[dict] = []
        self._resume_skip = 0

    def start(self, positions: Dict[Tuple[str, int], int]) -> None:
        """Resume: the checkpointed offset is the count of fully-emitted
        files in sorted order; skip that many on the first listing."""
        self._resume_skip = positions.get((self.name, 0), 0)

    def list_files(self) -> List[str]:
        files: List[str] = []
        for p in self.patterns:
            files.extend(glob.glob(p))
        return sorted(set(files))

    def poll(self, max_events: int) -> Tuple[List[dict], Offsets]:
        """Rows beyond max_events carry over to the next poll — a file is
        only offset-committed once fully emitted (at-least-once)."""
        rows: List[dict] = self._leftover
        self._leftover = []
        if self._resume_skip and not self._consumed:
            self._consumed.update(self.list_files()[: self._resume_skip])
            self._resume_skip = 0
        n_before = len(self._consumed)
        for f in self.list_files():
            if f in self._consumed or len(rows) >= max_events:
                continue
            self._consumed.add(f)
            rows.extend(read_json_file(f))
        self._leftover = rows[max_events:]
        committed = (
            len(self._consumed) if not self._leftover else len(self._consumed) - 1
        )
        return rows[:max_events], {
            (self.name, 0): (n_before, committed)
        }


class SocketSource(StreamingSource):
    """Newline-delimited JSON over TCP — the ingest-over-DCN stand-in for
    the EventHub/Kafka receivers. A background thread accepts connections
    and buffers events; poll() drains up to max_events.

    The readers stamp the arrival of every ``STAMP_EVERY``-th line, and
    sample their own CPU time with it; each poll leaves, on
    ``last_poll``, the stamp of its oldest line (the latest stamp at or
    before it, so never after its arrival), the drain's time, the lines
    left buffered and the readers' CPU ms since the previous poll."""

    STAMP_EVERY = 256

    def __init__(self, host: str = "127.0.0.1", port: int = 0, name: str = "socket"):
        self.name = name
        self._buf: List[bytes] = []
        # un-acked delivered batches (from_seq, lines, arrival); ack()
        # releases the oldest — a pipelined host holds several in flight
        self._fifo = UnackedFifo()
        self._lock = threading.Lock()
        self._seq = 0
        # (line sequence number, time.time()) of stamped lines not yet
        # behind the last poll; the readers' CPU seconds so far
        self._stamps: Deque[Tuple[int, float]] = deque()
        self._reader_cpu_s = 0.0
        self._reader_cpu_polled = 0.0
        self.last_poll: Optional[Dict[str, object]] = None
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(4)
        self.port = self._server.getsockname()[1]
        self._closing = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(
                target=self._reader, args=(conn,), daemon=True
            ).start()

    def _reader(self, conn):
        cpu = time.thread_time()
        with conn:
            f = conn.makefile("rb")
            for line in f:
                line = line.strip()
                if not line:
                    continue
                with self._lock:
                    seq = self._seq + len(self._buf)
                    if seq % self.STAMP_EVERY == 0:
                        self._stamps.append((seq, time.time()))
                        now = time.thread_time()
                        self._reader_cpu_s += now - cpu
                        cpu = now
                    self._buf.append(line)
        with self._lock:
            self._reader_cpu_s += time.thread_time() - cpu

    def _arrival(self, seq: int) -> float:
        """The stamp of line ``seq`` (buffered, under the lock): the
        latest at or before it; older stamps are dropped."""
        while len(self._stamps) > 1 and self._stamps[1][0] <= seq:
            self._stamps.popleft()
        return self._stamps[0][1]

    def poll_raw(self, max_events: int) -> Tuple[bytes, int, Offsets]:
        """Drain up to max_events raw JSON lines as one newline-joined
        blob for the native decoder — no per-event Python parse.

        Delivered lines join an in-flight FIFO until their ``ack()``;
        after ``requeue_unacked()`` (a failed batch) the next polls
        re-deliver the un-acked batches in order (at-least-once within
        the process; cross-restart replay needs a replayable upstream
        like the file/blob source). A redelivery keeps its first
        arrival."""
        requeued = self._fifo.next_redelivery()
        with self._lock:
            if requeued is not None:
                frm, lines, arrival = requeued
            else:
                lines = self._buf[:max_events]
                self._buf = self._buf[max_events:]
                frm = self._seq
                self._seq += len(lines)
                arrival = self._arrival(frm) if lines else None
            cpu, self._reader_cpu_polled = (
                self._reader_cpu_s - self._reader_cpu_polled, self._reader_cpu_s
            )
            self.last_poll = {
                "arrival": arrival, "polled": time.time(),
                "buffered": len(self._buf), "reader_cpu_ms": cpu * 1000.0,
            }
        self._fifo.deliver((frm, lines, arrival))
        blob = b"\n".join(lines) + (b"\n" if lines else b"")
        return blob, len(lines), {(self.name, 0): (frm, frm + len(lines))}

    def ack(self) -> None:
        self._fifo.ack_oldest()

    def requeue_unacked(self) -> None:
        self._fifo.requeue_all()

    def poll(self, max_events: int) -> Tuple[List[dict], Offsets]:
        blob, n, offsets = self.poll_raw(max_events)
        rows = []
        for line in blob.splitlines():
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return rows, offsets

    def close(self):
        self._closing = True
        try:
            self._server.close()
        except OSError:
            pass


class BlobPointerSource(StreamingSource):
    """Streaming input of *pointer* events ``{"BlobPath": ...}`` whose
    referenced files hold the actual event rows.

    reference: input/BlobPointerInput.scala:30-160 — EventHub events carry
    blob paths; the engine extracts a source id per path by regex
    (``extractSourceId``), drops out-of-scope paths (``filterPathGroups``),
    extracts the file time from the path (``extractTimeFromBlobPath``
    with ``fileTimeRegex``/``fileTimeFormat``), then reads the files.

    Here the pointer stream rides any inner StreamingSource (socket for
    DCN ingest, file for replay); referenced files are read host-side,
    gzip-aware. Each emitted row gains the reserved ``__DataX_FileInfo``
    field with {path, sourceId, target, fileTimeMs} so projections and
    per-source routing can use it (ColumnName.InternalColumnFileInfo).
    """

    def __init__(
        self,
        inner: StreamingSource,
        sources: Dict[str, str],
        source_id_regex: str = r"/([\w\d]+)/[^/]*$",
        file_time_regex: str = r"(\d{4}-\d{2}-\d{2}[T_ ][\d_:]+(?:\.\d+)?)",
        file_time_format: Optional[str] = None,
        name: str = "blobpointer",
    ):
        self.name = name
        self.inner = inner
        self.sources = sources  # source id -> target label
        self.source_id_re = re.compile(source_id_regex)
        self.file_time_re = re.compile(file_time_regex)
        self.file_time_format = file_time_format
        self.out_of_scope = 0

    def start(self, positions) -> None:
        self.inner.start(positions)

    def ack(self) -> None:
        # dx-proto: requeue-upstream delegating wrapper: the host's
        # batch tail owns the failure handler and requeues via
        # requeue_unacked() below
        self.inner.ack()

    def requeue_unacked(self) -> None:
        self.inner.requeue_unacked()

    def close(self) -> None:
        self.inner.close()

    def extract_source_id(self, path: str) -> Optional[str]:
        m = self.source_id_re.search(path)
        return m.group(1) if m else None

    def extract_file_time_ms(self, path: str) -> Optional[int]:
        m = self.file_time_re.search(path)
        if not m:
            return None
        text = m.group(1)
        try:
            if self.file_time_format:
                t = datetime.strptime(text, _java_fmt_to_strftime(self.file_time_format))
            else:
                # reference: Timestamp.valueOf(str.replace('_',':').replace('T',' '))
                # — but normalize the date/time separator first so paths
                # like 2024-03-01_12_30_00 parse (the default regex
                # accepts T/_/space there)
                iso = text[:10] + "T" + text[11:].replace("_", ":")
                t = datetime.fromisoformat(iso)
            if t.tzinfo is None:
                t = t.replace(tzinfo=timezone.utc)
            return int(t.timestamp() * 1000)
        except ValueError:
            return None

    def poll(self, max_events: int) -> Tuple[List[dict], Offsets]:
        pointers, offsets = self.inner.poll(max_events)
        rows: List[dict] = []
        for p in pointers:
            path = p.get("BlobPath")
            if not path:
                continue
            source_id = self.extract_source_id(path)
            if source_id is None or source_id not in self.sources:
                # out-of-scope path group (filterPathGroups warning path)
                self.out_of_scope += 1
                continue
            file_time_ms = self.extract_file_time_ms(path)
            info = {
                "path": path,
                "sourceId": source_id,
                "target": self.sources[source_id],
                "fileTimeMs": file_time_ms,
            }
            try:
                for r in read_json_file(path):
                    r["__DataX_FileInfo"] = info
                    rows.append(r)
            except (OSError, ValueError, EOFError):
                # unreadable/corrupt/truncated blob (e.g. a pointer that
                # raced its writer): skip, count, keep the stream alive
                self.out_of_scope += 1
        return rows, offsets


class KafkaSource(StreamingSource):
    """Kafka consumer input, gated on a client library being present.

    reference: input/KafkaStreamingFactory.scala:55-70 — direct Kafka
    DStream with SASL support for EventHub-over-Kafka (:43-49); offset
    checkpointing is an acknowledged TODO there (:51) — here offsets
    ride the same OffsetCheckpointer as every other source, keyed
    (topic, partition).

    The protocol client comes from ``confluent_kafka`` or
    ``kafka-python`` when installed; in their absence the built-in
    dependency-free wire client takes over
    (``runtime/kafka_wire.py`` — Metadata/ListOffsets/Fetch over raw
    sockets, incl. the EventHub-compatible SASL PLAIN path). Message
    values must be JSON event bodies.
    """

    # wire format the raw fast path delivers: whole Kafka v2 record
    # batches, decoded natively by encode_json_bytes(fmt="kafka-v2")
    raw_format = "kafka-v2"

    def __init__(
        self,
        brokers: str,
        topics: List[str],
        group_id: str = "dxtpu",
        name: str = "kafka",
        consumer=None,
        security: Optional[str] = None,
        username: Optional[str] = None,
        password: Optional[str] = None,
    ):
        self.name = name
        self.topics = topics
        # un-acked delivered batches (rows, offsets) — the pipelined
        # host may hold several in flight (same ledger as SocketSource)
        self._fifo = UnackedFifo()
        # checkpointed positions to seek once partitions are assigned
        self._pending_seek: Dict[Tuple[str, int], int] = {}
        # malformed record values dropped by the Python poll paths —
        # drained by the host into ingest_stats/malformed_rows_total so
        # the pilot's flood signal covers Kafka flows too
        self._stats: Dict[str, int] = {}
        # fetched-but-undelivered raw batch spans (binary fast path):
        # (topic, partition, frame bytes, record budget, from, until)
        self._raw_pending: List[Tuple[str, int, bytes, int, int, int]] = []
        if consumer is not None:
            self._consumer = consumer  # injected for tests
            if hasattr(consumer, "fetch_raw"):
                self.poll_raw = self._poll_raw
        else:
            try:
                from confluent_kafka import Consumer  # type: ignore
            except ImportError:
                try:
                    from kafka import KafkaConsumer  # type: ignore
                except ImportError:
                    # no client library installed: the built-in wire
                    # client speaks the Kafka protocol directly (incl.
                    # the EventHub-compatible SASL_SSL path) —
                    # runtime/kafka_wire.py
                    from .kafka_wire import WireKafkaConsumer

                    self._consumer = WireKafkaConsumer(
                        brokers, topics, client_id=group_id,
                        security=security, username=username,
                        password=password,
                    )
                    self._flavor = "wire"
                    # the wire client serves raw v2 record-batch bytes:
                    # expose poll_raw so StreamingHost routes this
                    # source through the native binary fast path
                    # (encode_json_bytes fmt="kafka-v2") like every
                    # other raw source
                    self.poll_raw = self._poll_raw
                    return
                kp_kwargs = {}
                if security:
                    kp_kwargs["security_protocol"] = security.upper()
                    if security.lower().startswith("sasl"):
                        kp_kwargs.update(
                            sasl_mechanism="PLAIN",
                            sasl_plain_username=username,
                            sasl_plain_password=password,
                        )
                self._consumer = KafkaConsumer(
                    *topics, bootstrap_servers=brokers, group_id=group_id,
                    enable_auto_commit=False, **kp_kwargs,
                )
                self._flavor = "kafka-python"
                return
            conf = {
                "bootstrap.servers": brokers,
                "group.id": group_id,
                "enable.auto.commit": False,
                "auto.offset.reset": "earliest",
            }
            if security:
                conf["security.protocol"] = security.upper()
                if security.lower().startswith("sasl"):
                    conf.update({
                        "sasl.mechanism": "PLAIN",
                        "sasl.username": username or "",
                        "sasl.password": password or "",
                    })
            c = Consumer(conf)
            c.subscribe(topics)
            self._consumer = c
            self._flavor = "confluent"
            return
        self._flavor = "injected"

    def start(self, positions: Dict[Tuple[str, int], int]) -> None:
        """Record checkpointed offsets to seek (the reference left Kafka
        offset checkpointing as a TODO, KafkaStreamingFactory.scala:51;
        here OffsetCheckpointer positions override the group's committed
        position). Seeking is deferred until the broker assigns
        partitions — seek-before-assignment errors on both client
        libraries — and applied at the top of each consume pass."""
        self._pending_seek.update(positions)
        if self._pending_seek:
            self._force_assignment()
        self._apply_pending_seeks()

    def _force_assignment(self) -> None:
        """Trigger the group rebalance BEFORE the first data batch so
        checkpoint seeks take effect from batch 1 (assignment happens
        lazily inside poll on both client libraries). confluent: swap in
        an on_assign callback that applies the checkpointed offsets at
        assignment time; kafka-python: a zero-timeout poll assigns (any
        records it returns are before the seek and re-read after it —
        duplicates only, at-least-once)."""
        try:
            if self._flavor == "confluent":
                from confluent_kafka import TopicPartition  # type: ignore

                def on_assign(consumer, partitions):
                    for tp in partitions:
                        seq = self._pending_seek.pop(
                            (tp.topic, tp.partition), None
                        )
                        if seq is not None:
                            tp.offset = seq
                    consumer.assign(partitions)

                self._consumer.subscribe(self.topics, on_assign=on_assign)
                self._consumer.poll(0)
            elif self._flavor == "kafka-python":
                self._consumer.poll(timeout_ms=0, max_records=1)
        except Exception as e:  # noqa: BLE001 — seeks retry per pass
            logger.warning("kafka assignment warm-up failed: %s", e)

    def _apply_pending_seeks(self) -> None:
        if not self._pending_seek:
            return
        seek = getattr(self._consumer, "seek", None)
        if seek is None:
            return
        assignment = getattr(self._consumer, "assignment", None)
        assigned = None
        if assignment is not None:
            try:
                assigned = {
                    (tp.topic, tp.partition) for tp in (assignment() or [])
                }
            except Exception:  # noqa: BLE001 — treat as not-yet-assigned
                assigned = set()
        for (topic, partition), seq in list(self._pending_seek.items()):
            if assigned is not None and (topic, partition) not in assigned:
                continue  # not assigned to this consumer (yet)
            try:
                if self._flavor == "kafka-python":
                    from kafka import TopicPartition  # type: ignore

                    seek(TopicPartition(topic, partition), seq)
                elif self._flavor == "confluent":
                    from confluent_kafka import TopicPartition  # type: ignore

                    seek(TopicPartition(topic, partition, seq))
                else:
                    seek(topic, partition, seq)
                del self._pending_seek[(topic, partition)]
            except Exception as e:  # noqa: BLE001 — retried next pass
                logger.warning(
                    "kafka seek %s/%s -> %s failed (will retry): %s",
                    topic, partition, seq, e,
                )

    def _count_malformed(self, n: int = 1) -> None:
        """A record value that isn't JSON is dropped but COUNTED — the
        host drains this into ``ingest_stats["malformed_rows"]`` /
        ``malformed_rows_total``, so the pilot's malformed-flood signal
        (and the Input_malformed_rows_Count metric) see Kafka garbage
        exactly like socket-line garbage instead of being blind to it."""
        self._stats["malformed_rows"] = (
            self._stats.get("malformed_rows", 0) + n
        )

    def take_ingest_stats(self) -> Dict[str, int]:
        """Drain ingest-side counters accumulated since the last take:
        this source's malformed record values plus any protocol-layer
        counters the wire consumer kept (CRC-skipped corrupt batches)."""
        out, self._stats = self._stats, {}
        wire_stats = getattr(self._consumer, "ingest_stats", None)
        if wire_stats:
            for k, v in wire_stats.items():
                if k == "corrupt_batches":
                    k = "CorruptBatch"
                out[k] = out.get(k, 0) + v
            wire_stats.clear()
        return out

    def _consume(self, max_events: int) -> Tuple[List[dict], Offsets]:
        self._apply_pending_seeks()
        rows: List[dict] = []
        offsets: Offsets = {}
        if self._flavor == "kafka-python":
            while len(rows) < max_events:
                batch = self._consumer.poll(
                    timeout_ms=50, max_records=max_events - len(rows)
                )
                if not batch:
                    break
                for tp, msgs in batch.items():
                    for m in msgs:
                        try:
                            rows.append(json.loads(m.value))
                        except ValueError:
                            self._count_malformed()
                        key = (tp.topic, tp.partition)
                        frm = offsets.get(key, (m.offset, m.offset))[0]
                        offsets[key] = (frm, m.offset + 1)
            return rows, offsets
        # confluent-style consumer: poll one message at a time
        while len(rows) < max_events:
            msg = self._consumer.poll(0.05)
            if msg is None:
                break
            if msg.error():
                # surface broker-side errors and end the pass instead of
                # spinning on instantly-returned error events
                logger.warning("kafka message error: %s", msg.error())
                break
            try:
                rows.append(json.loads(msg.value()))
            except ValueError:
                self._count_malformed()
            key = (msg.topic(), msg.partition())
            frm = offsets.get(key, (msg.offset(), msg.offset()))[0]
            offsets[key] = (frm, msg.offset() + 1)
        return rows, offsets

    # -- the binary fast path ---------------------------------------------
    def _consume_raw(self, max_events: int) -> Tuple[bytes, int, Offsets]:
        """One raw delivery: whole v2 record-batch frames (concatenated
        — exactly what ``decode_record_batches`` / the native walker
        accept), budgeted to ~max_events records at BATCH granularity
        so the decoder's row slots can't silently overflow. Leftover
        batches stay queued for the next poll with their offset
        ranges."""
        self._apply_pending_seeks()
        if not self._raw_pending:
            from .kafka_wire import iter_batch_spans

            for topic, partition, pos, records, next_off in (
                self._consumer.fetch_raw(0.05)
            ):
                cur = pos
                for span in iter_batch_spans(records):
                    until = max(cur, span["next_offset"])
                    self._raw_pending.append((
                        topic, partition,
                        records[span["start"]: span["end"]],
                        max(0, int(span["record_count"])),
                        cur, until,
                    ))
                    cur = until
        parts: List[bytes] = []
        offsets: Offsets = {}
        total = 0
        while self._raw_pending:
            _t, _p, frame, count, frm, until = self._raw_pending[0]
            if parts and total + count > max_events:
                break  # batch granularity: never split a batch
            self._raw_pending.pop(0)
            parts.append(frame)
            total += count
            key = (_t, _p)
            prev = offsets.get(key)
            offsets[key] = (
                (min(prev[0], frm), max(prev[1], until))
                if prev else (frm, until)
            )
        return b"".join(parts), total, offsets

    def _poll_raw(self, max_events: int) -> Tuple[bytes, int, Offsets]:
        """Raw record-batch delivery for the native Kafka fast path
        (bound to ``poll_raw`` when the consumer can serve raw bytes).
        Same un-acked FIFO contract as every buffering source: ack()
        releases + commits oldest-first, requeue_unacked() re-delivers
        after a failed batch."""
        requeued = self._fifo.next_redelivery()
        if requeued is not None:
            blob, n, offsets = requeued
        else:
            blob, n, offsets = self._consume_raw(max_events)
        self._fifo.deliver((blob, n, offsets))
        return blob, n, offsets

    def poll(self, max_events: int) -> Tuple[List[dict], Offsets]:
        """Polled batches join an un-acked FIFO (same contract as
        SocketSource): ack() releases + commits oldest-first, and
        requeue_unacked() re-delivers after a failed batch — the
        broker's committed position only ever advances past sunk data."""
        requeued = self._fifo.next_redelivery()
        if requeued is not None:
            rows, offsets = requeued
        else:
            rows, offsets = self._consume(max_events)
        self._fifo.deliver((rows, offsets))
        return rows, offsets

    def ack(self) -> None:
        released = self._fifo.ack_oldest()
        if released is not None:
            # fifo entries are (rows, offsets) from poll() or
            # (blob, n, offsets) from poll_raw(): offsets ride last
            self._commit(released[-1])

    def requeue_unacked(self) -> None:
        self._fifo.requeue_all()

    def _commit(self, offsets: Offsets) -> None:
        """Commit exactly this batch's end offsets (not the consumer's
        read position, which may include un-sunk in-flight batches)."""
        try:
            if self._flavor == "kafka-python":
                from kafka import TopicPartition  # type: ignore
                from kafka.structs import OffsetAndMetadata  # type: ignore

                # kafka-python-ng adds a required leader_epoch field to
                # the OffsetAndMetadata namedtuple; build by arity so
                # commits don't silently TypeError on the maintained fork
                if len(getattr(OffsetAndMetadata, "_fields", ())) >= 3:
                    def _om(until):
                        return OffsetAndMetadata(until, None, -1)
                else:
                    def _om(until):
                        return OffsetAndMetadata(until, None)
                self._consumer.commit({
                    TopicPartition(t, p): _om(until)
                    for (t, p), (_frm, until) in offsets.items()
                })
            elif self._flavor == "confluent":
                from confluent_kafka import TopicPartition  # type: ignore

                self._consumer.commit(offsets=[
                    TopicPartition(t, p, until)
                    for (t, p), (_frm, until) in offsets.items()
                ], asynchronous=True)
            else:
                self._consumer.commit(offsets)
            # a success re-arms the warning so a NEW failure episode
            # (e.g. ACL revoked weeks later) is not silently muted
            self._commit_warned = False
        except Exception as e:  # noqa: BLE001 — commit is best-effort;
            # at-least-once comes from the in-flight FIFO, commit only
            # narrows the cross-restart replay window
            if not getattr(self, "_commit_warned", False):
                self._commit_warned = True
                logger.warning("kafka commit failed (muting repeats): %s", e)

    def close(self) -> None:
        try:
            self._consumer.close()
        except Exception:  # noqa: BLE001
            pass


def make_source(conf, schema: Schema, source: str = "default") -> StreamingSource:
    """Build the source declared by ``datax.job.input.default.*`` (or one
    ``input.sources.<name>.*`` entry, passed as ``source``) conf.

    reference: the per-mode app entry points (DirectStreamingApp etc.)
    pick the input factory; here one factory keys off ``inputtype``.

    Each named source gets its own offset-ledger name (prefixed with the
    source name for non-default sources) so a multi-source flow's
    checkpoints never collide; the default source keeps the legacy names
    so existing single-source checkpoints stay readable.
    """
    input_type = (conf.get("inputtype") or "local").lower()

    def nm(base: str) -> str:
        return base if source == "default" else f"{source}.{base}"

    if input_type == "local":
        return LocalSource(schema, name=nm("local"))
    if input_type in ("file", "blob"):
        patterns = (conf.get("blobpathregex") or conf.get("path") or "").split(";")
        return FileSource([p for p in patterns if p], name=nm("files"))
    if input_type == "socket":
        port = conf.get_int_option("socket.port") or 0
        return SocketSource(port=port, name=nm("socket"))
    if input_type in ("kafka", "eventhub-kafka"):
        # eventhub-kafka: EventHub through its Kafka-compatible endpoint
        # (reference: KafkaStreamingFactory.scala:43-49 — SASL PLAIN,
        # username $ConnectionString, password the connection string)
        topics = (conf.get("kafka.topics") or "").split(";")
        username = conf.get("kafka.username")
        password = conf.get("kafka.password")
        security = conf.get("kafka.security")
        if input_type == "eventhub-kafka":
            security = security or "sasl_ssl"
            username = username or "$ConnectionString"
            password = password or conf.get("eventhub.connectionstring")
        return KafkaSource(
            conf.get_or_else("kafka.bootstrapservers", "localhost:9092"),
            [t for t in topics if t],
            group_id=conf.get_or_else("kafka.groupid", nm("dxtpu")),
            name=nm("kafka"),
            security=security,
            username=username,
            password=password,
        )
    if input_type == "blobpointer":
        # pointer events arrive over socket or from a pointer file
        pointer_path = conf.get("pointerfile")
        inner: StreamingSource = (
            FileSource([pointer_path], name=nm("pointers"))
            if pointer_path
            else SocketSource(
                port=conf.get_int_option("socket.port") or 0,
                name=nm("socket"),
            )
        )
        sources = {
            sid: sub.get_or_else("target", sid)
            for sid, sub in conf.get_sub_dictionary("source.")
            .group_by_sub_namespace().items()
        }
        kwargs = {}
        if conf.get("sourceidregex"):
            kwargs["source_id_regex"] = conf.get("sourceidregex")
        if conf.get("filetimeregex"):
            kwargs["file_time_regex"] = conf.get("filetimeregex")
        return BlobPointerSource(
            inner, sources, file_time_format=conf.get("filetimeformat"), **kwargs
        )
    raise ValueError(f"unsupported input type {input_type!r}")
