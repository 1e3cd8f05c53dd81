"""Output sinks: per-dataset operators fanning rows to destinations.

reference: datax-host sink/ package —
- OutputManager.scala:22-160: sink plugin registry + per-output operator
  construction from ``datax.job.output.<name>.<sink>.*`` conf, one-time
  processed-schema dump, parallel fan-out -> ``build_output_operators`` +
  ``OutputDispatcher``.
- BlobSinker.scala:30-226: JSON(.gz) files into time-partitioned folders
  (``${yyyy/MM/dd/HH}`` + quarter-hour bucket) -> ``FileSink``.
- HttpPoster.scala:16-84 -> ``HttpPostSink``; EventHubStreamPoster ->
  stubbed send hook; metric sink -> MetricLogger routing (the reference
  routes alert tables TO Metrics the same way).

Sinks receive host rows: lists of row dicts, or the hosts'
``LandedTable``s (``runtime/materialize.py``), whose rows a sink draws
through ``write_landed``; device->host transfer happens once per batch
in the processor, off the jitted path. The blob sink renders a flat
landed table's columns to JSON lines natively (``native/jsonl.py``),
the same bytes as ``json.dumps`` over its rows, and builds no row dict;
the dispatcher counts those rows as ``Sink_file_ColumnarRows``.

Otherwise a copy of the JAX package's ``runtime/sinks.py``; its
relative imports resolve to the port's modules, so ``KafkaSink`` goes
through the port's ``kafka_wire``.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..core.config import SettingDictionary
from ..obs import tracing
from ..obs.metrics import MetricLogger
from ..constants import MetricName
from ..native import jsonl
from ..utils import fs
from .materialize import LandedTable

logger = logging.getLogger(__name__)


class Sink:
    kind = "base"

    def write(self, dataset: str, rows: List[dict], batch_time_ms: int) -> int:
        raise NotImplementedError

    def write_landed(
        self, dataset: str, table: LandedTable, batch_time_ms: int
    ) -> Tuple[int, int]:
        """Write a landed table; (rows written, of them rendered straight
        from the columns). By default its rows, built once however many
        sinks the dataset goes to."""
        return self.write(dataset, table.rows(), batch_time_ms), 0


class ConsoleSink(Sink):
    kind = "console"

    def __init__(self, max_rows: int = 20, printer: Callable = print):
        self.max_rows = max_rows
        self.printer = printer

    def write(self, dataset, rows, batch_time_ms) -> int:
        for r in rows[: self.max_rows]:
            self.printer(f"[{dataset}] {json.dumps(r, default=str)}")
        return len(rows)


def partition_folder(base: str, batch_time_ms: int) -> str:
    """Time-partitioned output folder with the reference's bucket scheme:
    ``.../{yyyy/MM/dd/HH}/{quarter-bucket}`` (BlobSinker.scala:34-51)."""
    t = time.gmtime(batch_time_ms / 1000.0)
    minute_bucket = (t.tm_min // 15) * 15
    quarter = f"{t.tm_hour:02d}{minute_bucket:02d}"
    return os.path.join(
        base,
        f"{t.tm_year:04d}/{t.tm_mon:02d}/{t.tm_mday:02d}/{t.tm_hour:02d}",
        quarter,
    )


class FileSink(Sink):
    """JSON(.gz) writer into time-partitioned folders (blob sink analog).

    Writes temp + rename for atomicity (HadoopClient.scala:391-441)."""

    kind = "file"

    def __init__(self, folder: str, compression: str = "none"):
        self.folder = folder
        self.compression = compression
        # a file number a write, unique when threads share the sink
        self._counter = itertools.count(1)

    def write(self, dataset, rows, batch_time_ms) -> int:
        return self._write(
            dataset, len(rows), batch_time_ms, False,
            lambda: "\n".join(json.dumps(r, default=str) for r in rows) + "\n",
        )

    def write_landed(self, dataset, table, batch_time_ms) -> Tuple[int, int]:
        """A flat table's JSON lines rendered from its columns; any other
        table through ``write`` over its rows. The bytes are the same."""
        if not table.flat:
            return self.write(dataset, table.rows(), batch_time_ms), 0
        n = self._write(dataset, len(table), batch_time_ms, True, table.jsonl)
        return n, n

    def _write(self, dataset, n_rows, batch_time_ms, columnar, encode) -> int:
        if not n_rows:
            return 0
        out_dir = partition_folder(self.folder, batch_time_ms)
        ext = ".json.gz" if self.compression == "gzip" else ".json"
        name = f"{dataset}_{batch_time_ms}_{next(self._counter)}{ext}"
        path = os.path.join(out_dir, name)
        # children of the operator's sink/file span: the rows to JSON
        # text, then the gzip (if any: its deflate blocks and size on
        # the span) and the atomic write
        with tracing.span(
            "sink/file/encode", rows=n_rows, columnar=columnar
        ) as props:
            payload = encode()
            props["bytes"] = len(payload)
        with tracing.span(
            "sink/file/write", rows=n_rows, bytes=len(payload)
        ) as props:
            blocks, gz_bytes = fs.write_text(path, payload)
            if blocks:
                props.update(blocks=blocks, gz_bytes=gz_bytes)
        return n_rows


class HttpPostSink(Sink):
    """Per-batch POST of events (HttpPoster.scala:16-84)."""

    kind = "httppost"

    def __init__(self, endpoint: str, headers: Optional[Dict[str, str]] = None):
        self.endpoint = endpoint
        self.headers = headers or {}

    def write(self, dataset, rows, batch_time_ms) -> int:
        if not rows:
            return 0
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(rows, default=str).encode(),
            headers={"Content-Type": "application/json", **self.headers},
        )
        try:
            urllib.request.urlopen(req, timeout=10).read()
        except Exception as e:
            logger.warning("http sink post failed for %s: %s", dataset, e)
            return 0
        return len(rows)


class ExternalFunctionSink(Sink):
    """Per-row synchronous POST to an external function endpoint.

    reference: AzureFunctionHandler.scala:14-75 — UDFs that POST to an
    Azure Function per row (:47-66). TPU-native design keeps network
    I/O out of the compiled graph, so external functions attach at the
    output boundary: route a dataset to this sink (``OUTPUT Alerts TO
    MyFn;``) and each row is sent as the function's payload. The
    function definition comes from the same conf shape the reference
    flattens (serviceEndpoint/api/code/methodType)."""

    kind = "externalfn"

    def __init__(
        self,
        endpoint: str,
        api: str = "",
        code: str = "",
        method: str = "post",
        timeout_s: float = 10.0,
    ):
        from urllib.parse import quote

        url = endpoint.rstrip("/")
        if api:
            url += "/" + api.lstrip("/")
        if code:
            # function keys carry '+'/'=' — must be percent-encoded
            url += ("&" if "?" in url else "?") + "code=" + quote(code, safe="")
        self.url = url
        self.method = method.upper()
        self.timeout_s = timeout_s

    def write(self, dataset, rows, batch_time_ms) -> int:
        sent = 0
        for r in rows:
            req = urllib.request.Request(
                self.url,
                data=json.dumps(r, default=str).encode(),
                headers={"Content-Type": "application/json"},
                method=self.method,
            )
            try:
                urllib.request.urlopen(req, timeout=self.timeout_s).read()
                sent += 1
            except Exception as e:  # noqa: BLE001 — per-row best effort
                logger.warning(
                    "external function call failed for %s: %s", dataset, e
                )
        return sent


class SqlSink(Sink):
    """Relational sink: per-batch inserts with append/overwrite modes.

    reference: sink/SqlSinker.scala:15-106 — DataFrame writes to SQL
    Server via JDBC/connector/bulk-copy with a configured ``table`` and
    ``writeMode``. TPU-native one-box analog: sqlite3 (stdlib DB-API);
    any DB-API driver slots in behind the same conf
    (``output.<name>.sql.{connectionstring,table,writemode}``). Column
    DDL is inferred from the first batch's row shape.
    """

    kind = "sql"

    def __init__(self, connection_string: str, table: str, write_mode: str = "append"):
        # "jdbc:sqlite:/path/db" or a bare path both work
        self.db_path = connection_string.split(":", 2)[-1] if \
            connection_string.startswith("jdbc:") else connection_string
        self.table = table
        self.write_mode = write_mode.lower()
        self._initialized = False
        self._lock = threading.Lock()

    @staticmethod
    def _sql_type(v) -> str:
        if isinstance(v, bool):
            return "INTEGER"
        if isinstance(v, int):
            return "INTEGER"
        if isinstance(v, float):
            return "REAL"
        return "TEXT"

    @staticmethod
    def _q(identifier: str) -> str:
        """Quote an identifier, escaping embedded quotes — column names
        come from row keys, i.e. from data."""
        return '"' + identifier.replace('"', '""') + '"'

    def write(self, dataset, rows, batch_time_ms) -> int:
        if not rows:
            return 0
        import sqlite3

        fs.ensure_parent_dir(self.db_path)
        # union of keys across the batch: later rows may carry extra
        # columns, and later batches may evolve the shape
        cols: List[str] = []
        for r in rows:
            for c in r:
                if c not in cols:
                    cols.append(c)
        sample = {c: next((r[c] for r in rows if c in r), None) for c in cols}
        with self._lock:
            conn = sqlite3.connect(self.db_path, timeout=30)
            try:
                cur = conn.cursor()
                tq = self._q(self.table)
                if not self._initialized:
                    if self.write_mode == "overwrite":
                        cur.execute(f'DROP TABLE IF EXISTS {tq}')
                    ddl = ", ".join(
                        f'{self._q(c)} {self._sql_type(sample[c])}' for c in cols
                    )
                    cur.execute(
                        f'CREATE TABLE IF NOT EXISTS {tq} ({ddl})'
                    )
                    self._initialized = True
                existing = {
                    r[1] for r in cur.execute(
                        f'PRAGMA table_info({tq})'
                    ).fetchall()
                }
                for c in cols:
                    if c not in existing:
                        cur.execute(
                            f'ALTER TABLE {tq} ADD COLUMN '
                            f'{self._q(c)} {self._sql_type(sample[c])}'
                        )
                placeholders = ", ".join("?" for _ in cols)
                quoted = ", ".join(self._q(c) for c in cols)
                cur.executemany(
                    f'INSERT INTO {tq} ({quoted}) VALUES ({placeholders})',
                    [
                        tuple(
                            r.get(c) if isinstance(
                                r.get(c), (int, float, str, bytes, type(None))
                            ) else json.dumps(r.get(c), default=str)
                            for c in cols
                        )
                        for r in rows
                    ],
                )
                conn.commit()
            finally:
                conn.close()
        return len(rows)


class DocumentSink(Sink):
    """Document-store sink: per-row document create with generated ids.

    reference: sink/CosmosDBSinker.scala:19-140 — a DocumentClient pool
    per partition creating one document per row in ``db/collection``.
    One-box analog: an append-only JSONL document log per collection
    under ``<root>/<db>/<collection>/docs.jsonl``, each row gaining a
    GUID ``id`` like Cosmos assigns; a cloud document client slots in
    behind the same conf (``output.<name>.cosmosdb.{connectionstring,
    database,collection}``).
    """

    kind = "cosmosdb"

    def __init__(self, root: str, database: str, collection: str):
        self.dir = os.path.join(root, database, collection)
        self._lock = threading.Lock()

    def write(self, dataset, rows, batch_time_ms) -> int:
        if not rows:
            return 0
        import uuid

        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "docs.jsonl")
        with self._lock:
            with open(path, "a", encoding="utf-8") as f:
                for r in rows:
                    doc = {"id": str(uuid.uuid4()), **r}
                    f.write(json.dumps(doc, default=str) + "\n")
        return len(rows)


class StreamSink(Sink):
    """Event-stream sink: newline-delimited JSON over TCP.

    reference: sink/EventHubStreamPoster.scala:15-81 — per-row JSON
    posts into an EventHub. TPU-native analog: the DCN egress path is a
    TCP stream in the same wire format SocketSource ingests, so one
    flow's output can feed another's input (EventHub's role between
    chained flows). Reconnects lazily; failures raise so the batch
    retries rather than silently dropping (at-least-once).
    """

    kind = "eventhub"

    def __init__(self, host: str, port: int):
        self.addr = (host, port)
        self._sock = None
        self._lock = threading.Lock()

    def _connect(self):
        import socket as _socket

        s = _socket.create_connection(self.addr, timeout=10)
        return s

    def write(self, dataset, rows, batch_time_ms) -> int:
        if not rows:
            return 0
        payload = b"".join(
            json.dumps(r, default=str).encode() + b"\n" for r in rows
        )
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._sock.sendall(payload)
            except OSError:
                # one reconnect attempt, then propagate for batch retry
                try:
                    if self._sock is not None:
                        self._sock.close()
                except OSError:
                    pass
                self._sock = self._connect()
                self._sock.sendall(payload)
        return len(rows)


class KafkaSink(Sink):
    """Rows out to a Kafka topic — or EventHub through its
    Kafka-compatible endpoint, the reference EventHubStreamPoster's
    transport (sink/EventHubStreamPoster.scala:15-81) in its
    EventHub-over-Kafka form. Uses the dependency-free wire producer
    (runtime/kafka_wire.py), so it works on hosts without a Kafka
    client library; produce errors raise so the batch retries
    (at-least-once)."""

    kind = "kafka"

    def __init__(
        self,
        brokers: str,
        topic: str,
        security=None,
        username=None,
        password=None,
    ):
        from .kafka_wire import WireKafkaProducer

        self._producer = WireKafkaProducer(
            brokers, topic, security=security,
            username=username, password=password,
        )
        self._lock = threading.Lock()

    def write(self, dataset, rows, batch_time_ms) -> int:
        if not rows:
            return 0
        payload = [json.dumps(r, default=str).encode() for r in rows]
        with self._lock:
            self._producer.send(payload)
        return len(rows)

    def close(self) -> None:
        self._producer.close()


class MetricSink(Sink):
    """Routes a dataset's rows into the metrics pipeline.

    Tables with the CreateMetric shape (EventTime/MetricName/Metric/...)
    become metric points named ``<flow>:<MetricName>``; alert tables keep
    full rows for DirectTable widgets. reference: tables OUTPUT ... TO
    Metrics land in Redis via the metric sink path."""

    kind = "metric"

    def __init__(self, metric_logger: MetricLogger):
        self.logger = metric_logger

    def write(self, dataset, rows, batch_time_ms) -> int:
        for r in rows:
            metric_name = r.get("MetricName", dataset)
            uts = r.get("EventTime", batch_time_ms)
            if not isinstance(uts, (int, float)):
                uts = batch_time_ms
            if set(r) >= {"MetricName", "Metric"}:
                self.logger.send_metric(str(metric_name), r.get("Metric"), int(uts))
                if r.get("Pivot1"):
                    self.logger.send_metric_events(str(metric_name), [r], int(uts))
            else:
                self.logger.send_metric_events(str(metric_name), [r], int(uts))
        return len(rows)


# Sink_file_ColumnarRows, once the dispatcher prefixes it
FILE_COLUMNAR_ROWS = MetricName.SinkFileColumnarRows[len(MetricName.MetricSinkPrefix):]


@dataclass
class OutputOperator:
    """One named output dataset -> its sinks (OutputManager.scala:96-126)."""

    dataset: str
    sinks: List[Sink] = field(default_factory=list)

    def write(
        self, rows: Union[List[dict], LandedTable], batch_time_ms: int
    ) -> Dict[str, int]:
        """Each sink's rows written, by kind, and of those the rows the
        file sink reports it rendered from a landed table's columns
        (``file_ColumnarRows``)."""
        landed = isinstance(rows, LandedTable)
        counts = {}
        for s in self.sinks:
            # one span per sink write under the batch trace (no-op when
            # none is active) — makes a slow destination visible per
            # batch instead of hiding inside the "sinks" stage total
            with tracing.span(
                f"sink/{s.kind}", dataset=self.dataset, rows=len(rows)
            ):
                if landed:
                    n, from_cols = s.write_landed(self.dataset, rows, batch_time_ms)
                else:
                    n, from_cols = s.write(self.dataset, rows, batch_time_ms), 0
            counts[s.kind] = n
            if s.kind == FileSink.kind:
                counts[FILE_COLUMNAR_ROWS] = from_cols
        return counts


def build_output_operators(
    dict_: SettingDictionary,
    metric_logger: MetricLogger,
    table_sink_map: Dict[str, List[str]],
) -> Dict[str, OutputOperator]:
    """Construct operators from ``datax.job.output.<name>.*`` conf plus the
    codegen's table->sink map (OUTPUT t TO sink).

    table_sink_map: dataset -> [output names]. Conf defines each output
    name's sinks; datasets route to them.
    """
    outputs_conf = dict_.get_sub_dictionary("datax.job.output.").group_by_sub_namespace()
    named_sinks: Dict[str, List[Sink]] = {}
    for out_name, sub in outputs_conf.items():
        sinks: List[Sink] = []
        for sink_kind, sconf in sub.group_by_sub_namespace().items():
            if sink_kind in ("blob", "file"):
                folder = (
                    sconf.get("group.main.folder")
                    or sconf.get("path")
                    or f"/tmp/dxtpu-out/{out_name}"
                )
                compression = sconf.get_or_else("compressiontype", "gzip")
                sinks.append(FileSink(folder, compression))
            elif sink_kind == "httppost":
                headers = {
                    k.split(".", 1)[1]: v
                    for k, v in sconf.dict.items()
                    if k.startswith("header.")
                }
                sinks.append(HttpPostSink(sconf.get_string("endpoint"), headers))
            elif sink_kind == "console":
                sinks.append(ConsoleSink(sconf.get_int_option("maxrows") or 20))
            elif sink_kind in ("externalfn", "azurefunction"):
                sinks.append(ExternalFunctionSink(
                    sconf.get_string("serviceendpoint"),
                    api=sconf.get_or_else("api", ""),
                    code=sconf.get_or_else("code", ""),
                    method=sconf.get_or_else("methodtype", "post"),
                ))
            elif sink_kind == "metric":
                sinks.append(MetricSink(metric_logger))
            elif sink_kind == "sql":
                sinks.append(SqlSink(
                    sconf.get_string("connectionstring"),
                    sconf.get_or_else("table", out_name),
                    sconf.get_or_else("writemode", "append"),
                ))
            elif sink_kind in ("cosmosdb", "document"):
                sinks.append(DocumentSink(
                    sconf.get_or_else("connectionstring", "/tmp/dxtpu-docs"),
                    sconf.get_or_else("database", "db"),
                    sconf.get_or_else("collection", out_name),
                ))
            elif sink_kind in ("kafka", "eventhubkafka", "eventhub-kafka"):
                # conf: datax.job.output.<n>.kafka.{bootstrapservers,topic,
                # security,username,password}; the eventhub flavor (same
                # spelling as inputtype=eventhub-kafka) defaults the SASL
                # triplet to the EventHub Kafka-endpoint convention
                username = sconf.get("username")
                password = sconf.get("password")
                security = sconf.get("security")
                if sink_kind != "kafka":
                    security = security or "sasl_ssl"
                    username = username or "$ConnectionString"
                    password = password or sconf.get("connectionstring")
                sinks.append(KafkaSink(
                    sconf.get_or_else("bootstrapservers", "localhost:9092"),
                    sconf.get_or_else("topic", out_name),
                    security=security,
                    username=username,
                    password=password,
                ))
            elif sink_kind in ("eventhub", "stream"):
                # connection "host:port" (EventHub conn-string role); any
                # other shape (e.g. an sb:// conn string from a reference
                # conf) degrades to a file sink like one-box
                conn = sconf.get("connectionstring") or ""
                h, _, p = conn.rpartition(":")
                if p.isdigit():
                    sinks.append(StreamSink(h or "127.0.0.1", int(p)))
                else:
                    logger.warning(
                        "eventhub sink for output %s has no host:port; "
                        "writing to file sink instead", out_name,
                    )
                    sinks.append(FileSink(f"/tmp/dxtpu-out/{out_name}", "gzip"))
        if not sinks and out_name.lower() == "metrics":
            sinks.append(MetricSink(metric_logger))
        named_sinks[out_name] = sinks

    operators: Dict[str, OutputOperator] = {}
    for dataset, out_names in table_sink_map.items():
        op = OutputOperator(dataset)
        for on in out_names:
            if on.lower() == "metrics" and on not in named_sinks:
                op.sinks.append(MetricSink(metric_logger))
            else:
                op.sinks.extend(named_sinks.get(on, []))
        operators[dataset] = op
    return operators


class OutputDispatcher:
    """Parallel fan-out over output operators (the ``.par`` at
    CommonProcessorFactory.scala:311-314); emits per-sink count metrics
    (Sink_<kind> — OutputManager.scala:122).

    The fan-out runs on ONE persistent executor instead of spawning a
    thread per operator per batch: under the hosts' depth-N pipelined
    loops, batch N-1's sink I/O lands on already-warm workers while
    batch N's device step runs, so per-batch thread startup never sits
    on the critical path."""

    def __init__(
        self,
        operators: Dict[str, OutputOperator],
        metric_logger: MetricLogger,
        max_workers: Optional[int] = None,
    ):
        from concurrent.futures import ThreadPoolExecutor

        self.operators = operators
        self.metric_logger = metric_logger
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or max(1, min(8, len(operators) or 1)),
            thread_name_prefix="sink",
        )

    def prepare(self) -> None:
        """Build the blob sink's renderer before the first batch, so
        that no batch pays for it."""
        if any(isinstance(s, FileSink)
               for op in self.operators.values() for s in op.sinks):
            jsonl.load()

    def dispatch(
        self, datasets: Dict[str, Union[List[dict], LandedTable]],
        batch_time_ms: int,
    ) -> Dict[str, int]:
        """Each dataset (a list of rows, or a ``LandedTable``) to its
        operator's sinks, in parallel; emits ``Sink_<kind>`` counts."""
        results: Dict[str, int] = {}
        lock = threading.Lock()
        errors: List[BaseException] = []
        # carry the caller's batch trace onto the fan-out workers, so
        # per-sink spans parent under the host's "sinks" span
        trace_pos = tracing.capture()

        def run_op(name: str, op: OutputOperator, rows):
            try:
                with tracing.activated(trace_pos):
                    counts = op.write(rows, batch_time_ms)
            except BaseException as e:  # noqa: BLE001 — re-raised after wait
                with lock:
                    errors.append(e)
                return
            with lock:
                for kind, c in counts.items():
                    results[f"{MetricName.MetricSinkPrefix}{kind}"] = (
                        results.get(f"{MetricName.MetricSinkPrefix}{kind}", 0) + c
                    )

        futures = [
            self._pool.submit(run_op, name, op, datasets.get(name, []))
            for name, op in self.operators.items()
        ]
        for f in futures:
            f.result()  # run_op never raises; this is the join barrier
        if errors:
            # propagate so the host's batch try/except retries the batch
            # instead of checkpointing past lost events (at-least-once)
            raise errors[0]
        for metric, count in results.items():
            self.metric_logger.send_metric(metric, count, batch_time_ms)
        return results

    def close(self) -> None:
        """Shut the fan-out pool down (host stop path); idempotent."""
        self._pool.shutdown(wait=False, cancel_futures=True)
