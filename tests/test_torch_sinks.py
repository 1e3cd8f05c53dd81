"""The port's SQL, document and stream sinks, the mirror of
``test_sinks_extra.py`` on ``data_accelerator_tpu_torch``.
"""

import json
import sqlite3
import time

from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.obs.metrics import MetricLogger
from data_accelerator_tpu_torch.obs.store import MetricStore
from data_accelerator_tpu_torch.runtime.sinks import (
    DocumentSink,
    SqlSink,
    StreamSink,
    build_output_operators,
)
from data_accelerator_tpu_torch.runtime.sources import SocketSource

ROWS = [
    {"deviceId": 1, "temperature": 71.5, "deviceType": "Heating"},
    {"deviceId": 2, "temperature": 22.0, "deviceType": "DoorLock"},
]


def test_sql_sink_append(tmp_path):
    db = str(tmp_path / "out.db")
    sink = SqlSink(db, "alerts")
    assert sink.write("Alerts", ROWS, 1000) == 2
    assert sink.write("Alerts", ROWS, 2000) == 2
    conn = sqlite3.connect(db)
    rows = conn.execute("SELECT deviceId, temperature FROM alerts").fetchall()
    conn.close()
    assert len(rows) == 4
    assert rows[0] == (1, 71.5)


def test_sql_sink_overwrite_drops_previous_table(tmp_path):
    db = str(tmp_path / "out.db")
    SqlSink(db, "t").write("D", ROWS, 1000)
    sink2 = SqlSink(db, "t", write_mode="overwrite")
    sink2.write("D", ROWS[:1], 1000)
    conn = sqlite3.connect(db)
    assert conn.execute("SELECT COUNT(*) FROM t").fetchone()[0] == 1
    conn.close()


def test_sql_sink_jdbc_url_and_nested_values(tmp_path):
    db = str(tmp_path / "j.db")
    sink = SqlSink(f"jdbc:sqlite:{db}", "t")
    sink.write("D", [{"a": 1, "nested": {"x": 2}}], 0)
    conn = sqlite3.connect(db)
    (val,) = conn.execute("SELECT nested FROM t").fetchone()
    conn.close()
    assert json.loads(val) == {"x": 2}


def test_sql_sink_schema_evolution(tmp_path):
    """Later batches may carry new columns; the table grows instead of
    poisoning the stream with OperationalError."""
    db = str(tmp_path / "e.db")
    sink = SqlSink(db, "t")
    sink.write("D", [{"a": 1}], 0)
    sink.write("D", [{"a": 2, "alertLevel": "high"}, {"a": 3, "extra": 1.5}], 0)
    conn = sqlite3.connect(db)
    rows = conn.execute("SELECT a, alertLevel, extra FROM t ORDER BY a").fetchall()
    conn.close()
    assert rows == [(1, None, None), (2, "high", None), (3, None, 1.5)]


def test_document_sink_assigns_ids(tmp_path):
    sink = DocumentSink(str(tmp_path), "mydb", "events")
    assert sink.write("D", ROWS, 0) == 2
    lines = open(tmp_path / "mydb" / "events" / "docs.jsonl").read().splitlines()
    docs = [json.loads(x) for x in lines]
    assert len(docs) == 2
    assert all("id" in d and len(d["id"]) == 36 for d in docs)
    assert docs[0]["deviceId"] == 1


def test_stream_sink_feeds_socket_source():
    """The stream sink speaks SocketSource's wire format — chained flows."""
    src = SocketSource(port=0)
    try:
        sink = StreamSink("127.0.0.1", src.port)
        assert sink.write("D", ROWS, 0) == 2
        deadline = time.time() + 5
        rows = []
        while time.time() < deadline and len(rows) < 2:
            got, _ = src.poll(10)
            rows.extend(got)
            src.ack()
            time.sleep(0.02)
        assert [r["deviceId"] for r in rows] == [1, 2]
    finally:
        src.close()


def test_build_operators_constructs_new_sinks(tmp_path):
    d = SettingDictionary({
        "datax.job.name": "F",
        "datax.job.output.A.sql.connectionstring": str(tmp_path / "a.db"),
        "datax.job.output.A.sql.table": "a",
        "datax.job.output.B.cosmosdb.connectionstring": str(tmp_path / "docs"),
        "datax.job.output.B.cosmosdb.database": "db1",
        "datax.job.output.B.cosmosdb.collection": "c1",
        "datax.job.output.C.eventhub.connectionstring": "127.0.0.1:9",
    })
    ml = MetricLogger("DATAX-F", store=MetricStore())
    ops = build_output_operators(
        d, ml, {"A": ["A"], "B": ["B"], "C": ["C"]}
    )
    kinds = {name: [s.kind for s in op.sinks] for name, op in ops.items()}
    assert kinds == {"A": ["sql"], "B": ["cosmosdb"], "C": ["eventhub"]}
