"""The blob sink's columnar route (``runtime/sinks.py``
``FileSink.write_landed`` over ``runtime/materialize.py::LandedTable``,
rendered by ``csrc/jsonl.cpp``) against the row path it replaces.

- Byte identity: a flat table of every scalar type, in every dtype the
  route takes, written from its columns decompresses to exactly the
  bytes ``json.dumps`` gives for the rows ``materialize_rows`` builds
  (edge floats, random float32 and float64 bit patterns, integer
  bounds, timestamps under a batch base, escaped strings and null ids).
- Fallback: nested structs with ``__valid`` flags, CONCAT and
  CONCAT_WS templates and host-ordered views take the row path with
  the same bytes, and say so on the ``sink/file/encode`` span.
- Sharing: a dataset routed to a metric sink and a blob sink builds
  its rows once, and each sink gets what it got from a row list.
- Lifetime: a landed table owns its rows; later batches through the
  A/B output slots and the pool, poisoned by the buffer sanitizer,
  leave it as it was.
- The counter: ``Sink_file_ColumnarRows`` is registered and, on a
  storm batch of the streaming IoT alert flow, equals ``Sink_file``.
- Wrappers: a chaos-wrapped blob sink faults on a landed table as on
  rows, and the smoke's batch-tail timer wraps every sink of a host.
"""

import gzip
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from data_accelerator_tpu_torch.compile.exprs import WS_MARKER
from data_accelerator_tpu_torch.compile.planner import TableData, ViewSchema
from data_accelerator_tpu_torch.constants import MetricName
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.core.schema import StringDictionary
from data_accelerator_tpu_torch.obs.metrics import MetricLogger
from data_accelerator_tpu_torch.obs.store import MetricStore
from data_accelerator_tpu_torch.obs.tracing import Tracer
from data_accelerator_tpu_torch.pilot.chaos import ChaosFault, SinkOutageInjector
from data_accelerator_tpu_torch.runtime import materialize
from data_accelerator_tpu_torch.runtime.materialize import LandedTable, materialize_rows
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from data_accelerator_tpu_torch.runtime.sinks import (
    FileSink,
    MetricSink,
    OutputDispatcher,
    OutputOperator,
)

ROOT = Path(__file__).resolve().parent.parent
BATCH_MS = 1_767_225_600_000
STRINGS = ['say "hi"', "back\\slash", "ctl\x00\x01\x1f\n\t\r", "café üß",
           "astral \U0001d11e \U0001f600", "", "plain", "  ", "</script>"]


class _Spans(Tracer):
    """A tracer that keeps each span's name and props."""

    def __init__(self):
        super().__init__()
        self.spans = []

    def _emit_span(self, ctx, name, span_id, parent_id, start_ts, duration_ms, props):
        self.spans.append((name, dict(props)))


def _dictionary():
    d = StringDictionary()
    for s in STRINGS:
        d.encode(s)
    return d


def _bits(rs, n, dtype):
    """``n`` values of every bit pattern of ``dtype``: NaNs, infinities,
    subnormals and both zeros among them."""
    u = {np.float32: np.uint32, np.float64: np.uint64}[dtype]
    return rs.integers(0, np.iinfo(u).max, n, dtype=u, endpoint=True).view(dtype)


EDGES = [0.0, -0.0, 1.0, -1.0, 1e-4, 1e-5, 9.999e-5, 1e15, 1e16, 1.5e16,
         9999999999999998.0, 123456789012345678.0, 0.1, 1 / 3, 2.5, 100.0,
         float(np.finfo(np.float32).max), float(np.finfo(np.float32).tiny),
         float(np.float32(1e-45)), 5e-324, 2.2250738585072014e-308,
         1.7976931348623157e308, float("nan"), float("inf"), float("-inf")]
I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)


def _case(name, rs, n):
    """(types, columns, base_ms) of a flat table."""
    ints = lambda lo, hi, dt: rs.integers(lo, hi, n, endpoint=True).astype(dt)  # noqa: E731
    if name == "int32_bounds":
        v = ints(I32.min, I32.max, np.int32)
        v[:4] = [I32.min, I32.max, 0, -1]
        return {"v": "long"}, {"v": v}, 0
    if name == "int64_bounds":
        v = ints(I64.min, I64.max, np.int64)
        v[:4] = [I64.min, I64.max, 0, -1]
        return {"v": "bigint"}, {"v": v}, 0
    if name == "narrow_ints":
        return ({"a": "int", "b": "integer", "c": "short", "d": "long"},
                {"a": ints(-128, 127, np.int8), "b": ints(0, 2**32 - 1, np.uint32),
                 "c": ints(-2**15, 2**15 - 1, np.int16), "d": ints(0, 1, np.bool_)}, 0)
    if name == "timestamps":
        t64 = ints(I64.min, I64.max, np.int64)
        t64[:2] = [I64.max, I64.min]
        return ({"t": "timestamp", "s": "tssec", "t64": "timestamp", "s64": "tssec"},
                {"t": ints(-2**31, 2**31 - 1, np.int32), "s": ints(-2**20, 2**20, np.int32),
                 "t64": t64, "s64": t64[::-1].copy()}, 1_700_000_123_456)
    if name == "timestamps_negative_base":
        return ({"t": "timestamp", "s": "tssec"},
                {"t": ints(-10**6, 10**6, np.int32), "s": ints(-10**6, 10**6, np.int32)},
                -1_234_567)
    if name == "booleans":
        return ({"b": "boolean", "u": "boolean"},
                {"b": ints(0, 1, np.bool_), "u": ints(0, 3, np.uint8)}, 0)
    if name == "double_edges":
        v = np.resize(np.array(EDGES, np.float64), n)
        return {"x": "double", "neg": "double"}, {"x": v, "neg": -v}, 0
    if name == "float32_edges":
        v = np.resize(np.array(EDGES, np.float64).astype(np.float32), n)
        return {"x": "double"}, {"x": v}, 0
    if name == "random_float32":
        return {"x": "double"}, {"x": _bits(rs, n, np.float32)}, 0
    if name == "random_float64":
        return {"x": "double"}, {"x": _bits(rs, n, np.float64)}, 0
    if name == "doubles_held_in_ints":
        v = ints(I64.min, I64.max, np.int64)
        v[:3] = [2**53 + 1, -(2**53) - 1, I64.max]
        return {"x": "double", "b": "double"}, {"x": v, "b": ints(0, 1, np.bool_)}, 0
    if name == "strings":
        # every entry, the null id 0 and ids past the dictionary's end
        return ({"s": "string"},
                {"s": ints(-2, len(STRINGS) + 3, np.int32)}, 0)
    assert name == "mixed"
    return ({"deviceId": "long", "score": "double", "name": "string", "ok": "boolean",
             "at": "timestamp", "sec": "tssec"},
            {"deviceId": ints(1, 8, np.int32), "score": rs.random(n).astype(np.float32),
             "name": ints(0, len(STRINGS), np.int32), "ok": ints(0, 1, np.bool_),
             "at": ints(0, 999, np.int32), "sec": ints(0, 59, np.int32)}, BATCH_MS)


FLAT_CASES = ["int32_bounds", "int64_bounds", "narrow_ints", "timestamps",
              "timestamps_negative_base", "booleans", "double_edges", "float32_edges",
              "random_float32", "random_float64", "doubles_held_in_ints", "strings", "mixed"]


def _table(types, cols, n, rs):
    """A landed host table of ``n`` rows, a fifth of them invalid."""
    valid = rs.random(n) >= 0.2
    return TableData(dict(cols), valid), ViewSchema(dict(types))


def _text(rows):
    return "\n".join(json.dumps(r, default=str) for r in rows) + "\n"


def _files(folder):
    """{file name: decompressed bytes} of what a sink wrote."""
    out = {}
    for p in sorted(Path(folder).rglob("*.json*")):
        opener = gzip.open if p.name.endswith(".gz") else open
        with opener(p, "rb") as f:
            out[p.name] = f.read()
    return out


def _write(folder, compression, call):
    """Run ``call(sink)`` under a trace; (decompressed files, the
    ``sink/file/encode`` spans' props)."""
    sink = FileSink(str(folder), compression)
    tracer = _Spans()
    trace = tracer.begin("test/batch")
    with trace.activate():
        n = call(sink)
    trace.end()
    encodes = [p for name, p in tracer.spans if name == "sink/file/encode"]
    return n, _files(folder), encodes


@pytest.mark.parametrize("compression", ["gzip", "none"])
@pytest.mark.parametrize("case", FLAT_CASES)
def test_flat_table_renders_the_row_paths_bytes(tmp_path, case, compression):
    rs = np.random.default_rng(FLAT_CASES.index(case))
    n = 100_000 if case.startswith("random_") else 4_000
    types, cols, base_ms = _case(case, rs, n)
    d = _dictionary()
    table, schema = _table(types, cols, n, rs)
    # the rows as the host made them before: straight from the landed
    # (uncompacted) table
    rows = materialize_rows(table, schema, d, base_ms)
    landed = LandedTable.compact(table, schema, d, base_ms)
    assert landed.flat and len(landed) == len(rows) > 0
    assert not isinstance(landed, list)
    got, files, encodes = _write(
        tmp_path / "columns", compression,
        lambda s: s.write_landed("Alerts", landed, BATCH_MS))
    assert got == (len(rows), len(rows))
    assert landed._rows is None  # no row dict was built
    want_n, want, _ = _write(
        tmp_path / "rows", compression, lambda s: s.write("Alerts", rows, BATCH_MS))
    assert list(files) == list(want) and len(files) == 1
    (body,), (expected,) = files.values(), want.values()
    assert body == _text(rows).encode("utf-8") == expected
    assert [e["columnar"] for e in encodes] == [True]
    assert encodes[0]["rows"] == len(rows) and encodes[0]["bytes"] == len(body)


def test_empty_table_writes_no_file(tmp_path):
    rs = np.random.default_rng(1)
    types, cols, base_ms = _case("mixed", rs, 64)
    table = TableData(cols, np.zeros(64, bool))
    landed = LandedTable.compact(table, ViewSchema(types), _dictionary(), base_ms)
    assert landed.flat and len(landed) == 0
    n, files, encodes = _write(tmp_path, "gzip",
                               lambda s: s.write_landed("Alerts", landed, BATCH_MS))
    assert n == (0, 0) and files == {} and encodes == []


# -- the row path's tables ---------------------------------------------------------------
def _nested(rs, n):
    types = {"a": "long", "s.x": "double", "s.y": "string", "s.__valid": "boolean",
             "arr.0": "long", "arr.1": "long", "arr.1.__valid": "boolean"}
    cols = {"a": rs.integers(0, 9, n).astype(np.int32),
            "s.x": rs.random(n).astype(np.float32),
            "s.y": rs.integers(0, len(STRINGS), n).astype(np.int32),
            "s.__valid": rs.random(n) < 0.7,
            "arr.0": rs.integers(0, 9, n).astype(np.int32),
            "arr.1": rs.integers(0, 9, n).astype(np.int32),
            "arr.1.__valid": rs.random(n) < 0.5}
    return ViewSchema(types), cols, {}


def _concat(rs, n):
    types = {"deviceId": "long", "__defer.label.0": "long", "__defer.label.1": "string",
             "__defer.label.2": "double"}
    deferred = {"label": ("dev-", ("__defer.label.0", "long"), "/",
                          ("__defer.label.1", "string"), ":", ("__defer.label.2", "double"))}
    cols = {"deviceId": rs.integers(0, 9, n).astype(np.int32),
            "__defer.label.0": rs.integers(0, 9, n).astype(np.int32),
            "__defer.label.1": rs.integers(0, len(STRINGS) + 1, n).astype(np.int32),
            "__defer.label.2": rs.random(n).astype(np.float32)}
    return ViewSchema(types, deferred), cols, {}


def _concat_ws(rs, n):
    types = {"deviceId": "long", "__defer.csv.0": "string", "__defer.csv.1": "string"}
    deferred = {"csv": (WS_MARKER + ",", ("__defer.csv.0", "string"),
                        ("__defer.csv.1", "string"))}
    cols = {"deviceId": rs.integers(0, 9, n).astype(np.int32),
            "__defer.csv.0": rs.integers(0, len(STRINGS) + 1, n).astype(np.int32),
            "__defer.csv.1": rs.integers(0, len(STRINGS) + 1, n).astype(np.int32)}
    return ViewSchema(types, deferred), cols, {}


def _host_ordered(rs, n):
    types = {"name": "string", "score": "double"}
    cols = {"name": rs.integers(0, len(STRINGS) + 1, n).astype(np.int32),
            "score": rs.random(n).astype(np.float32)}
    return ViewSchema(types), cols, {"host_order": [("name", False), ("score", True)],
                                     "host_limit": 37}


ROW_PATH = {"nested": _nested, "concat": _concat, "concat_ws": _concat_ws,
            "host_order": _host_ordered}


def _expected_rows(table, schema, d, order):
    rows = materialize_rows(table, schema, d, BATCH_MS)
    for key, asc in reversed(order.get("host_order", [])):
        rows.sort(key=lambda r, k=key: (r[k] is not None, r[k] if r[k] is not None else 0),
                  reverse=not asc)
    limit = order.get("host_limit")
    return rows if limit is None else rows[:limit]


@pytest.mark.parametrize("kind", sorted(ROW_PATH))
def test_other_tables_take_the_row_path_with_the_same_bytes(tmp_path, kind):
    rs = np.random.default_rng(7)
    n = 500
    schema, cols, order = ROW_PATH[kind](rs, n)
    d = _dictionary()
    table = TableData(cols, rs.random(n) >= 0.2)
    rows = _expected_rows(table, schema, d, order)
    landed = LandedTable.compact(table, schema, d, BATCH_MS, **order)
    assert not landed.flat and len(landed) == len(rows)
    got, files, encodes = _write(
        tmp_path, "gzip", lambda s: s.write_landed("Out", landed, BATCH_MS))
    assert got == (len(rows), 0)
    assert landed.rows() == rows
    assert list(files.values()) == [_text(rows).encode("utf-8")]
    assert [e["columnar"] for e in encodes] == [False]


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "nested"])
def test_a_dataset_to_a_metric_and_a_blob_sink_builds_its_rows_once(
        tmp_path, monkeypatch, flat):
    rs = np.random.default_rng(11)
    n = 300
    if flat:
        types, cols, _base = _case("mixed", rs, n)
        schema = ViewSchema(types)
    else:
        schema, cols, _order = _nested(rs, n)
    d = _dictionary()
    table = TableData(cols, rs.random(n) >= 0.2)
    rows = materialize_rows(table, schema, d, BATCH_MS)

    def dispatch(data, where):
        store = MetricStore()
        logger = MetricLogger("DATAX-Landing", store=store)
        op = OutputOperator("Alerts", [MetricSink(logger),
                                       FileSink(str(tmp_path / where), "gzip")])
        dispatcher = OutputDispatcher({"Alerts": op}, logger)
        try:
            results = dispatcher.dispatch({"Alerts": data}, BATCH_MS)
        finally:
            dispatcher.close()
        # what the metric sink stored (not the dispatcher's Sink_* counts)
        stored = {k: store.zrangebyscore(k, float("-inf"), float("inf"))
                  for k in store.keys() if ":Sink_" not in k}
        return results, stored, _files(tmp_path / where)

    before = dispatch(rows, "rows")
    calls = []
    real = materialize.materialize_rows

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(materialize, "materialize_rows", counted)
    landed = LandedTable.compact(table, schema, d, BATCH_MS)
    after = dispatch(landed, "landed")
    assert len(calls) == 1
    results_b, stored_b, files_b = before
    results_a, stored_a, files_a = after
    assert stored_a == stored_b and list(files_a.values()) == list(files_b.values())
    assert results_b == {"Sink_metric": len(rows), "Sink_file": len(rows),
                         "Sink_file_ColumnarRows": 0}
    assert results_a == {"Sink_metric": len(rows), "Sink_file": len(rows),
                         "Sink_file_ColumnarRows": len(rows) if flat else 0}


# -- lifetime ----------------------------------------------------------------------------
LIFE_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
    {"name": "s", "type": "string", "nullable": False, "metadata": {}},
]})
LIFE_TRANSFORM = "--DataXQuery--\nOut = SELECT k, v, s FROM DataXProcessedInput WHERE v > 2\n"


def _life_conf(slots):
    return SettingDictionary({
        "datax.job.name": "LandedLifetime",
        "datax.job.input.default.blobschemafile": LIFE_SCHEMA,
        "datax.job.process.transform": LIFE_TRANSFORM,
        "datax.job.process.batchcapacity": "256",
        "datax.job.process.pipeline.outputslots": str(slots).lower(),
        "datax.job.process.debug.buffersanitizer": "true",
    })


def _life_bytes(b, n=200):
    return b"".join(
        b'{"k":%d,"v":%d.25,"s":"b%d-%d"}\n' % (b * 1000 + i, (i * (b + 3)) % 9, b, i % 5)
        for i in range(n)
    )


@pytest.mark.parametrize("slots", [True, False], ids=["ab_slots", "no_slots"])
def test_landed_table_outlives_the_buffers_it_came_from(tmp_path, slots):
    proc = FlowProcessor(_life_conf(slots), output_datasets=["Out"], device="cpu")
    twin = FlowProcessor(_life_conf(slots), output_datasets=["Out"], device="cpu")
    assert proc.buffer_sanitizer is not None

    def batch(p, b):
        t_ms = BATCH_MS + 1000 * b
        return p.dispatch_batch(p.encode_json_bytes(_life_bytes(b), t_ms), t_ms)

    first, _m = batch(proc, 0).collect_landed()
    want, _m = batch(twin, 0).collect_tables()
    # two more batches rotate through both output slots and the pool,
    # which the sanitizer poisons as each is released
    for b in (1, 2):
        later, _m = batch(proc, b).collect_landed()
        assert later["Out"].rows() != want["Out"]
    table = first["Out"]
    assert table.flat and len(table) == len(want["Out"]) > 0
    got, files, _enc = _write(tmp_path, "none",
                              lambda s: s.write_landed("Out", table, BATCH_MS))
    assert got == (len(table), len(table))
    assert list(files.values()) == [_text(want["Out"]).encode("utf-8")]
    assert table.rows() == want["Out"]
    assert "Sanitizer_PoisonHit_Count" not in _m


# -- the counter -------------------------------------------------------------------------
def test_columnar_rows_metric_is_registered_and_documented():
    name = "Sink_file_ColumnarRows"
    assert MetricName.is_runtime_metric(name)
    assert not MetricName.is_runtime_metric("Sink_file_Columnar")
    doc = (ROOT / "OBSERVABILITY.md").read_text(encoding="utf-8")
    assert name in doc
    # every name of the port's own registry, in the port's PERF.md
    perf = (ROOT / "PERF.md").read_text(encoding="utf-8")
    for pattern in MetricName.PORT_RUNTIME_METRIC_PATTERNS:
        assert pattern in perf


class _Once:
    """One poll of fixed JSON lines, then nothing."""

    name = "storm"

    def __init__(self, blob, n):
        self.blob, self.n, self.sent = blob, n, False

    def start(self, positions):
        pass

    def poll_raw(self, max_events):
        assert max_events >= self.n
        blob, n = (b"", 0) if self.sent else (self.blob, self.n)
        self.sent = True
        return blob, n, {(self.name, 0): (0, n)}

    def ack(self):
        pass

    def requeue_unacked(self):
        pass

    def close(self):
        pass


def _iot_alerts_conf(tmp_path, capacity):
    """The streaming IoT alert flow's conf as the benchmark runs it, at
    ``capacity`` events a batch."""
    cdir = ROOT / "streambench" / "configs" / "iot_alerts"
    text = (cdir / "iot_alerts.conf").read_text(encoding="utf-8")
    for k, v in {"@CONF@": str(cdir), "@JOB@": str(tmp_path / "job"),
                 "@OUT@": str(tmp_path / "out"), "@CACHE@": str(tmp_path / "cache")}.items():
        text = text.replace(k, v)
    conf = dict(line.split("=", 1) for line in text.splitlines() if "=" in line)
    # the manifest and the conformance model are the full capacity's
    for key in ("datax.job.process.compile.manifest", "datax.job.process.conformance.model"):
        conf.pop(key)
    conf.update({"datax.job.process.batchcapacity": str(capacity),
                 "datax.job.input.default.eventhub.maxrate": str(capacity)})
    return SettingDictionary(conf)


def test_storm_batch_renders_every_alert_row_from_columns(tmp_path):
    from data_accelerator_tpu_torch.runtime.host import StreamingHost
    from streambench.traffic import generator

    n = 4096
    mix = generator.load_mix(ROOT / "streambench" / "traffic" / "alert_storm.json")
    blob, _offsets = generator.encode_lines(generator.events(mix, 2**31 + 5, n))
    host = StreamingHost(_iot_alerts_conf(tmp_path, n), source=_Once(blob, n), device="cpu")
    results = []
    dispatch = host.dispatcher.dispatch

    def spy(datasets, batch_time_ms):
        assert all(isinstance(t, LandedTable) for t in datasets.values())
        results.append(dispatch(datasets, batch_time_ms))
        return results[-1]

    host.dispatcher.dispatch = spy
    try:
        host.run(max_batches=1)
    finally:
        host.stop()
    (r,) = results
    assert all(MetricName.is_runtime_metric(k) for k in r)
    # most storm events are alerts, every one rendered from columns
    assert r["Sink_file"] > n // 2
    assert r["Sink_file_ColumnarRows"] == r["Sink_file"]
    (body,) = _files(tmp_path / "out" / "AnomalyAlerts").values()
    rows = [json.loads(line) for line in body.decode().splitlines()]
    assert len(rows) == r["Sink_file"]
    assert all(list(row) == ["deviceId", "score"] and row["score"] > 0.9 for row in rows)


# -- wrappers ----------------------------------------------------------------------------
@pytest.mark.parametrize("fail", [True, False], ids=["outage", "brownout"])
def test_a_chaos_wrapped_blob_sink_faults_on_landed_tables(tmp_path, fail):
    rs = np.random.default_rng(13)
    types, cols, base_ms = _case("mixed", rs, 200)
    d = _dictionary()
    table = TableData(cols, np.ones(200, bool))
    rows = materialize_rows(table, ViewSchema(types), d, base_ms)
    landed = LandedTable.compact(table, ViewSchema(types), d, base_ms)
    sink = FileSink(str(tmp_path), "none")
    op = OutputOperator("Alerts", [sink])

    host = SimpleNamespace(dispatcher=SimpleNamespace(operators={"Alerts": op}))
    injector = SinkOutageInjector(fail=fail)
    injector.arm(host)
    try:
        assert op.sinks[0] is not sink and op.sinks[0].kind == "file"
        if fail:
            with pytest.raises(ChaosFault):
                op.write(landed, BATCH_MS)
        else:
            assert op.write(landed, BATCH_MS) == {"file": len(rows),
                                                  "file_ColumnarRows": len(rows)}
    finally:
        injector.disarm()
    assert op.sinks == [sink] and injector.writes == 1
    assert landed._rows is None
    want = [] if fail else [_text(rows).encode("utf-8")]
    assert list(_files(tmp_path).values()) == want


def test_the_smokes_batch_tail_timer_wraps_every_sink(tmp_path):
    import chip_smoke
    from data_accelerator_tpu_torch.runtime.host import StreamingHost
    from streambench.traffic import generator

    n = 1024
    mix = generator.load_mix(ROOT / "streambench" / "traffic" / "alert_storm.json")
    blob, _offsets = generator.encode_lines(generator.events(mix, 2**31 + 9, n))
    host = StreamingHost(_iot_alerts_conf(tmp_path, n), source=_Once(blob, n), device="cpu")
    # the recording stand-in sink first, then the timer over every sink
    rec = chip_smoke.record_host(host, chip_smoke.ThreadSyncCount())
    chip_smoke.time_batch_tail(host, rec)
    try:
        host.run(max_batches=1)
    finally:
        host.stop()
    split = rec["split"]
    assert len(split["collect_ms"]) == len(split["sinks_ms"]) == 1
    (kinds,) = split["sink_kind_ms"]
    assert {"file", "recording"} <= set(kinds)
    (body,) = _files(tmp_path / "out" / "AnomalyAlerts").values()
    got = [json.loads(line) for line in body.decode().splitlines()]
    ((_key, recorded),) = [(k, v) for k, v in rec["rows"].items() if k[1] == "AnomalyAlerts"]
    assert got == recorded and len(got) > n // 2
