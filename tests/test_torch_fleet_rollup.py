"""The fleet rollup (``streambench/configs/fleet_rollup``): the aggregate
alert's windowed GROUP BY with its HAVING on the average, run by the
port's processor from the deployment's own conf, projection and
transform, cut to a CPU's size (capacity 2,048, a 10 s window of 1 s
batches, devices 1 to 20,000, ``maxgroups`` 32,768), and held batch by
batch to the benchmark's plain-PyTorch reference
(``streambench/reference/fleet_rollup.py``); the boundary of the
HAVING; groups past ``maxgroups`` counted as dropped; the
``window-group`` span and the ``Group_*`` counters; and on the card
the span as the card's time between its events."""

import json
import time
import types
from pathlib import Path

import numpy as np
import pytest

from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.obs import telemetry
from data_accelerator_tpu_torch.obs.tracing import Tracer
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor, record_device_step
from streambench.reference import fleet_rollup as reference
from streambench.traffic import generator

ROOT = Path(__file__).resolve().parents[1]
CONF_DIR = ROOT / "streambench" / "configs" / "fleet_rollup"
CAPACITY = 2048
WINDOW_S = 10
SLOTS = WINDOW_S + 1
MAXGROUPS = 32768
BASE_MS = 1_700_000_000_000
SEED = 2**31 + 41
MIX = dict(json.loads((ROOT / "streambench" / "traffic" / "fleet.json").read_text()),
           device_id=[1, 20000])


def _conf(tmp_path, maxgroups=MAXGROUPS, capacity=CAPACITY):
    """The deployment's conf as the benchmark runs it, its window cut
    from a minute to ``WINDOW_S`` seconds, at ``capacity``."""
    window = f"DataXProcessedInput_{WINDOW_S}seconds"
    transform = tmp_path / "fleet_rollup.transform"
    transform.write_text((CONF_DIR / "fleet_rollup.transform").read_text()
                         .replace("DataXProcessedInput_1minutes", window))
    conf = {}
    for line in (CONF_DIR / "fleet_rollup.conf").read_text().splitlines():
        k, _, v = line.partition("=")
        for ph, path in (("@CONF@", CONF_DIR), ("@JOB@", tmp_path / "job"),
                         ("@OUT@", tmp_path / "out"), ("@CACHE@", tmp_path / "cache")):
            v = v.replace(ph, str(path))
        if "timewindow" not in k:
            conf[k] = v
    conf.update({
        "datax.job.process.transform": str(transform),
        f"datax.job.process.timewindow.{window}.windowduration": f"{WINDOW_S} seconds",
        "datax.job.process.batchcapacity": str(capacity),
        "datax.job.process.maxgroups": str(maxgroups),
    })
    return SettingDictionary(conf)


def _proc(tmp_path, **kw):
    return FlowProcessor(_conf(tmp_path, **kw), output_datasets=["HotDevices"], device="cpu")


def _cell(mix=MIX, seed=SEED):
    return types.SimpleNamespace(
        mix=mix, seed=seed,
        config={"window": {"duration_ms": 1000 * WINDOW_S, "slots": SLOTS}})


def _run(proc, buf, off, sizes, traced=None):
    """Dispatch consecutive events of ``buf`` in batches of ``sizes``,
    one a second; returns the framing, the rows by batch time and the
    metrics of each batch."""
    framing, rows, metrics = [], {}, []
    frm = 0
    for b, n in enumerate(sizes):
        bt = BASE_MS + 1000 * b + 250
        raw = proc.encode_json_bytes(bytes(buf[off[frm]:off[frm + n]]), (bt // 1000) * 1000)
        trace = traced() if traced else None
        handle = proc.dispatch_batch(raw, bt)
        if trace is not None:
            trace.mark("dispatch-done")
            handle.collect_counts()
            record_device_step(handle, trace)
        out, m = handle.collect_tables()
        framing.append({"frm": frm, "to": frm + n, "bt": bt})
        rows[bt] = out["HotDevices"]
        metrics.append(m)
        frm += n
    return framing, rows, metrics


def _pool(n, mix=MIX, seed=SEED):
    buf, off = generator.encode_lines(generator.events(mix, seed, n))
    return buf, off


SIZES = [CAPACITY - 37 * (b % 5) for b in range(16)]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    proc = _proc(tmp)
    buf, off = _pool(sum(SIZES))
    records = []

    class _Keep(telemetry.TelemetryWriter):
        def write(self, record):
            records.append(record)

    def traced():
        return Tracer(telemetry.TelemetryLogger("t", [_Keep()])).begin("streaming/batch")

    framing, rows, metrics = _run(proc, buf, off, SIZES, traced)
    record = {"pool_events": sum(SIZES), "framing": framing, "failed": 0,
              "outputs": {"HotDevices": rows}}
    verdict = reference.judge(_cell(), record)
    return proc, record, verdict, metrics, records


def test_the_deployment_matches_the_plain_reference_batch_by_batch(fleet):
    proc, record, verdict, metrics, _r = fleet
    assert proc.ring_slots == {"DataXProcessedInput": SLOTS}
    checks = {k: c["value"] for k, c in verdict["checks"].items()}
    assert verdict["correct"], checks
    assert checks["rows_wrong"] == 0 and checks["events_lost"] == 0
    assert checks["avgt_rel_err"] <= reference.LIMITS["avgt_rel_err"]
    assert checks["maxt_abs_err"] <= reference.LIMITS["maxt_abs_err"]
    # hot devices in every batch, and the window evicted (more batches
    # than slots): the window's rows stop growing at the ring's span
    counts = [record["ref_counts"][r["bt"]] for r in record["framing"]]
    assert all(c["HotDevices"] > 0 for c in counts)
    assert counts[-1]["window_rows"] == sum(SIZES[-SLOTS:])
    assert [len(record["outputs"]["HotDevices"][r["bt"]]) for r in record["framing"]] == \
        [m["Output_HotDevices_Events_Count"] for m in metrics]


def test_an_altered_row_is_not_correct(fleet):
    _p, record, _v, _m, _r = fleet
    bt = record["framing"][-1]["bt"]
    rows = [dict(r) for r in record["outputs"]["HotDevices"][bt]]
    for variant, change in (("avg", {"AvgT": rows[0]["AvgT"] * (1 + 1e-4)}),
                            ("max", {"MaxT": rows[0]["MaxT"] + 0.001}),
                            ("cnt", {"Cnt": rows[0]["Cnt"] + 1})):
        altered = {**record["outputs"]["HotDevices"], bt: [dict(rows[0], **change)] + rows[1:]}
        v = reference.judge(_cell(), dict(record), {"HotDevices": altered})
        assert not v["correct"], variant
    dropped = {**record["outputs"]["HotDevices"], bt: rows[1:]}
    v = reference.judge(_cell(), dict(record), {"HotDevices": dropped})
    assert v["checks"]["rows_wrong"]["value"] == 1


def test_the_bfloat16_control_is_not_correct(fleet):
    _p, record, _v, _m, _r = fleet
    v = reference.judge(_cell(), dict(record), reference.control_outputs(_cell(), record))
    assert not v["correct"]
    assert v["checks"]["avgt_rel_err"]["value"] > 10 * reference.LIMITS["avgt_rel_err"]


def test_the_counters_equal_the_references(fleet):
    proc, record, _v, metrics, _r = fleet
    for r, m in zip(record["framing"], metrics):
        ref = record["ref_counts"][r["bt"]]
        assert m["Group_RowsScanned"] == SLOTS * CAPACITY
        assert m["Group_RowsInWindow"] == ref["window_rows"]
        assert m["Group_Count"] == ref["groups"]
        assert m["Output_HotDevices_GroupsDropped"] == 0


def test_each_batch_has_a_window_group_span_on_the_cpu(fleet):
    _p, record, _v, _m, records = fleet
    spans = [s for s in records if s.get("type") == "span" and s["name"] == "window-group"]
    assert len(spans) == len(record["framing"])
    assert {s["properties"]["table"] for s in spans} == {"HotDevices"}
    assert all(s["durationMs"] > 0 for s in spans)


def _lines(rows):
    """JSON lines of (deviceId, temperature text) pairs, the payload's
    layout."""
    return "".join(
        '{"deviceDetails":{"deviceId":%d,"deviceType":"Heating","homeId":150,'
        '"status":1,"temperature":%s},"eventTimeStamp":1}\n' % (d, t) for d, t in rows
    ).encode()


def test_the_having_boundary(tmp_path):
    """A device whose mean is exactly 95.000 is not above it; one whose
    mean is 95.001 is; the mean and max are those of the parsed
    temperatures."""
    proc = _proc(tmp_path, capacity=64)
    rows = [(1, "94.5"), (1, "95.5"), (2, "95.001"), (3, "95.000"), (4, "100.0"), (4, "90.002")]
    raw = proc.encode_json_bytes(_lines(rows), BASE_MS)
    out, m = proc.dispatch_batch(raw, BASE_MS + 250).collect_tables()
    got = {r["deviceId"]: r for r in out["HotDevices"]}
    assert sorted(got) == [2, 4]
    assert got[2]["Cnt"] == 1 and got[2]["AvgT"] == np.float32(95.001)
    assert got[4]["Cnt"] == 2 and got[4]["MaxT"] == 100.0
    assert got[4]["AvgT"] == np.float32((np.float32(100.0) + np.float32(90.002)) / 2)
    assert m["Group_Count"] == 4 and m["Group_RowsInWindow"] == len(rows)


def test_rows_scanned_are_the_rows_the_sort_took(tmp_path, monkeypatch):
    """``Group_RowsScanned`` is the length of what the GROUP BY handed
    its sort, read at the call, not the window's capacity: a sort handed
    all but the ring's last slot reads a slot less."""
    from data_accelerator_tpu_torch.compile import planner

    took = []

    def spy(keys, valid):
        n = len(valid) - CAPACITY
        took.append(n)
        return group_ids([k[:n] for k in keys], valid[:n])

    group_ids = planner.group_ids
    monkeypatch.setattr(planner, "group_ids", spy)
    proc = _proc(tmp_path)
    buf, off = _pool(2 * CAPACITY)
    _f, _rows, metrics = _run(proc, buf, off, [CAPACITY] * 2)
    assert took == [(SLOTS - 1) * CAPACITY] * 2
    assert [m["Group_RowsScanned"] for m in metrics] == took


def test_groups_past_maxgroups_are_counted_as_dropped(tmp_path):
    proc = _proc(tmp_path, maxgroups=512)
    buf, off = _pool(3 * CAPACITY)
    _f, rows, metrics = _run(proc, buf, off, [CAPACITY] * 3)
    for m in metrics:
        assert m["Group_Count"] > 512
        assert m["Output_HotDevices_GroupsDropped"] == m["Group_Count"] - 512
        assert m["Output_HotDevices_Events_Count"] <= 512


@pytest.mark.cuda
def test_window_group_is_the_cards_time_between_its_events(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = FlowProcessor(_conf(tmp_path), output_datasets=["HotDevices"], device="cuda")
    buf, off = _pool(4 * CAPACITY)
    records = []

    class _Keep(telemetry.TelemetryWriter):
        def write(self, record):
            records.append(record)

    for b in range(4):
        bt = BASE_MS + 1000 * b + 250
        raw = proc.encode_json_bytes(bytes(buf[off[b * CAPACITY]:off[(b + 1) * CAPACITY]]),
                                     (bt // 1000) * 1000, to_device=False)
        trace = Tracer(telemetry.TelemetryLogger("t", [_Keep()])).begin("streaming/batch")
        t0 = time.time()
        handle = proc.dispatch_batch(raw, bt)
        trace.mark("dispatch-done")
        assert handle.group_steps() == []  # not before the counts landed
        handle.collect_counts()
        (view, enqueued, ms), = handle.group_steps()
        _v, _t, (start, end), rows = handle._group_marks[0]
        assert view == "HotDevices" and ms == start.elapsed_time(end)
        assert rows == SLOTS * CAPACITY
        assert t0 <= enqueued <= time.time() and ms > 0.0
        record_device_step(handle, trace)
        span = next(r for r in records if r["name"] == "window-group")
        step = next(r for r in records if r["name"] == "device-step")
        assert span["durationMs"] == round(ms, 4) and span["startTs"] == enqueued
        assert span["durationMs"] <= step["durationMs"]
        records.clear()
        _out, m = handle.collect_tables()
        assert m["Group_RowsScanned"] == SLOTS * CAPACITY
        assert m["Group_RowsInWindow"] == min(b + 1, SLOTS) * CAPACITY
    torch.cuda.synchronize()
