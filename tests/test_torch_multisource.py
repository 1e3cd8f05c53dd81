"""Multi-source flows, reference data and the two-stream window join of
the PyTorch port against the JAX package: ``tests/test_multisource.py``
mirrored (all but the sharded case, which waits for the mesh), with both
packages' ``FlowProcessor`` fed the same rows, batch for batch. Rows
must match in the order the reference defines (ints and dictionary ids
exactly, floats within rtol 1e-5), and so must every count-valued
metric, ``Output_<n>_JoinRowsDropped`` and the per-source
``Input_<target>_Events_Count`` among them.

Also here: the StormDoors flow of ``__graft_entry__._flow_conf(multi=True)``
with a reference-data query, as the port's ``chip_smoke.py`` copies it,
window snapshots that carry every ring across packages, and on the card
the same flow against the CPU.
"""

import json
import os
import time as _time

import numpy as np
import pytest
import torch

from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.runtime.checkpoint import (
    WindowStateCheckpointer as JWindowStateCheckpointer,
)
from data_accelerator_tpu.runtime.host import StreamingHost as JStreamingHost
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu_torch.core.config import EngineException, SettingDictionary
from data_accelerator_tpu_torch.runtime.checkpoint import WindowStateCheckpointer
from data_accelerator_tpu_torch.runtime.host import StreamingHost
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from test_torch_flow import _as_jax_metrics, _assert_same_rows

torch.set_num_threads(2)

IOT_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
    {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
     "metadata": {}},
]})

WX_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "stationId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "windSpeed", "type": "double", "nullable": False, "metadata": {}},
    {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
     "metadata": {}},
]})

JOIN_TRANSFORM = (
    "--DataXQuery--\n"
    "Joined = SELECT a.deviceId, a.temperature, b.windSpeed "
    "FROM DataXProcessedInput a INNER JOIN Weather_5seconds b "
    "ON a.deviceId = b.stationId\n"
)

BASE = 1_700_000_000_000


def _conf(tmp_path, transform, extra=None):
    tmp_path.mkdir(parents=True, exist_ok=True)
    t = tmp_path / "flow.transform"
    t.write_text(transform)
    d = {
        "datax.job.name": "MultiSrc",
        "datax.job.input.sources.default.blobschemafile": IOT_SCHEMA,
        "datax.job.input.sources.wx.blobschemafile": WX_SCHEMA,
        "datax.job.input.sources.wx.target": "Weather",
        "datax.job.process.transform": str(t),
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.batchcapacity": "32",
        "datax.job.process.timewindow.Weather_5seconds"
        ".windowduration": "5 seconds",
    }
    d.update(extra or {})
    return d


def _iot_rows(ids, temps, ts):
    return [
        {"deviceId": i, "temperature": t, "eventTimeStamp": s}
        for i, t, s in zip(ids, temps, ts)
    ]


def _wx_rows(ids, winds, ts):
    return [
        {"stationId": i, "windSpeed": w, "eventTimeStamp": s}
        for i, w, s in zip(ids, winds, ts)
    ]


class _Pair:
    """The same flow conf in both packages; ``batch`` feeds both the same
    rows per source and checks rows and metrics agree."""

    def __init__(self, conf, outputs, device="cpu"):
        self.j = JFlowProcessor(JSettingDictionary(conf), output_datasets=outputs)
        self.t = FlowProcessor(SettingDictionary(conf), output_datasets=outputs,
                               device=device)

    def batch(self, rows_by_source, t_ms):
        jraw = {s: self.j.encode_rows(r, t_ms, source=s)
                for s, r in rows_by_source.items()}
        traw = {s: self.t.encode_rows(r, t_ms, source=s)
                for s, r in rows_by_source.items()}
        jd, jm = self.j.process_batch(jraw, t_ms)
        td, tm = self.t.process_batch(traw, t_ms)
        _assert_same(jd, jm, td, tm, t_ms, self.t)
        return td, tm


def _assert_same(jd, jm, td, tm, what, proc):
    assert set(jd) == set(td)
    for name in jd:
        _assert_same_rows(jd[name], td[name], (what, name))
    tm = _as_jax_metrics(tm, proc)
    assert set(tm) <= set(jm), set(tm) - set(jm)
    for k, v in tm.items():
        if k not in ("Latency-Process", "Decode_RowsPerSec"):
            assert v == jm[k], (what, k, jm[k], v)


def test_two_stream_sliding_window_join(tmp_path):
    """Two independent streams with different schemas; the current IoT
    batch joins weather events retained in the 5 s window, including
    weather rows from EARLIER batches, and they evict once the window
    passes."""
    p = _Pair(_conf(tmp_path, JOIN_TRANSFORM), ["Joined"])
    # batch 1: only the weather stream speaks
    p.batch({"wx": _wx_rows([7, 9], [55.0, 10.0], [BASE, BASE])}, BASE)
    # batch 2 (+2 s): only IoT; joins batch 1's weather through the window
    datasets, metrics = p.batch(
        {"default": _iot_rows([7, 8], [21.0, 22.0], [BASE + 2000] * 2)}, BASE + 2000
    )
    joined = datasets["Joined"]
    assert len(joined) == 1
    assert joined[0] == {"deviceId": 7, "temperature": 21.0, "windSpeed": 55.0}
    assert metrics["Input_DataXProcessedInput_Events_Count"] == 2.0
    assert metrics["Input_Weather_Events_Count"] == 0.0
    # batch 3 (+12 s): batch 1's weather fell out of the 5 s window
    datasets, _ = p.batch({"default": _iot_rows([7], [25.0], [BASE + 12000])},
                          BASE + 12000)
    assert datasets["Joined"] == []


def test_join_overflow_metric_and_configured_capacity(tmp_path):
    """process.joincapacity bounds join output; overflowing it surfaces
    as Output_<n>_JoinRowsDropped."""
    p = _Pair(_conf(tmp_path, JOIN_TRANSFORM, {"datax.job.process.joincapacity": "8"}),
              ["Joined"])
    p.batch({"wx": _wx_rows([1] * 4, [50.0] * 4, [BASE] * 4)}, BASE)
    # 8 IoT rows x 4 matching weather rows = 32 pairs > capacity 8
    datasets, metrics = p.batch(
        {"default": _iot_rows([1] * 8, [20.0] * 8, [BASE + 1000] * 8)}, BASE + 1000
    )
    assert len(datasets["Joined"]) == 8
    assert metrics["Output_Joined_Events_Count"] == 8.0
    assert metrics["Output_Joined_JoinRowsDropped"] == 24.0
    # within capacity: the metric is present and zero
    _d, metrics = p.batch({"default": _iot_rows([1], [20.0], [BASE + 2000])},
                          BASE + 2000)
    assert metrics["Output_Joined_JoinRowsDropped"] == 0.0


def test_maxgroups_conf_bounds_groupby_and_counts_drops(tmp_path):
    transform = (
        "--DataXQuery--\n"
        "Agg = SELECT deviceId, COUNT(*) AS Cnt "
        "FROM DataXProcessedInput GROUP BY deviceId\n"
    )
    p = _Pair(_conf(tmp_path, transform, {"datax.job.process.maxgroups": "4"}), ["Agg"])
    datasets, metrics = p.batch(
        {"default": _iot_rows(list(range(10)), [1.0] * 10, [BASE] * 10)}, BASE
    )
    assert len(datasets["Agg"]) == 4
    assert metrics["Output_Agg_GroupsDropped"] == 6.0


def test_unknown_source_rejected(tmp_path):
    proc = FlowProcessor(SettingDictionary(_conf(tmp_path, JOIN_TRANSFORM)),
                         output_datasets=["Joined"], device="cpu")
    with pytest.raises(EngineException, match="unknown source 'nosuch'"):
        proc.dispatch_batch({"nosuch": proc.encode_rows([], BASE)}, BASE)
    with pytest.raises(EngineException, match="unknown source 'nosuch'"):
        proc.encode_rows([], BASE, source="nosuch")


def test_window_target_validation(tmp_path):
    conf = _conf(tmp_path, JOIN_TRANSFORM, {
        "datax.job.process.timewindow.Nowhere_5seconds.windowduration": "5 seconds",
    })
    with pytest.raises(EngineException, match="targets unknown table"):
        FlowProcessor(SettingDictionary(conf), device="cpu")


def test_duplicate_targets_rejected(tmp_path):
    conf = _conf(tmp_path, JOIN_TRANSFORM, {
        "datax.job.input.sources.wx.target": "DataXProcessedInput",
    })
    with pytest.raises(EngineException, match="duplicate tables"):
        FlowProcessor(SettingDictionary(conf), device="cpu")


def test_sources_and_specs(tmp_path):
    """One SourceSpec per source, each with its own schema, target,
    capacity (streaming.maxbatchsize) and pooled ingest matrix."""
    conf = _conf(tmp_path, JOIN_TRANSFORM, {
        "datax.job.input.sources.wx.streaming.maxbatchsize": "8",
    })
    proc = FlowProcessor(SettingDictionary(conf), output_datasets=["Joined"],
                         device="cpu")
    jproc = JFlowProcessor(JSettingDictionary(conf), output_datasets=["Joined"])
    assert list(proc.specs) == list(jproc.specs) == ["default", "wx"]
    assert proc.primary == "default" and proc.spec is proc.specs["default"]
    for name, spec in proc.specs.items():
        jspec = jproc.specs[name]
        assert (spec.target, spec.capacity) == (jspec.target, jspec.capacity)
        assert spec.raw_schema.types == jspec.raw_schema.types
    assert proc.specs["wx"].capacity == 8
    assert {t: (b.slots, b.valid.shape[1]) for t, b in proc.window_buffers.items()} == {
        t: tuple(np.asarray(b.valid).shape) for t, b in jproc.window_buffers.items()
    }
    blob = b"".join(json.dumps(r).encode() + b"\n"
                    for r in _wx_rows([7, 9], [55.0, 10.0], [BASE, BASE]))
    raw = proc.encode_json_bytes(blob, BASE, source="wx", to_device=False)
    assert raw.data.shape == (len(raw.layout) + 1, 8)
    assert set(proc._ingest_pools) == {"wx"}
    h = proc.dispatch_batch({"wx": raw}, BASE)
    assert len(h._ingest) == 1
    _d, metrics = h.collect()
    assert metrics["Input_Weather_Events_Count"] == 2.0
    assert h._ingest == []


# -- reference data --------------------------------------------------------
def test_reference_data_join(tmp_path):
    """input.referencedata.<name>: a CSV loaded onto the device once and
    joined like any table (string columns as dictionary ids)."""
    csv = tmp_path / "homes.csv"
    csv.write_text("homeId,city,floors\n150,Seattle,2\n32,Redmond,1\n88,Bellevue,3\n")
    transform = (
        "--DataXQuery--\n"
        "Homes = SELECT a.deviceId, h.city, h.floors FROM DataXProcessedInput a "
        "INNER JOIN homes h ON a.deviceId = h.homeId\n"
        "--DataXQuery--\n"
        "NoHome = SELECT a.deviceId, h.city FROM DataXProcessedInput a "
        "LEFT JOIN homes h ON a.deviceId = h.homeId WHERE a.temperature > 10.0\n"
    )
    conf = _conf(tmp_path, transform, {
        "datax.job.input.default.referencedata.homes.path": str(csv),
    })
    p = _Pair(conf, ["Homes", "NoHome"])
    assert p.t.refdata["homes"][0].types == p.j.refdata["homes"][0].types == {
        "homeId": "long", "city": "string", "floors": "long"}
    datasets, _m = p.batch(
        {"default": _iot_rows([150, 7, 88, 32, 150], [1.0, 20.0, 30.0, 40.0, 50.0],
                              [BASE] * 5)}, BASE)
    assert [(r["deviceId"], r["city"]) for r in datasets["Homes"]] == [
        (150, "Seattle"), (88, "Bellevue"), (32, "Redmond"), (150, "Seattle")]
    assert [(r["deviceId"], r["city"]) for r in datasets["NoHome"]] == [
        (7, None), (88, "Bellevue"), (32, "Redmond"), (150, "Seattle")]


# -- the StormDoors flow -------------------------------------------------------
def test_storm_conf_copy_matches_graft_entry(tmp_path):
    """``chip_smoke.py``'s copy of the StormDoors conf and transform is
    ``__graft_entry__._flow_conf(multi=True)``'s, plus the DoorHomes
    reference-data query and the phase's sizes."""
    import __graft_entry__ as graft
    import chip_smoke

    ref = graft._flow_conf(tmp_dir=str(tmp_path / "graft"), multi=True)
    conf = chip_smoke.storm_conf(str(tmp_path / "port"), capacity=64,
                                 weather_capacity=16, homes_csv="homes.csv")
    for k, v in ref.dict.items():
        if k == "datax.job.process.transform":
            with open(v, encoding="utf-8") as f:
                graft_transform = f.read()
            with open(conf[k], encoding="utf-8") as f:
                assert f.read() == graft_transform + chip_smoke.DOOR_HOMES_QUERY
        else:
            assert conf[k] == v, k


def _storm_run(tmp_path, device, batches=8, capacity=64, seed=3):
    """The StormDoors + DoorHomes flow, both packages where ``device`` is
    the CPU; returns the port's rows and metrics per batch."""
    import chip_smoke

    tmp_path.mkdir(parents=True, exist_ok=True)
    csv = tmp_path / "homes.csv"
    chip_smoke.write_homes_csv(str(csv))
    conf = chip_smoke.storm_conf(str(tmp_path / "flow"), capacity=capacity,
                                 weather_capacity=16, homes_csv=str(csv),
                                 join_capacity=capacity * 2)
    outputs = chip_smoke.STORM_OUTPUTS
    procs = {"torch": FlowProcessor(SettingDictionary(conf), output_datasets=outputs,
                                    device=device)}
    if device == "cpu":
        procs["jax"] = JFlowProcessor(JSettingDictionary(conf), output_datasets=outputs)
    rs = np.random.RandomState(seed)
    out = []
    for b in range(batches):
        t_ms = BASE + 1000 * b + 250
        iot = chip_smoke.iot_lines(rs, capacity)
        wx = chip_smoke.weather_lines(rs, b)
        res = {}
        for pkg, proc in procs.items():
            raws = {
                "default": proc.encode_json_bytes(iot, (t_ms // 1000) * 1000),
                "weather": proc.encode_json_bytes(wx, (t_ms // 1000) * 1000,
                                                  source="weather"),
            }
            res[pkg] = proc.process_batch(raws, t_ms)
        if "jax" in res:
            _assert_same(*res["jax"], *res["torch"], b, procs["torch"])
        out.append(res["torch"])
    return procs["torch"], out


def test_storm_flow_matches_jax(tmp_path):
    proc, out = _storm_run(tmp_path, "cpu")
    storm = [len(d["StormDoors"]) for d, _m in out]
    assert sum(storm) > 0 and sum(len(d["DoorHomes"]) for d, _m in out) > 0
    for d, m in out:
        assert m["Output_StormDoors_JoinRowsDropped"] == 0.0
        assert m["Input_Weather_Events_Count"] <= 1.0
    # every ring advanced: the weather window and the IoT window
    assert set(proc.window_buffers) == {"DataXProcessedInput", "Weather"}


def test_window_snapshot_carries_every_ring_across_packages(tmp_path):
    """A two-ring snapshot (IoT 5 s window, weather 10 s window) taken by
    one package restores in the other, and the next batch agrees."""
    import chip_smoke

    csv = tmp_path / "homes.csv"
    chip_smoke.write_homes_csv(str(csv))
    conf = chip_smoke.storm_conf(str(tmp_path / "flow"), capacity=32,
                                 weather_capacity=16, homes_csv=str(csv),
                                 join_capacity=64)
    outputs = chip_smoke.STORM_OUTPUTS
    jp = JFlowProcessor(JSettingDictionary(conf), output_datasets=outputs)
    tp = FlowProcessor(SettingDictionary(conf), output_datasets=outputs, device="cpu")
    rs = np.random.RandomState(4)
    for b in range(3):
        t_ms = BASE + 1000 * b
        jp.process_batch({
            "default": jp.encode_json_bytes(chip_smoke.iot_lines(rs, 32), t_ms),
            "weather": jp.encode_json_bytes(chip_smoke.weather_lines(rs, b), t_ms,
                                            source="weather"),
        }, t_ms)
    JWindowStateCheckpointer(str(tmp_path / "ck")).save(jp.snapshot_window_state())
    snap = WindowStateCheckpointer(str(tmp_path / "ck")).load()
    assert set(snap["rings"]) == {"DataXProcessedInput", "Weather"}
    assert tp.restore_window_state(snap)
    tsnap = tp.snapshot_window_state()
    for table, ring in snap["rings"].items():
        assert np.array_equal(tsnap["rings"][table]["valid"], ring["valid"])
        for c, a in ring["cols"].items():
            assert np.array_equal(tsnap["rings"][table]["cols"][c], a), (table, c)
    t_ms = BASE + 3000
    iot, wx = chip_smoke.iot_lines(rs, 32), chip_smoke.weather_lines(rs, 3)
    res = [p.process_batch({
        "default": p.encode_json_bytes(iot, t_ms),
        "weather": p.encode_json_bytes(wx, t_ms, source="weather"),
    }, t_ms) for p in (jp, tp)]
    _assert_same(*res[0], *res[1], "after restore", tp)
    # the restored IoT ring's three batches are in the 5 s window
    assert sum(r["Cnt"] for r in res[1][0]["HeatAvg"]) == 4 * 32


@pytest.mark.parametrize("mode,depth", [("run", 1), ("pipelined", 2)])
def test_two_source_host_matches_jax_host(tmp_path, monkeypatch, mode, depth):
    """Both packages' ``StreamingHost`` on the StormDoors flow with two
    byte sources, under one pinned clock: every batch polls, decodes and
    acks both sources, and the sink rows and count metrics agree."""
    import chip_smoke
    from data_accelerator_tpu.runtime import host as jhost_mod
    from data_accelerator_tpu.runtime import sinks as jsinks
    from data_accelerator_tpu_torch.runtime import host as thost_mod
    from data_accelerator_tpu_torch.runtime import sinks as tsinks
    from test_torch_host import _BytesSource, _Clock, _RecordingSink

    csv = tmp_path / "homes.csv"
    chip_smoke.write_homes_csv(str(csv))
    rs = np.random.RandomState(9)
    n_batches, cap = 8, 48
    iot = [chip_smoke.iot_lines(rs, cap) for _ in range(n_batches)]
    wx = [chip_smoke.weather_lines(rs, b) for b in range(n_batches)]
    iot_lines = [ln for blob in iot for ln in blob.rstrip(b"\n").split(b"\n")]
    wx_lines = [ln for blob in wx for ln in blob.rstrip(b"\n").split(b"\n") if ln]

    class BatchedSource(_BytesSource):
        """Serves the weather stream batch by batch, as it was fed."""

        def __init__(self, batches, clock):
            super().__init__([], clock)
            self.batches = [blob.rstrip(b"\n").split(b"\n") if blob else []
                            for blob in batches]

        def poll_raw(self, max_events):
            if not self.redeliver and self.batches:
                self.lines = self.lines[:self.pos] + self.batches.pop(0)
            return super().poll_raw(max_events)

    class QuarterClock(_Clock):
        """Two polls a batch, a quarter interval each: a loop iteration
        spans at most one interval, so backpressure never halves a poll."""

        def tick(self):
            self.now += 0.25

    got = {}
    for pkg, mod, sinks, SD in (("jax", jhost_mod, jsinks, JSettingDictionary),
                                ("torch", thost_mod, tsinks, SettingDictionary)):
        clock = QuarterClock()
        monkeypatch.setattr(mod, "time", clock.module())
        conf = chip_smoke.storm_conf(str(tmp_path / pkg), capacity=cap,
                                     weather_capacity=16, homes_csv=str(csv),
                                     join_capacity=2 * cap)
        conf.update({
            "datax.job.input.default.eventhub.maxrate": str(cap),
            "datax.job.process.pilot.enabled": "false",
            "datax.job.process.pipeline.depth": str(depth),
            **{f"datax.job.output.{n}.console.maxrows": "0"
               for n in chip_smoke.STORM_OUTPUTS},
        })
        kw = {"device": "cpu"} if pkg == "torch" else {}
        iot_src = _BytesSource(list(iot_lines), clock)
        host = mod.StreamingHost(SD(conf), source=iot_src, **kw)
        wx_src = BatchedSource(list(wx), clock)
        wx_src.name = "weather"
        host.sources["weather"] = wx_src
        sink = _RecordingSink()
        host.dispatcher = sinks.OutputDispatcher(
            {n: sinks.OutputOperator(n, [sink]) for n in chip_smoke.STORM_OUTPUTS},
            host.metric_logger)
        per_batch = []
        send = host.metric_logger.send_batch_metrics

        def spy(metrics, ts=None, per_batch=per_batch, send=send):
            per_batch.append((ts, dict(metrics)))
            return send(metrics, ts)

        host.metric_logger.send_batch_metrics = spy
        try:
            if mode == "run":
                host.run(max_batches=n_batches)
            else:
                host.run_pipelined(max_batches=n_batches)
        finally:
            host.stop()
            monkeypatch.undo()
        assert iot_src.unacked == [] and wx_src.unacked == []
        got[pkg] = (sink.rows, sorted(per_batch, key=lambda p: p[0]))
    (jrows, jm), (trows, tm) = got["jax"], got["torch"]
    assert set(trows) == set(jrows)
    for key in sorted(jrows):
        _assert_same_rows(jrows[key], trows[key], key)
    assert any(r for (_t, d), r in trows.items() if d == "StormDoors")
    counted = ("Input_DataXProcessedInput_Events_Count", "Input_Weather_Events_Count",
               "Output_StormDoors_JoinRowsDropped", "Output_StormDoors_Events_Count",
               "Output_DoorHomes_Events_Count")
    assert [[m[k] for k in counted] for _t, m in tm] == [
        [m[k] for k in counted] for _t, m in jm]
    assert sum(m["Input_Weather_Events_Count"] for _t, m in tm) == len(wx_lines)


# -- window-state checkpoint/restore --------------------------------------
WINAGG_TRANSFORM = (
    "--DataXQuery--\n"
    "WinAgg = SELECT deviceId, COUNT(*) AS Cnt "
    "FROM DataXProcessedInput_10seconds GROUP BY deviceId\n"
)


def _winagg_conf(tmp_path, extra=None):
    tmp_path.mkdir(parents=True, exist_ok=True)
    t = tmp_path / "flow.transform"
    t.write_text(WINAGG_TRANSFORM)
    d = {
        "datax.job.name": "WinCkpt",
        "datax.job.input.default.blobschemafile": IOT_SCHEMA,
        "datax.job.process.transform": str(t),
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.batchcapacity": "16",
        "datax.job.process.timewindow.DataXProcessedInput_10seconds"
        ".windowduration": "10 seconds",
    }
    d.update(extra or {})
    return d


def test_window_state_survives_restart(tmp_path):
    """Kill/restart: a TIMEWINDOW aggregate spanning the restart counts
    rows from before it, in both packages alike."""
    results = {}
    for pkg, Proc, SD, Ck in (
        ("jax", JFlowProcessor, JSettingDictionary, JWindowStateCheckpointer),
        ("torch", FlowProcessor, SettingDictionary, WindowStateCheckpointer),
    ):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        ckpt = Ck(str(tmp_path / pkg / "ckpt"))
        p1 = Proc(SD(_winagg_conf(tmp_path / pkg / "a")), output_datasets=["WinAgg"], **kw)
        p1.process_batch(p1.encode_rows(_iot_rows([5, 5], [1.0, 2.0], [BASE] * 2), BASE),
                         BASE)
        ckpt.save(p1.snapshot_window_state())
        p2 = Proc(SD(_winagg_conf(tmp_path / pkg / "b")), output_datasets=["WinAgg"], **kw)
        assert p2.restore_window_state(ckpt.load())
        got = []
        for t_ms, v in ((BASE + 3000, 3.0), (BASE + 11000, 4.0)):
            d, _m = p2.process_batch(p2.encode_rows(_iot_rows([5], [v], [t_ms]), t_ms),
                                     t_ms)
            got.append({r["deviceId"]: r["Cnt"] for r in d["WinAgg"]})
        results[pkg] = got
    assert results["torch"] == results["jax"] == [{5: 3}, {5: 2}]


def test_window_state_restart_preserves_string_ids(tmp_path):
    str_schema = json.dumps({"type": "struct", "fields": [
        {"name": "site", "type": "string", "nullable": False, "metadata": {}},
        {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
         "metadata": {}},
    ]})
    transform = (
        "--DataXQuery--\n"
        "BySite = SELECT site, COUNT(*) AS Cnt "
        "FROM DataXProcessedInput_10seconds GROUP BY site\n"
    )

    def conf(sub):
        d = tmp_path / sub
        d.mkdir(parents=True, exist_ok=True)
        t = d / "flow.transform"
        t.write_text(transform)
        return {
            "datax.job.name": "StrCkpt",
            "datax.job.input.default.blobschemafile": str_schema,
            "datax.job.process.transform": str(t),
            "datax.job.process.timestampcolumn": "eventTimeStamp",
            "datax.job.process.watermark": "0 second",
            "datax.job.process.batchcapacity": "16",
            "datax.job.process.timewindow.DataXProcessedInput_10seconds"
            ".windowduration": "10 seconds",
        }

    # the JAX package writes the checkpoint, the port restarts from it
    ckpt = JWindowStateCheckpointer(str(tmp_path / "ckpt"))
    p1 = JFlowProcessor(JSettingDictionary(conf("a")), output_datasets=["BySite"])
    rows = [{"site": s, "eventTimeStamp": BASE} for s in ["sea", "sea", "ams"]]
    p1.process_batch(p1.encode_rows(rows, BASE), BASE)
    ckpt.save(p1.snapshot_window_state())
    p2 = FlowProcessor(SettingDictionary(conf("b")), output_datasets=["BySite"],
                       device="cpu")
    assert p2.restore_window_state(WindowStateCheckpointer(str(tmp_path / "ckpt")).load())
    datasets, _ = p2.process_batch(
        p2.encode_rows([{"site": "sea", "eventTimeStamp": BASE + 3000}], BASE + 3000),
        BASE + 3000,
    )
    assert {r["site"]: r["Cnt"] for r in datasets["BySite"]} == {"sea": 3, "ams": 1}


def test_window_snapshot_rejected_on_shape_change(tmp_path):
    ckpt = WindowStateCheckpointer(str(tmp_path / "ckpt"))
    p1 = FlowProcessor(SettingDictionary(_winagg_conf(tmp_path / "a")),
                       output_datasets=["WinAgg"], device="cpu")
    ckpt.save(p1.snapshot_window_state())
    p2 = FlowProcessor(
        SettingDictionary(_winagg_conf(tmp_path / "b",
                                       {"datax.job.process.batchcapacity": "32"})),
        output_datasets=["WinAgg"], device="cpu",
    )
    assert p2.restore_window_state(ckpt.load()) is False


def test_streaming_host_restores_window_state(tmp_path):
    """Host-level restart in both packages: the second host picks the
    snapshot up from the checkpoint dir and the windowed aggregate spans
    the restart."""

    def write_events(pkg, name, rows):
        p = tmp_path / pkg / "in" / name
        os.makedirs(p.parent, exist_ok=True)
        with open(p, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")

    def conf(pkg, sub):
        return _winagg_conf(tmp_path / pkg / sub, {
            "datax.job.input.default.inputtype": "file",
            "datax.job.input.default.blobpathregex": str(tmp_path / pkg / "in" / "*.json"),
            "datax.job.input.default.eventhub.checkpointdir": str(tmp_path / pkg / "ckpt"),
            "datax.job.input.default.eventhub.checkpointinterval": "0 second",
            "datax.job.output.WinAgg.console.maxrows": "0",
            "datax.job.process.pilot.enabled": "false",
        })

    got = {}
    for pkg, Host, SD in (("jax", JStreamingHost, JSettingDictionary),
                          ("torch", StreamingHost, SettingDictionary)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        now = int(_time.time() * 1000)
        write_events(pkg, "b1.json", _iot_rows([5, 5], [1.0, 2.0], [now] * 2))
        host1 = Host(SD(conf(pkg, "h1")), **kw)
        host1.run_batch()
        host1.stop()
        write_events(pkg, "b2.json", _iot_rows([5], [3.0], [int(_time.time() * 1000)]))
        host2 = Host(SD(conf(pkg, "h2")), **kw)
        assert host2.processor._slot_counter > 0  # snapshot restored
        collected = {}
        orig = host2.dispatcher.dispatch

        def capture(datasets, batch_time_ms, orig=orig, collected=collected):
            collected.update(datasets)
            return orig(datasets, batch_time_ms)

        host2.dispatcher.dispatch = capture
        host2.run_batch()
        host2.stop()
        win = collected["WinAgg"]
        # the port's hosts hand the sinks landed tables, the JAX
        # package's hosts rows
        rows = win.rows() if hasattr(win, "rows") else win
        got[pkg] = {r["deviceId"]: r["Cnt"] for r in rows}
    assert got["torch"] == got["jax"] == {5: 3}


# -- on the card -----------------------------------------------------------------
@pytest.mark.cuda
def test_storm_flow_on_the_card_matches_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _p, cpu = _storm_run(tmp_path / "cpu", "cpu")
    _p, gpu = _storm_run(tmp_path / "gpu", "cuda")
    for b, ((cd, cm), (gd, gm)) in enumerate(zip(cpu, gpu)):
        assert set(cd) == set(gd)
        for name in cd:
            _assert_same_rows(cd[name], gd[name], (b, name))
        for k in ("Input_DataXProcessedInput_Events_Count", "Input_Weather_Events_Count",
                  "Output_StormDoors_JoinRowsDropped", "Output_StormDoors_Events_Count"):
            assert gm[k] == cm[k], (b, k)
