"""The conformance monitor of the PyTorch port (``obs/conformance.py``, a
copy of the JAX package's) against the JAX package's: the monitor tests
of ``tests/test_conformance.py`` (DX501-503, the DX510/511 mesh pair,
the missing-prediction posture, the model parsed from the conf) run on
each package's classes,
and a stream of batches gives both the same gauges and events. Then the
port's host on confs from the reference's control plane: the generated
model stays silent, a mis-modeled one fires DX501 once, the generation
opt-out arms no monitor, an operator latency pin arms DX520, and a live
HBM peak above the modeled footprint fires DX522. A host over virtual
shards with a generated sharding model is in tests/test_torch_meshcheck.py."""

import json
import types

import pytest

from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.obs import conformance as jconf
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.obs import conformance as tconf
from data_accelerator_tpu_torch.obs import telemetry

PACKAGES = {
    "jax": types.SimpleNamespace(
        ConformanceModel=jconf.ConformanceModel,
        ConformanceMonitor=jconf.ConformanceMonitor,
        DRIFT_CODES=jconf.DRIFT_CODES, SettingDictionary=JSettingDictionary),
    "torch": types.SimpleNamespace(
        ConformanceModel=tconf.ConformanceModel,
        ConformanceMonitor=tconf.ConformanceMonitor,
        DRIFT_CODES=tconf.DRIFT_CODES, SettingDictionary=SettingDictionary),
}


@pytest.fixture(params=sorted(PACKAGES))
def m(request):
    return PACKAGES[request.param]


class CaptureWriter(telemetry.TelemetryWriter):
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def _model(m, d2h=1000.0, outputs=None):
    return m.ConformanceModel(
        d2h_bytes_per_batch=d2h, outputs=outputs or {}
    )


def _run(monitor, metrics, n):
    """Feed the same metrics n times; returns (last gauges, ALL events)
    — drift events fire on the transition into drift, so only the
    accumulated list sees them."""
    gauges, all_events = None, []
    for i in range(n):
        gauges, events = monitor.observe(dict(metrics), 1000 + i)
        all_events += events
    return gauges, all_events


# -- monitor unit tests ------------------------------------------------------

def test_clean_flow_stays_silent(m):
    mon = m.ConformanceMonitor(_model(m, d2h=1000.0), warmup=2, window=4)
    all_events = []
    for i in range(10):
        gauges, events = mon.observe({"Transfer_D2HBytes": 950.0}, i)
        all_events += events
    assert not all_events
    assert gauges["Conformance_D2HBytes_Ratio"] == pytest.approx(0.95)
    assert "Conformance_Drift_Count" not in gauges


def test_d2h_drift_fires_dx501_once_and_rearms(m):
    mon = m.ConformanceMonitor(_model(m, d2h=1000.0), warmup=2, window=2)
    fired = []
    # drifting: observed 3x predicted
    for i in range(6):
        _, events = mon.observe({"Transfer_D2HBytes": 3000.0}, i)
        fired += events
    assert len(fired) == 1  # transition event, not one per batch
    ev = fired[0]
    assert ev.code == "DX501"
    assert ev.ratio == pytest.approx(3.0)
    assert "DX501" in m.DRIFT_CODES
    props = ev.to_props()
    assert props["name"] == "d2h-bytes-drift"
    assert props["batchTime"] is not None
    # recovery clears the episode...
    for i in range(6):
        gauges, events = mon.observe({"Transfer_D2HBytes": 900.0}, 10 + i)
        assert not events
    # ...and a new drift episode fires again
    _, ev2 = _run(mon, {"Transfer_D2HBytes": 5000.0}, 6)
    assert mon.drift_count == 2
    gauges, _ = mon.observe({"Transfer_D2HBytes": 5000.0}, 99)
    assert gauges["Conformance_Drift_Count"] == 2.0


def test_no_drift_during_warmup(m):
    mon = m.ConformanceMonitor(_model(m, d2h=1000.0), warmup=5, window=4)
    for i in range(5):
        _, events = mon.observe({"Transfer_D2HBytes": 9000.0}, i)
        assert not events  # still warming up


def test_occupancy_drift_fires_dx502_per_output(m):
    mon = m.ConformanceMonitor(
        _model(m, d2h=None, outputs={
            "Counts": {"rows": 10, "capacity": 1024},
            "Fine": {"rows": 100, "capacity": 1024},
        }),
        warmup=2, window=2, occupancy_factor=2.0,
    )
    metrics = {
        "Output_Counts_Events_Count": 50.0,   # 5x the modeled 10
        "Output_Fine_Events_Count": 90.0,     # within model
    }
    gauges, events = _run(mon, metrics, 5)
    codes = [(e.code, e.metric) for e in events]
    assert codes == [("DX502", "Output_Counts_Events_Count")]
    assert gauges["Conformance_Occupancy_Counts_Ratio"] == pytest.approx(5.0)
    assert gauges["Conformance_Occupancy_Fine_Ratio"] == pytest.approx(0.9)
    assert not any(
        e.metric == "Output_Fine_Events_Count" for e in events
    )


def test_unmodeled_retrace_fires_dx503(m):
    mon = m.ConformanceMonitor(_model(m, d2h=None), warmup=2, window=4)
    for i in range(4):
        _, events = mon.observe({}, i)
        assert not events
    _, events = mon.observe({"Retrace_Count": 1.0}, 5)
    assert [e.code for e in events] == ["DX503"]
    # quiet batches re-arm, a later retrace fires a new event
    mon.observe({}, 6)
    _, events = mon.observe({"Retrace_Count": 2.0}, 7)
    assert [e.code for e in events] == ["DX503"]


def test_missing_predictions_disable_checks_silently(m):
    mon = m.ConformanceMonitor(m.ConformanceModel(), warmup=1, window=4)
    gauges, events = _run(
        mon,
        {"Transfer_D2HBytes": 1e9, "Output_X_Events_Count": 1e9},
        8,
    )
    assert gauges == {}
    assert events == []


def test_model_parses_from_conf_and_rejects_garbage(m):
    SettingDictionary = m.SettingDictionary
    model_json = json.dumps({
        "totals": {"d2hBytesPerBatch": 4096, "hbmBytes": 1 << 20},
        "outputs": {"Hot": {"rows": 64, "capacity": 1024}},
        "stages": [{"name": "Hot", "kind": "project",
                    "d2hBytes": 4096, "hbmBytes": 2048}],
    })
    d = SettingDictionary({
        "datax.job.process.conformance.model": model_json,
    })
    model = m.ConformanceModel.from_conf(d)
    assert model.d2h_bytes_per_batch == 4096
    assert model.outputs["Hot"]["rows"] == 64
    assert m.ConformanceModel.from_json("not json") is None
    assert m.ConformanceModel.from_conf(SettingDictionary({})) is None
    mon = m.ConformanceMonitor.from_conf(d, flow="F")
    assert mon is not None and mon.flow == "F"
    assert m.ConformanceMonitor.from_conf(SettingDictionary({})) is None


def test_monitors_agree_on_one_stream():
    """The same model and metric stream through both monitors: equal
    gauges and equal events (codes, ratios), batch after batch."""
    model = json.dumps({
        "totals": {"d2hBytesPerBatch": 1000, "hbmBytes": 1 << 20},
        "outputs": {"A": {"rows": 10, "capacity": 64}, "B": {"rows": 40, "capacity": 64}},
    })
    mons = {
        pkg: mod.ConformanceMonitor.from_conf(mod.SettingDictionary({
            "datax.job.process.conformance.model": model,
            "datax.job.process.conformance.warmup": "2",
            "datax.job.process.conformance.window": "3",
            "datax.job.process.conformance.latency": json.dumps({"device-step": 2.0}),
        }), flow="F")
        for pkg, mod in PACKAGES.items()
    }
    for b in range(12):
        metrics = {
            "Transfer_D2HBytes": 800.0 + 300.0 * (b % 5),
            "Output_A_Events_Count": float(5 + 9 * (b % 4)),
            "Output_B_Events_Count": 30.0,
            "Hbm_PeakBytes": float((1 << 20) * (1 + (b > 6))),
            "Latency-DeviceStep-p50": 1.0 + 20.0 * (b == 9),
            **({"Retrace_Count": 1.0} if b in (4, 8) else {}),
        }
        out = {pkg: mon.observe(dict(metrics), b) for pkg, mon in mons.items()}
        (jg, jev), (tg, tev) = out["jax"], out["torch"]
        assert tg == jg, b
        assert [(e.code, e.metric, e.ratio) for e in tev] == [
            (e.code, e.metric, e.ratio) for e in jev], b
    assert mons["torch"].drift_count == mons["jax"].drift_count > 0


def test_mesh_drift_codes_are_not_ported():
    """The mesh pair is ported: the port's drift codes and model fields
    are the reference's."""
    assert set(tconf.DRIFT_CODES) == set(jconf.DRIFT_CODES)
    assert {"DX510", "DX511"} <= set(tconf.DRIFT_CODES)
    fields = set(tconf.ConformanceModel.__dataclass_fields__)
    assert fields == set(jconf.ConformanceModel.__dataclass_fields__)
    assert tconf.DEFAULT_ICI_RATIO_HIGH == jconf.DEFAULT_ICI_RATIO_HIGH == 8.0


# -- DX510/DX511: the mesh ICI drift pair (clean / drifting / missing
#    model), on each package's classes ------------------------------------------
def _mesh_model(m, wire=100_000.0, reshards=3.0):
    return m.ConformanceModel(ici_wire_bytes_per_batch=wire, reshard_count=reshards)


def test_clean_mesh_run_stays_silent(m):
    mon = m.ConformanceMonitor(_mesh_model(m, wire=100_000.0), warmup=2, window=4)
    all_events = []
    for i in range(10):
        gauges, events = mon.observe(
            {"Mesh_ICI_Bytes": 120_000.0, "Mesh_Reshard_Count": 51.0}, i)
        all_events += events
    assert all_events == []
    assert gauges["Conformance_MeshIci_Ratio"] == pytest.approx(1.2)
    assert "Conformance_Drift_Count" not in gauges


def test_ici_drift_fires_dx510_once_and_rearms(m):
    mon = m.ConformanceMonitor(_mesh_model(m, wire=1_000.0), warmup=2, window=2,
                               ici_ratio_high=8.0)
    fired = []
    for i in range(6):
        _, events = mon.observe({"Mesh_ICI_Bytes": 50_000.0}, i)
        fired += events
    assert [e.code for e in fired] == ["DX510"]
    ev = fired[0]
    assert ev.metric == "Mesh_ICI_Bytes"
    assert ev.ratio == pytest.approx(50.0)
    assert ev.to_props()["name"] == "ici-bytes-drift"
    assert "DX510" in m.DRIFT_CODES
    for i in range(6):
        _, events = mon.observe({"Mesh_ICI_Bytes": 900.0}, 10 + i)
        assert not events
    _, evs = _run(mon, {"Mesh_ICI_Bytes": 90_000.0}, 6)
    assert [e.code for e in evs] == ["DX510"]
    assert mon.drift_count == 2


def test_missing_mesh_model_disables_dx510_silently(m):
    mon = m.ConformanceMonitor(_model(m, d2h=1000.0), warmup=1, window=4)
    gauges, events = _run(
        mon, {"Transfer_D2HBytes": 950.0, "Mesh_ICI_Bytes": 1e12}, 8)
    assert events == []
    assert "Conformance_MeshIci_Ratio" not in gauges


def test_collective_count_drift_fires_dx511(m):
    mon = m.ConformanceMonitor(_mesh_model(m), warmup=2, window=4)
    for i in range(5):
        _, events = mon.observe({"Mesh_Reshard_Count": 51.0}, i)
        assert not events
    _, events = mon.observe({"Mesh_Reshard_Count": 80.0}, 6)
    assert [e.code for e in events] == ["DX511"]
    ev = events[0]
    assert ev.to_props()["name"] == "mesh-collective-count-drift"
    assert ev.observed == 80.0 and ev.predicted == 51.0
    mon.observe({"Mesh_Reshard_Count": 51.0}, 7)
    _, events = mon.observe({"Mesh_Reshard_Count": 80.0}, 8)
    assert [e.code for e in events] == ["DX511"]


def test_mesh_model_parses_from_conf_beside_conformance_model(m):
    mesh_json = json.dumps({
        "totals": {"iciWireBytesPerBatch": 129024.0, "reshardCount": 3, "chips": 8},
        "stages": [],
    })
    d = m.SettingDictionary({"datax.job.process.mesh.model": mesh_json})
    model = m.ConformanceModel.from_conf(d)
    assert model is not None
    assert model.ici_wire_bytes_per_batch == 129024.0
    assert model.reshard_count == 3
    assert model.d2h_bytes_per_batch is None
    assert m.ConformanceMonitor.from_conf(d) is not None
    both = m.SettingDictionary({
        "datax.job.process.mesh.model": mesh_json,
        "datax.job.process.conformance.model": json.dumps(
            {"totals": {"d2hBytesPerBatch": 4096}}),
    })
    model = m.ConformanceModel.from_conf(both)
    assert model.d2h_bytes_per_batch == 4096
    assert model.ici_wire_bytes_per_batch == 129024.0


def test_mesh_stream_gives_both_packages_the_same_gauges_and_events():
    """A census that drifts past the band and a reshard count that
    changes: both packages' monitors, fed the same batches, agree."""
    mesh_json = json.dumps({"totals": {"iciWireBytesPerBatch": 1000.0,
                                       "reshardCount": 4, "chips": 4}})
    mons = {
        pkg: mod.ConformanceMonitor.from_conf(mod.SettingDictionary({
            "datax.job.process.mesh.model": mesh_json,
            "datax.job.process.conformance.warmup": "2",
            "datax.job.process.conformance.window": "3",
        }), flow="F")
        for pkg, mod in PACKAGES.items()
    }
    for b in range(12):
        metrics = {"Mesh_ICI_Bytes": 1000.0 * (1 + 15 * (b in (5, 6, 7))),
                   "Mesh_Reshard_Count": 4.0 + (b == 9)}
        out = {pkg: mon.observe(dict(metrics), b) for pkg, mon in mons.items()}
        (jg, jev), (tg, tev) = out["jax"], out["torch"]
        assert tg == jg, b
        assert [(e.code, e.metric, e.ratio) for e in tev] == [
            (e.code, e.metric, e.ratio) for e in jev], b
    assert mons["torch"].drift_count == mons["jax"].drift_count >= 2


# -- the port's host on confs from the control plane ---------------------------
@pytest.fixture
def deployed_conf(tmp_path):
    from data_accelerator_tpu.serve.flowservice import FlowOperation
    from data_accelerator_tpu.serve.scenarios import probe_deploy_gui
    from data_accelerator_tpu.serve.storage import (
        LocalDesignTimeStorage,
        LocalRuntimeStorage,
    )

    fo = FlowOperation(
        LocalDesignTimeStorage(str(tmp_path / "d")),
        LocalRuntimeStorage(str(tmp_path / "r")),
        fleet_admission=False,
    )
    fo.save_flow(probe_deploy_gui())
    res = fo.generate_configs("probe-deploy")
    assert res.ok, res.errors
    return res.conf_paths[0]


def _run_host(conf_path, overrides, batches=6, hbm=None):
    from data_accelerator_tpu_torch.core.confmanager import ConfigManager
    from data_accelerator_tpu_torch.runtime.host import StreamingHost

    ConfigManager.reset()
    ConfigManager.get_configuration_from_arguments([f"conf={conf_path}"])
    conf = ConfigManager.load_config().with_settings(overrides)
    host = StreamingHost(conf, device="cpu")
    if hbm is not None:
        # the CPU reports no allocator stats: stand in the card's
        host.processor.device_memory_stats = lambda: {
            "bytes_in_use": hbm, "peak_bytes_in_use": hbm}
    cap = CaptureWriter()
    host.telemetry.writers.append(cap)
    try:
        host.run(max_batches=batches)
    finally:
        host.stop()
        ConfigManager.reset()
    drift = [r for r in cap.records
             if r.get("type") == "event" and r["name"] == "conformance/drift"]
    return host, drift


def test_mismodeled_conf_fires_dx501_clean_baseline_silent(deployed_conf):
    """The clean generated conf (the JAX package's model) runs silent on
    the port; the same flow with a shrunken D2H prediction fires DX501
    once."""
    host, drift = _run_host(deployed_conf, {"datax.job.process.conformance.warmup": "1"})
    assert drift == []
    ratios = host.metric_logger.store.points(
        "DATAX-probe-deploy:Conformance_D2HBytes_Ratio")
    assert ratios and all(p["val"] < 1.1 for p in ratios)
    bad_model = json.dumps({"totals": {"d2hBytesPerBatch": 100}, "outputs": {},
                            "stages": []})
    host, drift = _run_host(deployed_conf, {
        "datax.job.process.conformance.model": bad_model,
        "datax.job.process.conformance.warmup": "1",
    })
    assert {r["properties"]["code"] for r in drift} == {"DX501"}
    assert len(drift) == 1
    rows = host.metric_logger.store.points("DATAX-probe-deploy:Conformance_Drift")
    assert rows and rows[0]["code"] == "DX501"


def test_latency_pin_arms_dx520_and_hbm_peak_fires_dx522(deployed_conf):
    """No calibration in the port: DX520 judges only an operator pin.
    DX522 judges the allocator's live peak against the model's HBM
    footprint (here a stand-in peak 4x the footprint)."""
    with open(deployed_conf, encoding="utf-8") as f:
        model = json.loads(next(
            ln.split("=", 1)[1] for ln in f
            if ln.startswith("datax.job.process.conformance.model=")))
    hbm = int(model["totals"]["hbmBytes"]) * 4
    host, drift = _run_host(deployed_conf, {
        "datax.job.process.conformance.warmup": "1",
        "datax.job.process.conformance.latency": json.dumps({"batch": 1e-6}),
    }, hbm=hbm)
    codes = sorted(r["properties"]["code"] for r in drift)
    assert codes == ["DX520", "DX522"]
    assert host.conformance.latency_pinned
    gauges = host.metric_logger.store.points("DATAX-probe-deploy:Conformance_Hbm_Ratio")
    assert gauges[-1]["val"] == pytest.approx(4.0)


def test_generation_opt_out_arms_no_monitor(tmp_path):
    from data_accelerator_tpu.serve.flowservice import FlowOperation
    from data_accelerator_tpu.serve.scenarios import probe_deploy_gui
    from data_accelerator_tpu.serve.storage import (
        LocalDesignTimeStorage,
        LocalRuntimeStorage,
    )

    gui = probe_deploy_gui()
    gui.setdefault("process", {})["jobconfig"] = {"jobConformanceModel": "false"}
    fo = FlowOperation(LocalDesignTimeStorage(str(tmp_path / "d")),
                       LocalRuntimeStorage(str(tmp_path / "r")),
                       fleet_admission=False)
    fo.save_flow(gui)
    res = fo.generate_configs("probe-deploy")
    assert res.ok, res.errors
    host, drift = _run_host(res.conf_paths[0], {}, batches=2)
    assert host.conformance is None and host.alerts is not None
    assert drift == []
