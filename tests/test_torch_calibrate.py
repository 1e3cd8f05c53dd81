"""The port's time model against the JAX package's: machine-profile
calibration (``obs/calibrate.py``: torch probes, persistence, the object
store, the process cache per device, profiles of the two packages kept
apart), the latency closed forms (``analysis/costmodel.py``: equal to
the JAX package's for one profile and the committed config-1 conf's
model), the DX520/DX521 checks on both packages' monitors, the host's
calibrated predictions, and the on-demand profiler surface
(``obs/profiler.py``). The mirror of ``test_timemodel.py``'s
calibration, roofline, latency-model, DX520/521 and profiler cases; the
card-only cases run on the card."""

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

import chip_smoke
from data_accelerator_tpu.analysis import costmodel as jcost
from data_accelerator_tpu.obs import calibrate as jcal
from data_accelerator_tpu.obs import conformance as jconf
from data_accelerator_tpu_torch.analysis import costmodel as tcost
from data_accelerator_tpu_torch.core.config import EngineException, SettingDictionary
from data_accelerator_tpu_torch.obs import calibrate as tcal
from data_accelerator_tpu_torch.obs import conformance as tconf
from data_accelerator_tpu_torch.obs import profiler as prof_mod
from data_accelerator_tpu_torch.obs.exposition import HealthState, ObservabilityServer
from data_accelerator_tpu_torch.runtime import host as host_mod
from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreServer

torch.set_num_threads(2)

GEN_CONF = (Path(chip_smoke.GEN_FIXTURE) / "DataXTpu-GenConfig1.conf").read_text()
SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
]})
PKGS = {
    "jax": types.SimpleNamespace(cost=jcost, conf=jconf),
    "torch": types.SimpleNamespace(cost=tcost, conf=tconf),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _committed_model() -> str:
    """The ``conformance.model`` the reference's control plane wrote
    into the committed config-1 conf."""
    key = "datax.job.process.conformance.model="
    (line,) = [ln for ln in GEN_CONF.splitlines() if ln.startswith(key)]
    return line[len(key):]


def _run(monitor, metrics, n):
    gauges, all_events = None, []
    for i in range(n):
        gauges, events = monitor.observe(dict(metrics), 1000 + i)
        all_events += events
    return gauges, all_events


# -- calibration -------------------------------------------------------------
def test_calibration_deterministic_within_band():
    """Two calibrations of the CPU agree within a generous band (best-of-N
    probes on one intra-op thread; the DX520 band itself is 10x)."""
    a = tcal.calibrate("cpu")
    b = tcal.calibrate("cpu")
    for field in ("hbm_read_gbps", "hbm_write_gbps", "flops_gflops",
                  "dispatch_overhead_us", "d2h_gbps"):
        va, vb = getattr(a, field), getattr(b, field)
        assert va > 0 and vb > 0, field
        assert max(va, vb) / min(va, vb) < 3.0, (field, va, vb)
    assert a.backend == b.backend == "torch-cpu"
    assert a.device_kind == "cpu" and a.ici_gbps is None
    assert a.decode_rows_per_sec and a.decode_rows_per_sec > 0
    assert a.probe_ms > 0
    assert set(a.metrics()) == set(jcal.calibrate().metrics()) - {"Calib_IciGBps"}


def test_ici_probe_needs_two_distinct_cards(monkeypatch):
    """The ICI probe prices an all-reduce across distinct cards: on the
    CPU, and with one card visible (virtual shards share it), it gives
    None and says why, without touching a device."""
    gbps, how = tcal.ici_probe("cpu")
    assert gbps is None and "no interconnect" in how
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    gbps, how = tcal.ici_probe("cuda:0")
    assert gbps is None and "1 card(s) visible" in how
    # the reference's probe gives None on a one-device host too
    assert tcal.calibrate("cpu").ici_gbps is None


def test_calibration_leaves_the_intra_op_threads_as_they_were():
    torch.set_num_threads(3)
    try:
        tcal.calibrate("cpu")
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(2)


def test_profile_file_roundtrip(tmp_path):
    p = tcal.calibrate("cpu")
    path = str(tmp_path / "profile.json")
    tcal.save_profile(p, path)
    loaded = tcal.load_profile(path)
    assert loaded is not None
    assert loaded.to_dict() == p.to_dict()
    assert tcal.load_profile(str(tmp_path / "nope.json")) is None
    (tmp_path / "bad.json").write_text("{not json")
    assert tcal.load_profile(str(tmp_path / "bad.json")) is None


@pytest.fixture
def store(tmp_path):
    srv = ObjectStoreServer(root=str(tmp_path / "store")).start()
    yield srv
    srv.stop()


@pytest.fixture
def empty_cache(monkeypatch):
    monkeypatch.setattr(tcal, "_cached", {})
    monkeypatch.setattr(jcal, "_cached", None)


def test_profile_objstore_roundtrip(store, tmp_path, empty_cache):
    """A calibrated profile pushes to the shared store and a peer with
    the same backend+device pulls it instead of re-probing."""
    url = f"objstore://127.0.0.1:{store.port}/fleet/calib"
    p = tcal.calibrate("cpu")
    p.probe_ms = 123.456  # distinctive marker: a pull, not a re-probe
    assert tcal.push_shared(url, p)
    pulled = tcal.pull_shared(url, p.backend, p.device_kind)
    assert pulled is not None and pulled.probe_ms == 123.456
    local = str(tmp_path / "calib.json")
    got = tcal.get_profile(cache_file=local, share_url=url, device="cpu")
    assert got.probe_ms == 123.456
    assert tcal.load_profile(local).probe_ms == 123.456
    # the process cache serves the next call
    assert tcal.get_profile(device="cpu") is got
    # a dead store degrades to live calibration, never a crash
    tcal.clear_cache()
    got2 = tcal.get_profile(share_url="objstore://127.0.0.1:1/fleet/calib",
                            device="cpu")
    assert got2.probe_ms != 123.456


def test_mismatched_cached_profile_recalibrates(tmp_path, empty_cache):
    """A cached profile for another backend/device (or probe version)
    is ignored — stale machine constants must never price another
    machine's roofline."""
    stale = tcal.MachineProfile(
        backend="torch-cuda", device_kind="NVIDIA H100 80GB HBM3",
        hbm_read_gbps=3000.0, hbm_write_gbps=3000.0, flops_gflops=5e4,
        dispatch_overhead_us=10.0, d2h_gbps=50.0, probe_ms=777.0,
    )
    local = str(tmp_path / "calib.json")
    tcal.save_profile(stale, local)
    got = tcal.get_profile(cache_file=local, device="cpu")
    assert got.backend == "torch-cpu" and got.probe_ms != 777.0
    old = tcal.MachineProfile(**dict(got.to_dict(), version=1, probe_ms=555.0))
    tcal.save_profile(old, local)
    tcal.clear_cache()
    assert tcal.get_profile(cache_file=local, device="cpu").probe_ms != 555.0


@pytest.mark.parametrize("layer", ["file", "store"])
def test_profiles_of_the_two_packages_are_kept_apart(layer, store, tmp_path, empty_cache):
    """A profile the JAX package persisted to the same calibration file
    or store is never taken by the port (its probes differ), nor the
    port's by the JAX package."""
    url = f"objstore://127.0.0.1:{store.port}/fleet/calib"
    kw = ({"cache_file": str(tmp_path / "calib.json")} if layer == "file"
          else {"share_url": url})
    jp = jcal.get_profile(**kw)
    assert jp.backend == "cpu"
    tp = tcal.get_profile(device="cpu", **kw)
    assert tp.backend == "torch-cpu" and tp.probe_ms != jp.probe_ms
    if layer == "store":
        # both are in the store, under keys of their own
        assert tcal.pull_shared(url, "cpu", jp.device_kind).probe_ms == jp.probe_ms
        assert tcal.pull_shared(url, "torch-cpu", "cpu").probe_ms == tp.probe_ms
    else:
        # the port wrote its own profile over the file; the JAX package
        # does not take it back
        assert tcal.load_profile(kw["cache_file"]).backend == "torch-cpu"
        jcal._cached = None
        assert jcal.get_profile(**kw).backend == "cpu"


def test_a_cpu_profile_does_not_price_a_card(monkeypatch, empty_cache):
    """The process cache holds one profile per device: a card's cached
    profile never answers for the CPU, and on a machine without a card a
    CPU profile in the cache does not stand in for the card's."""
    card = tcal.MachineProfile(
        backend="torch-cuda", device_kind="NVIDIA H100 80GB HBM3",
        hbm_read_gbps=3000.0, hbm_write_gbps=3000.0, flops_gflops=5e4,
        dispatch_overhead_us=10.0, d2h_gbps=50.0, probe_ms=777.0,
    )
    tcal._cached["cuda:0"] = card
    cpu = tcal.get_profile(device="cpu")
    assert cpu.backend == "torch-cpu" and cpu.probe_ms != 777.0
    assert set(tcal._cached) == {"cuda:0", "cpu"}
    assert tcal._matches(cpu, "torch-cpu", "cpu")
    assert not tcal._matches(cpu, "torch-cuda", card.device_kind)
    assert not tcal._matches(card, "torch-cpu", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(EngineException, match="no CUDA device"):
            tcal.get_profile(device="cuda")


# -- latency closed forms ----------------------------------------------------
def _profile_dict(**over):
    base = {
        "backend": "cpu", "device_kind": "cpu",
        "hbm_read_gbps": 10.0, "hbm_write_gbps": 10.0,
        "flops_gflops": 100.0, "dispatch_overhead_us": 100.0,
        "d2h_gbps": 1.0, "ici_gbps": 2.0,
    }
    base.update(over)
    return base


def test_stage_time_ms_is_a_roofline(pkg):
    prof = _profile_dict()
    # memory-bound: 10 MB at 10 GB/s = 1 ms >> flop term
    assert pkg.cost.stage_time_ms(10e6, 1e3, prof) == pytest.approx(1.0)
    # compute-bound: 1 GFLOP at 100 GFLOP/s = 10 ms >> byte term
    assert pkg.cost.stage_time_ms(1e3, 1e9, prof) == pytest.approx(10.0)
    # the slower of read/write streams prices the memory term
    slow_write = _profile_dict(hbm_write_gbps=1.0)
    assert pkg.cost.stage_time_ms(10e6, 0, slow_write) == pytest.approx(10.0)


def test_latency_model_block_and_stage_predictions(pkg):
    stages = [
        {"name": "a", "kind": "project", "hbmBytes": 10e6, "flops": 1e3},
        {"name": "b", "kind": "group", "hbmBytes": 1e3, "flops": 1e9},
    ]
    totals = {"d2hBytesPerBatch": 2e6, "iciWireBytesPerBatch": 4e6}
    lm = pkg.cost.latency_model(stages, totals, _profile_dict(), "calibrated")
    assert lm["profileSource"] == "calibrated"
    assert [s["computeMs"] for s in lm["stages"]] == [
        pytest.approx(1.0), pytest.approx(10.0)
    ]
    t = lm["totals"]
    assert t["computeMs"] == pytest.approx(11.0)
    assert t["dispatchOverheadMs"] == pytest.approx(0.1)
    assert t["deviceStepMs"] == pytest.approx(11.1)
    assert t["d2hMs"] == pytest.approx(2.0)
    assert t["iciMs"] == pytest.approx(2.0)
    assert t["batchMs"] == pytest.approx(15.1)
    preds = pkg.cost.stage_latency_predictions(lm)
    assert preds == {
        "device-step": pytest.approx(11.1), "collect": pytest.approx(2.0)
    }
    lm2 = pkg.cost.latency_model(stages, totals, _profile_dict(ici_gbps=None))
    assert lm2["totals"]["iciMs"] is None


def test_decode_term_prices_the_input_rows(pkg):
    stages = [{"name": "input:default", "kind": "input", "rows": 262144,
               "hbmBytes": 7602176, "flops": 0}]
    lm = pkg.cost.latency_model(stages, {}, _profile_dict(decode_rows_per_sec=1e7))
    assert lm["totals"]["decodeMs"] == pytest.approx(26.2144)
    assert pkg.cost.stage_latency_predictions(lm)["decode"] == pytest.approx(26.2144)
    assert pkg.cost.decode_time_ms(262144, _profile_dict()) is None


# one profile of each kind the port meets: the CPU's probes, and a card's
# (numbers of the shape an H100 calibration gives, no measurement)
PROFILES = {
    "cpu": _profile_dict(hbm_read_gbps=25.5, hbm_write_gbps=22.5,
                         flops_gflops=128.4, dispatch_overhead_us=6.1,
                         d2h_gbps=11.7, ici_gbps=None,
                         decode_rows_per_sec=3.9e6),
    "card": _profile_dict(backend="torch-cuda", device_kind="NVIDIA H100 80GB HBM3",
                          hbm_read_gbps=2900.0, hbm_write_gbps=2800.0,
                          flops_gflops=50000.0, dispatch_overhead_us=12.0,
                          d2h_gbps=45.0, ici_gbps=None,
                          decode_rows_per_sec=1.2e7),
}


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_latency_model_equals_jax_on_the_committed_conf(profile):
    """One profile prices the committed config-1 conf's model to the
    same block and the same stage predictions in both packages, and to
    the same ``latency_predictions`` triple through each package's
    ``ConformanceModel``."""
    obj = json.loads(_committed_model())
    prof = PROFILES[profile]
    jm = jcost.latency_model(obj["stages"], obj["totals"], prof, "calibrated")
    tm = tcost.latency_model(obj["stages"], obj["totals"], prof, "calibrated")
    assert tm == jm
    assert tcost.stage_latency_predictions(tm) == jcost.stage_latency_predictions(jm)
    assert set(tcost.stage_latency_predictions(tm)) == {"decode", "device-step", "collect"}
    tpred = tconf.ConformanceModel.from_json(_committed_model()).latency_predictions(prof)
    jpred = jconf.ConformanceModel.from_json(_committed_model()).latency_predictions(prof)
    assert tpred == jpred
    assert tcost.runtime_conformance_model(obj["totals"], obj["stages"], obj["outputs"]) \
        == jcost.runtime_conformance_model(obj["totals"], obj["stages"], obj["outputs"])


def test_the_committed_conf_judges_only_decode_on_a_card():
    """On a card's profile the committed conf's device step (about
    134 MB of stage bytes) and collect (2,428,928 B) price under the
    1 ms floor, and only decode is judged."""
    preds, compute_ms, overhead_ms = tconf.ConformanceModel.from_json(
        _committed_model()).latency_predictions(PROFILES["card"])
    floor = tconf.DEFAULT_STAGE_TIME_FLOOR_MS
    assert {s for s, ms in preds.items() if ms >= floor} == {"decode"}
    assert preds["device-step"] == pytest.approx(compute_ms + overhead_ms, abs=1e-3)


@pytest.mark.parametrize("launches", [1, 2, 197])
def test_launches_add_one_dispatch_overhead_each(launches):
    """The port's deliberate difference from the reference's formula:
    the same stages at ``launches=N`` carry exactly ``N - 1`` more
    dispatch overheads in ``deviceStepMs``; at 1 they are the JAX
    package's block."""
    obj = json.loads(_committed_model())
    prof = PROFILES["card"]
    one = tcost.latency_model(obj["stages"], obj["totals"], prof, "calibrated")
    n = tcost.latency_model(obj["stages"], obj["totals"], prof, "calibrated",
                            launches=launches)
    overhead_ms = prof["dispatch_overhead_us"] / 1000.0
    assert n["totals"]["computeMs"] == one["totals"]["computeMs"]
    assert n["totals"]["deviceStepMs"] == pytest.approx(
        one["totals"]["deviceStepMs"] + (launches - 1) * overhead_ms, abs=2e-4)
    assert n["totals"]["dispatchOverheadMs"] == pytest.approx(launches * overhead_ms)
    if launches == 1:
        assert n == jcost.latency_model(obj["stages"], obj["totals"], prof, "calibrated")


def test_config1_step_launches_price_the_device_step_over_the_floor():
    """Config 1's step counted on ``meta`` launches a few hundred kernels
    (the card's profiler saw 241 device activities); priced at a card's
    dispatch overhead each, ``device-step`` crosses the 1 ms floor and is
    judged."""
    from data_accelerator_tpu_torch.analysis.deviceplan import analyze_processor
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    proc = FlowProcessor(SettingDictionary(chip_smoke.flow_conf()), batch_capacity=1024,
                         output_datasets=chip_smoke.OUTPUTS,
                         udfs={"anomalyscore": anomalyscore()}, device="cpu")
    report = analyze_processor(proc)
    launches = report.launches_per_step
    assert 150 <= launches <= 300
    assert report.plan_dict()["launchesPerStep"] == launches
    preds, compute_ms, overhead_ms = tconf.ConformanceModel.from_json(
        _committed_model()).latency_predictions(PROFILES["card"], launches=launches)
    assert preds["device-step"] >= tconf.DEFAULT_STAGE_TIME_FLOOR_MS
    assert overhead_ms == pytest.approx(launches * PROFILES["card"]["dispatch_overhead_us"] / 1e3)



# -- DX520/DX521 on both packages' monitors ------------------------------------
def test_clean_stage_times_stay_silent(pkg):
    mon = pkg.conf.ConformanceMonitor(pkg.conf.ConformanceModel(), warmup=2, window=4)
    mon.set_latency({"device-step": 10.0, "collect": 2.0},
                    compute_ms=9.0, overhead_ms=1.0)
    gauges, events = _run(
        mon, {"Latency-DeviceStep-p50": 25.0, "Latency-Collect-p50": 3.0}, 8)
    assert events == []  # 2.5x and 1.5x sit inside the 10x band
    assert gauges["Conformance_StageTime_DeviceStep_Ratio"] == pytest.approx(2.5)
    assert gauges["Conformance_StageTime_Collect_Ratio"] == pytest.approx(1.5)


def test_stage_time_drift_fires_dx520_once_and_rearms(pkg):
    mon = pkg.conf.ConformanceMonitor(pkg.conf.ConformanceModel(), warmup=2, window=4)
    mon.set_latency({"device-step": 2.0}, compute_ms=1.9, overhead_ms=0.1)
    fired = []
    for i in range(6):
        _, events = mon.observe({"Latency-DeviceStep-p50": 50.0}, i)
        fired += events
    assert [e.code for e in fired] == ["DX520"]
    ev = fired[0]
    assert ev.metric == "Latency-DeviceStep-p50"
    assert ev.ratio == pytest.approx(25.0)
    assert ev.to_props()["name"] == "stage-time-drift"
    assert "DX520" in pkg.conf.DRIFT_CODES
    for i in range(4):
        _, events = mon.observe({"Latency-DeviceStep-p50": 5.0}, 10 + i)
        assert not events
    _, events = _run(mon, {"Latency-DeviceStep-p50": 80.0}, 4)
    assert [e.code for e in events] == ["DX520"]
    assert mon.drift_count == 2


def test_missing_latency_model_disables_dx520_silently(pkg):
    mon = pkg.conf.ConformanceMonitor(
        pkg.conf.ConformanceModel(d2h_bytes_per_batch=1000.0), warmup=1, window=4)
    gauges, events = _run(
        mon, {"Transfer_D2HBytes": 950.0, "Latency-DeviceStep-p50": 1e9}, 8)
    assert events == []
    assert not any(k.startswith("Conformance_StageTime") for k in gauges)


def test_sub_floor_predictions_decline_to_judge(pkg):
    mon = pkg.conf.ConformanceMonitor(pkg.conf.ConformanceModel(), warmup=1, window=4)
    mon.set_latency({"collect": 0.001}, 0.0, 0.0)
    gauges, events = _run(mon, {"Latency-Collect-p50": 55.0}, 6)
    assert events == []
    assert gauges["Conformance_StageTime_Collect_Ratio"] > 1000
    pinned = pkg.conf.ConformanceMonitor(pkg.conf.ConformanceModel(), warmup=1, window=4)
    pinned.set_latency({"collect": 0.001}, pinned=True)
    _, events = _run(pinned, {"Latency-Collect-p50": 55.0}, 6)
    assert [e.code for e in events] == ["DX520"]


def test_overhead_bound_model_fires_dx521_not_dx520(pkg):
    mon = pkg.conf.ConformanceMonitor(pkg.conf.ConformanceModel(), warmup=2, window=4)
    mon.set_latency({"device-step": 1.1}, compute_ms=0.1, overhead_ms=1.0)
    _, events = _run(mon, {"Latency-DeviceStep-p50": 50.0}, 6)
    assert [e.code for e in events] == ["DX521"]
    assert events[0].to_props()["name"] == "dispatch-overhead-dominated"
    assert "per-dispatch fixed" in events[0].message
    mon2 = pkg.conf.ConformanceMonitor(pkg.conf.ConformanceModel(), warmup=2, window=4)
    mon2.set_latency({"device-step": 1.1}, compute_ms=1.0, overhead_ms=0.1)
    _, events = _run(mon2, {"Latency-DeviceStep-p50": 50.0}, 6)
    assert [e.code for e in events] == ["DX520"]


def test_latency_pin_survives_calibration(pkg):
    from data_accelerator_tpu.core.config import SettingDictionary as JSD

    SD = JSD if pkg is PKGS["jax"] else SettingDictionary
    d = SD({"datax.job.process.conformance.latency": json.dumps({"device-step": 7.5})})
    mon = pkg.conf.ConformanceMonitor.from_conf(d, flow="F")
    assert mon is not None and mon.latency == {"device-step": 7.5}
    assert mon.latency_pinned
    mon.set_latency({"device-step": 0.001}, 0.0, 0.0)
    assert mon.latency == {"device-step": 7.5}


def test_monitors_judge_the_calibrated_predictions_alike():
    """Both monitors, armed with one profile's predictions of the
    committed conf's model, give the same ratios and events on one
    stream of stage latencies."""
    prof = PROFILES["card"]
    mons = {}
    for name, p in PKGS.items():
        model = p.conf.ConformanceModel.from_json(_committed_model())
        mon = p.conf.ConformanceMonitor(model, warmup=2, window=4)
        mon.set_latency(*model.latency_predictions(prof))
        mons[name] = mon
    stream = [{"Latency-Decode-p50": d, "Latency-DeviceStep-p50": 9.0,
               "Latency-Collect-p50": 40.0} for d in (40.0, 60.0, 900.0, 950.0, 80.0)]
    for b, metrics in enumerate(stream):
        (tg, tev), (jg, jev) = (mons[n].observe(dict(metrics), b) for n in ("torch", "jax"))
        ratios = lambda g: {k: v for k, v in g.items() if "StageTime" in k}  # noqa: E731
        assert ratios(tg) == ratios(jg), b
        assert [(e.code, e.metric) for e in tev] == [(e.code, e.metric) for e in jev], b
    assert mons["torch"].drift_count == mons["jax"].drift_count == 1


# -- the host ----------------------------------------------------------------
def _host_conf(tmp_path, extra=None):
    from data_accelerator_tpu_torch.obs.histogram import HISTOGRAMS

    HISTOGRAMS.clear()
    os.makedirs(tmp_path / "in", exist_ok=True)
    with open(tmp_path / "in" / "a.json", "w", encoding="utf-8") as f:
        for i in range(8):
            f.write(json.dumps({"k": i, "v": float(i)}) + "\n")
    t = tmp_path / "t.transform"
    t.write_text("--DataXQuery--\nOut = SELECT k, v FROM DataXProcessedInput\n")
    d = {
        "datax.job.name": "TimeModel",
        "datax.job.input.default.inputtype": "file",
        "datax.job.input.default.blobpathregex": str(tmp_path / "in" / "*.json"),
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.input.default.eventhub.maxrate": "100",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.transform": str(t),
        "datax.job.process.batchcapacity": "16",
        "datax.job.output.Out.console.maxrows": "0",
    }
    d.update(extra or {})
    return SettingDictionary(d)


class _CaptureWriter:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def test_injected_slowdown_fires_dx520_exactly_once(tmp_path):
    """A live host whose latency prediction is pinned far below reality
    fires DX520 exactly once (the transition), and exports the machine
    profile as ``Calib_*`` gauges."""
    host = host_mod.StreamingHost(_host_conf(tmp_path, {
        "datax.job.process.conformance.latency": json.dumps({"device-step": 0.0001}),
        "datax.job.process.conformance.warmup": "1",
    }), device="cpu")
    cap = _CaptureWriter()
    host.telemetry.writers.append(cap)
    try:
        host.run(max_batches=6)
    finally:
        host.stop()
    drift = [r for r in cap.records
             if r.get("type") == "event" and r.get("name") == "conformance/drift"]
    assert [r["properties"]["code"] for r in drift] == ["DX520"]
    metrics = {k.partition(":")[2] for k in host.metric_logger.store.keys("DATAX-TimeModel:")}
    assert "Calib_DispatchOverheadUs" in metrics
    assert "Conformance_StageTime_DeviceStep_Ratio" in metrics


def test_host_arms_the_monitor_with_its_profiles_predictions(tmp_path, store, empty_cache):
    """Without a pin the host prices the conf's model with its device's
    profile, read here from the calibration file it persisted; with
    ``observability.calibration=false`` it emits no ``Calib_*`` and arms
    no prediction."""
    path = str(tmp_path / "calib.json")
    url = f"objstore://127.0.0.1:{store.port}/calib"
    conf = {
        "datax.job.process.conformance.model": _committed_model(),
        "datax.job.process.observability.calibrationfile": path,
        "datax.job.process.observability.calibrationurl": url,
    }
    host = host_mod.StreamingHost(_host_conf(tmp_path, conf), device="cpu")
    host.stop()
    profile = tcal.load_profile(path)
    assert profile is not None and profile.backend == "torch-cpu"
    assert tcal.pull_shared(url, "torch-cpu", "cpu").to_dict() == profile.to_dict()
    # the port's eager step pays a dispatch overhead a launched kernel
    launches = host.launches_per_step()
    assert launches > 1
    preds, _c, _o = host.conformance.model.latency_predictions(
        profile.to_dict(), launches=launches)
    assert host.conformance.latency == preds
    assert host._calib_metrics == profile.metrics()
    off = host_mod.StreamingHost(_host_conf(tmp_path, dict(conf, **{
        "datax.job.process.observability.calibration": "false"})), device="cpu")
    off.stop()
    assert off._calib_metrics == {} and off.conformance.latency == {}


def test_post_profile_on_live_host_writes_capture_into_batch_trace(tmp_path):
    """POST /profile?seconds=N on a live host's observability port arms
    a capture; the capture directory fills with a Chrome trace and its
    path lands as a profiler/capture span in the batch trace plus the
    Profiler_Captures_Count series."""
    host = host_mod.StreamingHost(_host_conf(tmp_path, {
        "datax.job.process.observability.port": "0",
        "datax.job.process.observability.profilerdir": str(tmp_path / "prof"),
    }), device="cpu")
    cap = _CaptureWriter()
    host.telemetry.writers.append(cap)
    try:
        port = host.obs_server.port
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/profile?seconds=0.2", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            payload = json.loads(r.read())
        assert payload["path"].startswith(str(tmp_path / "prof"))
        host.run_batch()
        deadline = time.time() + 30.0
        while host.profiler.captures_count == 0 and time.time() < deadline:
            time.sleep(0.05)
        host.run_batch()  # drains the finished capture into this trace
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/profile", timeout=10) as r:
            state = json.loads(r.read())
        assert state == {"available": True, "active": None, "captures": 1}
    finally:
        host.stop()
    spans = [r for r in cap.records
             if r.get("type") == "span" and r.get("name") == "profiler/capture"]
    assert spans and spans[0]["properties"]["path"] == payload["path"]
    with open(os.path.join(payload["path"], prof_mod.TRACE_FILE)) as f:
        assert json.load(f)["traceEvents"]
    pts = host.metric_logger.store.points("DATAX-TimeModel:Profiler_Captures_Count")
    assert pts and pts[-1]["val"] == 1.0


def test_profile_endpoint_noop_when_profiler_unavailable(tmp_path, monkeypatch):
    """Without torch.profiler the endpoint answers 501 and the surface
    reports unavailable — never an exception; a server without the
    surface answers 501 too."""
    monkeypatch.setattr(prof_mod, "profiler_available", lambda: False)
    surface = prof_mod.ProfilerSurface(str(tmp_path / "p"), flow="f")
    assert surface.available is False
    assert "error" in surface.start(1.0)
    for profiler in (surface, None):
        srv = ObservabilityServer(HealthState(flow="f"), port=0, profiler=profiler)
        srv.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/profile?seconds=1", data=b"", method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=10)
            assert err.value.code == 501
            assert "unavailable" in json.loads(err.value.read())["error"]
        finally:
            srv.stop()


def test_double_start_conflicts_and_stop_is_idempotent(tmp_path):
    surface = prof_mod.ProfilerSurface(str(tmp_path / "p"), flow="f")
    res = surface.start(seconds=60)
    assert res.get("path")
    again = surface.start(seconds=60)
    assert "error" in again and again["path"] == res["path"]
    assert surface.stop() == res["path"]
    assert surface.stop() is None
    assert surface.captures_count == 1
    caps = surface.drain_finished()
    assert [c["path"] for c in caps] == [res["path"]]
    assert surface.drain_finished() == []


def test_a_failed_profiler_start_is_an_error_not_a_crash(tmp_path, monkeypatch):
    """A profiler that fails to start: the surface's start fails open
    with the error, and the next capture works."""
    surface = prof_mod.ProfilerSurface(str(tmp_path / "p"), flow="f")

    def broken(cuda):
        raise RuntimeError("profiler backend busy")

    with monkeypatch.context() as m:
        m.setattr(prof_mod, "_new_profile", broken)
        res = surface.start(seconds=60)
    assert res == {"error": "profiler start failed: profiler backend busy"}
    assert surface.active() is None and surface.stop() is None
    assert surface.captures_count == 0
    ok = surface.start(seconds=60)
    assert ok.get("path") and surface.stop() == ok["path"]
    assert surface.captures_count == 1


def test_capture_records_the_ops_of_other_threads(tmp_path):
    """Armed from one thread, stopped from another: the capture thread
    owns the profiler, and the ops a third thread ran during the window
    are in the trace, with the span it ran them under as a range."""
    from data_accelerator_tpu_torch.obs import tracing
    from data_accelerator_tpu_torch.obs.tracing import Tracer

    surface = prof_mod.ProfilerSurface(str(tmp_path / "p"), flow="f")
    armed = {}
    arm = threading.Thread(target=lambda: armed.update(surface.start(seconds=60)))
    arm.start()
    arm.join(timeout=60)
    assert armed.get("path")

    trace = Tracer(None, enabled=False).begin("streaming/batch")

    def work():
        a = torch.ones(64, 64)
        with trace.activate(), tracing.span("collect"):
            for _ in range(4):
                torch.mm(a, a)

    worker = threading.Thread(target=work)
    worker.start()
    worker.join(timeout=60)
    assert surface.stop() == armed["path"]
    assert not tracing.PROFILER_RANGES.is_set()
    with open(os.path.join(armed["path"], prof_mod.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    tids = {e.get("name"): e.get("tid") for e in events}
    assert "aten::mm" in tids
    assert tids.get("collect") == worker.native_id == tids["aten::mm"]


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# NVIDIA's published HBM3 bandwidth of the H100 SXM5 80GB
H100_PEAK_GBPS = 3350.0


@pytest.mark.cuda
def test_card_probes_stream_past_the_l2_and_leave_no_peak(card, empty_cache):
    keep = torch.empty(1 << 20, device=card)
    torch.cuda.reset_peak_memory_stats(card)
    peak = torch.cuda.max_memory_allocated(card)
    p = tcal.get_profile(device=card)
    assert p.backend == "torch-cuda" and p.device_kind == torch.cuda.get_device_name(card)
    assert 0 < p.hbm_read_gbps <= H100_PEAK_GBPS and 0 < p.hbm_write_gbps <= H100_PEAK_GBPS
    assert p.d2h_gbps > 0 and p.decode_rows_per_sec
    assert torch.cuda.max_memory_allocated(card) == peak
    assert tcal.get_profile(device="cuda") is p
    del keep


@pytest.mark.cuda
def test_card_capture_holds_the_kernels(card, tmp_path):
    surface = prof_mod.ProfilerSurface(str(tmp_path / "p"), flow="f", cuda=True)
    res = surface.start(seconds=60)
    a = torch.ones(256, 256, device=card)
    (a @ a).sum().item()
    assert surface.stop() == res["path"]
    with open(os.path.join(res["path"], prof_mod.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
