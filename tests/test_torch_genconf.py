"""Confs from the reference's control plane, run by the PyTorch port.

``RuntimeConfigGeneration`` (the JAX package's control plane) generates
the conf of a designer flow holding the config-1 queries (the three
queries of ``__graft_entry__.BASE_TRANSFORM``). Such a conf always
carries ``process.alerts.rules``, and unless the designer opts out
``process.conformance.model`` and ``process.compile.manifest``.

- ``tests/data/generated_torch/`` holds that conf at 262,144 rows a
  batch, with its transform, projection, schema and manifest, absolute
  paths replaced by ``@GENDIR@``: ``chip_smoke.py`` runs it on the card,
  where the control plane cannot run. A test regenerates it and holds
  the fixture equal to the fresh output, so it cannot go stale.
  Regenerate it with
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_genconf.py``.
- The same designer flow generated at 256 rows a batch runs on both
  packages' ``StreamingHost`` batch for batch: rows and metrics equal,
  less what the port does not emit (``Calib_IciGBps``: no ICI probe on
  one card) and the compile cache's counts, which both emit but count
  different things (XLA executables; kernel libraries, none of which a
  CPU step loads). The machine profiles' ``Calib_*`` gauges and the
  ``Conformance_StageTime_*`` ratios priced from them appear on both,
  their values measured by each package's own probes.
- The manifest's eager meaning in the port: a warm at init that leaves
  no adaptive state behind, reports ``Compile_ColdStart_Ms``, counts a
  bucket or kernel first met after it as ``Compile_WarmMiss_Count``,
  and raises where the JAX package's warm logs and carries on.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.core.config import parse_conf_lines as jparse_conf_lines
from data_accelerator_tpu.runtime import host as jhost_mod
from data_accelerator_tpu.runtime import processor as jprocessor_mod
from data_accelerator_tpu.runtime import sinks as jsinks
from data_accelerator_tpu.runtime import sources as jsources
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu_torch.core.config import SettingDictionary, parse_conf_lines
from data_accelerator_tpu_torch.kernels import build as kernel_build
from data_accelerator_tpu_torch.runtime import host as thost_mod
from data_accelerator_tpu_torch.runtime import sinks as tsinks
from data_accelerator_tpu_torch.runtime import sources as tsources
from data_accelerator_tpu_torch.runtime.processor import (
    FlowProcessor, transfer_buckets, window_groups,
)
from data_accelerator_tpu_torch.udf.api import TorchUdf
from test_torch_flow import (
    BASE_MS, PORT_GROUP_METRICS, TYPES, _as_jax_metrics, _assert_same_rows, _batch_columns,
)
from test_torch_host import _Clock, _local_source, _RecordingSink

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE_DIR = ROOT / "tests" / "data" / "generated_torch"
FLOW = chip_smoke.GEN_FLOW
OUTPUTS = ["OpenDoors", "HeatAvg"]
# the config-1 queries as a designer writes them: TIMEWINDOW and OUTPUT
# clauses that codegen turns into the window conf and the sinks
DESIGNER_QUERIES = (
    "--DataXQuery--\n"
    "DoorEvents = SELECT deviceDetails.deviceId AS deviceId, "
    "deviceDetails.deviceType AS deviceType, deviceDetails.status AS status, "
    "deviceDetails.homeId AS homeId, "
    "deviceDetails.temperature AS temperature, eventTimeStamp "
    "FROM DataXProcessedInput;\n"
    "--DataXQuery--\n"
    "OpenDoors = SELECT deviceId, eventTimeStamp FROM DoorEvents "
    "WHERE deviceType = 'DoorLock' AND status = 0;\n"
    "--DataXQuery--\n"
    "HeatAvg = SELECT deviceId, COUNT(*) AS Cnt, AVG(temperature) AS AvgT "
    "FROM DataXProcessedInput TIMEWINDOW('5 seconds') GROUP BY deviceId;\n"
    "OUTPUT OpenDoors TO Metrics;\nOUTPUT HeatAvg TO Metrics;"
)


def designer_gui(capacity: int) -> dict:
    """The designer state of the config-1 flow: local input polled at a
    full batch a second, ``jobBatchCapacity`` rows a batch."""
    import __graft_entry__ as graft

    return {
        "name": FLOW, "displayName": FLOW,
        "input": {"mode": "streaming", "type": "local", "properties": {
            "windowDuration": "1", "maxRate": str(capacity),
            "inputSchemaFile": graft.IOT_SCHEMA,
            "normalizationSnippet": "current_timestamp() AS eventTimeStamp\nRaw.*",
            "watermarkValue": 0, "watermarkUnit": "second",
        }, "referenceData": []},
        "process": {
            "timestampColumn": "eventTimeStamp", "watermark": "0 second",
            "functions": [], "queries": [DESIGNER_QUERIES],
            "jobconfig": {"jobNumChips": "1", "jobBatchCapacity": str(capacity)},
        },
        "outputs": [{"id": "Metrics", "type": "metric", "properties": {}}],
        "outputTemplates": [], "rules": [],
    }


def generate(work: Path, capacity: int) -> dict:
    """Run the reference's control plane on the designer flow; returns
    {file name: text} of the generated job directory, its absolute path
    replaced by the placeholder."""
    from data_accelerator_tpu.serve.flowbuilder import FlowConfigBuilder
    from data_accelerator_tpu.serve.generation import RuntimeConfigGeneration
    from data_accelerator_tpu.serve.storage import (
        LocalDesignTimeStorage,
        LocalRuntimeStorage,
    )

    design = LocalDesignTimeStorage(str(work / "design"))
    runtime = LocalRuntimeStorage(str(work / "runtime"))
    design.save(FlowConfigBuilder().build(designer_gui(capacity)))
    res = RuntimeConfigGeneration(design, runtime).generate(FLOW)
    assert res.ok, res.errors
    job_dir = Path(res.conf_paths[0]).parent
    return {
        p.name: p.read_text(encoding="utf-8").replace(str(job_dir), chip_smoke.GEN_PLACEHOLDER)
        for p in sorted(job_dir.iterdir()) if p.is_file()
    }


def _generated_conf(tmp_path, capacity, jobs=("job",)):
    """The designer flow generated at ``capacity`` rows a batch, placed
    in one job directory per name in ``jobs`` (each with checkpoint
    directories of its own); returns the conf path, or the paths."""
    files = generate(tmp_path / "gen", capacity)
    src = tmp_path / "fixture"
    src.mkdir()
    for name, text in files.items():
        (src / name).write_text(text, encoding="utf-8")
    paths = [chip_smoke.materialize_generated_conf(tmp_path / j, src) for j in jobs]
    return paths[0] if len(paths) == 1 else paths


def _conf_dict(path: Path) -> dict:
    return parse_conf_lines(path.read_text(encoding="utf-8").splitlines())


# -- the fixture ------------------------------------------------------------------
def test_fixture_equals_fresh_generation(tmp_path):
    fresh = generate(tmp_path, chip_smoke.CAPACITY)
    committed = {p.name: p.read_text(encoding="utf-8")
                 for p in sorted(FIXTURE_DIR.iterdir())}
    assert sorted(fresh) == sorted(committed)
    for name, text in fresh.items():
        assert committed[name] == text, name


def test_fixture_holds_the_three_keys_and_the_config1_queries(tmp_path):
    import __graft_entry__ as graft

    conf_path = chip_smoke.materialize_generated_conf(tmp_path, FIXTURE_DIR)
    conf = _conf_dict(conf_path)
    proc = "datax.job.process."
    assert json.loads(conf[proc + "alerts.rules"])
    assert json.loads(conf[proc + "conformance.model"])["totals"]["d2hBytesPerBatch"] > 0
    manifest = json.loads(Path(conf[proc + "compile.manifest"]).read_text())
    assert manifest["flow"] == FLOW and manifest["entries"]
    assert conf[proc + "batchcapacity"] == str(chip_smoke.CAPACITY)
    assert conf["datax.job.input.default.eventhub.maxrate"] == str(chip_smoke.CAPACITY)
    lines = Path(conf[proc + "transform"]).read_text().splitlines()
    assert [ln for ln in lines if ln.strip()] == graft.BASE_TRANSFORM.splitlines()
    assert chip_smoke.GEN_PLACEHOLDER not in conf_path.read_text()


# -- both hosts, batch for batch ---------------------------------------------------
# metrics of wall clock (the calibration gauges and the stage-time
# ratios priced from them among them), the compile cache's counts (both
# hosts report them, but the JAX package counts its XLA executables and
# the port its kernel libraries, of which a CPU step loads none), and
# what only the JAX host emits: the ICI gauge (the JAX package measures a
# link between the tests' 8 virtual CPU devices; the port has no ICI
# probe until multi-GPU)
UNCOMPARED = ("Latency-", "Pipeline_Stall_Ms", "Decode_RowsPerSec",
              "Compile_ColdStart_Ms", "Calib_", "Conformance_StageTime_",
              "Compile_Cache_")
JAX_ONLY = ("Calib_IciGBps",)
BATCHES = 8
CAP = 256


def _drive(pkg, conf_path, batches, monkeypatch):
    clock = _Clock()
    mod, sinks, sources, SD, parse = {
        "jax": (jhost_mod, jsinks, jsources, JSettingDictionary, jparse_conf_lines),
        "torch": (thost_mod, tsinks, tsources, SettingDictionary, parse_conf_lines),
    }[pkg]
    monkeypatch.setattr(mod, "time", clock.module())
    if pkg == "jax":
        # the JAX package's transfer-helper jit cache is process-wide:
        # start it empty, so that its evictions of what earlier tests in
        # this process compiled (Compile_JitCacheEvict_Count) stay out
        # of this run, as in a process of its own
        with jprocessor_mod._HELPER_JIT_LOCK:
            jprocessor_mod._HELPER_JITS.clear()
        jprocessor_mod.drain_jit_evictions()
    conf = SD(parse(conf_path.read_text(encoding="utf-8").splitlines()))
    src = _local_source(sources, [{c: a.copy() for c, a in b.items()} for b in batches],
                        clock)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    host = mod.StreamingHost(conf, source=src, **kw)
    sink = _RecordingSink()
    host.dispatcher = sinks.OutputDispatcher(
        {n: sinks.OutputOperator(n, [sink]) for n in OUTPUTS}, host.metric_logger)
    per_batch = []
    send = host.metric_logger.send_batch_metrics

    def spy(metrics, ts=None):
        per_batch.append((ts, dict(metrics)))
        return send(metrics, ts)

    host.metric_logger.send_batch_metrics = spy
    try:
        host.run(max_batches=len(batches))
    finally:
        host.stop()
        monkeypatch.undo()
    names = {k.split(":", 1)[1] for k in host.metric_logger.store.keys(f"DATAX-{FLOW}:")}
    return host, sink.rows, per_batch, names


def test_generated_conf_runs_on_both_hosts_batch_for_batch(tmp_path, monkeypatch):
    conf_paths = dict(zip(("jax", "torch"),
                          _generated_conf(tmp_path, CAP, jobs=("jax", "torch"))))
    conf = _conf_dict(conf_paths["torch"])
    for key in ("alerts.rules", "conformance.model", "compile.manifest"):
        assert conf["datax.job.process." + key]
    rs = np.random.RandomState(6)
    ids = np.array([1 + i for i in range(len(TYPES))], np.int32)
    batches = [_batch_columns(rs, ids, CAP) for _ in range(BATCHES)]
    runs = {pkg: _drive(pkg, conf_paths[pkg], batches, monkeypatch)
            for pkg in ("jax", "torch")}
    (jhost, jrows, jm, jnames), (thost, trows, tm, tnames) = runs["jax"], runs["torch"]

    assert set(trows) == set(jrows) and len({t for t, _d in trows}) == BATCHES
    for key in sorted(jrows):
        _assert_same_rows(jrows[key], trows[key], key)
    assert sum(len(r) for (_t, d), r in trows.items() if d == "OpenDoors")

    assert tnames - PORT_GROUP_METRICS == {n for n in jnames if not n.startswith(JAX_ONLY)}
    assert PORT_GROUP_METRICS <= tnames
    assert len(tm) == len(jm)
    for (ts, t), (_js, j) in zip(tm, jm):
        j = {k: v for k, v in j.items() if not k.startswith(JAX_ONLY)}
        t = _as_jax_metrics(t, thost.processor)
        # the observed D2H bytes' windowed mean over the model's: the
        # port's counts vector is 8 bytes longer a windowed GROUP BY
        extra = 8 * len(window_groups(thost.processor.pipeline, thost.processor.windows))
        t["Conformance_D2HBytes_Ratio"] -= extra / thost.conformance.model.d2h_bytes_per_batch
        assert set(t) == set(j), (ts, set(t) ^ set(j))
        for k, v in t.items():
            if not k.startswith(UNCOMPARED):
                assert v == pytest.approx(j[k], rel=1e-12), (ts, k, j[k], v)
    # the three features are live: audit gauges, conformance ratios, the
    # alert engine, the warm's cold start on the first batch only
    assert any(n.startswith("Conf_") for n in tnames)
    assert "Conformance_D2HBytes_Ratio" in tm[-1][1]
    assert "Calib_HbmReadGBps" in tm[-1][1]
    assert "Conformance_StageTime_DeviceStep_Ratio" in tm[-1][1]
    assert thost.alerts is not None and thost.conformance is not None
    assert thost.processor._aot_warmed
    assert [("Compile_ColdStart_Ms" in m) for _t, m in tm] == [True] + [False] * (BATCHES - 1)
    # the port's own cache counts: a fresh directory, and no kernel
    # library loaded by a CPU step
    assert (tm[0][1]["Compile_Cache_Hit_Count"], tm[0][1]["Compile_Cache_Miss_Count"]) == (0, 0)
    assert jm[0][1]["Compile_Cache_Miss_Count"] > 0
    assert not any("Compile_WarmMiss_Count" in m for _t, m in tm)
    assert ([e["name"] for e in thost.alerts.evaluate()]
            == [e["name"] for e in jhost.alerts.evaluate()])


def test_main_runs_the_generated_conf_on_the_cpu(tmp_path):
    conf_path = _generated_conf(tmp_path, CAP)
    host = thost_mod.main([f"conf={conf_path}", "batches=2", "device=cpu"])
    assert host.batches_processed == 2
    store = host.metric_logger.store
    keys = {k.split(":", 1)[1] for k in store.keys(f"DATAX-{FLOW}:")}
    assert {"Compile_ColdStart_Ms", "Conf_Audited_Count", "Alerts_Firing",
            "Conformance_D2HBytes_Ratio", "Output_OpenDoors_Events_Count"} <= keys
    assert "Compile_WarmMiss_Count" not in keys
    assert host.processor.compile_manifest["flow"] == FLOW


# -- the manifest warm ----------------------------------------------------------------
def _warm_conf(tmp_path, extra=None):
    conf = _conf_dict(_generated_conf(tmp_path, CAP))
    conf.update(extra or {})
    return conf


def test_manifest_warm_leaves_no_state_and_matches_a_cold_processor(tmp_path):
    conf = _warm_conf(tmp_path)
    cold_conf = {k: v for k, v in conf.items() if "compile." not in k}
    warm = FlowProcessor(SettingDictionary(conf), output_datasets=OUTPUTS, device="cpu")
    cold = FlowProcessor(SettingDictionary(cold_conf), output_datasets=OUTPUTS,
                         device="cpu")
    assert warm._aot_warmed and not cold._aot_warmed
    # the warm's state is gone: rings, counter, base, EWMA, boost, stats
    assert warm._slot_counter == 0 and warm._base_ms is None
    for buf in warm.window_buffers.values():
        assert not buf.valid.any()
    assert warm.transfer_ewma == {} and warm.transfer_boost == {}
    assert warm.transfer_stats == {} and warm.ingest_stats == {}
    assert warm._slot_parity == {}
    # ...and every transfer slot an output can use is made, both A/B
    for name in OUTPUTS:
        full = CAP if name == "OpenDoors" else warm.pipeline.view_by_name(name).capacity
        for cap in transfer_buckets(full):
            assert [s is not None for s in warm._slots[(name, cap)]] == [True, True]
    # compile.cachedir arms the kernel build cache: its directory is made
    # at init, and a CPU warm builds nothing into it
    assert Path(conf["datax.job.process.compile.cachedir"]).is_dir()
    assert warm._compile_cache.file_count() == 0 and cold._compile_cache is None
    rs = np.random.RandomState(2)
    ids = np.array([warm.dictionary.encode(t) for t in TYPES], np.int32)
    assert np.array_equal(ids, [cold.dictionary.encode(t) for t in TYPES])
    for b in range(6):
        cols = _batch_columns(rs, ids, CAP)
        t_ms = BASE_MS + 1000 * b
        wd, wm = warm.process_batch(warm.encode_columns(cols, CAP), t_ms)
        cd, cm = cold.process_batch(cold.encode_columns(cols, CAP), t_ms)
        for name in OUTPUTS:
            _assert_same_rows(cd[name], wd[name], (b, name))
        compile_keys = {k for k in wm if k.startswith("Compile_")}
        assert compile_keys == ({"Compile_ColdStart_Ms", "Compile_Cache_Hit_Count",
                                 "Compile_Cache_Miss_Count"} if b == 0 else set())
        assert wm["Compile_ColdStart_Ms" if b == 0 else "Sync_CountsBytes"] > 0
        for k, v in cm.items():
            if k != "Latency-Process":
                assert wm[k] == v, (b, k)


def _late_kernel_proc(tmp_path, monkeypatch, name):
    """A warmed processor whose UDF ``late`` loads, at its next call, the
    kernel sources put in the list returned beside it. ``load`` runs its
    own bookkeeping; the build and the library handle are stand-ins."""
    conf = _warm_conf(tmp_path / name)
    transform = Path(conf["datax.job.process.transform"])
    transform.write_text(transform.read_text().rstrip("\n") + (
        "\n--DataXQuery--\nLate = SELECT deviceId, late(temperature) AS t "
        "FROM DoorEvents\n"))
    pending = []

    def late(x):
        while pending:
            kernel_build.load(pending.pop())
        return x + 1.0

    monkeypatch.setattr(kernel_build, "_LOADED", dict(kernel_build._LOADED))
    monkeypatch.setattr(kernel_build, "build", lambda srcs: [Path(s) for s in srcs])
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", lambda path: object())
    proc = FlowProcessor(SettingDictionary(conf), output_datasets=OUTPUTS, device="cpu",
                         udfs={"late": TorchUdf("late", late)})
    assert proc._aot_warmed
    return proc, pending


def _kernel_source(tmp_path, name):
    path = tmp_path / f"{name}.cu"
    path.write_text(f"// {name}\n")
    return path


def test_warm_misses_count_a_bucket_and_a_kernel_first_met_after_the_warm(
        tmp_path, monkeypatch):
    proc, pending = _late_kernel_proc(tmp_path, monkeypatch, "a")
    # a bucket the warm did not stage (dropped from the slots here)
    cap = transfer_buckets(CAP)[0]
    del proc._slots[("OpenDoors", cap)]
    proc.transfer_ewma["OpenDoors"] = 1.0
    _d, m = proc.process_batch(proc.encode_columns({}, 0), BASE_MS)
    assert m["Compile_WarmMiss_Count"] == 1.0
    # two kernel libraries this flow's step first loads after the warm
    pending += [_kernel_source(tmp_path, "late_a"), _kernel_source(tmp_path, "late_b")]
    _d, m = proc.process_batch(proc.encode_columns({}, 0), BASE_MS + 1000)
    assert m["Compile_WarmMiss_Count"] == 2.0 and not pending
    _d, m = proc.process_batch(proc.encode_columns({}, 0), BASE_MS + 2000)
    assert "Compile_WarmMiss_Count" not in m


def test_another_flows_kernel_load_is_no_warm_miss_of_this_flow(tmp_path, monkeypatch):
    """Warm misses are a processor's own: a kernel that another flow, or
    code outside any step, loads after this flow's warm is not one."""
    first, _ = _late_kernel_proc(tmp_path, monkeypatch, "first")
    second, pending = _late_kernel_proc(tmp_path, monkeypatch, "second")
    kernel_build.load(_kernel_source(tmp_path, "outside"))
    pending.append(_kernel_source(tmp_path, "second_only"))
    _d, m = second.process_batch(second.encode_columns({}, 0), BASE_MS)
    assert m["Compile_WarmMiss_Count"] == 1.0
    _d, m = first.process_batch(first.encode_columns({}, 0), BASE_MS)
    assert "Compile_WarmMiss_Count" not in m


def test_a_failed_warm_raises_where_jax_logs(tmp_path, caplog):
    """The JAX package's warm logs a failure and compiles at the first
    batch; the port's raises at init, as the first batch would."""
    transform = Path(_warm_conf(tmp_path)["datax.job.process.transform"])
    transform.write_text(transform.read_text().rstrip("\n") + (
        "\n--DataXQuery--\nBoom = SELECT deviceId, boom(temperature) AS b FROM DoorEvents\n"))
    conf = _conf_dict(tmp_path / "job" / f"DataXTpu-{FLOW}.conf")

    def fail(*_a):
        raise RuntimeError("kernel build failed at warm")

    from data_accelerator_tpu.udf.api import JaxUdf

    with caplog.at_level("ERROR"):
        jp = JFlowProcessor(JSettingDictionary(conf), output_datasets=OUTPUTS,
                            udfs={"boom": JaxUdf("boom", fail)})
    assert not jp._aot_warmed
    assert "AOT warm failed" in caplog.text
    with pytest.raises(RuntimeError, match="kernel build failed at warm"):
        FlowProcessor(SettingDictionary(conf), output_datasets=OUTPUTS, device="cpu",
                      udfs={"boom": TorchUdf("boom", fail)})


def test_unparseable_manifest_warms_nothing(tmp_path, caplog):
    conf = _warm_conf(tmp_path, {"datax.job.process.compile.manifest": "{not json"})
    with caplog.at_level("WARNING"):
        proc = FlowProcessor(SettingDictionary(conf), output_datasets=OUTPUTS,
                             device="cpu")
    assert not proc._aot_warmed and proc.compile_manifest is None
    assert "compile manifest does not parse" in caplog.text
    proc = FlowProcessor(SettingDictionary(_warm_conf(
        tmp_path / "off", {"datax.job.process.compile.aot": "false"})),
        output_datasets=OUTPUTS, device="cpu")
    assert not proc._aot_warmed and proc.compile_manifest is not None


# -- Retrace_Count: step rebuilds after init ---------------------------------------
def test_step_rebuilds_count_as_retraces_like_jax(tmp_path):
    """A UDF ``on_interval`` refresh rebuilds the step: the port counts
    it as the JAX package counts its re-trace, into ``Retrace_Count``;
    a steady state emits none."""
    from data_accelerator_tpu.udf.api import JaxUdf

    conf = {k: v for k, v in _warm_conf(tmp_path).items() if "compile." not in k}
    transform = Path(conf["datax.job.process.transform"])
    transform.write_text(transform.read_text().rstrip("\n") + (
        "\n--DataXQuery--\nScaled = SELECT deviceId, bump(temperature) AS t FROM DoorEvents\n"))
    flips = {"jax": [], "torch": []}

    def refresher(pkg):
        def on_interval(batch_time_ms):
            flips[pkg].append(batch_time_ms)
            return len(flips[pkg]) == 3  # the third batch rebuilds
        return on_interval

    jp = JFlowProcessor(JSettingDictionary(conf), output_datasets=OUTPUTS, udfs={
        "bump": JaxUdf("bump", lambda x: x + 1.0, on_interval=refresher("jax"))})
    tp = FlowProcessor(SettingDictionary(conf), output_datasets=OUTPUTS, device="cpu",
                       udfs={"bump": TorchUdf("bump", lambda x: x + 1.0,
                                              on_interval=refresher("torch"))})
    got = {"jax": [], "torch": []}
    for b in range(5):
        for pkg, p in (("jax", jp), ("torch", tp)):
            _d, m = p.process_batch(p.encode_columns({}, 0), BASE_MS + 1000 * b)
            got[pkg].append(m.get("Retrace_Count"))
    assert got["torch"] == got["jax"] == [None, None, 1.0, None, None]


# -- on the card -------------------------------------------------------------------------
@pytest.mark.cuda
def test_warm_builds_and_launches_kernels_at_init_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    conf = _warm_conf(tmp_path)
    transform = Path(conf["datax.job.process.transform"])
    transform.write_text(transform.read_text().rstrip("\n") + (
        "\n--DataXQuery--\nScored = SELECT deviceId, "
        "anomalyscore(temperature, deviceId) AS score FROM DoorEvents\n"))
    udf = anomalyscore()
    proc = FlowProcessor(SettingDictionary(conf), output_datasets=OUTPUTS, device="cuda",
                         udfs={"anomalyscore": udf})
    assert udf.launches == 1  # the warm's zero-filled batch
    _d, m = proc.process_batch(proc.encode_columns({}, 0), BASE_MS)
    assert "Compile_WarmMiss_Count" not in m and udf.launches == 2


@pytest.mark.cuda
def test_a_kernel_that_fails_to_build_raises_at_the_warm_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from data_accelerator_tpu_torch.kernels.launch import cuda_call
    from data_accelerator_tpu_torch.udf.api import CudaKernelUdf

    bad = tmp_path / "bad_kernel.cu"
    bad.write_text("this is not CUDA\n")
    conf = _warm_conf(tmp_path)
    transform = Path(conf["datax.job.process.transform"])
    transform.write_text(transform.read_text().rstrip("\n") + (
        "\n--DataXQuery--\nBad = SELECT deviceId, bad(temperature) AS b FROM DoorEvents\n"))
    udf = CudaKernelUdf(
        "bad", lambda x: cuda_call(bad, "bad", x, out_shape=x.shape),
        lambda x: x * 1.0)
    with pytest.raises(kernel_build.KernelBuildError):
        FlowProcessor(SettingDictionary(conf), output_datasets=OUTPUTS, device="cuda",
                      udfs={"bad": udf})


def write_fixture() -> None:
    """Regenerate ``tests/data/generated_torch/`` from the control plane."""
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        files = generate(Path(work), chip_smoke.CAPACITY)
    if FIXTURE_DIR.exists():
        shutil.rmtree(FIXTURE_DIR)
    FIXTURE_DIR.mkdir(parents=True)
    for name, text in files.items():
        (FIXTURE_DIR / name).write_text(text, encoding="utf-8")


if __name__ == "__main__":
    write_fixture()
