"""The port's job layer (``serve/jobs.py``, ``serve/flowservice.py``,
``serve/scheduler.py``'s ``PlacementReplanner``) against the JAX
package's, and the slice as a whole:

- the lifecycle (start, sync, stop, idempotent start, retries, restart,
  delete cascade) with an in-memory client, on both packages, the same
  states and submits;
- the fleet admission gate: DX400/401/410/411 and the placements equal
  the JAX gate's on the same flows under one explicit ``FleetSpec``;
  the port's default spec is the machine's (one CPU device here);
- ``LocalJobClient`` spawns the port's host (``device=cpu`` only when
  asked), and ``K8sJobClient`` renders a GPU Job that never names the
  JAX package or a TPU selector;
- the in-place rescale assigns partitions as the JAX one does;
- the slice as a whole, in process: each package's ``FlowOperation``
  saves and generates the config-1 gui with a file input, and each
  generated conf runs through its own package's ``runtime.host.main``
  for two batches under a pinned clock, with equal rows and metrics;
- a slow twin of ``tests/test_serve_jobs.py``'s real child process.

Counts, states, codes and placements compare exactly; float rows within
rtol 1e-5 (``test_torch_flow._assert_same_rows``).
"""

import json
import os
import sys

import numpy as np
import pytest

import chip_smoke
from data_accelerator_tpu.analysis import FleetSpec as JFleetSpec
from data_accelerator_tpu.runtime import host as jhost_mod
from data_accelerator_tpu.serve import flowservice as jflowservice
from data_accelerator_tpu.serve import jobs as jjobs
from data_accelerator_tpu.serve import storage as jstorage
from data_accelerator_tpu_torch.analysis import FleetSpec
from data_accelerator_tpu_torch.core.config import EngineException
from data_accelerator_tpu_torch.runtime import host as thost_mod
from data_accelerator_tpu_torch.serve import flowservice as tflowservice
from data_accelerator_tpu_torch.serve import jobs as tjobs
from data_accelerator_tpu_torch.serve import storage as tstorage

from test_fleetcheck import ONE_CHIP_TINY, _SpyPopen, _tiny_gui, load_fleet
from test_serve_generation import make_gui
from test_torch_flow import _assert_same_rows
from test_torch_host import _Clock

PACKAGES = {
    "jax": (jflowservice, jjobs, jstorage, JFleetSpec),
    "torch": (tflowservice, tjobs, tstorage, FleetSpec),
}


def recording_client(jobs_mod, fail_submits=0):
    """In-memory client of the package's ``TpuJobClient`` interface."""

    class Recording(jobs_mod.TpuJobClient):
        def __init__(self):
            self.states, self.submits, self.fail_submits = {}, 0, fail_submits

        def submit(self, job):
            self.submits += 1
            if self.submits <= self.fail_submits:
                raise RuntimeError("transient submit failure")
            self.states[job["name"]] = jobs_mod.JobState.Running
            job["state"], job["clientId"] = jobs_mod.JobState.Starting, 4242
            return job

        def stop(self, job):
            self.states[job["name"]] = jobs_mod.JobState.Idle
            job["state"], job["clientId"] = jobs_mod.JobState.Idle, None
            return job

        def get_state(self, job):
            return self.states.get(job["name"], job.get("state") or jobs_mod.JobState.Idle)

    return Recording()


def local_client(pkg, root):
    """The package's ``LocalJobClient``, on the CPU for the port."""
    jobs_mod = PACKAGES[pkg][1]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    return jobs_mod.LocalJobClient(log_dir=os.path.join(root, "logs"), **extra)


def make_ops(pkg, root, client=None, spec=None, **kw):
    fs, jobs_mod, st, _spec_cls = PACKAGES[pkg]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    ops = fs.FlowOperation(
        st.LocalDesignTimeStorage(os.path.join(root, "design")),
        st.LocalRuntimeStorage(os.path.join(root, "runtime")),
        job_client=client if client is not None else recording_client(jobs_mod),
        fleet_spec=spec, **extra, **kw)
    ops.jobs.retry_interval_s = 0.01
    return ops


def _spec(pkg, d):
    return PACKAGES[pkg][3].from_dict(d)


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def _lifecycle(pkg, root) -> list:
    ops = make_ops(pkg, root)
    client = ops.jobs.client
    ops.save_flow(make_gui("JobFlow"))
    res = ops.generate_configs("JobFlow")
    assert res.ok, res.errors
    seen = [[j["state"] for j in ops.start_jobs("JobFlow")],
            [j["state"] for j in ops.sync_jobs("JobFlow")],
            [j["state"] for j in ops.start_jobs("JobFlow")], client.submits,
            [j["state"] for j in ops.restart_jobs("JobFlow")], client.submits,
            [j["state"] for j in ops.stop_jobs("JobFlow")]]
    ops.save_flow(make_gui("NoGen"))
    with pytest.raises(ValueError):
        ops.start_jobs("NoGen")
    flaky = make_ops(pkg, os.path.join(root, "flaky"),
                     client=recording_client(PACKAGES[pkg][1], fail_submits=2))
    flaky.save_flow(make_gui("RetryFlow"))
    flaky.generate_configs("RetryFlow")
    seen += [[j["state"] for j in flaky.start_jobs("RetryFlow")], flaky.jobs.client.submits]
    assert ops.delete_flow("JobFlow") and not ops.delete_flow("JobFlow")
    seen += [ops.get_flow("JobFlow"), ops.registry.get(res.job_names[0]),
             os.path.exists(res.conf_paths[0])]
    return seen


def test_lifecycle_equals_the_reference(tmp_path):
    got = {pkg: _lifecycle(pkg, str(tmp_path / pkg)) for pkg in PACKAGES}
    assert got["torch"] == got["jax"]
    assert got["torch"][:7] == [["starting"], ["running"], ["running"], 1,
                                ["starting"], 2, ["idle"]]


# ---------------------------------------------------------------------------
# the fleet admission gate
# ---------------------------------------------------------------------------
def _admissions(pkg, root, guis, spec, monkeypatch):
    """Each flow started in turn under ``spec`` through a
    ``LocalJobClient`` whose spawns are recorded, never made; returns
    per flow the admission, placement and the codes of a rejection."""
    fs, jobs_mod, _st, _c = PACKAGES[pkg]
    spy = _SpyPopen()
    monkeypatch.setattr(jobs_mod.subprocess, "Popen", spy)
    ops = make_ops(pkg, root, client=local_client(pkg, root), spec=_spec(pkg, spec))
    out = []
    for gui in guis:
        ops.save_flow(gui)
        assert ops.generate_configs(gui["name"]).ok
    for gui in guis:
        try:
            [job] = ops.start_jobs(gui["name"])
            out.append(("admitted", job["admission"], job["placement"]))
        except jobs_mod.FleetAdmissionError as e:
            rec = ops.registry.get(f"DataXTpu-{gui['name']}")
            out.append(("rejected", sorted(d.code for d in e.diagnostics),
                        rec["admission"]["codes"], rec.get("state")))
    out.append(len(spy.calls))
    return out, spy.calls


ADMISSION_CASES = {
    "dx400_one_chip": (lambda: [_tiny_gui("first"), _tiny_gui("second")], ONE_CHIP_TINY),
    "dx400_two_chips": (lambda: [_tiny_gui("first"), _tiny_gui("second")],
                        {**ONE_CHIP_TINY, "chips": 2}),
    "dx401_oversized": (lambda: [_tiny_gui("huge")], {**ONE_CHIP_TINY, "hbmPerChipBytes": 4096}),
    "dx410_shared_dirs": (lambda: load_fleet("dx410_shared_dir")["flows"],
                          {"chips": 4, "hbmPerChipBytes": 1 << 34}),
    "dx411_kafka": (lambda: load_fleet("dx411_kafka_collision")["flows"],
                    {"chips": 4, "hbmPerChipBytes": 1 << 34}),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_gate_equals_the_references(tmp_path, monkeypatch, case):
    make, spec = ADMISSION_CASES[case]
    runs = {pkg: _admissions(pkg, str(tmp_path / pkg), make(), spec, monkeypatch)
            for pkg in PACKAGES}
    assert runs["torch"][0] == runs["jax"][0]
    outcomes = runs["torch"][0][:-1]
    if case != "dx400_two_chips":
        assert any(o[0] == "rejected" for o in outcomes), outcomes
        code = case.split("_")[0].upper()
        assert any(code in o[1] for o in outcomes if o[0] == "rejected")
    # the port spawns its own host, never the JAX package's
    for cmd in runs["torch"][1]:
        assert cmd[1:3] == ["-m", "data_accelerator_tpu_torch.runtime.host"]
        assert "device=cpu" in cmd


def test_the_default_spec_is_the_machines(tmp_path):
    ops = make_ops("torch", str(tmp_path))
    assert ops.fleet_gate.spec.to_dict() == FleetSpec.from_dict({}, device="cpu").to_dict()
    assert ops.fleet_gate.spec.chips == 1
    gate = tjobs.FleetAdmissionGate(ops.design, ops.registry)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gate.spec  # noqa: B018 — the card's spec, and this machine has none


# ---------------------------------------------------------------------------
# the job clients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device,tail", [("cpu", ["device=cpu"]), ("cuda", [])])
def test_local_client_spawns_the_ports_host(tmp_path, monkeypatch, device, tail):
    spy = _SpyPopen()
    monkeypatch.setattr(tjobs.subprocess, "Popen", spy)
    client = tjobs.LocalJobClient(log_dir=str(tmp_path), device=device)
    job = client.submit({"name": "j", "confPath": "/c/j.conf", "batches": 2,
                         "confOverrides": {"datax.job.process.state.replicaindex": "2"}})
    assert job["state"] == "starting"
    assert spy.calls == [[sys.executable, "-m", "data_accelerator_tpu_torch.runtime.host",
                          "conf=/c/j.conf", *tail, "batches=2",
                          "datax.job.process.state.replicaindex=2"]]


def test_k8s_manifest_asks_for_a_gpu_and_names_no_tpu(tmp_path):
    client = tjobs.K8sJobClient("https://k8s.example:6443", image="dxtpu-torch:v1",
                                accelerator="nvidia-a100-80gb", http=lambda *a: (200, {}))
    m = client.render_manifest({"name": "DataXTpu-Flow", "flowName": "Flow",
                                "confPath": "/var/dxtpu/runtime/Flow/DataXTpu-Flow.conf",
                                "batches": 3})
    pod = m["spec"]["template"]["spec"]
    c = pod["containers"][0]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert c["command"] == ["python", "-m", "data_accelerator_tpu_torch.runtime.host"]
    assert c["args"] == ["conf=/var/dxtpu/runtime/Flow/DataXTpu-Flow.conf", "batches=3"]
    assert c["image"] == "dxtpu-torch:v1"
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-a100-80gb"}
    assert m["metadata"]["name"] == "dxtpu-job-dataxtpu-flow"
    text = json.dumps(m)
    for word in ("data_accelerator_tpu.", "gke-tpu", "google.com/tpu", "JAX_PLATFORMS"):
        assert word not in text, word
    with open(client.manifest_path, encoding="utf-8") as f:
        assert "data_accelerator_tpu." not in f.read()


def test_k8s_topology_is_refused_until_multi_gpu():
    with pytest.raises(EngineException, match="slice 8"):
        tjobs.K8sJobClient("https://k8s.example:6443", topology="4x4")
    with pytest.raises(EngineException, match="slice 8"):
        tjobs.make_job_client({"type": "k8s", "topology": "2x2"})
    assert isinstance(tjobs.make_job_client({}, device="cpu"), tjobs.LocalJobClient)
    assert tjobs.make_job_client({}, device="cpu").device == "cpu"


# ---------------------------------------------------------------------------
# the rescale
# ---------------------------------------------------------------------------
def _rescale(pkg, root, monkeypatch) -> list:
    fs, jobs_mod, _st, _c = PACKAGES[pkg]
    spy = _SpyPopen()
    monkeypatch.setattr(jobs_mod.subprocess, "Popen", spy)
    ops = make_ops(pkg, root, client=local_client(pkg, root),
                   spec=_spec(pkg, {**ONE_CHIP_TINY, "chips": 4}))
    ops.save_flow(_tiny_gui("elastic"))
    assert ops.generate_configs("elastic").ok
    [job] = ops.start_jobs("elastic")
    out = []
    for n in (3, 2, 1):
        recs = ops.jobs.rescale(job["name"], n)
        base = ops.registry.get(job["name"])
        out.append(([(r["name"], r.get("statePartitionsOwned"), r.get("confOverrides"))
                     for r in recs], base["statePartitionMap"],
                    base["statePartitionsReassigned"], base["rescale"], len(spy.calls)))
    out.append(ops.jobs.job_lineage(job["name"]))
    return out


def test_rescale_assigns_partitions_as_the_reference(tmp_path, monkeypatch):
    runs = {pkg: _rescale(pkg, str(tmp_path / pkg), monkeypatch) for pkg in PACKAGES}
    assert runs["torch"] == runs["jax"]
    first = runs["torch"][0]
    assert [r[0] for r in first[0]] == ["DataXTpu-elastic", "DataXTpu-elastic-r2",
                                        "DataXTpu-elastic-r3"]
    assert sorted(p for r in first[0] for p in r[1]) == list(range(16))


def test_rescale_emits_the_reassigned_count(tmp_path):
    from data_accelerator_tpu_torch.obs.metrics import MetricLogger
    from data_accelerator_tpu_torch.obs.store import MetricStore

    store = MetricStore()
    ops = make_ops("torch", str(tmp_path), spec=FleetSpec.from_dict(
        {**ONE_CHIP_TINY, "chips": 4}, device="cpu"))
    ops.fleet_gate._metrics = MetricLogger("DATAX-Fleet", store=store)
    ops.save_flow(_tiny_gui("metered"))
    ops.generate_configs("metered")
    [job] = ops.start_jobs("metered")
    # 1 -> 2: no earlier map, nothing moves; 2 -> 3: seven of 16 move
    ops.jobs.rescale(job["name"], 2)
    ops.jobs.rescale(job["name"], 3)
    assert [p["val"] for p in store.points(
        "DATAX-Fleet:State_Partition_Reassigned_Count")] == [0.0, 7.0]
    assert "DATAX-Fleet:Placement_Replans_Count" in store.keys()


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
WHOLE_CAP = 256
WHOLE_BATCHES = 2


def _whole_gui() -> dict:
    gui = chip_smoke.control_gui("file", WHOLE_CAP)
    # rows land in files, one folder a package (the generation default)
    gui["outputs"] = [{"id": "Metrics", "type": "file", "properties": {}}]
    return gui


def _read_rows(folder) -> dict:
    import gzip

    rows = {}
    for dirpath, _dirs, files in os.walk(folder):
        for f in sorted(files):
            stem = f.removesuffix(".gz").removesuffix(".json")
            dataset, batch_ms, _n = stem.rsplit("_", 2)
            opener = gzip.open if f.endswith(".gz") else open
            with opener(os.path.join(dirpath, f), "rt", encoding="utf-8") as fh:
                rows[(dataset, int(batch_ms))] = [json.loads(ln) for ln in fh if ln.strip()]
    return rows


def _whole(pkg, root, events_path, monkeypatch):
    ops = make_ops(pkg, root)
    gui = _whole_gui()
    if pkg == "jax":
        gui = json.loads(json.dumps(gui).replace("data_accelerator_tpu_torch.udf",
                                                 "data_accelerator_tpu.udf"))
    ops.save_flow(gui)
    res = ops.generate_configs(gui["name"])
    assert res.ok, res.errors
    [job] = ops.start_jobs(gui["name"])  # recorded, not spawned
    assert job["confPath"] == res.conf_paths[0]
    clock = _Clock()
    mod = {"jax": jhost_mod, "torch": thost_mod}[pkg]
    monkeypatch.setattr(mod, "time", clock.module())
    made = []

    class Kept(mod.StreamingHost):
        """The host ``main`` builds, kept (the JAX ``main`` returns none)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(mod, "StreamingHost", Kept)
    argv = [f"conf={res.conf_paths[0]}", f"batches={WHOLE_BATCHES}",
            f"datax.job.input.default.blobpathregex={events_path}"]
    try:
        mod.main(argv + (["device=cpu"] if pkg == "torch" else []))
    finally:
        monkeypatch.undo()
    [host] = made
    out_dir = ops.runtime.resolve(os.path.join(gui["name"], "out"))
    store = host.metric_logger.store
    prefix = f"DATAX-{gui['name']}:"
    metrics = {k[len(prefix):]: [(p["uts"], p["val"]) for p in store.points(k)]
               for k in store.keys(prefix)}
    return host, _read_rows(out_dir), metrics


# metrics of wall clock, and what only the JAX host emits: its compile
# cache, its ICI probe (test_torch_genconf.py) and its step's jit-cache
# growth past the manifest's warm, which a file source's row batches
# cause there (the port's warm misses count buckets and kernel loads,
# and it has none here)
UNCOMPARED = ("Latency-", "Pipeline_Stall_Ms", "Decode_RowsPerSec", "Compile_ColdStart_Ms",
              "Calib_", "Conformance_StageTime_")
JAX_ONLY = ("Compile_Cache_", "Calib_IciGBps", "Compile_WarmMiss_Count")


def test_the_slice_generates_and_runs_equal_on_both_packages(tmp_path, monkeypatch):
    rs = np.random.RandomState(12)
    events = tmp_path / "events.json"
    events.write_bytes(chip_smoke.make_json_payload(rs, WHOLE_BATCHES * WHOLE_CAP))
    runs = {pkg: _whole(pkg, str(tmp_path / pkg), str(events), monkeypatch)
            for pkg in PACKAGES}
    (jhost, jrows, jm), (thost, trows, tm) = runs["jax"], runs["torch"]
    assert thost.batches_processed == jhost.batches_processed == WHOLE_BATCHES
    assert thost.device.type == "cpu"
    assert sorted(trows) == sorted(jrows)
    assert {d for d, _t in trows} >= {"OpenDoors", "AnomalyAlerts", "HeatAvg"}
    for key in sorted(jrows):
        _assert_same_rows(jrows[key], trows[key], key)
    assert set(tm) == {k for k in jm if not k.startswith(JAX_ONLY)}
    for k, points in tm.items():
        if not k.startswith(UNCOMPARED):
            # values in order; init-time gauges carry the wall clock
            assert len(points) == len(jm[k]), k
            assert [v for _t, v in points] == pytest.approx(
                [v for _t, v in jm[k]], rel=1e-12), k
    assert [v for _t, v in tm["Input_DataXProcessedInput_Events_Count"]] == \
        [WHOLE_CAP] * WHOLE_BATCHES


@pytest.mark.slow
def test_real_child_process_lifecycle(tmp_path):
    """``tests/test_serve_jobs.py``'s real process twin: the generated
    conf runs as a child process of the port's host on the CPU; its
    state is observed through the client."""
    client = tjobs.LocalJobClient(log_dir=str(tmp_path / "logs"), device="cpu")
    ops = make_ops("torch", str(tmp_path), client=client)
    ops.save_flow(make_gui("ProcFlow"))
    res = ops.generate_configs("ProcFlow")
    assert res.ok, res.errors
    [job] = ops.start_jobs("ProcFlow", batches=2)
    job = ops.jobs.wait_for_state(job["name"], ("success", "error"), timeout_s=180)
    with open(tmp_path / "logs" / f"{job['name']}.log", encoding="utf-8") as f:
        log = f.read()
    assert job["state"] == "success", log[-2000:]
    batches = chip_smoke.host_batch_metrics(log)
    assert [m["Input_DataXProcessedInput_Events_Count"] for m in batches] == [100.0, 100.0]
    assert chip_smoke.HOST_START_LINE.search(log).group(1) == "cpu"
