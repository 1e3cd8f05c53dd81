"""Job lifecycle: submit/stop/sync engine jobs on GPU hosts.

reference: DataX.Config's job layer —
- ``ISparkJobClient`` (DataX.Config/Client/ISparkJobClient.cs): the
  cluster-client interface (submit/stop/get state) with Livy, Databricks
  and local spark-submit implementations -> ``TpuJobClient`` here, with
  ``LocalJobClient`` spawning the streaming host as a child process
  (DataX.Config.Local/LocalSparkClient.cs:18-180 semantics: process
  handle is the job id, state from process liveness).
- ``SparkJobOperation`` (InternalService/SparkJobOperation.cs:42-268):
  start/stop/restart with bounded retries + state sync against the
  client -> ``JobOperation``.
- ``JobState`` (InternalService/JobState.cs): Idle/Starting/Running/
  Success/Error.

TPU flavor: a "cluster" is a set of TPU-VM hosts running the engine
process; the local client covers the one-box and single-host cases, and
the same interface carries a gRPC/SSH remote client for pods.

Copy of the JAX package's ``serve/jobs.py`` over the port's modules,
with these changes. ``LocalJobClient`` spawns the port's host (``python
-m data_accelerator_tpu_torch.runtime.host``) and appends ``device=cpu``
only when the control plane runs on the CPU. ``FleetAdmissionGate``'s
default spec is the port's fleet default, the machine's cards and a
card's memory (or one CPU device when asked), not a TPU fleet.
``K8sJobClient`` renders the port's own GPU Job manifest
(``serve/k8s/gpu-job.yaml``): it asks for as many ``nvidia.com/gpu`` as
the job's conf has ``process.numchips`` (one by default), its
accelerator override is the GPU pool's node label, and its topology
selector is GPU Feature Discovery's ``nvidia.com/gpu.count`` node label
(the cards one node holds, NVLink-joined on an HGX board), where the
reference selects a TPU slice's topology.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..obs import tracing
from .storage import JobRegistry

logger = logging.getLogger(__name__)


class JobState:
    Idle = "idle"
    Starting = "starting"
    Running = "running"
    Success = "success"
    Error = "error"


# ---------------------------------------------------------------------------
# Fleet admission gate: the DX4xx analyzer as a runtime input
# ---------------------------------------------------------------------------
# the DX4xx codes that REJECT a submit: capacity infeasibility and the
# interference classes that corrupt state/streams (warnings — headroom,
# bandwidth, series/port conflicts — admit but surface in the record)
ADMISSION_GATE_CODES = ("DX400", "DX401", "DX410", "DX411")


class FleetAdmissionError(RuntimeError):
    """A job submit the fleet analyzer rejected. Carries the gating
    diagnostics; NOT retried by ``JobOperation._with_retries`` (the
    fleet state that rejected it does not change by retrying)."""

    def __init__(self, job_name: str, diagnostics):
        self.job_name = job_name
        self.diagnostics = list(diagnostics)
        super().__init__(
            f"job '{job_name}' rejected by fleet admission: "
            + "; ".join(d.render() for d in self.diagnostics)
        )


class FleetAdmissionGate:
    """Consults ``analysis/fleetcheck.py`` at job submission: the
    candidate flow is analyzed against every flow with running jobs,
    and a submit that would trigger DX400/DX401/DX410/DX411 is rejected
    with the diagnostic BEFORE any process spawns. The accepted
    placement (flow -> chip) is written onto the job record, and
    ``Fleet_*`` metrics (constants.MetricName) export the packed fleet
    state on every check/re-plan.

    The reference's cluster clients deployed blind (SURVEY §1 L3 —
    oversubscription was discovered by watching jobs die); this gate is
    the cost model, used as a runtime input.
    """

    def __init__(
        self,
        design_storage,
        registry: JobRegistry,
        spec=None,
        metric_logger=None,
        device: str = "cuda",
    ):
        self.design = design_storage
        self.registry = registry
        self._spec = spec  # analysis.FleetSpec | None (default)
        # whose machine the default spec describes: its cards, or one
        # CPU device when the control plane runs on the CPU
        self.device = device
        self._metrics = metric_logger
        self.rejected_count = 0
        # flow name -> (flow-doc fingerprint, FlowFootprint): device
        # analysis per flow is the expensive step, so footprints are
        # cached and invalidated by config content
        self._footprints: Dict[str, tuple] = {}

    @property
    def spec(self):
        if self._spec is None:
            from ..analysis import FleetSpec

            self._spec = FleetSpec(device=self.device)
        return self._spec

    @property
    def metrics(self):
        if self._metrics is None:
            from ..obs.metrics import MetricLogger

            self._metrics = MetricLogger("DATAX-Fleet")
        return self._metrics

    # -- footprints ------------------------------------------------------
    def _footprint(self, name: str, doc: dict):
        from ..analysis import flow_footprint

        gui = doc.get("gui") if isinstance(doc.get("gui"), dict) else doc
        fingerprint = json.dumps(gui, sort_keys=True, default=str)
        cached = self._footprints.get(name)
        if cached is not None and cached[0] == fingerprint:
            return cached[1]
        fp = flow_footprint(doc, name=name)
        self._footprints[name] = (fingerprint, fp)
        return fp

    def _active_flow_names(self, exclude_flow: Optional[str] = None):
        names = []
        for rec in self.registry.get_all():
            if rec.get("state") not in (JobState.Running, JobState.Starting):
                continue
            flow = rec.get("flow")
            if not flow or flow == exclude_flow or flow in names:
                continue
            names.append(flow)
        return names

    # -- planning --------------------------------------------------------
    def plan(self, candidate_doc: Optional[dict] = None,
             exclude_flow: Optional[str] = None):
        """Fleet report over the flows with running jobs, optionally
        plus a candidate flow (excluded from the active set by name so
        a restart competes against the OTHERS, not its own old slot)."""
        from ..analysis import analyze_fleet

        footprints = []
        if candidate_doc is not None:
            footprints.append(self._footprint(exclude_flow or "", candidate_doc))
        for name in self._active_flow_names(exclude_flow=exclude_flow):
            doc = self.design.get_by_name(name)
            if doc is not None:
                footprints.append(self._footprint(name, doc))
        report = analyze_fleet(footprints, spec=self.spec)
        self._export_metrics(report)
        return report

    # -- the gate --------------------------------------------------------
    def admit(self, job: dict) -> dict:
        """Check one job's flow against the current fleet. On rejection
        the registry record carries the reason and a
        ``FleetAdmissionError`` raises before any process spawns; on
        admission the record carries the accepted placement."""
        flow_name = job.get("flow")
        doc = self.design.get_by_name(flow_name) if flow_name else None
        if doc is None:
            return job  # no flow doc to analyze (bare job record)
        with tracing.span("admission", job=job.get("name"), flow=flow_name):
            return self._admit_traced(job, doc, flow_name)

    def _admit_traced(self, job: dict, doc: dict, flow_name: str) -> dict:
        with tracing.span("placement"):
            report = self.plan(candidate_doc=doc, exclude_flow=flow_name)
        gating = [
            d for d in report.diagnostics
            if d.code in ADMISSION_GATE_CODES
            and (not d.table or flow_name in d.table.split("/"))
        ]
        if gating:
            self.rejected_count += 1
            job["admission"] = {
                "admitted": False,
                "codes": [d.code for d in gating],
                "reason": "; ".join(d.render() for d in gating),
            }
            self.registry.upsert(job)
            self.metrics.send_metric(
                "Fleet_AdmissionRejected_Count", self.rejected_count
            )
            raise FleetAdmissionError(job["name"], gating)
        chip = report.placement.chip_of(flow_name)
        fp = next(
            (f for f in report.footprints if f.name == flow_name), None
        )
        assignment = next(
            (c for c in report.placement.chips if c.chip == chip), None
        )
        job["admission"] = {"admitted": True, "codes": []}
        job["placement"] = {
            "chip": chip,
            "hbmBytes": fp.hbm_bytes if fp else None,
            "chipHbmBytes": assignment.hbm_bytes if assignment else None,
            "headroom": round(1 - assignment.utilization(self.spec), 6)
            if assignment else None,
            "fleetChips": self.spec.chips,
        }
        return job

    def admit_replicas(self, job: dict, count: int) -> None:
        """Vet an in-place rescale: would ``count`` replicas of this
        job's flow still pack onto the fleet? Replicas of ONE flow
        intentionally share checkpoint dirs / consumer groups / metric
        series (that's what makes them a competing-consumer group), so
        only the CAPACITY codes gate here — DX400/DX401 over ``count``
        copies of the flow's footprint plus every other active flow.
        Raises ``FleetAdmissionError`` BEFORE any process spawns."""
        import dataclasses

        flow_name = job.get("flow")
        doc = self.design.get_by_name(flow_name) if flow_name else None
        if doc is None or count <= 1:
            return
        from ..analysis import analyze_fleet

        base = self._footprint(flow_name, doc)
        footprints = [base] + [
            dataclasses.replace(
                base, name=f"{flow_name}~r{i}",
                # suffixed shadow footprints drop the shared-resource
                # claims so the interference lints don't see the
                # intentional sharing as cross-flow collisions
                dirs=set(), consumer_keys=set(), metric_series=set(),
                obs_port=None,
            )
            for i in range(2, count + 1)
        ]
        for name in self._active_flow_names(exclude_flow=flow_name):
            other = self.design.get_by_name(name)
            if other is not None:
                footprints.append(self._footprint(name, other))
        with tracing.span("rescale/placement", flow=flow_name, count=count):
            report = analyze_fleet(footprints, spec=self.spec)
        self._export_metrics(report)
        gating = [
            d for d in report.diagnostics
            if d.code in ("DX400", "DX401")
            and (not d.table or flow_name in d.table.split("/")
                 or any(f"{flow_name}~r" in part
                        for part in d.table.split("/")))
        ]
        if gating:
            self.rejected_count += 1
            job["rescale"] = {
                "requested": count,
                "admitted": False,
                "codes": [d.code for d in gating],
                "reason": "; ".join(d.render() for d in gating),
            }
            self.registry.upsert(job)
            self.metrics.send_metric(
                "Fleet_AdmissionRejected_Count", self.rejected_count
            )
            raise FleetAdmissionError(job["name"], gating)
        job["rescale"] = {"requested": count, "admitted": True, "codes": []}
        self.registry.upsert(job)

    def replan(self):
        """Recompute placement over the currently running flows (freed
        capacity becomes reusable) and refresh every active job
        record's ``placement``. Called by the scheduler's
        ``PlacementReplanner`` on job stop/start."""
        report = self.plan()
        by_chip = {
            name: c for c in report.placement.chips for name in c.flows
        }
        for rec in self.registry.get_all():
            flow = rec.get("flow")
            if flow not in by_chip or rec.get("state") not in (
                JobState.Running, JobState.Starting,
            ):
                continue
            c = by_chip[flow]
            rec["placement"] = {
                "chip": c.chip,
                "hbmBytes": next(
                    (f.hbm_bytes for f in report.footprints
                     if f.name == flow), None
                ),
                "chipHbmBytes": c.hbm_bytes,
                "headroom": round(1 - c.utilization(self.spec), 6),
                "fleetChips": self.spec.chips,
            }
            self.registry.upsert(rec)
        return report

    # -- metrics ---------------------------------------------------------
    def _export_metrics(self, report) -> None:
        try:
            plan = report.placement
            placed = sum(len(c.flows) for c in plan.chips)
            unplaced = (
                len(plan.unplaced) + len(plan.oversized)
                + len(plan.unanalyzed)
            )
            m = {
                "Fleet_Chips": self.spec.chips,
                "Fleet_FlowsPlaced": placed,
                "Fleet_FlowsUnplaced": unplaced,
                "Fleet_MaxChipUtilization": max(
                    (c.utilization(self.spec) for c in plan.chips),
                    default=0.0,
                ),
            }
            for c in plan.chips:
                if c.flows:
                    m[f"Fleet_Chip{c.chip}_HbmBytes"] = c.hbm_bytes
                    m[f"Fleet_Chip{c.chip}_Utilization"] = (
                        c.utilization(self.spec)
                    )
            self.metrics.send_batch_metrics(m)
        except Exception:  # noqa: BLE001 — metrics must never gate a job
            logger.exception("fleet metric export failed")


class TpuJobClient:
    """Cluster-client interface (ISparkJobClient analog)."""

    def submit(self, job: dict) -> dict:
        """Start the job; returns updated job record (clientId, state)."""
        raise NotImplementedError

    def stop(self, job: dict) -> dict:
        raise NotImplementedError

    def get_state(self, job: dict) -> str:
        raise NotImplementedError


class LocalJobClient(TpuJobClient):
    """Runs each job as a local engine process.

    reference: LocalSparkClient.cs:21,112-140 — spark-submit with
    ``--master local[*]``, pid tracked in the job record, state derived
    from process table. Here: ``python -m
    data_accelerator_tpu_torch.runtime.host conf=<path>`` with optional
    env overrides, plus ``device=cpu`` when ``device`` is the CPU (the
    host runs on the card otherwise).
    """

    def __init__(self, log_dir: Optional[str] = None, env: Optional[dict] = None,
                 device: str = "cuda"):
        self.log_dir = log_dir
        self.env = env or {}
        self.device = device
        self._procs: Dict[str, subprocess.Popen] = {}

    def submit(self, job: dict) -> dict:
        name = job["name"]
        conf_path = job["confPath"]
        cmd = [
            sys.executable, "-m", "data_accelerator_tpu_torch.runtime.host",
            f"conf={conf_path}",
        ]
        if self.device == "cpu":
            cmd.append("device=cpu")
        if job.get("batches"):
            cmd.append(f"batches={job['batches']}")
        if job.get("parentTrace"):
            # cross-process trace propagation: the spawned host's batch
            # traces JOIN the control-plane request trace (CLI key=value
            # args merge into the conf dictionary, ConfigManager)
            cmd.append(
                "datax.job.process.telemetry.parenttrace="
                f"{job['parentTrace']}"
            )
        for k, v in (job.get("confOverrides") or {}).items():
            # per-replica conf overrides (same key=value contract): the
            # rescale path passes each replica its state partition
            # assignment (process.state.replicaindex/replicacount)
            cmd.append(f"{k}={v}")
        env = {**os.environ, **self.env}
        stdout = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = open(os.path.join(self.log_dir, f"{name}.log"), "ab")
        try:
            proc = subprocess.Popen(
                cmd, stdout=stdout, stderr=subprocess.STDOUT, env=env,
                start_new_session=True,
            )
        finally:
            if stdout is not subprocess.DEVNULL:
                stdout.close()  # child keeps its inherited fd
        self._procs[name] = proc
        job["clientId"] = proc.pid
        job["state"] = JobState.Starting
        logger.info("submitted job %s pid=%d conf=%s", name, proc.pid, conf_path)
        return job

    def _proc(self, job: dict) -> Optional[subprocess.Popen]:
        return self._procs.get(job["name"])

    def stop(self, job: dict) -> dict:
        # forget the process so a later get_state doesn't read the
        # SIGTERM exit code as a job failure
        proc = self._procs.pop(job["name"], None)
        pid = job.get("clientId")
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        elif pid:
            # job from a previous service instance: signal by pid
            try:
                os.kill(int(pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        job["state"] = JobState.Idle
        job["clientId"] = None
        return job

    def get_state(self, job: dict) -> str:
        proc = self._proc(job)
        if proc is not None:
            rc = proc.poll()
            if rc is None:
                return JobState.Running
            return JobState.Success if rc == 0 else JobState.Error
        pid = job.get("clientId")
        if pid:
            try:
                os.kill(int(pid), 0)
                return JobState.Running
            except (ProcessLookupError, PermissionError):
                return JobState.Error
        return job.get("state") or JobState.Idle


# the node label GKE puts on a GPU pool's nodes
GPU_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
# the node label NVIDIA GPU Feature Discovery puts on a GPU node: the
# number of cards it holds (a topology selector places a multi-card job
# on a node of that many NVLink-joined cards)
GPU_TOPOLOGY_LABEL = "nvidia.com/gpu.count"


class K8sJobClient(TpuJobClient):
    """Submits flow jobs as Kubernetes Jobs on a GPU node pool.

    The cluster-submission role Livy/Databricks REST plays for the
    reference (DataX.Config.LivyClient/LivyClient.cs:81-94 submit/poll/
    delete of cluster batches; state mapping per
    InternalService/SparkJobOperation.cs:42-268): render the
    ``serve/k8s/gpu-job.yaml`` manifest for the flow, POST it to the
    k8s batch API, derive JobState from the Job's status counts, DELETE
    (foreground propagation) to stop.

    Auth follows the in-cluster convention: bearer token from
    ``token``/``token_file`` (defaults to the service-account token
    path). ``http`` is the transport — ``(method, url, body|None) ->
    (status_code, parsed_json)`` — injectable for tests and for custom
    TLS setups.
    """

    TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"

    def __init__(
        self,
        api_server: str,
        namespace: str = "default",
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        image: str = "dxtpu-torch:latest",
        manifest_path: Optional[str] = None,
        http=None,
        insecure: bool = False,
        accelerator: Optional[str] = None,
        topology: Optional[str] = None,
    ):
        self.api_server = api_server.rstrip("/")
        self.namespace = namespace
        self.image = image
        # GPU placement overrides for the rendered Job (the template's
        # nodeSelector value is the H100 default)
        self.accelerator = accelerator
        self.topology = topology
        self.manifest_path = manifest_path or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "k8s", "gpu-job.yaml",
        )
        self._token = token
        self._token_file = token_file
        self.insecure = insecure
        self._http = http or self._urllib_http

    # -- transport -------------------------------------------------------
    def _bearer(self) -> Optional[str]:
        if self._token:
            return self._token
        path = self._token_file or self.TOKEN_PATH
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                return f.read().strip()
        return None

    def _urllib_http(self, method: str, url: str, body: Optional[dict]):
        import ssl
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        req.add_header("Accept", "application/json")
        tok = self._bearer()
        if tok:
            req.add_header("Authorization", f"Bearer {tok}")
        ctx = ssl._create_unverified_context() if self.insecure else None
        try:
            with urllib.request.urlopen(req, context=ctx, timeout=30) as r:
                return r.status, json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read().decode() or "{}")
            except ValueError:
                payload = {}
            return e.code, payload

    # -- manifest --------------------------------------------------------
    def _k8s_name(self, job: dict) -> str:
        safe = "".join(
            c if c.isalnum() or c == "-" else "-" for c in job["name"].lower()
        ).strip("-")
        return f"dxtpu-job-{safe}"

    @staticmethod
    def _label_safe(value: str) -> str:
        """k8s label-value charset ([A-Za-z0-9._-], alnum ends, <=63) —
        also what makes the raw-text FLOWNAME/JOBNAME substitution safe
        against YAML metacharacters in user-authored flow names."""
        safe = "".join(
            c if c.isalnum() or c in "._-" else "-" for c in value
        )[:63]
        return safe.strip("._-") or "flow"

    def render_manifest(self, job: dict) -> dict:
        """serve/k8s/gpu-job.yaml with FLOWNAME/JOBNAME substituted —
        the manifest IS the submission payload (no drift between the
        documented shape and what the client sends). The container asks
        for the cards the job's conf runs on (the record's ``numChips``,
        written by generation's S800; 1 for a record without one)."""
        import yaml

        with open(self.manifest_path, encoding="utf-8") as f:
            text = f.read()
        flow = self._label_safe(job.get("flowName") or job["name"])
        text = text.replace("FLOWNAME", flow).replace(
            "JOBNAME", self._label_safe(job["name"])
        )
        manifest = yaml.safe_load(text)
        manifest["metadata"]["name"] = self._k8s_name(job)
        manifest["metadata"].setdefault("labels", {})["job"] = (
            self._label_safe(job["name"])
        )
        pod = manifest["spec"]["template"]["spec"]
        if self.accelerator or self.topology:
            sel = pod.setdefault("nodeSelector", {})
            if self.accelerator:
                sel[GPU_ACCELERATOR_LABEL] = self.accelerator
            if self.topology:
                sel[GPU_TOPOLOGY_LABEL] = self.topology
        container = pod["containers"][0]
        container["image"] = self.image
        container.setdefault("resources", {}).setdefault("limits", {})[
            "nvidia.com/gpu"] = str(job.get("numChips") or 1)
        if job.get("confPath"):
            container["args"] = [f"conf={job['confPath']}"]
        # append unconditionally (the template always carries an
        # explicit command, so args never shadow an image CMD): a
        # manifest without args must NOT silently drop the replica's
        # partition assignment — a pod running with the default
        # replicaindex=1/replicacount=1 owns every partition and
        # duplicates the rest of the group's processing
        args = container.setdefault("args", [])
        if job.get("batches"):
            args.append(f"batches={job['batches']}")
        if job.get("parentTrace"):
            # same key=value conf-override contract as the local client
            args.append(
                "datax.job.process.telemetry.parenttrace="
                f"{job['parentTrace']}"
            )
        for k, v in (job.get("confOverrides") or {}).items():
            args.append(f"{k}={v}")
        return manifest

    def _jobs_url(self, name: Optional[str] = None) -> str:
        base = (
            f"{self.api_server}/apis/batch/v1/namespaces/"
            f"{self.namespace}/jobs"
        )
        return f"{base}/{name}" if name else base

    # -- TpuJobClient ----------------------------------------------------
    def submit(self, job: dict) -> dict:
        manifest = self.render_manifest(job)
        status, body = self._http("POST", self._jobs_url(), manifest)
        if status == 409:
            # already exists: delete the finished run, then resubmit
            # (Livy parity: a batch id is single-use; k8s Jobs likewise)
            self._delete(self._k8s_name(job))
            self._wait_gone(self._k8s_name(job))
            status, body = self._http("POST", self._jobs_url(), manifest)
        if status not in (200, 201, 202):
            raise RuntimeError(
                f"k8s job submit failed ({status}): "
                f"{body.get('message', body)}"
            )
        job["clientId"] = self._k8s_name(job)
        job["state"] = JobState.Starting
        logger.info(
            "submitted k8s job %s as %s", job["name"], job["clientId"]
        )
        return job

    def _delete(self, k8s_name: str):
        return self._http(
            "DELETE",
            self._jobs_url(k8s_name),
            {"propagationPolicy": "Foreground"},
        )

    def _wait_gone(self, k8s_name: str, timeout_s: float = 30):
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            status, _ = self._http("GET", self._jobs_url(k8s_name), None)
            if status == 404:
                return
            time.sleep(0.5)

    def stop(self, job: dict) -> dict:
        name = job.get("clientId") or self._k8s_name(job)
        status, body = self._delete(name)
        if status not in (200, 202, 404):
            raise RuntimeError(
                f"k8s job delete failed ({status}): "
                f"{body.get('message', body)}"
            )
        job["state"] = JobState.Idle
        job["clientId"] = None
        return job

    def get_state(self, job: dict) -> str:
        name = job.get("clientId") or self._k8s_name(job)
        status, body = self._http("GET", self._jobs_url(name), None)
        if status == 404:
            return job.get("state") if job.get("state") in (
                JobState.Idle, JobState.Success, JobState.Error
            ) else JobState.Idle
        if status != 200:
            raise RuntimeError(f"k8s job get failed ({status})")
        s = body.get("status", {}) or {}
        # the Job controller's conditions are the authoritative terminal
        # signal: a crash-looping pod under restartPolicy OnFailure may
        # exhaust retries without status.failed ever exceeding
        # backoffLimit, so counting alone never surfaces the failure
        for cond in s.get("conditions") or []:
            if str(cond.get("status")).lower() != "true":
                continue
            if cond.get("type") == "Failed":
                return JobState.Error
            if cond.get("type") == "Complete":
                return JobState.Success
        if s.get("active"):
            return JobState.Running
        if s.get("succeeded"):
            return JobState.Success
        return JobState.Starting  # created/retrying, not yet terminal


def make_job_client(conf: Optional[dict] = None, log_dir: Optional[str] = None,
                    device: str = "cuda"):
    """Client factory keyed by conf — the role the reference's client
    factory plays choosing Livy vs Databricks vs local
    (DataX.Config/ConfigGenConfiguration SparkType switch)."""
    conf = conf or {}
    kind = (conf.get("type") or "local").lower()
    if kind == "local":
        return LocalJobClient(log_dir=log_dir, env=conf.get("env"), device=device)
    if kind in ("k8s", "kubernetes"):
        return K8sJobClient(
            api_server=conf.get("apiserver")
            or "https://kubernetes.default.svc",
            namespace=conf.get("namespace", "default"),
            token=conf.get("token"),
            token_file=conf.get("tokenfile"),
            image=conf.get("image", "dxtpu-torch:latest"),
            manifest_path=conf.get("manifest"),
            insecure=str(conf.get("insecure", "")).lower() == "true",
            accelerator=conf.get("accelerator"),
            topology=conf.get("topology"),
        )
    raise ValueError(f"unknown job client type {kind!r}")


class JobOperation:
    """Start/stop/restart with bounded retries + state sync.

    reference: SparkJobOperation.cs:42-268 (StartJobWithRetries /
    StopJobWithRetries / RestartJob / SyncJobState / SyncAllJobState).
    """

    def __init__(
        self,
        registry: JobRegistry,
        client: TpuJobClient,
        retries: int = 3,
        retry_interval_s: float = 0.5,
        admission_gate: Optional[FleetAdmissionGate] = None,
        replanner=None,
    ):
        self.registry = registry
        self.client = client
        self.retries = retries
        self.retry_interval_s = retry_interval_s
        # fleet placement: the admission gate rejects an oversubscribing
        # submit BEFORE the client spawns anything; the replanner
        # (serve/scheduler.py) recomputes placement after stop/start so
        # freed capacity is reusable
        self.admission_gate = admission_gate
        self.replanner = replanner

    def _notify_replanner(self) -> None:
        if self.replanner is not None:
            try:
                self.replanner.on_job_event()
            except Exception:  # noqa: BLE001 — re-plan must not fail ops
                logger.exception("placement re-plan failed")

    # -- state sync ------------------------------------------------------
    def sync_job_state(self, job_name: str) -> dict:
        job = self.registry.get(job_name)
        if job is None:
            raise KeyError(f"job '{job_name}' not found")
        state = self.client.get_state(job)
        if state != job.get("state"):
            job["state"] = state
            self.registry.upsert(job)
        return job

    def sync_all(self) -> List[dict]:
        return [self.sync_job_state(j["name"]) for j in self.registry.get_all()]

    # -- lifecycle -------------------------------------------------------
    def start_job(self, job_name: str, batches: Optional[int] = None) -> dict:
        job = self.sync_job_state(job_name)
        if job["state"] in (JobState.Running, JobState.Starting):
            return job  # idempotent start (reference: StartJob short-circuit)
        if batches:
            job["batches"] = batches
        if self.admission_gate is not None:
            # raises FleetAdmissionError (recording the rejection on the
            # registry record) before the client spawns anything
            job = self.admission_gate.admit(job)
        with tracing.span("submit", job=job_name):
            # hand the active trace position (the REST request's span
            # tree, when the control plane traces) to the spawned host:
            # its batch spans then root under this submit
            parent = tracing.format_parent(tracing.capture())
            if parent is not None:
                job["parentTrace"] = parent
            job = self.client.submit(job)
        self.registry.upsert(job)
        self._notify_replanner()
        return job

    def start_job_with_retries(self, job_name: str, **kw) -> dict:
        return self._with_retries(lambda: self.start_job(job_name, **kw))

    def stop_job(self, job_name: str) -> dict:
        job = self.sync_job_state(job_name)
        if job["state"] not in (JobState.Running, JobState.Starting):
            return job
        job = self.client.stop(job)
        self.registry.upsert(job)
        self._notify_replanner()
        return job

    def stop_job_with_retries(self, job_name: str) -> dict:
        return self._with_retries(lambda: self.stop_job(job_name))

    # -- in-place rescale -------------------------------------------------
    def replica_records(self, job_name: str) -> List[dict]:
        """The job's live replica records (``replicaOf`` == job, state
        running/starting — stopped replicas stay in the registry as
        history, like any stopped job), in replica order."""
        out = [
            r for r in self.registry.get_all()
            if r.get("replicaOf") == job_name
            and r.get("state") in (JobState.Running, JobState.Starting)
        ]
        out.sort(key=lambda r: r.get("replicaIndex") or 0)
        return out

    def job_lineage(self, flow: str) -> List[dict]:
        """A flow's replica lineage for the fleet telemetry plane
        (obs/fleetview.py ``lineage_fn``): the base record plus EVERY
        replica record in the registry — stopped replicas included,
        they are the history a cross-replica trace stitches over — in
        (replicaIndex, name) order with the base's authoritative
        ``statePartitionMap`` attached to each entry. Returns [] for
        unknown flows so the fleet view falls back to frame-derived
        lineage."""
        base = None
        replicas = []
        for r in self.registry.get_all():
            if r.get("name") == flow or (
                r.get("flow") == flow and not r.get("replicaOf")
            ):
                base = r
            elif r.get("replicaOf") == flow or (
                r.get("flow") == flow and r.get("replicaOf")
            ):
                replicas.append(r)
        if base is None and not replicas:
            return []
        pmap = (base or {}).get("statePartitionMap") or {}
        replicas.sort(
            key=lambda r: (r.get("replicaIndex") or 0, r.get("name") or "")
        )
        out = []
        for rec in ([base] if base else []) + replicas:
            idx = rec.get("replicaIndex") or 1
            out.append({
                "replica": rec.get("name"),
                "replicaIndex": idx,
                "replicaOf": rec.get("replicaOf"),
                "state": rec.get("state"),
                "statePartitionsOwned": rec.get("statePartitionsOwned"),
                "partitionMap": pmap.get(str(idx)) or pmap.get(idx),
            })
        return out

    def _state_partition_plan(self, base: dict, replicas: int) -> dict:
        """Compute + persist the state-partition map of the new replica
        set: the admitted rescale plan now CARRIES the partition
        assignment. The map lands on the base job
        record (``statePartitionMap``) and its geometry exports as the
        ``State_Partition_*`` series under DATAX-Fleet; each spawned
        replica receives its contiguous range via conf overrides
        (``process.state.replicaindex``/``replicacount``/``partitions``)
        and pulls exactly those partitions from the snapshot store at
        init — the handoff, not a state loss."""
        from ..runtime.statepartition import (
            DEFAULT_STATE_PARTITIONS,
            partition_map,
            reassigned_partitions,
        )

        partitions = int(
            base.get("statePartitions") or DEFAULT_STATE_PARTITIONS
        )
        old_map = base.get("statePartitionMap") or {}
        new_map = partition_map(replicas, partitions)
        moved = reassigned_partitions(old_map, new_map) if old_map else []
        base["statePartitions"] = partitions
        base["statePartitionMap"] = {
            str(i): parts for i, parts in new_map.items()
        }
        base["statePartitionsReassigned"] = moved
        if self.admission_gate is not None:
            try:
                self.admission_gate.metrics.send_batch_metrics({
                    "State_Partition_Count": float(partitions),
                    "State_Partition_Reassigned_Count": float(len(moved)),
                })
            except Exception:  # noqa: BLE001 — metrics never gate a rescale
                logger.exception("state partition metric export failed")
        return new_map

    @staticmethod
    def _replica_conf_overrides(index: int, count: int,
                                partitions: int) -> Dict[str, str]:
        return {
            "datax.job.process.state.replicaindex": str(index),
            "datax.job.process.state.replicacount": str(count),
            "datax.job.process.state.partitions": str(partitions),
        }

    def _apply_member_assignment(
        self, rec: dict, position: int, count: int, partitions: int,
        pmap: Dict[int, List[int]],
    ) -> dict:
        """Put one PRE-EXISTING group member (the base job at position
        1, surviving replicas after it) onto the new partition map: its
        position's overrides merge into the record and, when the
        effective assignment changed, the member is restarted so the
        running process picks the map up (conf is read at host start).
        Without this the base would keep running replicacount=1 after a
        1->2 scale-up and own EVERY partition alongside the new replica
        — duplicate processing under the key-routed ingest filter and
        both replicas clobbering the same mirror prefixes. The rescale
        only returns once every member runs the same map."""
        from ..runtime.statepartition import DEFAULT_STATE_PARTITIONS

        target = self._replica_conf_overrides(position, count, partitions)
        current = dict(rec.get("confOverrides") or {})
        # what a host with no overrides assumes — a base job started
        # before any rescale carries none, yet already runs this map
        defaults = self._replica_conf_overrides(
            1, 1, DEFAULT_STATE_PARTITIONS
        )
        changed = any(
            current.get(k, defaults[k]) != v for k, v in target.items()
        )
        rec["confOverrides"] = {**current, **target}
        rec["statePartitionsOwned"] = sorted(pmap.get(position, []))
        if changed and rec.get("state") in (
            JobState.Running, JobState.Starting,
        ):
            with tracing.span("rescale/restart", job=rec["name"]):
                rec = self.client.stop(rec)
                self.registry.upsert(rec)
                deadline = time.time() + 10
                while time.time() < deadline and self.client.get_state(
                    rec
                ) in (JobState.Running, JobState.Starting):
                    time.sleep(self.retry_interval_s)
                parent = tracing.format_parent(tracing.capture())
                if parent is not None:
                    rec["parentTrace"] = parent
                rec = self.client.submit(rec)
        self.registry.upsert(rec)
        return rec

    def rescale(self, job_name: str, replicas: int) -> List[dict]:
        """In-place replica scaling — the path a replica-count change
        used to require a stop+start for. ``replicas`` counts the base
        job plus ``<job>-rN`` replica records sharing its conf (a
        competing-consumer group against the same source). Scale-UP is
        vetted by the fleet admission gate BEFORE any process spawns
        (``FleetAdmissionGate.admit_replicas`` — capacity codes over N
        copies of the flow's footprint); scale-DOWN stops the
        highest-numbered replicas first. The admitted plan carries the
        state-partition map (``_state_partition_plan``): EVERY member
        of the new replica set — the base job and surviving replicas
        included, restarted when their assignment changed — runs its
        contiguous partition range as conf overrides, so stateful
        flows hand partitions off instead of losing them (and never
        double-own one). The replanner refreshes placement after every
        change. Returns the live record set (base + replicas)."""
        base = self.sync_job_state(job_name)
        replicas = max(1, int(replicas))
        live = self.replica_records(job_name)
        have = 1 + len(live)
        if replicas > have and self.admission_gate is not None:
            # raises FleetAdmissionError (recording the rejection on
            # the base record) before the client spawns anything AND
            # before the partition plan lands on the record — a
            # rejected scale-up must not persist a map describing a
            # replica set that never materialized
            self.admission_gate.admit_replicas(base, replicas)
        pmap = self._state_partition_plan(base, replicas)
        partitions = int(base["statePartitions"])
        self.registry.upsert(base)
        if replicas < have:
            # stop the highest-numbered replicas first (the base job is
            # never stopped by a rescale — replicas floor at 1), BEFORE
            # survivors re-conf: their orphaned partitions come from
            # the stopped tail, never from a still-running member
            for rec in list(reversed(live))[: have - replicas]:
                rec = self.client.stop(rec)
                self.registry.upsert(rec)
            live = live[: replicas - 1]
        # every pre-existing member adopts the new map before any
        # successor spawns: shrinking ranges first means a partition is
        # at worst transiently unowned, never owned twice
        for position, rec in enumerate([base] + live, start=1):
            self._apply_member_assignment(
                rec, position, replicas, partitions, pmap
            )
        if replicas > have:
            taken = {r.get("replicaIndex") for r in live}
            idx = 2
            for i in range(replicas - have):
                while idx in taken:
                    idx += 1
                taken.add(idx)
                # the i-th new replica takes position have+1+i in the
                # final set — its contiguous partition range under pmap
                position = have + 1 + i
                rec = {
                    "name": f"{job_name}-r{idx}",
                    "flow": base.get("flow"),
                    "confPath": base.get("confPath"),
                    "replicaOf": job_name,
                    "replicaIndex": idx,
                    "state": JobState.Idle,
                    "statePartitionsOwned": sorted(pmap.get(position, [])),
                    "confOverrides": self._replica_conf_overrides(
                        position, replicas, partitions
                    ),
                }
                with tracing.span(
                    "rescale/submit", job=rec["name"], of=job_name
                ):
                    parent = tracing.format_parent(tracing.capture())
                    if parent is not None:
                        rec["parentTrace"] = parent
                    rec = self.client.submit(rec)
                self.registry.upsert(rec)
                live.append(rec)
        self._notify_replanner()
        return [base] + self.replica_records(job_name)

    def restart_job(self, job_name: str, batches: Optional[int] = None) -> dict:
        self.stop_job_with_retries(job_name)
        # wait until the client reports not-running before resubmitting
        deadline = time.time() + 10
        while time.time() < deadline:
            if self.sync_job_state(job_name)["state"] not in (
                JobState.Running, JobState.Starting,
            ):
                break
            time.sleep(self.retry_interval_s)
        return self.start_job_with_retries(job_name, batches=batches)

    def wait_for_state(
        self, job_name: str, states, timeout_s: float = 30
    ) -> dict:
        """Poll sync until the job reaches one of ``states``
        (EnsureJobState semantics, SparkJobOperation.cs:229-266)."""
        deadline = time.time() + timeout_s
        job = self.sync_job_state(job_name)
        while job["state"] not in states and time.time() < deadline:
            time.sleep(self.retry_interval_s)
            job = self.sync_job_state(job_name)
        return job

    def _with_retries(self, fn):
        last: Optional[Exception] = None
        for _ in range(self.retries):
            try:
                return fn()
            except FleetAdmissionError:
                # deterministic rejection: the fleet state that refused
                # the job does not change by retrying
                raise
            except Exception as e:  # noqa: BLE001 — retried, then re-raised
                last = e
                logger.warning("job operation failed, retrying: %s", e)
                time.sleep(self.retry_interval_s)
        raise last  # type: ignore[misc]
