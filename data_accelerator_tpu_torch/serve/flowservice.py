"""Flow lifecycle public service: save, generate, start/stop/restart.

reference: DataX.Config/PublicService/{FlowOperation,JobOperation}.cs —
``SaveFlowConfig`` (FlowOperation.cs:112) builds/merges the flow doc and
upserts design-time storage; ``GenerateConfigs`` runs the S100–S900
chain; ``StartJobsForFlow``/``StopJobsForFlow``/``RestartJobsForFlow``
(FlowOperation.cs:158+) fan out to SparkJobOperation per job name;
``ScheduleBatch`` (FlowOperation.cs:88) registers batch rounds. The
DeleteHelper cascade (DataX.Flow.DeleteHelper) is ``delete_flow``.

Copy of the JAX package's ``serve/flowservice.py`` over the port's
tiers. ``FlowOperation`` takes ``device`` (default ``"cuda"``): the
default fleet spec is that device's machine, and the default
``LocalJobClient`` spawns hosts on it.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from .flowbuilder import FlowConfigBuilder
from .generation import GenerationResult, RuntimeConfigGeneration
from .jobs import (
    FleetAdmissionGate,
    JobOperation,
    JobState,
    LocalJobClient,
    TpuJobClient,
)
from .scheduler import PlacementReplanner
from .storage import DesignTimeStorage, JobRegistry, LocalRuntimeStorage

logger = logging.getLogger(__name__)


class FlowOperation:
    """The control plane's front door (one per service process)."""

    def __init__(
        self,
        design_storage: DesignTimeStorage,
        runtime_storage: LocalRuntimeStorage,
        job_client: Optional[TpuJobClient] = None,
        env_tokens: Optional[dict] = None,
        fleet_spec=None,
        fleet_admission: bool = True,
        device: str = "cuda",
    ):
        self.design = design_storage
        self.runtime = runtime_storage
        # where jobs run and whose machine the default fleet spec is
        self.device = device
        self.builder = FlowConfigBuilder()
        self.generation = RuntimeConfigGeneration(
            design_storage, runtime_storage, env_tokens=env_tokens,
            device=device,
        )
        self.registry: JobRegistry = self.generation.jobs
        # fleet placement as an admission gate: every job submit is
        # checked against the DX4xx analyzer before a process spawns
        # (``fleet_admission=False`` runs the reference's blind-deploy
        # behavior; ``fleet_spec`` is an ``analysis.FleetSpec``)
        self.fleet_gate: Optional[FleetAdmissionGate] = None
        self.placement: Optional[PlacementReplanner] = None
        if fleet_admission:
            self.fleet_gate = FleetAdmissionGate(
                design_storage, self.registry, spec=fleet_spec, device=device
            )
            self.placement = PlacementReplanner(self.fleet_gate)
        self.jobs = JobOperation(
            self.registry,
            job_client or LocalJobClient(
                log_dir=runtime_storage.resolve("logs"), device=device
            ),
            admission_gate=self.fleet_gate,
            replanner=self.placement,
        )

    # -- design-time -----------------------------------------------------
    def save_flow(self, gui: dict) -> dict:
        """reference: FlowOperation.SaveFlowConfig (FlowOperation.cs:112)."""
        name = gui.get("name")
        existing = self.design.get_by_name(name) if name else None
        doc = self.builder.build(gui, existing=existing)
        return self.design.save(doc)

    def get_flow(self, name: str) -> Optional[dict]:
        return self.design.get_by_name(name)

    def get_all_flows(self) -> List[dict]:
        return self.design.get_all()

    def validate_flow(self, flow: dict):
        """Static analysis over a flow config (gui JSON or full doc) —
        the same implementation the CLI runs, so the ``validate``
        endpoint and ``python -m data_accelerator_tpu_torch.analysis`` can
        never drift. Returns an ``analysis.AnalysisReport``. (Imported
        lazily: analysis reuses serve.flowbuilder for rule expansion.)"""
        from ..analysis import analyze_flow

        return analyze_flow(flow)

    def validate_flow_device(self, flow: dict, chips=None):
        """The device tier of ``flow/validate`` (``device: true``):
        abstract interpretation of the compiled plan — per-stage
        HBM/FLOP cost report plus the DX2xx capacity lints. Same
        implementation as the CLI's ``--device``; no device executes."""
        from ..analysis import analyze_flow_device

        return analyze_flow_device(flow, chips=chips)

    def validate_flow_udfs(self, flow: dict):
        """The UDF tier of ``flow/validate`` (``udfs: true``): every
        declared UDF/UDAF resolves through the production loader and
        its device functions are abstract-interpreted under the taint
        lattice — the DX3xx tracing-safety/purity/determinism lints.
        Same implementation as the CLI's ``--udfs``."""
        from ..analysis import analyze_flow_udfs

        return analyze_flow_udfs(flow)

    def validate_flow_compile(self, flow: dict, manifest: Optional[dict] = None):
        """The compile tier of ``flow/validate`` (``compile: true``):
        every entry point the flow will ever dispatch is enumerated and
        evaluated on ``meta`` tensors — the DX6xx
        finiteness/stability lints plus the AOT compile manifest.
        ``manifest`` (body ``compileManifest``) additionally checks a
        previously emitted manifest for drift (DX602/DX603). Same
        implementation as the CLI's ``--compile``; no device executes."""
        from ..analysis import analyze_flow_compile

        return analyze_flow_compile(flow, manifest=manifest)

    def validate_flow_mesh(self, flow: dict, chips=None,
                           spec: Optional[dict] = None):
        """The mesh tier of ``flow/validate`` (``mesh: true``): the
        flow's partition plan over a 1-D data mesh (per-stage shard
        axis, reshard edges, closed-form collective bytes) with the
        DX7xx lints, cross-checked against the census of the flow's mesh
        step run on ``meta`` virtual shards. The per-chip budget is the
        fleet spec's (body ``fleetSpec``; unset keys from this
        service's device), as the fleet tier's. Same implementation as
        the CLI's ``--mesh``; no device executes."""
        from ..analysis import FleetSpec, analyze_flow_mesh

        return analyze_flow_mesh(
            flow, chips=chips,
            spec=FleetSpec.from_dict(spec or {}, device=self.device),
        )

    def validate_flow_race(self, flow: dict):
        """The race tier of ``flow/validate`` (``race: true``): the
        DX8xx buffer-lifetime/concurrency gate over the ENGINE modules
        the flow would deploy onto (``runtime/``, ``lq/``, ``pilot/``)
        — a provenance-lattice abstract interpretation of the runtime's
        own source, cached per engine-source state. Same implementation
        as the CLI's ``--race``; nothing executes."""
        from ..analysis import analyze_flow_race

        return analyze_flow_race(flow)

    def validate_flow_protocol(self, flow: dict):
        """The protocol tier of ``flow/validate`` (``protocol: true``):
        the DX90x exactly-once delivery gate over the engine modules
        plus the rescale handoff (``serve/jobs.py``) — typed effect
        traces checked against the declared ordering spec, cached per
        engine-source state. Same implementation as the CLI's
        ``--protocol``; nothing executes."""
        from ..analysis import analyze_flow_protocol

        return analyze_flow_protocol(flow)

    def validate_flow_conf(self, flow: dict):
        """The conf tier of ``flow/validate`` (``conf: true``): the
        DX10xx configuration-lattice gate — engine conf read sites and
        generation-produced keys checked against the typed registry
        (``analysis/confspec.py``), plus type/bounds (DX1004) and
        incompatible-knob (DX1005) checks on THIS flow's effective
        conf. Cached per engine-source state. Same implementation as
        the CLI's ``--conf``; nothing executes."""
        from ..analysis import analyze_flow_conf

        return analyze_flow_conf(flow)

    def validate_flow_fleet(self, flow: dict, spec: Optional[dict] = None):
        """The fleet tier of ``flow/validate`` (``fleet: true``): the
        candidate flow is analyzed AS A SET with every currently
        registered flow against the fleet spec (body ``fleetSpec``
        overrides the default) — the DX4xx capacity/interference lints
        plus the placement plan. Same analyzer the CLI's ``--fleet``
        and the job-submission admission gate run."""
        from ..analysis import FleetSpec, analyze_fleet_flows

        gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
        name = (gui or {}).get("name")
        # a re-save of an existing flow competes with the OTHER flows,
        # not its own registered copy
        others = [
            d for d in self.design.get_all() if d.get("name") != name
        ]
        return analyze_fleet_flows(
            [flow] + others,
            spec=FleetSpec.from_dict(spec or {}, device=self.device),
        )

    def generate_configs(self, flow_name: str) -> GenerationResult:
        doc = self.design.get_by_name(flow_name)
        if doc is not None:
            # deploy gate: a flow whose OUTPUT routes a dataset no
            # transform produces would generate and start a job that
            # produces nothing — fail here with the analyzer's
            # unbound-reference diagnostic instead. Fail-open: an
            # analyzer crash must not block generation (generation has
            # its own validation stages).
            try:
                report = self.validate_flow(doc)
            except Exception:  # noqa: BLE001
                logger.exception("flow validation failed for %s", flow_name)
            else:
                unbound = [d for d in report.errors if d.code == "DX003"]
                if unbound:
                    return GenerationResult(
                        flow_name, errors=[d.render() for d in unbound]
                    )
        return self.generation.generate(flow_name)

    # -- runtime ---------------------------------------------------------
    def _flow_job_names(self, flow_name: str) -> List[str]:
        doc = self.design.get_by_name(flow_name)
        if not doc:
            raise KeyError(f"flow '{flow_name}' not found")
        names = doc.get("jobNames") or []
        if not names:
            raise ValueError(
                f"flow '{flow_name}' has no generated jobs; run generateconfigs"
            )
        return names

    def start_jobs(self, flow_name: str, batches: Optional[int] = None) -> List[dict]:
        return [
            self.jobs.start_job_with_retries(n, batches=batches)
            for n in self._flow_job_names(flow_name)
        ]

    def stop_jobs(self, flow_name: str) -> List[dict]:
        return [
            self.jobs.stop_job_with_retries(n)
            for n in self._flow_job_names(flow_name)
        ]

    def restart_jobs(self, flow_name: str, batches: Optional[int] = None) -> List[dict]:
        return [
            self.jobs.restart_job(n, batches=batches)
            for n in self._flow_job_names(flow_name)
        ]

    def sync_jobs(self, flow_name: Optional[str] = None) -> List[dict]:
        if flow_name is None:
            return self.jobs.sync_all()
        return [self.jobs.sync_job_state(n) for n in self._flow_job_names(flow_name)]

    def schedule_batch(self, flow_name: str) -> List[dict]:
        """Trigger one batch round for a batch-mode flow
        (reference: FlowOperation.ScheduleBatch, FlowOperation.cs:88 —
        recurring scheduling is the TimedScheduler's job)."""
        res = self.generate_configs(flow_name)
        if not res.ok:
            raise RuntimeError(f"generateconfigs failed: {res.errors}")
        return self.start_jobs(flow_name)

    # -- delete cascade --------------------------------------------------
    def delete_flow(self, flow_name: str) -> bool:
        """Stop jobs, drop runtime artifacts + job records + flow doc
        (reference: DataX.Flow.DeleteHelper cascade)."""
        doc = self.design.get_by_name(flow_name)
        if doc is None:
            return False
        for job_name in doc.get("jobNames") or []:
            try:
                self.jobs.stop_job_with_retries(job_name)
            except Exception:  # noqa: BLE001 — best-effort stop during delete
                logger.warning("failed stopping job %s during delete", job_name)
            self.registry.delete(job_name)
        self.runtime.delete_all(flow_name)
        return self.design.delete(flow_name)
