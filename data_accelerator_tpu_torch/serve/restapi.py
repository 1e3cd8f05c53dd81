"""Control-plane REST service.

reference: the four DataX.Flow micro-services + gateway, collapsed into
one process (the reference's one-box does the same — Flow.ManagementService
hosts everything in DeploymentLocal/Dockerfile):

- ``api/flow/*``      — Flow.ManagementService
  (FlowManagementController.cs:51-249: save, generateconfigs, get,
  getall, startjobs, stopjobs, restartjobs, schedulebatch, job/*)
- ``api/userqueries/*`` — SqlParser schema + codegen endpoints
  (FlowManagementController.cs:246-301)
- ``api/inputdata/*`` — Flow.SchemaInferenceService
  (SchemaInferenceController.cs:33-52)
- ``api/kernel*``     — Flow.InteractiveQueryService
  (InteractiveQueryController.cs:33-171)
- role gate          — DataX.Gateway role/whitelist check
  (GatewayController.cs:113-148): callers present roles in the
  ``X-DataX-Roles`` header; writer endpoints need the writer role.

Responses use the DataX.Contract ApiResult envelope:
``{"result": ...}`` on success, ``{"error": {"message": ...}}`` on
failure. Run: ``python -m data_accelerator_tpu_torch.serve [port=5000]``.

Copy of the JAX package's ``serve/restapi.py`` over the port's
``KernelService``, ``LiveQueryService``, ``SchemaInferenceManager``,
``SqlAnalyzer`` and ``CodegenEngine``, with the same route table.
``DataXApi`` takes ``device`` (default ``"cuda"``) for the kernel pool
and the serving plane it builds. A kernel
or LiveQuery session of a saved flow carries the flow's declared UDFs
and UDAFs, loaded as its job loads them; the reference's carry none.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..compile.codegen import CodegenEngine
from ..core.config import SettingDictionary
from ..lq.service import LiveQueryService
from ..lq.session import AdmissionRejected, SessionManager
from ..obs import tracing
from .flowservice import FlowOperation
from .jobs import FleetAdmissionError
from .livequery import KernelService
from .schemainference import SchemaInferenceManager
from ..udf.api import load_udfs_from_conf
from .sqlanalyzer import SqlAnalyzer

logger = logging.getLogger(__name__)

ROLE_READER = "DataXReader"
ROLE_WRITER = "DataXWriter"


class ApiError(Exception):
    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


class DataXApi:
    """Route table + handlers over the service objects (transport-free,
    so tests can call ``dispatch`` directly)."""

    def __init__(
        self,
        flow_ops: FlowOperation,
        kernels: Optional[KernelService] = None,
        require_roles: bool = False,
        tracer: Optional[tracing.Tracer] = None,
        livequery: Optional[LiveQueryService] = None,
        fleet=None,
        device: str = "cuda",
    ):
        # control-plane request tracing: each dispatched route becomes a
        # `rest/<path>` trace whose id flows through job submit ->
        # admission -> spawned host conf (telemetry.parenttrace), so the
        # flight recorder can show one tree from the designer click to
        # the batch spans it caused. None = tracing off (default).
        self.tracer = tracer
        self.flow_ops = flow_ops
        # kernel pool shares one persistent compile cache under the
        # runtime root: repeated kernel creates (and restarts of the
        # whole control plane) deserialize query compiles instead of
        # re-tracing them — the warm-LiveQuery-pool half of the AOT
        # compile path (runtime/processor.py process.compile.*)
        from ..compile.aotcache import compile_conf_for

        compile_conf = compile_conf_for(os.path.join(
            flow_ops.runtime.resolve("livequery"), "compilecache"
        ))
        # ONE session registry behind both interactive surfaces: the
        # legacy designer kernels (kernel/* routes, TTL-reaped now) and
        # the multi-tenant serving plane (lq/* routes, quota'd). The
        # in-process LiveQuery default runs tickless (each execute
        # flushes its own dispatch tick — still coalescing whatever
        # queued concurrently); ``serve/__main__`` passes a ticker'd
        # instance for the real server.
        if kernels is not None:
            self.kernels = kernels
            self.livequery = livequery or LiveQueryService(
                session_manager=kernels.sessions,
                compile_conf=compile_conf,
                device=device,
            )
        else:
            self.livequery = livequery or LiveQueryService(
                session_manager=SessionManager(),
                compile_conf=compile_conf,
                device=device,
            )
            self.kernels = KernelService(
                runtime_storage=flow_ops.runtime,
                compile_conf=compile_conf,
                session_manager=self.livequery.sessions,
                device=device,
            )
        # fleet telemetry rollup (obs/fleetview.py): /fleet/* routes
        # read it; None = fleet plane not wired (404s explain why)
        self.fleet = fleet
        self.schema_inference = SchemaInferenceManager(flow_ops.runtime)
        self.analyzer = SqlAnalyzer()
        self.codegen = CodegenEngine()
        self.require_roles = require_roles
        # (method, path) -> (handler, needs_writer)
        self.routes: Dict[Tuple[str, str], Tuple[Callable, bool]] = {}
        self._register()

    def _register(self) -> None:
        r = self.routes
        r[("POST", "flow/save")] = (self._flow_save, True)
        r[("POST", "flow/validate")] = (self._flow_validate, False)
        r[("POST", "flow/generateconfigs")] = (self._flow_generate, True)
        r[("POST", "flow/startjobs")] = (self._flow_start, True)
        r[("POST", "flow/stopjobs")] = (self._flow_stop, True)
        r[("POST", "flow/restartjobs")] = (self._flow_restart, True)
        r[("POST", "flow/schedulebatch")] = (self._flow_schedulebatch, True)
        r[("POST", "flow/delete")] = (self._flow_delete, True)
        r[("GET", "flow/get")] = (self._flow_get, False)
        r[("GET", "flow/getall")] = (self._flow_getall, False)
        r[("GET", "flow/getall/min")] = (self._flow_getall_min, False)
        r[("GET", "job/getall")] = (self._job_getall, False)
        r[("GET", "job/get")] = (self._job_get, False)
        r[("POST", "job/getbynames")] = (self._job_getbynames, False)
        r[("POST", "job/syncall")] = (self._job_syncall, True)
        r[("POST", "userqueries/schema")] = (self._userquery_schema, False)
        r[("POST", "userqueries/codegen")] = (self._userquery_codegen, False)
        r[("POST", "inputdata/inferschema")] = (self._infer_schema, True)
        r[("POST", "inputdata/refreshsample")] = (self._infer_schema, True)
        r[("POST", "kernel")] = (self._kernel_create, True)
        r[("POST", "kernel/refresh")] = (self._kernel_refresh, True)
        r[("POST", "kernel/executequery")] = (self._kernel_execute, False)
        r[("POST", "kernel/delete")] = (self._kernel_delete, True)
        r[("POST", "kernels/deleteall")] = (self._kernels_deleteall, True)
        r[("GET", "kernels/list")] = (self._kernels_list, False)
        # LiveQuery serving plane (lq/): multi-tenant sessions with
        # micro-batched dispatch; quota rejections surface as 429 +
        # Retry-After (see _dispatch_traced / DataXApiService._respond)
        r[("POST", "lq/session")] = (self._lq_session_create, False)
        r[("POST", "lq/execute")] = (self._lq_execute, False)
        r[("POST", "lq/session/close")] = (self._lq_session_close, False)
        r[("GET", "lq/sessions")] = (self._lq_sessions_list, False)
        r[("GET", "lq/stats")] = (self._lq_stats, False)
        # fleet telemetry plane (obs/fleetview.py): the cross-replica
        # rollup + lineage + DX54x delivery audit; /fleet/flows/<name>
        # is rewritten onto the ?flow= form in dispatch()
        r[("GET", "fleet/metrics")] = (self._fleet_metrics, False)
        r[("GET", "fleet/flows")] = (self._fleet_flow, False)

    # -- dispatch --------------------------------------------------------
    def dispatch(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        query: Optional[dict] = None,
        roles: Optional[list] = None,
    ) -> Tuple[int, dict]:
        """Returns (http_status, ApiResult envelope)."""
        path = path.strip("/")
        if path.startswith("api/"):
            path = path[len("api/"):]
        # gateway/website-style paths carry the target service as the
        # first segment (api/{service}/{route}); this single process
        # serves all four service families, so drop it when present
        head, _, rest = path.partition("/")
        if head in (
            "flow", "interactivequery", "schemainference", "livedata",
            "livequery",
        ) and (method.upper(), path) not in self.routes:
            path = rest
        # path-parameter form of the fleet flow route: the route table
        # is exact-match, so /fleet/flows/<flow> rewrites onto the
        # query-param handler
        if path.startswith("fleet/flows/"):
            query = dict(query or {})
            query["flow"] = [path[len("fleet/flows/"):]]
            path = "fleet/flows"
        entry = self.routes.get((method.upper(), path))
        if entry is None:
            return 404, {"error": {"message": f"unknown route {method} {path}"}}
        handler, needs_writer = entry
        if self.require_roles:
            roles = roles or []
            if ROLE_READER not in roles and ROLE_WRITER not in roles:
                return 401, {"error": {"message": "caller has no DataX role"}}
            if needs_writer and ROLE_WRITER not in roles:
                return 403, {"error": {"message": "writer role required"}}
        ctx = (
            self.tracer.begin(f"rest/{path}", method=method.upper())
            if self.tracer is not None else None
        )
        status, payload = self._dispatch_traced(
            handler, ctx, method, path, body, query
        )
        if ctx is not None:
            ctx.end(status=status)
        return status, payload

    def _dispatch_traced(
        self, handler, ctx, method, path, body, query,
    ) -> Tuple[int, dict]:
        try:
            with (ctx.activate() if ctx is not None
                  else contextlib.nullcontext()):
                result = handler(body or {}, query or {})
            return 200, {"result": result}
        except ApiError as e:
            return e.status, {"error": {"message": str(e)}}
        except AdmissionRejected as e:
            # serving-plane quota/capacity rejection: typed 429 the
            # caller can back off on — the rejected call NEVER queued,
            # so it consumed no kernel compile and no device dispatch.
            # DataXApiService turns retryAfterSeconds into the
            # Retry-After response header.
            return 429, {"error": e.to_dict()}
        except FleetAdmissionError as e:
            # fleet admission gate: the submit conflicts with the
            # current fleet state (DX400/401/410/411) — a client
            # problem, not a server fault; the diagnostics are the body
            return 409, {"error": {
                "message": str(e),
                "codes": [d.code for d in e.diagnostics],
                "diagnostics": [d.to_dict() for d in e.diagnostics],
            }}
        except KeyError as e:
            return 404, {"error": {"message": str(e)}}
        except Exception as e:  # noqa: BLE001 — API boundary
            logger.exception("api error on %s %s", method, path)
            return 500, {"error": {"message": f"{type(e).__name__}: {e}"}}

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _flow_name(body: dict, query: dict) -> str:
        name = (
            body.get("flowName") or body.get("name")
            or (query.get("flowName") or [None])[0]
            or (query.get("flowname") or [None])[0]
        )
        if isinstance(name, list):
            name = name[0]
        if not name:
            raise ApiError("flowName required")
        return name

    # -- flow ------------------------------------------------------------
    def _flow_save(self, body, query):
        gui = body.get("gui") or body
        doc = self.flow_ops.save_flow(gui)
        return {"name": doc["name"], "displayName": doc.get("displayName")}

    def _flow_validate(self, body, query):
        """Static analysis; same diagnostics as the analysis CLI (shared
        ``analysis.analyze_flow`` implementation). Body: a flow config
        (gui JSON / full doc), or ``{"flowName": ...}`` for a saved one.
        ``"device": true`` adds the device-plan tier (the CLI's
        ``--device``): DX2xx lints merged into the diagnostics plus a
        ``device`` cost report (per-stage HBM/FLOP/ICI); optional
        ``"chips": N`` sets the ICI model's chip count. ``"udfs":
        true`` adds the UDF tier (the CLI's ``--udfs``): DX3xx
        tracing-safety/purity lints merged into the diagnostics plus a
        ``udfs`` summary of the functions analyzed. ``"fleet": true``
        adds the fleet tier (the CLI's ``--fleet``): the candidate flow
        is analyzed against every currently registered flow — DX4xx
        capacity/interference lints merged into the diagnostics plus a
        ``fleet`` placement plan (chip -> flows -> packed HBM/headroom);
        optional ``"fleetSpec": {...}`` overrides the default fleet.
        ``"compile": true`` adds the compile-surface tier (the CLI's
        ``--compile``): DX6xx finiteness/stability lints merged into
        the diagnostics plus a ``compile`` section carrying the AOT
        compile manifest; optional ``"compileManifest": {...}`` checks
        a previously emitted manifest for drift (DX602/DX603).
        ``"mesh": true`` adds the mesh-sharding tier (the CLI's
        ``--mesh``): DX7xx partition lints merged into the diagnostics
        plus a ``mesh`` section carrying the sharding plan (stage ->
        axis -> per-chip bytes -> ICI bytes); the same ``"chips": N``
        body field sets the mesh size, and ``"fleetSpec"`` the per-chip
        budget DX702 holds it to. ``"race": true`` adds the
        buffer-lifetime/concurrency tier (the CLI's ``--race``): the
        DX8xx lints over the ENGINE modules the flow deploys onto,
        merged into the diagnostics plus a ``race`` section (modules
        analyzed, pinned zero-copy sites, owner handoffs).
        ``"protocol": true`` adds the exactly-once delivery-protocol
        tier (the CLI's ``--protocol``): the DX90x ordering lints over
        the engine modules plus the rescale handoff, merged into the
        diagnostics plus a ``protocol`` section (modules analyzed,
        effect events, pinned post-commit / requeue-upstream sites).
        ``"conf": true`` adds the configuration-lattice tier (the
        CLI's ``--conf``): the DX10xx conf lints — engine read sites
        and generation-produced keys checked against the typed conf
        registry, plus type/bounds and incompatible-knob checks on
        THIS flow's effective conf — merged into the diagnostics plus
        a ``conf`` section (modules scanned, read sites/keys, produced
        keys, registry rows).
        ``"all": true`` runs every tier in one call — one merged report, one
        ``schemaVersion``, the CI single-invocation path."""
        flow = body.get("flow") or body.get("gui")
        if flow is None and (body.get("flowName") or body.get("name")) \
                and not body.get("process") and not body.get("input"):
            flow = self.flow_ops.get_flow(self._flow_name(body, query))
            if flow is None:
                raise ApiError("flow not found", status=404)
        if flow is None:
            flow = body
        report = self.flow_ops.validate_flow(flow)
        all_tiers = bool(body.get("all"))
        want_device = all_tiers or body.get("device")
        want_udfs = all_tiers or body.get("udfs")
        want_fleet = all_tiers or body.get("fleet")
        want_compile = all_tiers or body.get("compile")
        want_mesh = all_tiers or body.get("mesh")
        want_race = all_tiers or body.get("race")
        want_protocol = all_tiers or body.get("protocol")
        want_conf = all_tiers or body.get("conf")
        if not (want_device or want_udfs or want_fleet or want_compile
                or want_mesh or want_race or want_protocol
                or want_conf):
            return report.to_dict()
        from ..analysis import (
            ChipCountError,
            combined_report_dict,
            parse_chip_count,
        )

        # one shared, typed chip-count parser for the device ICI model
        # and the mesh plan (the CLI's --chips counterpart)
        try:
            chips = parse_chip_count(body.get("chips"), '"chips"')
        except ChipCountError as e:
            raise ApiError(str(e))
        device = (
            self.flow_ops.validate_flow_device(flow, chips=chips)
            if want_device else None
        )
        udfs = (
            self.flow_ops.validate_flow_udfs(flow) if want_udfs else None
        )
        fleet = (
            self.flow_ops.validate_flow_fleet(
                flow, spec=body.get("fleetSpec")
            )
            if want_fleet else None
        )
        comp = (
            self.flow_ops.validate_flow_compile(
                flow, manifest=body.get("compileManifest")
            )
            if want_compile else None
        )
        mesh = (
            self.flow_ops.validate_flow_mesh(
                flow, chips=chips, spec=body.get("fleetSpec")
            )
            if want_mesh else None
        )
        race = (
            self.flow_ops.validate_flow_race(flow) if want_race else None
        )
        protocol = (
            self.flow_ops.validate_flow_protocol(flow)
            if want_protocol else None
        )
        conf = (
            self.flow_ops.validate_flow_conf(flow) if want_conf else None
        )
        return combined_report_dict(
            report, device, udfs, fleet, compile_surface=comp, mesh=mesh,
            race=race, protocol=protocol, conf=conf,
        )

    def _flow_generate(self, body, query):
        res = self.flow_ops.generate_configs(self._flow_name(body, query))
        if not res.ok:
            raise ApiError("; ".join(res.errors), status=500)
        return {
            "flowName": res.flow_name,
            "jobNames": res.job_names,
            "confPaths": res.conf_paths,
        }

    def _flow_start(self, body, query):
        return self.flow_ops.start_jobs(
            self._flow_name(body, query), batches=body.get("batches")
        )

    def _flow_stop(self, body, query):
        return self.flow_ops.stop_jobs(self._flow_name(body, query))

    def _flow_restart(self, body, query):
        return self.flow_ops.restart_jobs(
            self._flow_name(body, query), batches=body.get("batches")
        )

    def _flow_schedulebatch(self, body, query):
        return self.flow_ops.schedule_batch(self._flow_name(body, query))

    def _flow_delete(self, body, query):
        """Cascade delete incl. the flow's live kernels + LQ sessions
        (DataX.Flow.DeleteHelper deletes configs/checkpoints/kernels)."""
        name = self._flow_name(body, query)
        self.kernels.delete_kernels(name)
        self.livequery.close_flow(name)
        return {"deleted": self.flow_ops.delete_flow(name)}

    def _flow_get(self, body, query):
        doc = self.flow_ops.get_flow(self._flow_name(body, query))
        if doc is None:
            raise ApiError("flow not found", status=404)
        return doc

    def _flow_getall(self, body, query):
        return self.flow_ops.get_all_flows()

    def _flow_getall_min(self, body, query):
        return [
            {
                "name": d["name"],
                "displayName": d.get("displayName"),
                "jobNames": d.get("jobNames") or [],
            }
            for d in self.flow_ops.get_all_flows()
        ]

    # -- jobs ------------------------------------------------------------
    def _job_getall(self, body, query):
        return self.flow_ops.registry.get_all()

    def _job_get(self, body, query):
        name = (query.get("jobName") or [None])[0] or body.get("jobName")
        if not name:
            raise ApiError("jobName required")
        job = self.flow_ops.registry.get(name)
        if job is None:
            raise ApiError("job not found", status=404)
        return job

    def _job_getbynames(self, body, query):
        names = body.get("jobNames") or []
        return [self.flow_ops.registry.get(n) for n in names]

    def _job_syncall(self, body, query):
        return self.flow_ops.sync_jobs()

    # -- user queries ----------------------------------------------------
    def _userquery_schema(self, body, query):
        res = self.analyzer.analyze(
            body.get("query") or "",
            input_columns=body.get("inputColumns") or [],
        )
        return {
            "tables": [
                {
                    "name": t.name,
                    "columns": t.columns,
                    "dependsOn": t.depends_on,
                }
                for t in res.tables
            ],
            "errors": res.errors,
        }

    def _userquery_codegen(self, body, query):
        # live validation must match generation: TIMEWINDOW targets
        # check against the saved flow's projected tables when known
        windowable = None
        name = body.get("name") or ""
        doc = self.flow_ops.get_flow(name) if name else None
        if doc:
            windowable = {"DataXProcessedInput"}
            gui = doc.get("gui") or {}
            for src in (gui.get("input") or {}).get("sources") or []:
                sname = src.get("id") or src.get("name")
                if sname:
                    windowable.add(
                        (src.get("properties") or {}).get("target") or sname
                    )
        rc = self.codegen.generate_code(
            body.get("query") or "",
            json.dumps(body.get("rules") or []),
            name,
            windowable_tables=windowable,
        )
        return {
            "code": rc.code,
            "outputs": rc.outputs,
            "timeWindows": rc.time_windows,
            "accumulationTables": rc.accumulation_tables,
        }

    # -- schema inference ------------------------------------------------
    def _infer_schema(self, body, query):
        name = body.get("name") or body.get("flowName") or ""
        events = body.get("events")
        seconds = float(body.get("seconds") or 2.0)
        if events is None:
            events = self._sample_from_flow(name, seconds, body)
        return self.schema_inference.get_input_schema(
            events=events, flow_name=name
        )

    def _sample_from_flow(self, name: str, seconds: float, body: dict):
        """Sample from the flow's configured input (local source built
        from the designer's schema — the one-box path; remote bus
        sampling plugs in here)."""
        from ..core.schema import Schema
        from ..runtime.sources import LocalSource

        schema_json = body.get("inputSchema")
        if not schema_json and name:
            doc = self.flow_ops.get_flow(name)
            if doc:
                schema_json = (
                    ((doc.get("gui") or {}).get("input") or {})
                    .get("properties") or {}
                ).get("inputSchemaFile")
        if not schema_json:
            raise ApiError(
                "no events supplied and no input schema available to sample"
            )
        src = LocalSource(Schema.from_spark_json(schema_json))
        return self.schema_inference.sample_events(src, seconds=seconds)

    # -- kernels ---------------------------------------------------------
    @staticmethod
    def _flow_udfs(doc: Optional[dict]) -> Optional[dict]:
        """The saved flow's declared UDFs and UDAFs, loaded as its job
        loads them (``udf/api.py::load_udfs_from_conf``, the tiers of
        generation's S500), so that a kernel or session of the flow can
        call them; None when it declares none."""
        conf = {}
        gui = (doc or {}).get("gui") or {}
        for fn in (gui.get("process") or {}).get("functions") or []:
            props = fn.get("properties") or {}
            path = props.get("class") or props.get("module")
            ftype = (fn.get("type") or "").lower()
            tier = ("udf" if ftype in ("jarudf", "udf", "pythonudf")
                    else "udaf" if ftype in ("jarudaf", "udaf") else None)
            if fn.get("id") and path and tier:
                conf[f"datax.job.process.jar.{tier}.{fn['id']}.class"] = path
        return load_udfs_from_conf(SettingDictionary(conf)) if conf else None

    def _kernel_body(self, body) -> dict:
        name = body.get("name") or body.get("flowName") or ""
        schema_json = body.get("inputSchema")
        normalization = body.get("normalizationSnippet") or "Raw.*"
        doc = self.flow_ops.get_flow(name) if name else None
        if not schema_json and name:
            if doc:
                props = (
                    ((doc.get("gui") or {}).get("input") or {})
                    .get("properties") or {}
                )
                schema_json = props.get("inputSchemaFile")
                normalization = (
                    body.get("normalizationSnippet")
                    or props.get("normalizationSnippet")
                    or "Raw.*"
                )
        if not schema_json:
            raise ApiError("inputSchema required (or a saved flow name)")
        sample_rows = body.get("sampleRows")
        if sample_rows is None and not self.kernels.has_sample(name):
            # no persisted sample blob (schema inference never ran):
            # local/one-box flows sample from the simulated source the
            # job itself would use, so LiveQuery still has input rows
            from ..core.schema import Schema
            from ..utils.datagen import DataGenerator

            try:
                gen = DataGenerator(Schema.from_spark_json(schema_json))
                sample_rows = gen.random_rows(50)
            except (ValueError, KeyError):
                sample_rows = None
        return {
            "flow_name": name,
            "schema_json": schema_json,
            "normalization": normalization,
            "sample_rows": sample_rows,
            "udfs": self._flow_udfs(doc),
            # sanitizer opt-in for interactive UDF runs ("debug": true
            # or {"nans": "true", "tracerleaks": "true"}) — the
            # process.debug conf block, LiveQuery edition
            "debug": body.get("debug"),
        }


    def _kernel_create(self, body, query):
        kw = self._kernel_body(body)
        kid = self.kernels.create_kernel(**kw)
        return {"kernelId": kid}

    def _kernel_refresh(self, body, query):
        """Recycle the flow's kernels and create a fresh one
        (InteractiveQueryController kernel/refresh)."""
        kw = self._kernel_body(body)
        self.kernels.delete_kernels(kw["flow_name"])
        kid = self.kernels.create_kernel(**kw)
        return {"kernelId": kid}

    def _kernel_execute(self, body, query):
        kid = body.get("kernelId")
        if not kid:
            raise ApiError("kernelId required")
        return self.kernels.execute(
            kid, body.get("query") or "", int(body.get("maxRows") or 100)
        )

    def _kernel_delete(self, body, query):
        kid = body.get("kernelId")
        if not kid:
            raise ApiError("kernelId required")
        return {"deleted": self.kernels.delete_kernel(kid)}

    def _kernels_deleteall(self, body, query):
        return {"deleted": self.kernels.delete_kernels(body.get("flowName"))}

    def _kernels_list(self, body, query):
        return self.kernels.list_kernels()

    # -- LiveQuery serving plane (lq/) -----------------------------------
    def _lq_session_create(self, body, query):
        """Create a tenant session. Flow fields resolve exactly like a
        legacy kernel create (saved flow name, inline schema, persisted
        or generated sample); per-tenant session quotas are enforced
        here — over-quota tenants get 429 + Retry-After, not a kernel."""
        kw = self._kernel_body(body)
        return self.livequery.create_session(
            tenant=str(body.get("tenant") or "default"),
            flow_name=kw["flow_name"],
            schema_json=kw["schema_json"],
            normalization=kw["normalization"],
            sample_rows=kw["sample_rows"],
            udfs=kw["udfs"],
            debug=kw["debug"],
        )

    def _lq_execute(self, body, query):
        sid = body.get("sessionId")
        if not sid:
            raise ApiError("sessionId required")
        return self.livequery.execute(
            sid, body.get("query") or "", int(body.get("maxRows") or 100)
        )

    def _lq_session_close(self, body, query):
        sid = body.get("sessionId")
        if not sid:
            raise ApiError("sessionId required")
        return {"closed": self.livequery.close_session(sid)}

    def _lq_sessions_list(self, body, query):
        tenant = (query.get("tenant") or [None])[0] or body.get("tenant")
        return self.livequery.list_sessions(tenant=tenant)

    def _lq_stats(self, body, query):
        return self.livequery.snapshot()

    # -- fleet telemetry plane -------------------------------------------
    def _require_fleet(self):
        if self.fleet is None:
            raise ApiError(
                "fleet view not configured (run the control plane "
                "with an object store so replicas have a frame plane)",
                503,
            )
        return self.fleet

    def _fleet_metrics(self, body, query):
        fleet = self._require_fleet()
        fleet.refresh()
        return fleet.summary()

    def _fleet_flow(self, body, query):
        fleet = self._require_fleet()
        flow = (query.get("flow") or [None])[0]
        if not flow:
            raise ApiError("flow name required: /fleet/flows/<flow>")
        fleet.refresh()
        if flow not in fleet.flows():
            raise ApiError(f"no telemetry frames for flow {flow!r}", 404)
        payload = fleet.fleet_metrics(flow)
        output = (query.get("output") or [None])[0]
        if output:
            payload["audit"] = fleet.audit(flow, output=output)
        return payload


class DataXApiService:
    """HTTP host for DataXApi (ThreadingHTTPServer)."""

    def __init__(self, api: DataXApi, host: str = "127.0.0.1", port: int = 5000):
        self.api = api
        api_ref = api

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                logger.debug("http %s", fmt % args)

            def _respond(self, status: int, payload: dict) -> None:
                data = json.dumps(payload, default=str).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if status == 429:
                    # quota rejections carry a typed retry hint
                    # (lq/session.py AdmissionRejected.to_dict) —
                    # surface it as the standard backoff header
                    retry = (payload.get("error") or {}).get(
                        "retryAfterSeconds"
                    )
                    if isinstance(retry, (int, float)):
                        self.send_header(
                            "Retry-After", str(max(1, int(-(-retry // 1))))
                        )
                self.end_headers()
                self.wfile.write(data)

            def _roles(self):
                hdr = self.headers.get("X-DataX-Roles") or ""
                return [r.strip() for r in hdr.split(",") if r.strip()]

            def _handle(self, method: str) -> None:
                parsed = urlparse(self.path)
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    try:
                        body = json.loads(self.rfile.read(length) or b"{}")
                    except json.JSONDecodeError:
                        self._respond(
                            400, {"error": {"message": "invalid JSON body"}}
                        )
                        return
                status, payload = api_ref.dispatch(
                    method,
                    parsed.path,
                    body=body,
                    query=parse_qs(parsed.query),
                    roles=self._roles(),
                )
                self._respond(status, payload)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info("DataX API listening on :%d", self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def serve_forever(self) -> None:
        self._server.serve_forever()
