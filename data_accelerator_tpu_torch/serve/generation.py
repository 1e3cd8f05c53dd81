"""Runtime config generation: flow document -> runnable flat ``.conf``.

reference: DataX.Config/PublicService/RuntimeConfigGeneration.cs:21-110
and the ordered IFlowDeploymentProcessor chain
(ConfigGeneration/Processor/S100_RestoreFlowConfig.cs ...
S900_FinishUp.cs). Stage numbering and responsibilities preserved:

  S100 restore/port flow defaults      S550 batch inputs
  S200 merge job template defaults     S600 per-job config resolution
  S300 validate gui                    S650 flatten JSON -> .conf
  S400 prepare job tokens              S700 write runtime files
  S450 generate transform (codegen)    S800 upsert job records
  S500 resolve outputs/windows/state   S850 metrics config
                                       S900 finalize + save flow doc

The TPU flavor: job tokens describe chips/batch capacity instead of
executors/memory, and generated confs run directly on the local
StreamingHost (runtime/host.py) — the reference's spark-submit target
is replaced by the engine process itself.

Copy of the JAX package's ``serve/generation.py`` over the port's
modules. The generated conf equals the JAX package's key by key, the job
names (``DataXTpu-<flow>``) included, but for: the conformance model
(S620), which is the port's ``analyze_flow_device`` plan; the compile
manifest (S630), which is the port's ``analyze_flow_compile`` manifest,
its entries the JAX manifest's and its digests the port's; and a multi-
card job (``jobNumChips`` > 1), which ``generate`` refuses with an
``EngineException`` naming multi-GPU slice 8 before any stage runs, so
that the stages' fail-open cannot turn the missing mesh tier into a
silent 'no mesh model'. The reference's S660 mesh stage is therefore
absent. The generator writes no module path of its own: UDF class paths
come from the designer's document.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..compile.codegen import CodegenEngine, RulesCode
from ..compile.flattener import ConfigFlattener
from ..compile.flattener_schema import DEFAULT_FLATTENER_SCHEMA
from ..core.config import EngineException
from .flowbuilder import FlowConfigBuilder, RuleDefinitionGenerator, _deep_merge
from .storage import DesignTimeStorage, JobRegistry, LocalRuntimeStorage
from .templating import TokenDictionary, unresolved_tokens

logger = logging.getLogger(__name__)


def _refuse_multi_card(doc: dict) -> None:
    """Raise for a flow that asks for more than one card: the mesh tier
    and mesh execution (``analysis/meshcheck.py``, ``dist/mesh.py``)
    are multi-GPU slice 8, not ported yet. Runs before the stages, whose
    fail-open would otherwise generate a multi-card conf without its
    mesh model."""
    gui = doc.get("gui") if isinstance(doc.get("gui"), dict) else doc
    jobconf = (gui.get("process") or {}).get("jobconfig") or {}
    chips_s = str(
        jobconf.get("jobNumChips") or jobconf.get("jobNumExecutors") or "1"
    )
    try:
        chips = int(chips_s)
    except ValueError:
        chips = 1
    if chips > 1:
        raise EngineException(
            f"flow '{doc.get('name')}' asks for {chips} cards "
            "(jobNumChips); a multi-card job needs the mesh tier and mesh "
            "execution (analysis/meshcheck.py, dist/mesh.py, multi-GPU "
            "slice 8), which are not ported to data_accelerator_tpu_torch yet"
        )


@dataclass
class GenerationResult:
    flow_name: str
    job_names: List[str] = field(default_factory=list)
    conf_paths: List[str] = field(default_factory=list)
    files: Dict[str, str] = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


class RuntimeConfigGeneration:
    """Run the S100–S900 chain for one flow."""

    def __init__(
        self,
        design_storage: DesignTimeStorage,
        runtime_storage: LocalRuntimeStorage,
        codegen: Optional[CodegenEngine] = None,
        env_tokens: Optional[Dict[str, str]] = None,
    ):
        self.design = design_storage
        self.runtime = runtime_storage
        self.codegen = codegen or CodegenEngine()
        self.jobs = JobRegistry(runtime_storage)
        self.rule_gen = RuleDefinitionGenerator()
        # environment-level token defaults (EngineEnvironment analog,
        # DataX.Flow.Common/EngineEnvironment.cs:26-237) — e.g. the
        # one-box website metrics endpoint; flow-level values win
        self.env_tokens = dict(env_tokens or {})

    # -- public entry ----------------------------------------------------
    def generate(self, flow_name: str) -> GenerationResult:
        doc = self.design.get_by_name(flow_name)
        if doc is None:
            return GenerationResult(flow_name, errors=[f"flow '{flow_name}' not found"])
        _refuse_multi_card(doc)
        result = GenerationResult(flow_name)
        ctx: Dict[str, Any] = {"doc": doc, "result": result}
        for stage in (
            self._s100_restore,
            self._s200_merge_defaults,
            self._s300_validate,
            self._s400_job_tokens,
            self._s450_transform,
            self._s500_resolve,
            self._s550_batch,
            self._s600_job_configs,
            self._s620_conformance,
            self._s630_compile,
            self._s640_pilot,
            self._s650_flatten,
            self._s700_write_files,
            self._s800_jobs,
            self._s850_metrics,
            self._s900_finalize,
        ):
            try:
                stage(ctx)
            except Exception as e:  # noqa: BLE001 — surfaced per stage
                logger.exception("generation stage %s failed", stage.__name__)
                result.errors.append(f"{stage.__name__}: {e}")
                return result
        return result

    # -- stages ----------------------------------------------------------
    def _s100_restore(self, ctx) -> None:
        """Ensure structural defaults exist (S100_RestoreFlowConfig)."""
        doc = ctx["doc"]
        if "gui" not in doc:
            # gui-only save: wrap it
            ctx["doc"] = FlowConfigBuilder().build(doc)
            return
        ctx["doc"] = FlowConfigBuilder().build(doc["gui"], existing=doc)

    def _s200_merge_defaults(self, ctx) -> None:
        """Merge job-template defaults (S200: defaultSparkJobTemplate).
        Per-job entries inherit jobCommonTokens."""
        cp = ctx["doc"]["commonProcessor"]
        cp.setdefault("jobs", [{"partitionJobNumber": "1"}])
        ctx["job_common"] = dict(cp.get("jobCommonTokens") or {})

    _NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")

    def _s300_validate(self, ctx) -> None:
        doc = ctx["doc"]
        gui = doc["gui"]
        if not doc.get("name"):
            raise ValueError("flow has no name")
        # the name becomes a filesystem folder under the runtime root;
        # reject separators/'..' so generated files can't escape it
        if not self._NAME_RE.match(doc["name"]):
            raise ValueError(
                f"invalid flow name '{doc['name']}': use letters, digits, "
                "'_', '-', '.'"
            )
        mode = (gui.get("input") or {}).get("mode", "streaming")
        if mode not in ("streaming", "batching"):
            raise ValueError(f"unknown input mode '{mode}'")
        itype = (gui.get("input") or {}).get("type", "local")
        if itype not in ("local", "events", "eventhub", "kafka", "iothub", "blobs", "socket", "file"):
            raise ValueError(f"unknown input type '{itype}'")

    def _s400_job_tokens(self, ctx) -> None:
        """Build the token dictionary from gui + environment
        (S400_PrepareJobConfigVariables)."""
        doc = ctx["doc"]
        gui = doc["gui"]
        name = doc["name"]
        iprops = (gui.get("input") or {}).get("properties") or {}
        proc = gui.get("process") or {}
        jobconf = proc.get("jobconfig") or {}

        flow_dir = name  # runtime-storage-relative folder per flow
        tok = TokenDictionary({
            "name": name,
            "cpConfigFolderBase": self.runtime.resolve(""),
            "inputType": (gui.get("input") or {}).get("type", "local"),
            "inputStreamingIntervalInSeconds": str(
                iprops.get("windowDuration") or iprops.get("intervalInSeconds") or "1"
            ),
            "inputStreamingCheckpointDir": os.path.join(
                self.runtime.resolve(flow_dir), "checkpoints"
            ),
            "inputEventHubConnectionString": iprops.get("inputEventhubConnection", ""),
            "inputEventHubConsumerGroup": iprops.get("consumerGroup") or name,
            "inputEventHubCheckpointDir": os.path.join(
                self.runtime.resolve(flow_dir), "eventhub-checkpoints"
            ),
            "inputEventHubCheckpointInterval": str(
                iprops.get("checkpointInterval") or "60"
            ),
            "inputEventHubMaxRate": str(iprops.get("maxRate") or "35000"),
            "inputEventHubFlushExistingCheckpoints": str(
                iprops.get("flushExistingCheckpoints") or "false"
            ).lower(),
            "processTimestampColumn": proc.get("timestampColumn", ""),
            "processWatermark": proc.get("watermark")
            or f"{iprops.get('watermarkValue', 0)} {iprops.get('watermarkUnit', 'second')}",
            "localMetricsHttpEndpoint": iprops.get("localMetricsHttpEndpoint")
            or (doc.get("properties") or {}).get("localMetricsHttpEndpoint", ""),
            "guiJobNumChips": str(
                jobconf.get("jobNumChips")
                or jobconf.get("jobNumExecutors")  # legacy designer field
                or "1"
            ),
            "guiJobBatchCapacity": str(
                jobconf.get("jobBatchCapacity") or "65536"
            ),
            # in-flight window of the pipelined hosts; empty = engine
            # default (runtime/processor.py DEFAULT_PIPELINE_DEPTH)
            "guiJobPipelineDepth": str(
                jobconf.get("jobPipelineDepth") or ""
            ),
            # ingest decoder shard count (csrc/decoder.cpp sharded
            # decode); empty = engine default (cap 4), env
            # DATAX_DECODER_THREADS stays the operator override
            "guiJobDecoderThreads": str(
                jobconf.get("jobDecoderThreads") or ""
            ),
            # host Prometheus/health port (0/empty = ephemeral); the
            # fleet analyzer's DX413 lint flags co-placed flows that
            # pin the same port
            "guiJobObservabilityPort": str(
                jobconf.get("jobObservabilityPort") or ""
            ),
            # bound on the transfer-helper jit caches; empty = engine
            # default (runtime/processor.py DEFAULT_JIT_CACHE_CAP, the
            # same constant the DX601 compile-surface lint uses)
            "guiJobCompileJitCacheCap": str(
                jobconf.get("jobCompileJitCacheCap") or ""
            ),
            "processedSchemaPath": os.path.join(
                self.runtime.resolve(flow_dir), "processedschema.json"
            ),
        })
        # environment defaults fill tokens the flow left empty
        for k, v in self.env_tokens.items():
            if not tok.get(k):
                tok.set(k, v)
        ctx["tokens"] = tok
        ctx["flow_dir"] = flow_dir

        # input schema: gui carries the schema JSON inline; write to file
        schema_json = iprops.get("inputSchemaFile") or "{}"
        schema_path = os.path.join(ctx["flow_dir"], "inputschema.json")
        ctx["result"].files[schema_path] = (
            schema_json if isinstance(schema_json, str) else json.dumps(schema_json)
        )
        tok.set("inputSchemaFilePath", self.runtime.stored_path(schema_path))

        # additional named input sources (gui.input.sources — the
        # flattenerConfig input.sources map): each gets its own schema/
        # projection artifact and flat datax.job.input.sources.<name>.*
        # keys, enabling multi-source flows (cross-stream window joins)
        # straight from the designer
        ctx["multi_source_keys"] = {}
        for src in (gui.get("input") or {}).get("sources") or []:
            sname = src.get("id") or src.get("name")
            if not sname:
                continue
            if not re.fullmatch(r"[A-Za-z][A-Za-z0-9_-]*", sname):
                # the id becomes a file path segment and a flat conf-key
                # namespace: anything else is a traversal / key-injection
                # vector
                raise ValueError(
                    f"source id {sname!r} must match [A-Za-z][A-Za-z0-9_-]*"
                )
            sprops = src.get("properties") or {}
            ns = f"datax.job.input.sources.{sname}"
            keys = ctx["multi_source_keys"]
            keys[f"{ns}.inputtype"] = (src.get("type") or "local").lower()
            sschema = sprops.get("inputSchemaFile") or "{}"
            spath = os.path.join(ctx["flow_dir"], "sources",
                                 f"{sname}.schema.json")
            ctx["result"].files[spath] = (
                sschema if isinstance(sschema, str) else json.dumps(sschema)
            )
            keys[f"{ns}.blobschemafile"] = self.runtime.stored_path(spath)
            if sprops.get("target"):
                keys[f"{ns}.target"] = sprops["target"]
            snippet = sprops.get("normalizationSnippet")
            if snippet:
                ppath = os.path.join(ctx["flow_dir"], "sources",
                                     f"{sname}.projection")
                ctx["result"].files[ppath] = snippet
                keys[f"{ns}.projection"] = self.runtime.stored_path(ppath)
            # remaining scalar properties pass through lowercased
            # (kafka.topics, socket.port, maxRate, ...) — key charset
            # restricted and newlines rejected: conf is line-based
            # key=value text, so either would inject arbitrary lines
            for pk, pv in sprops.items():
                if pk in ("inputSchemaFile", "target",
                          "normalizationSnippet") or pv in (None, "", [], {}):
                    continue
                if not isinstance(pv, (str, int, float, bool)):
                    continue
                if not re.fullmatch(r"[A-Za-z0-9_.-]+", pk):
                    raise ValueError(
                        f"source property key {pk!r} must match "
                        "[A-Za-z0-9_.-]+"
                    )
                sv = str(pv)
                if "\n" in sv or "\r" in sv:
                    raise ValueError(
                        f"source property {pk!r} value must be single-line"
                    )
                keys[f"{ns}.{pk.lower()}"] = sv

        # reference data passes straight through as the template value
        tok.set("inputReferenceData", [
            {
                "name": rd.get("id"),
                "path": (rd.get("properties") or {}).get("path", ""),
                "format": rd.get("type", "csv"),
                "header": str((rd.get("properties") or {}).get("header", "true")),
                "delimiter": (rd.get("properties") or {}).get("delimiter", ","),
            }
            for rd in (gui.get("input") or {}).get("referenceData") or []
        ])

    def _s450_transform(self, ctx) -> None:
        """Queries + rules -> transform script via the codegen engine
        (S450_GenerateTransformFile + CodegenRules Engine.GenerateCode)."""
        doc = ctx["doc"]
        gui = doc["gui"]
        queries = (gui.get("process") or {}).get("queries") or []
        code = "\n".join(q if isinstance(q, str) else str(q) for q in queries)
        rules_json = self.rule_gen.generate(gui.get("rules") or [], doc["name"])
        windowable = {"DataXProcessedInput"}
        for src in (gui.get("input") or {}).get("sources") or []:
            sname = src.get("id") or src.get("name")
            if sname:
                windowable.add(
                    (src.get("properties") or {}).get("target") or sname
                )
        rules_code: RulesCode = self.codegen.generate_code(
            code, rules_json, doc["name"], windowable_tables=windowable
        )
        ctx["rules_code"] = rules_code

        transform_path = os.path.join(ctx["flow_dir"], f"{doc['name']}.transform")
        ctx["result"].files[transform_path] = rules_code.code
        ctx["tokens"].set("processTransforms",
                          self.runtime.stored_path(transform_path))

    def _s500_resolve(self, ctx) -> None:
        """Resolve projections, UDFs, time windows, state tables, outputs
        (S500_ResolveProcessTemplate / ResolveOutputs)."""
        doc = ctx["doc"]
        gui = doc["gui"]
        tok: TokenDictionary = ctx["tokens"]
        rules_code: RulesCode = ctx["rules_code"]
        iprops = (gui.get("input") or {}).get("properties") or {}

        # projection file: normalization snippet (or Raw.* passthrough)
        normalization = iprops.get("normalizationSnippet") or "Raw.*"
        proj_path = os.path.join(ctx["flow_dir"], f"{doc['name']}.projection")
        ctx["result"].files[proj_path] = normalization
        tok.set("processProjections", [self.runtime.stored_path(proj_path)])

        # functions -> jar UDFs / UDAFs / azure functions template arrays
        jar_udfs, jar_udafs, azure_fns = [], [], []
        for fn in (gui.get("process") or {}).get("functions") or []:
            props = fn.get("properties") or {}
            entry = {
                "name": fn.get("id"),
                "class": props.get("class") or props.get("module", ""),
                "path": props.get("path", ""),
                "libs": props.get("libs") or [],
            }
            ftype = (fn.get("type") or "").lower()
            if ftype in ("jarudf", "udf", "pythonudf"):
                jar_udfs.append(entry)
            elif ftype in ("jarudaf", "udaf"):
                jar_udafs.append(entry)
            elif ftype == "azurefunction":
                azure_fns.append({
                    "name": fn.get("id"),
                    "serviceEndpoint": props.get("serviceEndpoint", ""),
                    "api": props.get("api", ""),
                    "code": props.get("code", ""),
                    "methodType": props.get("methodType", "get"),
                    "params": props.get("params") or [],
                })
        tok.set("processJarUDFs", jar_udfs)
        tok.set("processJarUDAFs", jar_udafs)
        tok.set("processAzureFunctions", azure_fns)

        # time windows from codegen's TIMEWINDOW extraction
        tok.set("processTimeWindows", [
            {"name": n, "windowDuration": d}
            for n, d in sorted(rules_code.time_windows.items())
        ])

        # accumulation (state) tables from --DataXStates--
        tok.set("processStateTables", [
            {
                "name": n,
                "schema": s,
                "location": os.path.join(
                    self.runtime.resolve(ctx["flow_dir"]), "statetables", n
                ),
            }
            for n, s in sorted(rules_code.accumulation_tables.items())
        ])

        # outputs: gui sink definitions keyed by id
        sink_defs: Dict[str, dict] = {}
        for out in gui.get("outputs") or []:
            sink_defs[out.get("id")] = out

        # codegen's OUTPUT tables TO sink (tables may be comma-separated)
        table_sinks: Dict[str, List[str]] = {}
        for tables, sink_name in rules_code.outputs:
            for table in tables.split(","):
                table_sinks.setdefault(table.strip(), []).append(sink_name)

        outputs_arr: List[dict] = []
        for table, sinks in sorted(table_sinks.items()):
            entry: Dict[str, Any] = {"name": table}
            for sname in sinks:
                sdef = sink_defs.get(sname)
                stype = (sdef.get("type") if sdef else "metric") or "metric"
                props = (sdef.get("properties") if sdef else {}) or {}
                if stype == "metric":
                    entry["metric"] = "enabled"
                elif stype in ("blob", "file", "local"):
                    entry["file"] = {
                        "path": props.get("folder")
                        or props.get("path")
                        or os.path.join(
                            self.runtime.resolve(ctx["flow_dir"]), "out", table
                        ),
                        "compressionType": props.get("compressionType", "none"),
                        "format": props.get("format", "json"),
                    }
                elif stype == "httppost":
                    entry["httppost"] = {
                        "endpoint": props.get("endpoint", ""),
                        "filter": props.get("filter", ""),
                    }
                elif stype == "console":
                    entry["console"] = {"maxRows": props.get("maxRows", 20)}
                elif stype == "eventhub":
                    entry["eventhub"] = {
                        "connectionStringRef": props.get("connection", ""),
                        "compressionType": props.get("compressionType", "gzip"),
                    }
                elif stype in ("externalfn", "azurefunction"):
                    entry["externalfn"] = {
                        "serviceEndpoint": props.get("serviceEndpoint", ""),
                        "api": props.get("api", ""),
                        "code": props.get("code", ""),
                        "methodType": props.get("methodType", "post"),
                    }
                elif stype == "cosmosdb":
                    entry["cosmosdb"] = {
                        "connectionStringRef": props.get("connection", ""),
                        "database": props.get("db", ""),
                        "collection": props.get("collection", ""),
                    }
            outputs_arr.append(entry)
        tok.set("outputs", outputs_arr)

    def _s550_batch(self, ctx) -> None:
        """Batch-mode inputs: start/end/path/partition increment
        (S550_ProduceBatchInput). Streaming flows: no-op."""
        gui = ctx["doc"]["gui"]
        if (gui.get("input") or {}).get("mode") != "batching":
            return
        iprops = (gui.get("input") or {}).get("properties") or {}
        batches = (gui.get("batch") or [])
        ctx["batch_inputs"] = [
            {
                "path": (b.get("properties") or {}).get("path", iprops.get("path", "")),
                "startTime": (b.get("properties") or {}).get("startTime", ""),
                "endTime": (b.get("properties") or {}).get("endTime", ""),
                "partitionIncrement": (b.get("properties") or {}).get(
                    "partitionIncrement", "1"
                ),
            }
            for b in batches
        ] or [{"path": iprops.get("path", ""), "startTime": "", "endTime": "",
               "partitionIncrement": "1"}]

    def _s600_job_configs(self, ctx) -> None:
        """Resolve the template per job entry with all tokens
        (S600_GenerateJobConfig)."""
        doc = ctx["doc"]
        cp = doc["commonProcessor"]
        tok: TokenDictionary = ctx["tokens"]
        job_configs: List[tuple] = []
        for i, job in enumerate(cp.get("jobs") or [{}]):
            jt = TokenDictionary()
            jt.update({n: tok.get(n) for n in tok.names()})
            for k, v in {**ctx.get("job_common", {}), **job}.items():
                jt.set(k, jt.replace(v))
            resolved = jt.replace(copy.deepcopy(cp["template"]))
            job_name = jt.get("tpuJobName") or f"DataXTpu-{doc['name']}"
            if len(cp.get("jobs") or []) > 1:
                job_name = f"{job_name}-{i + 1}"
            leftover = set(unresolved_tokens(resolved))
            if leftover:
                logger.warning("unresolved tokens in %s: %s", job_name, leftover)
            job_configs.append((job_name, resolved, jt))
        ctx["job_configs"] = job_configs

    def _s620_conformance(self, ctx) -> None:
        """Embed the flow's machine-readable cost-model report and the
        default alert rules into the generated conf, making the DX2xx
        static prediction a *runtime artifact* the host's
        ConformanceMonitor and AlertEngine read
        (``datax.job.process.conformance.model`` /
        ``datax.job.process.alerts.rules``; obs/conformance.py,
        obs/alerts.py).

        Fail-open: the conformance model rides on the device analyzer
        (the same lowering the job will run); an analyzer error must
        not block deployment — the job simply runs unmonitored, like
        every job did before this layer existed. Opt out with designer
        jobconfig ``jobConformanceModel: "false"``."""
        doc = ctx["doc"]
        jobconf = (doc["gui"].get("process") or {}).get("jobconfig") or {}
        ctx["conformance_json"] = None
        if str(jobconf.get("jobConformanceModel", "")).lower() != "false":
            try:
                from ..analysis import analyze_flow_device

                report = analyze_flow_device(doc)
                if report.stages:
                    ctx["conformance_json"] = json.dumps(
                        report.runtime_model(), separators=(",", ":")
                    )
            except Exception as e:  # noqa: BLE001 — monitoring is optional
                logger.warning(
                    "conformance model generation failed for %s: %s",
                    doc.get("name"), e,
                )
        from ..obs.alerts import default_rules

        ctx["alert_rules_json"] = json.dumps(
            default_rules(doc.get("name")), separators=(",", ":")
        )

    def _s630_compile(self, ctx) -> None:
        """Emit the flow's AOT **compile manifest** as a deployment
        artifact and wire the persistent compilation cache — the
        reference compiled Flow JSON into a deployable job artifact
        ahead of time (SURVEY §1 L3, DataX.Config -> flat .conf ->
        spark-submit); ours additionally ships the *compiled
        executables' coordinates*: the compile-surface analyzer
        (``analysis/compilecheck.py``) proves the flow's jit entry set
        finite, the manifest lands beside the conf
        (``<flow>/compile.manifest.json``), and the conf points at it
        (``datax.job.process.compile.manifest``) so ``FlowProcessor``
        AOT-warms every entry at init instead of first dispatch.

        The cache conf rides along: ``compile.cachedir`` under the
        flow's runtime folder (restarts deserialize instead of
        recompiling), and — when runtime storage is the shared object
        store — ``compile.cacheurl`` (an ``objstore://`` prefix) so
        preemption-recovered and scaled-out replicas pull compiles
        their peers already paid for.

        Fail-open like S620: an analyzer error must not block
        deployment — the job simply cold-starts like every job did
        before this layer existed. Opt out with designer jobconfig
        ``jobCompileManifest: "false"``. Skipped for multi-chip jobs
        (mesh shardings change the lowering; the manifest is a
        single-chip artifact for now)."""
        doc = ctx["doc"]
        jobconf = (doc["gui"].get("process") or {}).get("jobconfig") or {}
        ctx["compile_manifest_path"] = None
        chips = str(
            jobconf.get("jobNumChips")
            or jobconf.get("jobNumExecutors") or "1"
        )
        if (
            str(jobconf.get("jobCompileManifest", "")).lower() != "false"
            and chips in ("", "1")
        ):
            try:
                from ..analysis import analyze_flow_compile

                report = analyze_flow_compile(doc)
                if report.manifest and report.manifest.get("entries"):
                    mpath = os.path.join(
                        ctx["flow_dir"], "compile.manifest.json"
                    )
                    ctx["result"].files[mpath] = json.dumps(
                        report.manifest, separators=(",", ":")
                    )
                    ctx["compile_manifest_path"] = (
                        self.runtime.stored_path(mpath)
                    )
            except Exception as e:  # noqa: BLE001 — AOT is an optimization
                logger.warning(
                    "compile manifest generation failed for %s: %s",
                    doc.get("name"), e,
                )
        ctx["compile_cache_dir"] = os.path.join(
            self.runtime.resolve(ctx["flow_dir"]), "compilecache"
        )
        ctx["compile_cache_url"] = None
        client = getattr(self.runtime, "client", None)
        if client is not None and hasattr(client, "url_for"):
            ctx["compile_cache_url"] = client.url_for(
                f"{ctx['flow_dir']}/compilecache".replace(os.sep, "/")
            )

    def _s640_pilot(self, ctx) -> None:
        """Wire the autopilot (``pilot/controller.py``) into the
        generated conf: ``datax.job.process.pilot.*`` from the designer
        ``jobPilot*`` knobs. Default ON — a generated job runs piloted
        (depth/backpressure actuation bounded by budget + cooldown)
        unless the designer sets ``jobPilot: "false"``. The stall-EWMA
        half-life (``jobStallEwmaMs`` ->
        ``observability.stallewmams``) rides along so /readyz and the
        controller judge "stalled" off one conf'd constant."""
        doc = ctx["doc"]
        jobconf = (doc["gui"].get("process") or {}).get("jobconfig") or {}
        keys: Dict[str, str] = {}
        if str(jobconf.get("jobPilot", "")).lower() == "false":
            keys["datax.job.process.pilot.enabled"] = "false"
        for gui_key, conf_key in (
            ("jobPilotWindowSeconds", "pilot.windowseconds"),
            ("jobPilotCooldownSeconds", "pilot.cooldownseconds"),
            ("jobPilotBudget", "pilot.budget"),
            ("jobPilotMaxDepth", "pilot.maxdepth"),
            ("jobPilotMaxReplicas", "pilot.maxreplicas"),
            ("jobStallEwmaMs", "observability.stallewmams"),
            # the time-model surface: the on-demand profiler endpoint,
            # the per-batch HBM watermark sampler and machine-profile
            # calibration (all default ON in the host; these designer
            # knobs exist to turn one off per job)
            ("jobProfiler", "observability.profiler"),
            ("jobHbmSample", "observability.hbmsample"),
            ("jobCalibration", "observability.calibration"),
            # LiveQuery serving plane (lq/service.py): dispatch-tick
            # deadline, per-tenant quotas and the warm-kernel HBM
            # budget ride in the conf like every other process knob,
            # so a serving plane built from this flow's conf honors
            # the designer's choices
            ("jobLqMaxBatchWaitMs", "lq.maxbatchwaitms"),
            ("jobLqMaxFanin", "lq.maxfanin"),
            ("jobLqSessionTtlSeconds", "lq.sessionttlseconds"),
            ("jobLqMaxSessions", "lq.maxsessions"),
            ("jobLqTenantMaxSessions", "lq.tenant.maxsessions"),
            ("jobLqTenantMaxQps", "lq.tenant.maxqps"),
            ("jobLqHbmBudgetMb", "lq.hbmbudgetmb"),
        ):
            v = jobconf.get(gui_key)
            if v not in (None, ""):
                keys[f"datax.job.process.{conf_key}"] = str(v)
        ctx["pilot_keys"] = keys

    def _s650_flatten(self, ctx) -> None:
        """Flatten each resolved job config JSON to flat conf text
        (S650 ConfigFlattener.Flatten)."""
        flattener = ConfigFlattener(DEFAULT_FLATTENER_SCHEMA)
        ctx["flat_confs"] = []
        for job_name, resolved, jt in ctx["job_configs"]:
            flat = flattener.flatten(self._prune(resolved))
            extra = {}
            if jt.get("jobBatchCapacity"):
                extra["datax.job.process.batchcapacity"] = str(
                    jt.get("jobBatchCapacity"))
            if jt.get("jobNumChips"):
                extra["datax.job.process.numchips"] = str(jt.get("jobNumChips"))
            if jt.get("jobPipelineDepth"):
                extra["datax.job.process.pipeline.depth"] = str(
                    jt.get("jobPipelineDepth"))
            if jt.get("jobDecoderThreads"):
                extra["datax.job.process.ingest.decoderthreads"] = str(
                    jt.get("jobDecoderThreads"))
            if jt.get("jobObservabilityPort"):
                extra["datax.job.process.observability.port"] = str(
                    jt.get("jobObservabilityPort"))
            if jt.get("telemetryTraceFile"):
                # one flight recorder for control plane + jobs (the
                # env-token wiring serve/__main__ uses so `obs trace`
                # renders the whole cross-process tree from one file)
                extra["datax.job.process.telemetry.tracefile"] = str(
                    jt.get("telemetryTraceFile"))
            if jt.get("fleetPublishUrl"):
                # fleet telemetry plane (obs/publisher.py): spawned
                # hosts publish windowed frames to the control plane's
                # shared objstore so FleetView can roll them up — the
                # env-token wiring serve/__main__ sets when an object
                # store is configured
                extra["datax.job.process.fleet.publishurl"] = str(
                    jt.get("fleetPublishUrl"))
            if ctx.get("conformance_json"):
                extra["datax.job.process.conformance.model"] = (
                    ctx["conformance_json"])
            if ctx.get("alert_rules_json"):
                extra["datax.job.process.alerts.rules"] = (
                    ctx["alert_rules_json"])
            if ctx.get("compile_manifest_path"):
                extra["datax.job.process.compile.manifest"] = (
                    ctx["compile_manifest_path"])
            if ctx.get("compile_cache_dir"):
                extra["datax.job.process.compile.cachedir"] = (
                    ctx["compile_cache_dir"])
            if ctx.get("compile_cache_url"):
                extra["datax.job.process.compile.cacheurl"] = (
                    ctx["compile_cache_url"])
            if jt.get("jobCompileJitCacheCap"):
                extra["datax.job.process.compile.jitcachecap"] = str(
                    jt.get("jobCompileJitCacheCap"))
            for b_i, b in enumerate(ctx.get("batch_inputs") or []):
                ns = f"datax.job.input.batch.blob.{b_i}"
                for k, v in b.items():
                    if v:
                        extra[f"{ns}.{k.lower()}"] = str(v)
            extra.update(ctx.get("pilot_keys") or {})
            extra.update(ctx.get("multi_source_keys") or {})
            flat.update(extra)
            conf_text = "\n".join(f"{k}={v}" for k, v in sorted(flat.items()))
            ctx["flat_confs"].append((job_name, conf_text))

    @staticmethod
    def _prune(value):
        """Drop empty strings/dicts/lists so absent features emit no keys
        (the reference's conf omits unset namespaces entirely)."""
        if isinstance(value, dict):
            out = {}
            for k, v in value.items():
                pv = RuntimeConfigGeneration._prune(v)
                if pv not in ("", None) and pv != {} and pv != []:
                    out[k] = pv
            return out
        if isinstance(value, list):
            return [RuntimeConfigGeneration._prune(v) for v in value]
        return value

    def _s700_write_files(self, ctx) -> None:
        """Write transform/projection/schema + conf files
        (S700_DeployConfigFiles)."""
        result: GenerationResult = ctx["result"]
        for rel, content in result.files.items():
            self.runtime.save_file(rel, content)
        for job_name, conf_text in ctx["flat_confs"]:
            rel = os.path.join(ctx["flow_dir"], f"{job_name}.conf")
            path = self.runtime.save_file(rel, conf_text + "\n")
            result.conf_paths.append(path)
            result.job_names.append(job_name)

    def _s800_jobs(self, ctx) -> None:
        """Upsert job records (S800_DeploySparkJob.cs:23-60)."""
        for job_name, conf_path in zip(
            ctx["result"].job_names, ctx["result"].conf_paths
        ):
            existing = self.jobs.get(job_name)
            self.jobs.upsert({
                "name": job_name,
                "flow": ctx["doc"]["name"],
                "confPath": conf_path,
                "state": (existing or {}).get("state") or "idle",
            })

    def _s850_metrics(self, ctx) -> None:
        """Attach the auto-generated metrics dashboard config
        (S850_DeployMetricsConfig + CodegenRules Metrics.cs)."""
        rules_code: RulesCode = ctx["rules_code"]
        if rules_code.metrics_root:
            ctx["doc"]["metrics"] = rules_code.metrics_root
            ctx["result"].metrics = rules_code.metrics_root

    def _s900_finalize(self, ctx) -> None:
        """Persist the updated flow doc with jobNames (S900_FinishUp)."""
        ctx["doc"]["jobNames"] = ctx["result"].job_names
        self.design.save(ctx["doc"])
