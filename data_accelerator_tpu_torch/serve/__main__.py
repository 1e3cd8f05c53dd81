"""Run the control plane (and optionally the full one-box stack):
``python -m data_accelerator_tpu_torch.serve``.

Args (key=value):
  port=5000          control-plane REST port
  device=cuda        where LiveQuery kernels and spawned jobs run;
                     device=cpu runs them on the CPU
  root=<tmp>/dxtpu-torch-serve   storage root (under the system's
                     temporary directory)
  roles=false        require X-DataX-Roles on mutating routes
  web=0              website port (0 = no website)
  gateway=0          gateway port (0 = no gateway; website then talks
                     to the API in-process, the one-box wiring)
  authfile=          gateway auth table JSON (token -> user/roles)
  ingest=0           metrics-ingestor TCP port (0 = off)
  scheduler=0        batch scheduler tick seconds (0 = off)
  tracefile=<root>/telemetry.jsonl
                     control-plane flight recorder; REST requests become
                     rest/<route> traces and spawned jobs join them
                     (datax.job.process.telemetry.parenttrace), so
                     `obs trace` renders one tree from the submit to its
                     batch spans. tracefile=off disables.
  objectstore=       design/runtime configs in a shared object store:
                     an endpoint URL (http://host:port) to use an
                     external store, or serve:<port> to also run the
                     bundled store server here (workers point at it)
  objectstore.host=  bundled store bind address (0.0.0.0 for remote
                     workers; default 127.0.0.1)
  objectstore.advertise=  endpoint URL baked into generated objstore://
                     conf references (must be reachable from workers)
  jobclient=local    job submission: local (child processes) or k8s
  fleetspec=         fleet-spec JSON for the DX4xx admission gate
                     (chips, hbmPerChipBytes, ... — see ANALYSIS.md
                     "Placement model"); default: the cards of
                     this machine and a card's memory (one CPU
                     device with device=cpu)
  admission=true     false = skip the fleet admission gate on job
                     submits (the reference's blind-deploy behavior)
  k8s.apiserver=     k8s API server URL (default in-cluster)
  k8s.namespace=     k8s namespace (default "default")
  k8s.image=         engine image for rendered GPU Jobs
  k8s.tokenfile=     bearer-token file (default service-account path)

The one-box analog of the reference's local container entry
(DeploymentLocal/finalrun.sh): flow services + gateway + website +
metrics path in one process, local file storage under ``root``.

Copy of the JAX package's ``serve/__main__.py`` over the port's control
plane. It takes every argument of the JAX entry point plus ``device=``
(default ``cuda``): the kernel pool, the serving plane and the jobs it
spawns run there, the default fleet spec is that device's machine, and
without a card it exits non-zero unless asked for ``device=cpu``. Its
default storage root is its own, so that the two packages' one-box
servers on one machine never share design or job storage.
"""

import logging
import os
import sys
import tempfile

from ..core.config import EngineException
from .flowservice import FlowOperation
from .livequery import require_device
from .restapi import DataXApi, DataXApiService
from .storage import LocalDesignTimeStorage, LocalRuntimeStorage


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger(__name__)
    args = dict(
        a.split("=", 1) for a in (argv or sys.argv[1:]) if "=" in a
    )
    device = args.get("device", "cuda")
    try:
        require_device(device)
    except EngineException as e:
        print(f"data_accelerator_tpu_torch.serve: {e}", file=sys.stderr)
        return 2
    root = args.get(
        "root", os.path.join(tempfile.gettempdir(), "dxtpu-torch-serve")
    )
    port = int(args.get("port", "5000"))
    web_port = int(args.get("web", "0") or 0)
    env_tokens = {}
    # end-to-end trace propagation: the control plane records REST
    # request spans into a flight recorder, generated confs point jobs
    # at the SAME file, and each submit hands its trace position to the
    # spawned host — one `obs trace` tree from designer click to batch
    tracefile = args.get("tracefile", f"{root}/telemetry.jsonl")
    tracer = None
    if tracefile and tracefile != "off":
        from ..obs.telemetry import JsonlWriter, LogWriter, TelemetryLogger
        from ..obs.tracing import Tracer

        tracer = Tracer(TelemetryLogger(
            "DataX-ControlPlane", [LogWriter(), JsonlWriter(tracefile)]
        ))
        env_tokens["telemetryTraceFile"] = tracefile
        log.info("control-plane flight recorder: %s", tracefile)
    if web_port:
        # jobs POST metrics to the website in one-box mode
        # (the localMetricsHttpEndpoint wiring, DeploymentLocal samples)
        env_tokens["localMetricsHttpEndpoint"] = (
            f"http://127.0.0.1:{web_port}/metrics/post"
        )
    parts_pre = []
    objstore = args.get("objectstore")
    if objstore:
        from .objectstore import ObjectStoreClient, ObjectStoreServer
        from .storage import ObjectDesignTimeStorage, ObjectRuntimeStorage

        if objstore.startswith("serve:"):
            store = ObjectStoreServer(
                port=int(objstore.split(":", 1)[1] or 0),
                root=f"{root}/objectstore",
                # workers on other hosts need a reachable bind+advertise
                # (objectstore.host=0.0.0.0 objectstore.advertise=http://<ip>:<port>)
                host=args.get("objectstore.host", "127.0.0.1"),
                advertise=args.get("objectstore.advertise"),
            ).start()
            parts_pre.append(store)
            endpoint = store.endpoint
            log.info("bundled object store on %s", endpoint)
        else:
            endpoint = objstore
        client = ObjectStoreClient(endpoint)
        design_storage = ObjectDesignTimeStorage(client)
        runtime_storage = ObjectRuntimeStorage(
            client, scratch_dir=f"{root}/scratch"
        )
        # fleet telemetry plane: jobs publish windowed frames into the
        # same store; the control plane aggregates them (FleetView)
        # behind GET /fleet/metrics and the website's /metrics rollup
        from ..obs.fleetview import FleetView

        fleet_view = FleetView(client=ObjectStoreClient(endpoint))
        env_tokens["fleetPublishUrl"] = (
            f"objstore://{endpoint.split('://', 1)[-1]}/dxtpu"
        )
        log.info("fleet telemetry plane: frames -> %s",
                 env_tokens["fleetPublishUrl"])
    else:
        design_storage = LocalDesignTimeStorage(f"{root}/design")
        runtime_storage = LocalRuntimeStorage(f"{root}/runtime")
        fleet_view = None

    job_client = None
    if args.get("jobclient", "local") != "local":
        from .jobs import make_job_client

        job_client = make_job_client(
            {"type": args["jobclient"],
             **{k[4:]: v for k, v in args.items() if k.startswith("k8s.")}},
            device=device,
        )

    fleet_spec = None
    if args.get("fleetspec"):
        from ..analysis import load_fleet_spec

        fleet_spec = load_fleet_spec(args["fleetspec"], device=device)
        log.info("fleet spec: %s", fleet_spec.to_dict())

    flow_ops = FlowOperation(
        design_storage,
        runtime_storage,
        job_client=job_client,
        env_tokens=env_tokens,
        fleet_spec=fleet_spec,
        fleet_admission=args.get("admission", "true") != "false",
        device=device,
    )
    # LiveQuery serving plane: the real server runs the deadline-tick
    # dispatcher thread so concurrent tenants' executes micro-batch
    # (lq.* args override the datax.job.process.lq.* defaults, e.g.
    # lq.maxbatchwaitms=8 lq.tenant.maxqps=50; lq.ticker=false falls
    # back to the tickless in-process mode)
    from ..compile.aotcache import compile_conf_for
    from ..lq.service import LiveQueryService

    lq_conf = {
        f"datax.job.process.lq.{k[3:]}": v
        for k, v in args.items() if k.startswith("lq.")
    }
    lq_conf.setdefault("datax.job.process.lq.ticker", "true")
    livequery = LiveQueryService(
        conf=lq_conf,
        compile_conf=compile_conf_for(os.path.join(
            runtime_storage.resolve("livequery"), "compilecache"
        )),
        device=device,
    )
    if fleet_view is not None:
        # job-registry records carry the authoritative partition map;
        # trace lineage stitching prefers them over frame ordering
        fleet_view.lineage_fn = flow_ops.jobs.job_lineage
    api = DataXApi(
        flow_ops, require_roles=args.get("roles", "false") == "true",
        tracer=tracer, livequery=livequery, fleet=fleet_view, device=device,
    )
    service = DataXApiService(api, port=port)
    service.start()
    log.info("control plane on :%d (storage %s, device %s)",
             service.port, root, device)

    parts = parts_pre + [service]
    if int(args.get("ingest", "0") or 0):
        from ..obs.ingestor import MetricsIngestor

        ing = MetricsIngestor(port=int(args["ingest"]))
        parts.append(ing)
        log.info("metrics ingestor on :%d", ing.port)
    gateway = None
    if int(args.get("gateway", "0") or 0):
        from .gateway import AuthTable, Gateway

        auth = (
            AuthTable.from_file(args["authfile"])
            if args.get("authfile")
            else AuthTable()
        )
        gateway = Gateway(
            auth,
            backends={
                "flow": f"http://127.0.0.1:{service.port}",
                "interactivequery": f"http://127.0.0.1:{service.port}",
                "schemainference": f"http://127.0.0.1:{service.port}",
                "livedata": f"http://127.0.0.1:{service.port}",
            },
            port=int(args["gateway"]),
        )
        gateway.start()
        parts.append(gateway)
        log.info("gateway on :%d", gateway.port)
    if web_port:
        from ..web import WebsiteServer

        if gateway is not None:
            # browser traffic must pass the gateway's role gate
            web = WebsiteServer(
                gateway_url=f"http://127.0.0.1:{gateway.port}",
                gateway_token=args.get("webtoken"),
                port=web_port,
            )
            if not args.get("webtoken"):
                log.warning("gateway enabled but no webtoken= given; "
                            "website API calls will be unauthenticated")
        else:
            web = WebsiteServer(api=api, port=web_port, fleet=fleet_view)
        web.start()
        parts.append(web)
        log.info("website on :%d", web.port)
    if float(args.get("scheduler", "0") or 0):
        from .scheduler import TimedScheduler

        sched = TimedScheduler(
            flow_ops,
            interval_s=float(args["scheduler"]),
            replanner=flow_ops.placement,
            fleet_view=fleet_view,
        )
        sched.start()
        parts.append(sched)
        log.info("batch scheduler every %ss", sched.interval_s)

    try:
        # the API service already runs on its own thread; park here
        import threading

        threading.Event().wait()
    except KeyboardInterrupt:
        for p in parts:
            try:
                getattr(p, "stop", getattr(p, "close", lambda: None))()
            except Exception:  # noqa: BLE001 — best-effort shutdown
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
