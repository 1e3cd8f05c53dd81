"""Website server: static SPA + API proxy + live metric feed.

reference: Website/Website — an Express server that (a) serves the
composed React packages per ``web.composition.json``, (b) proxies REST
calls to the Gateway, and (c) polls Redis sorted sets every 700 ms,
emitting ``datapoints`` over socket.io rooms per metric key
(metrics/dataProxy/redisProxy.js:21-52,71-80) with a
``zrangebyscore`` history backfill on init.

TPU-native stand-in: one ThreadingHTTPServer.

- ``/``, ``/static/*``      — the SPA (static/ directory).
- ``/api/*``                — forwarded to the Gateway (HTTP) or
                              dispatched in-process against a DataXApi
                              (the one-box wiring, like the reference's
                              DATAX_ENABLE_ONEBOX local mode).
- ``/metrics/stream``       — Server-Sent Events; every MetricStore
                              zadd is pushed as a ``datapoints`` event
                              (push replaces the reference's 700 ms
                              poll — the store publishes on write).
- ``/metrics/history``      — zrangebyscore backfill for a key.
- ``/metrics/keys``         — known metric keys by prefix.
- ``/metrics``              — Prometheus text exposition (per-stage
                              latency histograms + latest gauge values;
                              obs/exposition.py renders it, same dialect
                              as every runtime host's own endpoint).
- ``/alerts``               — alert rules + firing set of every
                              registered AlertEngine (``?flow=`` to
                              filter); the SPA's firing-alert
                              annotations poll this.
- ``/healthz``, ``/readyz`` — liveness/readiness probes for the website
                              process itself.
- ``/composition``          — page registry (web.composition.json role).

Copy of the JAX package's ``web/server.py``, unchanged, over the port's
``obs/exposition.py``, ``obs/histogram.py``, ``obs/store.py`` and
``obs/fleetview.py``; it serves the port's own copy of the SPA
(``web/static/``).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..obs.exposition import render_prometheus
from ..obs.histogram import HISTOGRAMS
from ..obs.store import METRIC_STORE, MetricStore

logger = logging.getLogger(__name__)

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")

_CONTENT_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".js": "text/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".json": "application/json",
    ".svg": "image/svg+xml",
    ".png": "image/png",
}

COMPOSITION = {
    "pages": [
        {"name": "home", "displayName": "Flows", "path": "#/flows"},
        {"name": "pipeline", "displayName": "Flow Designer", "path": "#/flow"},
        {"name": "query", "displayName": "Query", "path": "#/query"},
        {"name": "metrics", "displayName": "Metrics", "path": "#/metrics"},
        {"name": "jobs", "displayName": "Jobs", "path": "#/jobs"},
        {"name": "fleet", "displayName": "Fleet", "path": "#/fleet"},
    ]
}


class WebsiteServer:
    """Serves the SPA and bridges it to the control plane + metrics."""

    def __init__(
        self,
        api=None,
        gateway_url: Optional[str] = None,
        gateway_token: Optional[str] = None,
        store: Optional[MetricStore] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        static_dir: Optional[str] = None,
        alerts=None,
        fleet=None,
    ):
        if api is None and gateway_url is None:
            raise ValueError("need an in-process api or a gateway_url")
        self.api = api
        self.gateway_url = gateway_url
        self.gateway_token = gateway_token
        self.store = store if store is not None else METRIC_STORE
        self.static_dir = static_dir or STATIC_DIR
        # obs.fleetview.FleetView: when wired, /metrics appends the
        # fleet rollup (datax_fleet_*) to the per-process exposition
        self.fleet = fleet
        # obs.alerts.AlertEngine instances (one per flow) whose firing
        # sets the SPA annotates; register_alerts() adds more at runtime
        self.alert_engines = list(alerts or [])
        ws = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("web %s", fmt % args)

            def _send(self, status: int, body: bytes, ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, status: int, payload) -> None:
                self._send(
                    status, json.dumps(payload, default=str).encode(),
                    "application/json",
                )

            def _handle(self, method: str) -> None:
                parsed = urlparse(self.path)
                path = parsed.path
                if path.startswith("/api/"):
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else None
                    status, payload = ws.call_api(method, path, parsed.query, body)
                    self._send_json(status, payload)
                elif path == "/metrics/post" and method == "POST":
                    # jobs in local mode POST metric points here instead
                    # of Redis (the localMetricsHttpEndpoint path,
                    # MetricLogger.scala:65-69 -> website)
                    length = int(self.headers.get("Content-Length") or 0)
                    try:
                        points = json.loads(self.rfile.read(length) or b"[]")
                    except ValueError:
                        self._send_json(400, {"error": "invalid JSON"})
                        return
                    n = 0
                    for p in points if isinstance(points, list) else [points]:
                        try:
                            key = f"{p['app']}:{p['metric']}"
                            ws.store.add_point(key, int(p["uts"]), p["value"])
                            n += 1
                        except (KeyError, TypeError, ValueError):
                            continue
                    self._send_json(200, {"stored": n})
                elif path == "/metrics" and method == "GET":
                    # Prometheus scrape: stage histograms (one-box jobs
                    # share the process HISTOGRAMS registry) + the latest
                    # point of every MetricStore key as a gauge
                    body = render_prometheus(HISTOGRAMS, ws.store).encode()
                    if ws.fleet is not None:
                        from ..obs.fleetview import render_fleet_prometheus

                        try:
                            body += render_fleet_prometheus(
                                ws.fleet
                            ).encode()
                        except Exception:  # noqa: BLE001 — scrape survives
                            logger.exception("fleet exposition failed")
                    self._send(
                        200, body,
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/alerts":
                    q = parse_qs(parsed.query)
                    flow = (q.get("flow") or [""])[0]
                    snaps = [
                        e.snapshot() for e in ws.alert_engines
                        if not flow or e.flow == flow
                    ]
                    self._send_json(200, {
                        "alerts": snaps,
                        "firing": [
                            {**a, "flow": s["flow"]}
                            for s in snaps for a in s["firing"]
                        ],
                    })
                elif path == "/healthz":
                    self._send_json(200, {"status": "ok", "role": "website"})
                elif path == "/readyz":
                    ready = ws.api is not None or ws.gateway_url is not None
                    self._send_json(
                        200 if ready else 503,
                        {"ready": ready, "role": "website"},
                    )
                elif path == "/metrics/stream":
                    self._sse(parse_qs(parsed.query))
                elif path == "/metrics/history":
                    q = parse_qs(parsed.query)
                    key = (q.get("key") or [""])[0]
                    try:
                        lo = float((q.get("from") or ["0"])[0])
                        hi = float((q.get("to") or ["inf"])[0])
                    except ValueError:
                        self._send_json(400, {"error": "bad from/to"})
                        return
                    self._send_json(200, ws.store.points(key, lo, hi))
                elif path == "/metrics/keys":
                    q = parse_qs(parsed.query)
                    prefix = (q.get("prefix") or [""])[0]
                    self._send_json(200, ws.store.keys(prefix))
                elif path == "/composition":
                    self._send_json(200, COMPOSITION)
                else:
                    self._static(path)

            def _static(self, path: str) -> None:
                rel = path.lstrip("/") or "index.html"
                if rel.startswith("static/"):
                    rel = rel[len("static/"):]
                root = os.path.abspath(ws.static_dir)
                full = os.path.abspath(os.path.join(root, rel))
                if os.path.commonpath([full, root]) != root:
                    self._send_json(403, {"error": "forbidden"})
                    return
                if not os.path.isfile(full):
                    # SPA fallback: unknown paths load the app shell
                    full = os.path.join(ws.static_dir, "index.html")
                    if not os.path.isfile(full):
                        self._send_json(404, {"error": "not found"})
                        return
                ext = os.path.splitext(full)[1]
                with open(full, "rb") as f:
                    self._send(
                        200, f.read(),
                        _CONTENT_TYPES.get(ext, "application/octet-stream"),
                    )

            def _sse(self, q: Dict) -> None:
                """Push 'datapoints' events for keys matching ?prefix=
                (socket.io room-per-metric analog)."""
                prefix = (q.get("prefix") or [""])[0]
                feed: "queue.Queue" = queue.Queue(maxsize=1000)

                def on_add(key, score, member):
                    if key.startswith(prefix):
                        try:
                            feed.put_nowait((key, score, member))
                        except queue.Full:
                            pass

                ws.store.subscribe(on_add)
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    while True:
                        try:
                            key, score, member = feed.get(timeout=15.0)
                            payload = json.dumps(
                                {"key": key, "score": score, "member": member}
                            )
                            chunk = f"event: datapoints\ndata: {payload}\n\n"
                        except queue.Empty:
                            chunk = ": keepalive\n\n"
                        self.wfile.write(chunk.encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # client went away
                finally:
                    ws.store.unsubscribe(on_add)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

        self._server = ThreadingHTTPServer((host, port), Handler)
        # SSE keeps sockets open; don't block shutdown on them
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- API bridging -----------------------------------------------------
    def call_api(
        self, method: str, path: str, query: str, body: Optional[bytes]
    ) -> Tuple[int, dict]:
        if self.gateway_url:
            url = f"{self.gateway_url.rstrip('/')}{path}"
            if query:
                url += f"?{query}"
            headers = {"Content-Type": "application/json"}
            if self.gateway_token:
                headers["Authorization"] = f"Bearer {self.gateway_token}"
            req = urllib.request.Request(
                url, data=body, headers=headers, method=method
            )
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    return resp.status, json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                try:
                    return e.code, json.loads(e.read() or b"{}")
                except ValueError:
                    return e.code, {"error": {"message": str(e)}}
            except (urllib.error.URLError, OSError) as e:
                return 502, {"error": {"message": f"gateway unreachable: {e}"}}
        # one-box: dispatch straight into the in-process DataXApi;
        # strip the gateway's /api/{service} hop (single-service mode)
        parts = path.split("/", 3)  # '', 'api', maybe service, rest
        rest = parts[3] if len(parts) > 3 and parts[2] in (
            "flow", "interactivequery", "schemainference", "livedata"
        ) else path[len("/api/"):]
        parsed_body = None
        if body:
            try:
                parsed_body = json.loads(body)
            except ValueError:
                return 400, {"error": {"message": "invalid JSON body"}}
        return self.api.dispatch(
            method, rest, body=parsed_body, query=parse_qs(query)
        )

    def register_alerts(self, engine) -> None:
        """Register a flow's AlertEngine with the website's ``/alerts``
        surface (one-box hosts running in-process do this; remote hosts
        serve their own /alerts on the observability port)."""
        self.alert_engines.append(engine)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info("website on :%d", self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def serve_forever(self) -> None:
        self._server.serve_forever()
