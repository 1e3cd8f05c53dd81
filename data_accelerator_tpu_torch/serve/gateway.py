"""Gateway: authenticated reverse proxy in front of the flow services.

reference: Services/DataX.Gateway/DataX.Gateway.Api/Controllers/
GatewayController.cs — a single controller that (a) authenticates the
caller via AAD, (b) checks membership in the reader/writer roles and an
optional client whitelist (:113-148), then (c) forwards
``api/{service}/{*path}`` through the Service Fabric reverse proxy to
the internal service, attaching the caller's resolved roles as request
headers the services trust (:178-208).

TPU-native stand-in: bearer-token auth from a local auth table (the
AAD-role-assignment analog; tokens map to user + roles and can live in
the secret vault), per-method role enforcement (GET needs reader,
POST needs writer), and plain HTTP forwarding to registered backend
base-URLs. Caller-supplied ``X-DataX-*`` headers are stripped — only
the gateway mints them, which is exactly why services can trust them.

Copy of the JAX package's ``serve/gateway.py``, unchanged.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

ROLE_READER = "DataXReader"
ROLE_WRITER = "DataXWriter"

logger = logging.getLogger(__name__)


class AuthTable:
    """token -> (user, roles). The AAD role-assignment analog."""

    def __init__(self, entries: Optional[Dict[str, Tuple[str, List[str]]]] = None):
        self._entries = dict(entries or {})

    @staticmethod
    def from_file(path: str) -> "AuthTable":
        """JSON file: {"<token>": {"user": "...", "roles": [...]}, ...}"""
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        return AuthTable({
            tok: (v.get("user", ""), list(v.get("roles") or []))
            for tok, v in raw.items()
        })

    def add(self, token: str, user: str, roles: List[str]) -> None:
        self._entries[token] = (user, roles)

    def resolve(self, token: Optional[str]) -> Optional[Tuple[str, List[str]]]:
        if not token:
            return None
        return self._entries.get(token)


class Gateway:
    """Role-checked reverse proxy over registered backend services."""

    def __init__(
        self,
        auth: AuthTable,
        backends: Dict[str, str],
        host: str = "127.0.0.1",
        port: int = 0,
        whitelist: Optional[List[str]] = None,
        timeout_s: float = 30.0,
    ):
        self.auth = auth
        self.backends = dict(backends)  # service name -> base url
        self.whitelist = list(whitelist or [])
        self.timeout_s = timeout_s
        gw = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("gateway %s", fmt % args)

            def _respond(self, status: int, payload: dict) -> None:
                data = json.dumps(payload, default=str).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _forward(self, method: str) -> None:
                status, payload = gw.handle(
                    method,
                    self.path,
                    dict(self.headers),
                    self.rfile.read(
                        int(self.headers.get("Content-Length") or 0)
                    ) or None,
                )
                self._respond(status, payload)

            def do_GET(self):
                self._forward("GET")

            def do_POST(self):
                self._forward("POST")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- core -------------------------------------------------------------
    def authenticate(self, headers: Dict[str, str]) -> Optional[Tuple[str, List[str]]]:
        authz = headers.get("Authorization") or headers.get("authorization") or ""
        token = authz[7:].strip() if authz.lower().startswith("bearer ") else authz
        return self.auth.resolve(token.strip() or None)

    def authorize(
        self, method: str, user: str, roles: List[str]
    ) -> Optional[str]:
        """Returns an error message, or None when allowed
        (GatewayController.cs:113-148 role + whitelist check)."""
        if self.whitelist and user not in self.whitelist:
            return f"user '{user}' is not whitelisted"
        if method == "GET":
            if ROLE_READER not in roles and ROLE_WRITER not in roles:
                return "reader role required"
        else:
            if ROLE_WRITER not in roles:
                return "writer role required"
        return None

    def handle(
        self,
        method: str,
        path: str,
        headers: Dict[str, str],
        body: Optional[bytes],
    ) -> Tuple[int, dict]:
        ident = self.authenticate(headers)
        if ident is None:
            return 401, {"error": {"message": "authentication required"}}
        user, roles = ident
        err = self.authorize(method, user, roles)
        if err:
            return 403, {"error": {"message": err}}

        # api/{service}/{*path} -> backend base url + api/{*path}
        parts = path.lstrip("/").split("/", 2)
        if len(parts) < 2 or parts[0] != "api":
            return 404, {"error": {"message": "expected /api/{service}/..."}}
        service = parts[1]
        rest = parts[2] if len(parts) > 2 else ""
        base = self.backends.get(service)
        if base is None:
            return 404, {"error": {"message": f"unknown service '{service}'"}}
        url = f"{base.rstrip('/')}/api/{rest}"

        fwd_headers = {
            k: v
            for k, v in headers.items()
            if not k.lower().startswith("x-datax-")
            and k.lower() not in ("host", "content-length", "authorization")
        }
        # only the gateway mints identity headers (:178-208)
        fwd_headers["X-DataX-User"] = user
        fwd_headers["X-DataX-Roles"] = ",".join(roles)
        req = urllib.request.Request(
            url, data=body, headers=fwd_headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                raw = resp.read() or b"{}"
                try:
                    return resp.status, json.loads(raw)
                except ValueError:
                    return resp.status, {"raw": raw.decode("utf-8", "replace")}
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except ValueError:
                return e.code, {"error": {"message": str(e)}}
        except (urllib.error.URLError, OSError) as e:
            return 502, {"error": {"message": f"backend unreachable: {e}"}}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info("gateway listening on :%d", self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
