"""Shared object store: the remote design/runtime storage backend.

reference: the reference keeps design-time docs in CosmosDB and runtime
artifacts in blob storage behind storage interfaces
(DataX.Config/Storage/{IDesignTimeConfigStorage,IRuntimeConfigStorage}.cs),
so the control plane and every cluster worker see one config source.
Here the same role is played by any HTTP object store speaking a
minimal S3-flavored REST subset:

    PUT    /<bucket>/<key>          store bytes
    GET    /<bucket>/<key>          fetch bytes (404 when absent)
    DELETE /<bucket>/<key>          remove
    GET    /<bucket>?prefix=<p>     JSON list of keys

``ObjectStoreClient`` is the tiny dependency-free client (urllib, token
auth, injectable transport for tests); ``ObjectStoreServer`` is a
bundled implementation of the same protocol (threaded http.server over
a local directory) so one-box and CI runs get a real shared store
without any cloud dependency — workers on other hosts point at its URL.
Engine processes resolve ``objstore://host:port/bucket/key`` conf URLs
through this client (core/confmanager.py), which is what lets a job
submitted to a cluster read the configs the control plane generated.

A whole copy of the JAX package's ``serve/objectstore.py`` (no JAX in
it): the engine reads ``objstore://`` confs and ships partitioned state
snapshots through it, and the tests and ``chip_smoke.py`` serve it in
process.
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

Transport = Callable[[str, str, Optional[bytes]], Tuple[int, bytes]]

# bounded exponential backoff on transient store failures: 3 attempts,
# doubling delay with jitter. Every consumer shares the SAME retry
# shape; what differs is the posture AFTER the retries are spent —
# fail-open for the compile cache (compile/aotcache.py: a cold compile
# beats a dead host), fail-closed for state snapshots
# (runtime/statepartition.py: losing state is never better than
# failing the batch).
RETRY_ATTEMPTS = 3
RETRY_BASE_S = 0.05
RETRY_MAX_S = 1.0


def retry_transient(fn, attempts: int = RETRY_ATTEMPTS,
                    base_s: float = RETRY_BASE_S,
                    max_s: float = RETRY_MAX_S,
                    what: str = "object-store operation"):
    """Run ``fn`` with bounded, jittered exponential backoff on
    transient failures (transport errors and 5xx responses surface as
    IOError/OSError from the client methods below). The LAST failure
    re-raises — posture (open/closed) is the caller's decision."""
    last: Optional[Exception] = None
    for attempt in range(max(1, int(attempts))):
        try:
            return fn()
        except (IOError, OSError) as e:  # includes urllib.error.URLError
            last = e
            if attempt + 1 >= attempts:
                break
            delay = min(max_s, base_s * (2 ** attempt))
            delay *= 0.5 + random.random()  # jitter: 0.5x..1.5x
            logger.warning(
                "%s failed (attempt %d/%d, retrying in %.0f ms): %s",
                what, attempt + 1, attempts, delay * 1000, e,
            )
            time.sleep(delay)
    raise last  # type: ignore[misc]


class ObjectStoreClient:
    """Minimal object-store client over the REST subset above.

    Transient failures — connection errors and 5xx responses — retry
    with bounded jittered backoff (``retries`` attempts); definitive
    answers (2xx, 404, 4xx) never retry."""

    def __init__(
        self,
        endpoint: str,
        bucket: str = "dxtpu",
        token: Optional[str] = None,
        http: Optional[Transport] = None,
        retries: int = RETRY_ATTEMPTS,
    ):
        self.endpoint = endpoint.rstrip("/")
        parsed = urllib.parse.urlparse(self.endpoint)
        if parsed.scheme not in ("http", "https"):
            raise ValueError(
                f"object-store endpoint must be http(s)://, got {endpoint!r}"
            )
        if parsed.path:
            # objstore:// URLs partition as host/bucket/key; a path
            # component would be swallowed as the bucket — fail loud
            raise ValueError(
                "object-store endpoint must not carry a path component "
                f"(got {endpoint!r}); buckets name the top level"
            )
        self.bucket = bucket
        self.token = token
        self.retries = max(1, int(retries))
        self._http = http or self._urllib_http

    def _request(self, method: str, url: str, body: Optional[bytes],
                 what: str) -> Tuple[int, bytes]:
        """One logical request: transport errors and 5xx answers are
        transient (the server may be restarting, the LB draining) and
        retry with jittered backoff; anything else is definitive."""

        def once():
            status, resp = self._http(method, url, body)
            if status >= 500:
                raise IOError(f"{what} failed ({status})")
            return status, resp

        return retry_transient(once, attempts=self.retries, what=what)

    # -- transport -------------------------------------------------------
    def _urllib_http(self, method: str, url: str, body: Optional[bytes]):
        req = urllib.request.Request(url, data=body, method=method)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def _url(self, key: str = "", query: str = "") -> str:
        path = f"{self.endpoint}/{self.bucket}"
        if key:
            path += "/" + urllib.parse.quote(key)
        if query:
            path += "?" + query
        return path

    # -- operations ------------------------------------------------------
    def put(self, key: str, content: bytes) -> None:
        status, body = self._request(
            "PUT", self._url(key), content, f"object put {key!r}"
        )
        if status not in (200, 201, 204):
            raise IOError(f"object put {key!r} failed ({status})")

    def get(self, key: str) -> Optional[bytes]:
        status, body = self._request(
            "GET", self._url(key), None, f"object get {key!r}"
        )
        if status == 404:
            return None
        if status != 200:
            raise IOError(f"object get {key!r} failed ({status})")
        return body

    def delete(self, key: str) -> bool:
        status, _ = self._request(
            "DELETE", self._url(key), None, f"object delete {key!r}"
        )
        if status in (200, 202, 204):
            return True
        if status == 404:
            return False
        raise IOError(f"object delete {key!r} failed ({status})")

    def list(self, prefix: str = "") -> List[str]:
        q = "prefix=" + urllib.parse.quote(prefix) if prefix else ""
        status, body = self._request(
            "GET", self._url(query=q), None, f"object list {prefix!r}"
        )
        if status != 200:
            raise IOError(f"object list {prefix!r} failed ({status})")
        return json.loads(body.decode() or "[]")

    def delete_prefix(self, prefix: str) -> int:
        n = 0
        for key in self.list(prefix):
            if self.delete(key):
                n += 1
        return n

    def url_for(self, key: str) -> str:
        """objstore:// URL a worker can resolve back through this
        protocol (utils/fs.read_text -> fetch_objstore_url). TLS
        endpoints keep their scheme via the objstore+https:// form."""
        scheme, host = self.endpoint.split("://", 1)
        prefix = "objstore+https" if scheme == "https" else "objstore"
        return f"{prefix}://{host}/{self.bucket}/{key}"


_SAFE_KEY_RE = re.compile(r"^[\w\-./ %]+$")


class _StoreHandler(BaseHTTPRequestHandler):
    server_version = "dxtpu-objectstore/1"

    def log_message(self, fmt, *args):  # quiet; logger instead
        logger.debug("objectstore: " + fmt, *args)

    # path: /<bucket>/<key...> — bucket is one segment
    def _parse(self):
        parsed = urllib.parse.urlparse(self.path)
        parts = parsed.path.lstrip("/").split("/", 1)
        bucket = urllib.parse.unquote(parts[0]) if parts[0] else ""
        key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
        query = urllib.parse.parse_qs(parsed.query)
        return bucket, key, query

    def _check_auth(self) -> bool:
        token = self.server.token  # type: ignore[attr-defined]
        if not token:
            return True
        got = self.headers.get("Authorization", "")
        if got == f"Bearer {token}":
            return True
        self._send(401, b"unauthorized")
        return False

    def _send(self, status: int, body: bytes = b"",
              ctype: str = "application/octet-stream"):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_PUT(self):
        if not self._check_auth():
            return
        bucket, key, _ = self._parse()
        if not bucket or not key or not _SAFE_KEY_RE.match(key) \
                or ".." in key:
            self._send(400, b"bad key")
            return
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n)
        self.server.store_put(bucket, key, data)  # type: ignore[attr-defined]
        self._send(201)

    def do_GET(self):
        if not self._check_auth():
            return
        bucket, key, query = self._parse()
        if key:
            data = self.server.store_get(bucket, key)  # type: ignore[attr-defined]
            if data is None:
                self._send(404, b"not found")
            else:
                self._send(200, data)
            return
        prefix = (query.get("prefix") or [""])[0]
        keys = self.server.store_list(bucket, prefix)  # type: ignore[attr-defined]
        self._send(200, json.dumps(keys).encode(), "application/json")

    def do_DELETE(self):
        if not self._check_auth():
            return
        bucket, key, _ = self._parse()
        ok = self.server.store_delete(bucket, key)  # type: ignore[attr-defined]
        self._send(204 if ok else 404)


class ObjectStoreServer(ThreadingHTTPServer):
    """Bundled store: the protocol above over a local directory (or
    memory), so a one-box deployment has a real shared config store the
    moment it starts — no cloud account needed. Keys map to files under
    ``root/<bucket>/<key>`` with atomic replace writes."""

    daemon_threads = True

    def __init__(self, port: int = 0, root: Optional[str] = None,
                 token: Optional[str] = None, host: str = "127.0.0.1",
                 advertise: Optional[str] = None):
        """``host``: bind address (0.0.0.0 to serve other hosts).
        ``advertise``: the endpoint URL baked into objstore:// conf
        references — REQUIRED to be externally reachable when workers
        run on other machines; defaults to the bind address."""
        super().__init__((host, port), _StoreHandler)
        self.root = root
        self.token = token
        self.advertise = advertise
        self._bind_host = host
        self._mem: Dict[Tuple[str, str], bytes] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def endpoint(self) -> str:
        if self.advertise:
            return self.advertise.rstrip("/")
        host = self._bind_host if self._bind_host not in ("", "0.0.0.0") \
            else "127.0.0.1"
        return f"http://{host}:{self.port}"

    def start(self) -> "ObjectStoreServer":
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()

    # -- backend ---------------------------------------------------------
    def _file(self, bucket: str, key: str) -> str:
        path = os.path.realpath(os.path.join(self.root, bucket, key))
        root = os.path.realpath(self.root)
        if not path.startswith(root + os.sep):
            raise ValueError("key escapes store root")
        return path

    def store_put(self, bucket: str, key: str, data: bytes) -> None:
        if self.root is None:
            with self._lock:
                self._mem[(bucket, key)] = data
            return
        path = self._file(bucket, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def store_get(self, bucket: str, key: str) -> Optional[bytes]:
        if self.root is None:
            with self._lock:
                return self._mem.get((bucket, key))
        try:
            with open(self._file(bucket, key), "rb") as f:
                return f.read()
        except (FileNotFoundError, ValueError, NotADirectoryError,
                IsADirectoryError):
            return None

    def store_delete(self, bucket: str, key: str) -> bool:
        if self.root is None:
            with self._lock:
                return self._mem.pop((bucket, key), None) is not None
        try:
            os.remove(self._file(bucket, key))
            return True
        except (FileNotFoundError, ValueError, NotADirectoryError,
                IsADirectoryError):
            # a directory is not an object; only exact keys delete here
            return False

    def store_list(self, bucket: str, prefix: str) -> List[str]:
        if self.root is None:
            with self._lock:
                return sorted(
                    k for (b, k) in self._mem if b == bucket
                    and k.startswith(prefix)
                )
        base = os.path.join(self.root, bucket)
        out: List[str] = []
        for dirpath, _dirs, files in os.walk(base):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), base)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)


def is_objstore_url(path: str) -> bool:
    return path.startswith("objstore://") or path.startswith(
        "objstore+https://"
    )


def fetch_objstore_url(url: str, token: Optional[str] = None) -> str:
    """Resolve an ``objstore://host:port/bucket/key`` (or
    ``objstore+https://``) URL to text — how engine workers read
    configs the control plane stored remotely."""
    if url.startswith("objstore+https://"):
        scheme, rest = "https", url[len("objstore+https://"):]
    elif url.startswith("objstore://"):
        scheme, rest = "http", url[len("objstore://"):]
    else:
        raise ValueError(f"not an objstore URL: {url!r}")
    host, _, bucket_key = rest.partition("/")
    bucket, _, key = bucket_key.partition("/")
    client = ObjectStoreClient(f"{scheme}://{host}", bucket, token=token)
    data = client.get(key)
    if data is None:
        raise FileNotFoundError(url)
    return data.decode("utf-8")
