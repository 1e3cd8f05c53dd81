"""Persistent kernel build cache, optionally shared via objstore://.

The port of the JAX package's ``compile/aotcache.py``, with one
difference: what is cached is the port's built kernel libraries
(``kernels/build.py``: each ``.cu`` through ``nvcc``, a host ``.cpp``
through ``g++``), not XLA executables. The first-use cost it removes is
the compiler's. ``FlowProcessor._aot_warm`` builds every kernel its step
calls at init; with this cache the builds inside that warm resolve from
libraries on disk and, when a shared object store is configured, newly
built libraries are pushed back so the NEXT start (restart, preemption
recovery, scale-out replica, a LiveQuery kernel pool on another box)
loads instead of compiling.

Layering:

- **local dir** (``datax.job.process.compile.cachedir``): the directory
  kernels build into while the cache is armed (``enable``: the whole
  process, as the JAX class sets ``jax_compilation_cache_dir``;
  ``scope``: one thread's block, which is how a processor arms it, since
  one process holds many processors, each with its own cache).
- **shared store** (``datax.job.process.compile.cacheurl``, an
  ``objstore://host:port/bucket/prefix`` URL): ``open``/``enable``
  pulls entries absent locally; ``push()`` uploads entries created
  since. Entries are named by their content key (the source's bytes,
  the flags and the compiler's ``--version`` text), so a stale entry
  can never be *loaded* wrongly, only ignored.

File counting is at library granularity (the ``*.so`` files; a
library's ``.log``, the ``ptxas -v`` report, travels with it but is not
counted, as the JAX class skips its ``*-atime`` files, and ``*.tmp``
files are writes in flight), which is what the
``Compile_Cache_{Hit,Miss}_Count`` metrics report.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import tempfile
from typing import List, Optional, Set, Tuple

from ..kernels import build

logger = logging.getLogger(__name__)

LIBRARY_SUFFIX = ".so"
# what travels with a library: its build log
LOG_SUFFIX = ".log"


def compile_conf_for(cache_dir: str,
                     cache_url: Optional[str] = None) -> dict:
    """The ``datax.job.process.compile.*`` conf keys that arm this
    cache for a kernel pool — the one way LiveQuery surfaces (REST
    kernel pool, serving-plane warm cache, one-box server) build their
    shared compile conf, so the layers can't drift on key names."""
    conf = {"datax.job.process.compile.cachedir": cache_dir}
    if cache_url:
        conf["datax.job.process.compile.cacheurl"] = cache_url
    return conf


def _parse_objstore_url(url: str) -> Tuple[str, str, str]:
    """objstore://host:port/bucket/prefix -> (endpoint, bucket, prefix)."""
    if url.startswith("objstore+https://"):
        scheme, rest = "https", url[len("objstore+https://"):]
    elif url.startswith("objstore://"):
        scheme, rest = "http", url[len("objstore://"):]
    else:
        raise ValueError(f"not an objstore URL: {url!r}")
    host, _, bucket_key = rest.partition("/")
    bucket, _, prefix = bucket_key.partition("/")
    if not bucket:
        raise ValueError(f"objstore URL needs a bucket: {url!r}")
    return f"{scheme}://{host}", bucket, prefix.strip("/")


class PersistentCompileCache:
    """One flow's compile-cache session: local library dir + optional
    shared objstore layer."""

    def __init__(
        self, cache_dir: Optional[str] = None,
        cache_url: Optional[str] = None,
    ):
        if not cache_dir and not cache_url:
            raise ValueError("cache_dir or cache_url required")
        self.url = cache_url
        self._client = None
        self._prefix = ""
        if cache_url:
            from ..serve.objectstore import ObjectStoreClient

            endpoint, bucket, prefix = _parse_objstore_url(cache_url)
            token = os.environ.get("DATAX_OBJSTORE_TOKEN")
            self._client = ObjectStoreClient(endpoint, bucket, token=token)
            self._prefix = prefix
        if not cache_dir:
            # deterministic local layer per shared prefix so co-located
            # flows sharing a cacheurl also share the local dir
            cache_dir = os.path.join(
                tempfile.gettempdir(), "dxtpu-torch-compile-cache",
                hashlib.sha256(cache_url.encode()).hexdigest()[:16],
            )
        self.dir = cache_dir
        # libraries pulled from the shared store by this session
        self.pulled = 0
        self._baseline: Set[str] = set()
        self._armed = False
        self._prev_dir = None

    # -- local entries ---------------------------------------------------
    def _entries(self) -> List[str]:
        try:
            return sorted(
                fn for fn in os.listdir(self.dir) if fn.endswith(LIBRARY_SUFFIX)
            )
        except OSError:
            return []

    def file_count(self) -> int:
        return len(self._entries())

    # -- lifecycle -------------------------------------------------------
    def open(self) -> None:
        """Make the local dir, pull the shared entries it lacks, and
        count new entries from here on: ``enable`` without pointing the
        process's builds at the dir (a processor builds into it only
        within its own calls, through ``scope``)."""
        os.makedirs(self.dir, exist_ok=True)
        self.pulled += self.pull()
        self._baseline = set(self._entries())

    def enable(self) -> None:
        """``open``, then point every later kernel build of the process
        at the local dir. Remembers the build dir set before so
        ``disable()`` can restore it (tests; production leaves it armed
        so later builds also persist)."""
        self.open()
        if not self._armed:
            self._prev_dir = build.set_build_dir(self.dir)
            self._armed = True

    def disable(self) -> None:
        """Restore the build dir captured by ``enable()``."""
        if not self._armed:
            return
        build.set_build_dir(self._prev_dir)
        self._armed = False
        self._prev_dir = None

    def scope(self) -> contextlib.AbstractContextManager:
        """Within the block, this thread's kernel builds use the local dir."""
        return build.build_dir_scope(self.dir)

    # -- shared layer ----------------------------------------------------
    def _key(self, fn: str) -> str:
        return f"{self._prefix}/{fn}" if self._prefix else fn

    def pull(self) -> int:
        """Download shared entries absent locally; returns the libraries
        pulled. Each lands through a temporary file and a rename, so a
        half-written library is never loaded. FAIL-OPEN: the client
        retries transient failures with bounded jittered backoff
        (serve/objectstore.py), and whatever still fails degrades to the
        local-only cache — a cold compile beats a dead host. Each entry
        fails independently so one bad object can't abort the rest of
        the pull (contrast the state-snapshot store, which is
        fail-closed: runtime/statepartition.py)."""
        if self._client is None:
            return 0
        n = 0
        try:
            have = set(os.listdir(self.dir))
            keys = self._client.list(self._prefix)
        except Exception as e:  # noqa: BLE001 — shared layer is best-effort
            logger.warning("compile-cache pull failed: %s", e)
            return 0
        for key in keys:
            fn = key.rsplit("/", 1)[-1]
            if fn in have or not fn.endswith((LIBRARY_SUFFIX, LOG_SUFFIX)):
                continue
            try:
                data = self._client.get(key)
                if data is None:
                    continue
                path = os.path.join(self.dir, fn)
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
                n += fn.endswith(LIBRARY_SUFFIX)
            except Exception as e:  # noqa: BLE001 — best-effort per entry
                logger.warning("compile-cache pull %s failed: %s", fn, e)
        return n

    def push(self) -> int:
        """Upload entries created since ``open()`` (the builds this
        process actually paid for), each with its build log, and return
        how many there were — the ``Compile_Cache_Miss_Count`` number.
        With no shared store the new-entry count still reports (local
        misses)."""
        new = [fn for fn in self._entries() if fn not in self._baseline]
        if self._client is not None:
            for fn in new:
                log = fn[: -len(LIBRARY_SUFFIX)] + LOG_SUFFIX
                for name in (fn, log):
                    path = os.path.join(self.dir, name)
                    if name == log and not os.path.exists(path):
                        continue
                    try:
                        with open(path, "rb") as f:
                            self._client.put(self._key(name), f.read())
                    except Exception as e:  # noqa: BLE001 — best-effort
                        logger.warning("compile-cache push %s failed: %s", name, e)
        self._baseline |= set(new)
        return len(new)
