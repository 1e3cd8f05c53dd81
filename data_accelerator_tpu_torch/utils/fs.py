"""File I/O layer: atomic writes, retries, gzip awareness, listing.

The port's copy of the JAX package's ``utils/fs.py`` (reference:
datax-host fs/HadoopClient.scala:33-815 — the engine routes *all* file
access through one client that adds: gzip-aware reads (:201+),
atomic-ish writes via temp file + rename (:391-441), writes with timeout
and bounded retries (:333-362), and directory listing/copying).
``objstore://`` and ``objstore+https://`` URLs read through the port's
object-store client (``serve/objectstore.py``). A gzip write deflates
its payload in parallel blocks (``gzip_bytes``), in the manner of pigz.
"""

from __future__ import annotations

import glob
import gzip
import itertools
import logging
import os
import shutil
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Tuple

logger = logging.getLogger(__name__)

_TMP_COUNTER = itertools.count()


def ensure_parent_dir(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def is_gzip(path: str) -> bool:
    return path.endswith(".gz")


def read_text(path: str) -> str:
    """Gzip-aware whole-file text read (HadoopClient gzip read path).

    This is the fs chokepoint (reference: HadoopClient.scala resolves
    wasbs/abfs/local URIs in one place): ``objstore://`` URLs fetch from
    the shared object store, so any engine conf value may point at a
    file the control plane stored remotely."""
    from ..serve.objectstore import fetch_objstore_url, is_objstore_url

    if is_objstore_url(path):
        return fetch_objstore_url(
            path, token=os.environ.get("DATAX_OBJSTORE_TOKEN")
        )
    if is_gzip(path):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return f.read()
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


# gzip payloads deflate in blocks of at least this size, each primed
# with the previous block's last 32 KiB (deflate's whole window)
_GZIP_BLOCK = 64 * 1024
_GZIP_WINDOW = 32 * 1024

_pool_lock = threading.Lock()
_pool: Optional[Tuple[int, ThreadPoolExecutor]] = None
_in_pool = threading.local()


def gzip_workers() -> int:
    """The deflate pool's width: the process's cores, at most 8."""
    return min(8, len(os.sched_getaffinity(0)))


def _mark_worker() -> None:
    _in_pool.worker = True


def _gzip_pool() -> ThreadPoolExecutor:
    """The process's deflate pool, built at its first use and again in a
    forked child (whose copy of the parent's pool has no threads)."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[0] != os.getpid():
            _pool = (os.getpid(), ThreadPoolExecutor(
                gzip_workers(), thread_name_prefix="gzip",
                initializer=_mark_worker))
        return _pool[1]


def _deflate_block(data: memoryview, lo: int, hi: int, last: bool) -> bytes:
    """Raw deflate (level 9) of ``data[lo:hi]``, primed with the window
    before it; the last block ends the stream, every other ends on a
    byte boundary (a sync flush), so the blocks concatenate into one
    stream that inflates to ``data``."""
    if lo:
        c = zlib.compressobj(9, zlib.DEFLATED, -15, 8, zlib.Z_DEFAULT_STRATEGY,
                             data[max(0, lo - _GZIP_WINDOW):lo])
    else:
        c = zlib.compressobj(9, zlib.DEFLATED, -15, 8)
    return c.compress(data[lo:hi]) + c.flush(
        zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def _gzip(data: bytes) -> Tuple[bytes, int]:
    """``gzip_bytes`` and its number of deflate blocks."""
    view = memoryview(data)
    n = len(data)
    # each block at least _GZIP_BLOCK bytes; one block (under two blocks'
    # worth, or on one of the pool's own threads) deflates here
    k = 1 if getattr(_in_pool, "worker", False) else max(
        1, min(gzip_workers(), n // _GZIP_BLOCK))
    if k == 1:
        parts = [_deflate_block(view, 0, n, True)]
        crc = zlib.crc32(data)
    else:
        cuts = [n * i // k for i in range(k + 1)]
        pool = _gzip_pool()
        futures = [pool.submit(_deflate_block, view, cuts[i], cuts[i + 1], i == k - 1)
                   for i in range(k)]
        crc = zlib.crc32(data)  # releases the interpreter lock, as deflate does
        parts = [f.result() for f in futures]
    # one RFC 1952 member: no flags, the mtime, XFL 2 (best), OS 255
    header = struct.pack("<4BI2B", 0x1F, 0x8B, 8, 0, int(time.time()), 2, 255)
    trailer = struct.pack("<2I", crc, n & 0xFFFFFFFF)
    return b"".join([header, *parts, trailer]), k


def gzip_bytes(data: bytes) -> bytes:
    """One gzip member holding ``data``, deflated at level 9 in blocks of
    at least 64 KiB on the process's deflate pool (one block, on the
    caller's thread, under 128 KiB). Any gzip reader inflates it to
    ``data``; it is within a few hundredths of a percent of
    ``gzip.compress(data, 9)``'s size."""
    return _gzip(data)[0]


def read_lines(path: str) -> List[str]:
    return read_text(path).splitlines()


def write_text(
    path: str,
    content: str,
    atomic: bool = True,
    abort: Optional[threading.Event] = None,
) -> Tuple[int, int]:
    """Write text, gzip-aware; atomic temp+rename by default
    (HadoopClient.scala:391-441 writeFile via temp + rename).

    The temp name is unique per call so concurrent writers never share a
    temp file. If ``abort`` is set before the final rename, the temp is
    discarded instead of installed. Returns (deflate blocks, bytes of
    the gzip file) for a ``.gz`` path, else (0, 0).
    """
    ensure_parent_dir(path)
    target = (
        f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}" if atomic else path
    )
    written = (0, 0)
    try:
        if is_gzip(path):
            blob, blocks = _gzip(content.encode("utf-8"))
            with open(target, "wb") as f:
                f.write(blob)
            written = (blocks, len(blob))
        else:
            with open(target, "w", encoding="utf-8") as f:
                f.write(content)
        if atomic:
            if abort is not None and abort.is_set():
                raise InterruptedError(f"write of {path} superseded")
            os.replace(target, path)
    finally:
        if atomic and os.path.exists(target):
            try:
                os.remove(target)
            except OSError:
                pass
    return written


def write_with_timeout_and_retries(
    path: str,
    content: str,
    timeout_s: float = 10.0,
    retries: int = 3,
) -> bool:
    """Bounded-time write with retries (HadoopClient.scala:333-362:
    each attempt runs under a timeout; failures retry up to the limit).

    Returns True on success; raises the last error after exhausting
    retries (the caller's batch try/except owns the retry-batch policy).
    """
    last_err: Optional[BaseException] = None
    orphans: List[threading.Thread] = []
    for attempt in range(1, retries + 1):
        done = threading.Event()
        abort = threading.Event()
        err: List[BaseException] = []

        def attempt_write():
            try:
                write_text(path, content, abort=abort)
            except Exception as e:  # noqa: BLE001 — captured for the caller
                err.append(e)
            finally:
                done.set()

        t = threading.Thread(target=attempt_write, daemon=True)
        t.start()
        if not done.wait(timeout_s):
            # the orphan writes a unique temp and checks `abort` before
            # its rename. An orphan that passes the check just before
            # abort.set() can still rename afterwards — the window is
            # narrowed, not closed. Within this call that is harmless
            # (every attempt writes identical bytes); writers of
            # *different* content to the same path must serialize
            # externally (the sink dispatcher does).
            abort.set()
            orphans.append(t)
            last_err = TimeoutError(
                f"write of {path} exceeded {timeout_s}s (attempt {attempt})"
            )
            logger.warning("%s", last_err)
            continue
        if err:
            last_err = err[0]
            logger.warning(
                "write of %s failed (attempt %d): %s", path, attempt, last_err
            )
            continue
        # best-effort: drain straggler attempts so none outlives success
        for o in orphans:
            o.join(timeout=0.1)
        return True
    if last_err is None:
        raise ValueError(f"retries must be >= 1, got {retries}")
    raise last_err


def list_files(pattern_or_dir: str) -> List[str]:
    """List files by glob pattern or directory prefix, sorted."""
    if os.path.isdir(pattern_or_dir):
        out = []
        for root, _dirs, files in os.walk(pattern_or_dir):
            out.extend(os.path.join(root, f) for f in files)
        return sorted(out)
    return sorted(f for f in glob.glob(pattern_or_dir) if os.path.isfile(f))


def copy_file(src: str, dst: str) -> None:
    ensure_parent_dir(dst)
    shutil.copyfile(src, dst)


def delete_path(path: str) -> bool:
    """Remove a file or directory tree; True if anything was removed."""
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
        return True
    if os.path.exists(path):
        os.remove(path)
        return True
    return False


def append_lines(path: str, lines: Iterable[str]) -> None:
    ensure_parent_dir(path)
    with open(path, "a", encoding="utf-8") as f:
        for line in lines:
            f.write(line.rstrip("\n") + "\n")


def file_modified_ms(path: str) -> int:
    return int(os.path.getmtime(path) * 1000)


def wait_for_file(path: str, timeout_s: float, poll_s: float = 0.05) -> bool:
    """Poll until a file exists (used by tests and job-handoff paths)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if os.path.exists(path):
            return True
        time.sleep(poll_s)
    return os.path.exists(path)
