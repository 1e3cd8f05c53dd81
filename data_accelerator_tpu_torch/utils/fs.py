"""File I/O layer: atomic writes, retries, gzip awareness, listing.

The port's copy of the JAX package's ``utils/fs.py`` (reference:
datax-host fs/HadoopClient.scala:33-815 — the engine routes *all* file
access through one client that adds: gzip-aware reads (:201+),
atomic-ish writes via temp file + rename (:391-441), writes with timeout
and bounded retries (:333-362), and directory listing/copying).
``objstore://`` and ``objstore+https://`` URLs read through the port's
object-store client (``serve/objectstore.py``).
"""

from __future__ import annotations

import glob
import gzip
import itertools
import logging
import os
import shutil
import threading
import time
from typing import Iterable, List, Optional

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


def read_lines(path: str) -> List[str]:
    return read_text(path).splitlines()


def write_text(
    path: str,
    content: str,
    atomic: bool = True,
    abort: Optional[threading.Event] = None,
) -> None:
    """Write text, gzip-aware; atomic temp+rename by default
    (HadoopClient.scala:391-441 writeFile via temp + rename).

    The temp name is unique per call so concurrent writers never share a
    temp file. If ``abort`` is set before the final rename, the temp is
    discarded instead of installed.
    """
    ensure_parent_dir(path)
    target = (
        f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}" if atomic else path
    )
    try:
        if is_gzip(path):
            with gzip.open(target, "wt", encoding="utf-8") as f:
                f.write(content)
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
