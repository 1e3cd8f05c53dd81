"""Filesystem reads of conf-referenced content (gzip-aware).

A trimmed copy of the JAX package's ``utils/fs.py``: the port needs
``read_text``, ``read_lines``, ``write_text`` (atomic temp + rename),
``ensure_parent_dir`` and ``list_files``. ``objstore://`` and
``objstore+https://`` URLs read through the port's object-store client
(``serve/objectstore.py``).
"""

from __future__ import annotations

import glob
import gzip
import itertools
import os
import threading
from typing import List, Optional

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


def list_files(pattern_or_dir: str) -> List[str]:
    """List files by glob pattern or directory prefix, sorted."""
    if os.path.isdir(pattern_or_dir):
        out = []
        for root, _dirs, files in os.walk(pattern_or_dir):
            out.extend(os.path.join(root, f) for f in files)
        return sorted(out)
    return sorted(f for f in glob.glob(pattern_or_dir) if os.path.isfile(f))
