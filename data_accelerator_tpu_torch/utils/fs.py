"""Filesystem reads of conf-referenced content (gzip-aware).

A trimmed copy of the JAX package's ``utils/fs.py``: the port needs only
``read_text``. ``objstore://`` URLs need the object-store client, which
is not ported yet, so they raise.
"""

from __future__ import annotations

import gzip

from ..core.config import EngineException


def is_gzip(path: str) -> bool:
    return path.endswith(".gz")


def read_text(path: str) -> str:
    """Gzip-aware whole-file text read (HadoopClient gzip read path)."""
    if path.startswith("objstore://") or path.startswith("objstore+https://"):
        raise EngineException(
            f"cannot read {path!r}: the objstore:// client is not ported yet"
        )
    if is_gzip(path):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return f.read()
    with open(path, "r", encoding="utf-8") as f:
        return f.read()
