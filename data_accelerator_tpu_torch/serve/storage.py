"""Runtime artifact storage: the generated conf, transform, projection,
schema and the LiveQuery sample blob.

reference: DataX.Config/Storage/IRuntimeConfigStorage.cs with blob
storage for runtime files; the local ("one-box") implementation is
DataX.Config.Local/LocalRuntimeTimeStorage.cs.

A copy of the JAX package's ``serve/storage.py`` trimmed to
``RuntimeStorage``, ``LocalRuntimeStorage`` and ``ObjectRuntimeStorage``
(over the port's ``serve/objectstore.py``), which schema inference and
the designer's kernels use. The design-time flow store
(``DesignTimeStorage``, ``LocalDesignTimeStorage``,
``ObjectDesignTimeStorage``) and ``JobRegistry`` come with the control
plane, not ported yet.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional


class RuntimeStorage:
    """Generated runtime artifacts (conf, transform, projection, schema)."""

    def save_file(self, path: str, content: str) -> str:
        raise NotImplementedError

    def read_file(self, path: str) -> str:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list_files(self, prefix: str) -> List[str]:
        """Relative paths of stored files under ``prefix``."""
        raise NotImplementedError

    def stored_path(self, path: str) -> str:
        """The reference a generated conf should carry for a stored
        artifact — a local absolute path here, an objstore:// URL for
        the object backend (workers resolve it via utils/fs.read_text,
        the HadoopClient-chokepoint role)."""
        raise NotImplementedError

    def delete_all(self, prefix: str) -> None:
        raise NotImplementedError


class LocalRuntimeStorage(RuntimeStorage):
    """Runtime files under a root dir; atomic temp+rename writes
    (reference: HadoopClient.scala:391-441 write semantics)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def resolve(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.root, path)

    def stored_path(self, path: str) -> str:
        return self.resolve(path)

    def save_file(self, path: str, content: str) -> str:
        full = self.resolve(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = full + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(content)
        os.replace(tmp, full)
        return full

    def read_file(self, path: str) -> str:
        with open(self.resolve(path), encoding="utf-8") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(self.resolve(path))

    def list_files(self, prefix: str) -> List[str]:
        base = self.resolve(prefix)
        if os.path.isfile(base):
            return [prefix]
        out: List[str] = []
        for dirpath, _dirs, files in os.walk(base):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    def delete_all(self, prefix: str) -> None:
        full = os.path.realpath(self.resolve(prefix))
        root = os.path.realpath(self.root)
        # recursive delete only ever inside the runtime root — a flow
        # name is caller-supplied and must not reach rmtree unconfined
        if not (full == root or full.startswith(root + os.sep)):
            raise ValueError(f"refusing to delete outside runtime root: {prefix}")
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
        elif os.path.exists(full):
            os.remove(full)


class ObjectRuntimeStorage(RuntimeStorage):
    """Runtime artifacts in the shared object store — the blob-storage
    role (reference: IRuntimeConfigStorage blob impl), so a job
    submitted to a cluster host reads the exact configs the control
    plane generated. ``save_file`` returns an ``objstore://`` URL the
    engine resolves at startup (core/confmanager.py); local scratch
    (``resolve``) stays on disk for logs."""

    PREFIX = "runtime/"

    def __init__(self, client, scratch_dir: Optional[str] = None):
        self.client = client
        self.scratch = scratch_dir or os.path.join(
            os.path.expanduser("~"), ".dxtpu-scratch"
        )

    def _key(self, path: str) -> str:
        return self.PREFIX + path.lstrip("/")

    def resolve(self, path: str) -> str:
        """Local scratch path (logs etc. — host-local by design)."""
        if os.path.isabs(path):
            return path
        full = os.path.join(self.scratch, path)
        os.makedirs(os.path.dirname(full) or full, exist_ok=True)
        return full

    def save_file(self, path: str, content: str) -> str:
        key = self._key(path)
        self.client.put(key, content.encode())
        return self.client.url_for(key)

    def read_file(self, path: str) -> str:
        data = self.client.get(self._key(path))
        if data is None:
            raise FileNotFoundError(path)
        return data.decode()

    def exists(self, path: str) -> bool:
        # membership via the key listing — no object-body download
        key = self._key(path)
        return key in self.client.list(key)

    def list_files(self, prefix: str) -> List[str]:
        # directory semantics like the local backend: an exact-key file,
        # plus keys under the '/'-terminated prefix (a bare string
        # prefix would also match sibling flows sharing the spelling)
        n = len(self.PREFIX)
        key = self._key(prefix)
        out = []
        if prefix and key in self.client.list(key):
            out.append(prefix)
        term = key.rstrip("/") + "/" if prefix else self.PREFIX
        out.extend(k[n:] for k in self.client.list(term))
        return sorted(out)

    def stored_path(self, path: str) -> str:
        return self.client.url_for(self._key(path))

    def delete_all(self, prefix: str) -> None:
        # exact file, then the '/'-terminated subtree — never a bare
        # string prefix (deleting flow "iot" must not touch "iot2")
        key = self._key(prefix)
        self.client.delete(key)
        self.client.delete_prefix(key.rstrip("/") + "/")
