"""Design-time and runtime config storage.

reference: DataX.Config/Storage/{IDesignTimeConfigStorage,
IRuntimeConfigStorage}.cs with the CosmosDB implementation for flow
documents and blob storage for runtime files; the local ("one-box")
implementations are DataX.Config.Local/{LocalDesignTimeStorage,
LocalRuntimeTimeStorage}.cs. Here the local filesystem is the primary
backend (TPU VMs mount shared storage); the interfaces keep the same
split so an object-store backend can slot in.

Copy of the JAX package's ``serve/storage.py``, whole: the design-time
flow store (``DesignTimeStorage``, ``LocalDesignTimeStorage``,
``ObjectDesignTimeStorage``), the runtime artifact store
(``RuntimeStorage``, ``LocalRuntimeStorage``, ``ObjectRuntimeStorage``,
over the port's ``serve/objectstore.py``; schema inference and the
designer's kernels use it too) and ``JobRegistry``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional


class DesignTimeStorage:
    """Flow documents keyed by flow name."""

    def get_by_name(self, name: str) -> Optional[dict]:
        raise NotImplementedError

    def get_all(self) -> List[dict]:
        raise NotImplementedError

    def save(self, doc: dict) -> dict:
        raise NotImplementedError

    def delete(self, name: str) -> bool:
        raise NotImplementedError


class LocalDesignTimeStorage(DesignTimeStorage):
    """One JSON file per flow under ``root/`` (diskdb analog)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, name: str) -> str:
        safe = "".join(c for c in name if c.isalnum() or c in "-_.")
        return os.path.join(self.root, f"{safe}.json")

    def get_by_name(self, name: str) -> Optional[dict]:
        p = self._path(name)
        if not os.path.exists(p):
            return None
        with open(p, "r", encoding="utf-8") as f:
            return json.load(f)

    def get_all(self) -> List[dict]:
        out = []
        for fn in sorted(os.listdir(self.root)):
            if fn.endswith(".json"):
                with open(os.path.join(self.root, fn), encoding="utf-8") as f:
                    out.append(json.load(f))
        return out

    def save(self, doc: dict) -> dict:
        name = doc.get("name")
        if not name:
            raise ValueError("flow document requires a 'name'")
        with self._lock:
            tmp = self._path(name) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, self._path(name))
        return doc

    def delete(self, name: str) -> bool:
        p = self._path(name)
        if os.path.exists(p):
            os.remove(p)
            return True
        return False


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


class ObjectDesignTimeStorage(DesignTimeStorage):
    """Flow documents in a shared object store — the CosmosDB-role
    backend (reference: DataX.Config.Storage CosmosDB impl of
    IDesignTimeConfigStorage) so every control-plane replica sees the
    same designs. Keys: ``design/<name>.json``."""

    PREFIX = "design/"

    def __init__(self, client):
        from .objectstore import ObjectStoreClient  # noqa: F401 — type

        self.client = client

    def _key(self, name: str) -> str:
        safe = "".join(c for c in name if c.isalnum() or c in "-_.")
        return f"{self.PREFIX}{safe}.json"

    def get_by_name(self, name: str) -> Optional[dict]:
        data = self.client.get(self._key(name))
        return json.loads(data.decode()) if data is not None else None

    def get_all(self) -> List[dict]:
        out = []
        for key in self.client.list(self.PREFIX):
            data = self.client.get(key)
            if data is not None:
                out.append(json.loads(data.decode()))
        return out

    def save(self, doc: dict) -> dict:
        name = doc.get("name")
        if not name:
            raise ValueError("flow document requires a 'name'")
        self.client.put(self._key(name), json.dumps(doc, indent=1).encode())
        return doc

    def delete(self, name: str) -> bool:
        return self.client.delete(self._key(name))


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


class JobRegistry:
    """Job records (name -> record dict), stored alongside runtime configs.

    reference: DataX.Config SparkJobData/SparkJobConfig docs in the
    design-time store, upserted by S800_DeploySparkJob.cs:23-60.
    """

    def __init__(self, storage: RuntimeStorage):
        self.storage = storage
        self._lock = threading.Lock()

    def _path(self, name: str) -> str:
        return os.path.join("jobs", f"{name}.json")

    def upsert(self, record: dict) -> dict:
        name = record["name"]
        with self._lock:
            existing = self.get(name) or {}
            existing.update(record)
            self.storage.save_file(self._path(name), json.dumps(existing, indent=1))
        return existing

    def get(self, name: str) -> Optional[dict]:
        try:
            return json.loads(self.storage.read_file(self._path(name)))
        except FileNotFoundError:
            return None

    def get_all(self) -> List[dict]:
        out = []
        for rel in self.storage.list_files("jobs"):
            if rel.endswith(".json"):
                out.append(json.loads(self.storage.read_file(rel)))
        return out

    def delete(self, name: str) -> None:
        self.storage.delete_all(self._path(name))
