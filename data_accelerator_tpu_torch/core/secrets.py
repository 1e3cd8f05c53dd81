"""Secret resolution: ``keyvault://vault/name`` URIs in config values.

reference: datax-host securedsetting/KeyVaultClient.scala:19-130 — any
config *value* may be a ``keyvault://<vault>/<secret>`` URI and the engine
resolves it transparently (``resolveSecretIfAny`` applied to every value
read, :108-125); the C# side generates the same URIs at config-gen time
(DataX.Config.KeyVault). The vault itself is reached with MSI auth
(datax-keyvault/KeyVaultMsiAuthenticatorClient.scala).

TPU-native stand-in: vaults are local JSON files (``<root>/<vault>.json``
name->secret maps, the one-box analog of a cloud vault) with an
environment-variable overlay ``DATAX_SECRET_<VAULT>_<NAME>`` taking
precedence (the MSI-equivalent injection path under k8s: mount secrets
as env). A process-wide resolver keeps one cache, like the reference's
singleton client.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Optional

SECRET_URI_RE = re.compile(r"^(keyvault|secretscope|secret)://([^/]+)/(.+)$")

DEFAULT_VAULT_DIR_ENV = "DATAX_VAULT_DIR"


class SecretNotFound(KeyError):
    pass


class SecretVault:
    """Resolves secret URIs from env overlay + local vault files."""

    def __init__(self, vault_dir: Optional[str] = None):
        # default under $HOME, not /tmp: a world-writable default dir
        # would let any local user pre-seed secrets the config resolves
        self.vault_dir = vault_dir or os.environ.get(
            DEFAULT_VAULT_DIR_ENV, os.path.expanduser("~/.dxtpu/vault")
        )
        self._cache: Dict[str, Dict[str, str]] = {}
        self._lock = threading.Lock()

    def _env_key(self, vault: str, name: str) -> str:
        clean = lambda s: re.sub(r"[^A-Za-z0-9]", "_", s).upper()  # noqa: E731
        return f"DATAX_SECRET_{clean(vault)}_{clean(name)}"

    def _load_vault(self, vault: str) -> Dict[str, str]:
        with self._lock:
            if vault in self._cache:
                return self._cache[vault]
        path = os.path.join(self.vault_dir, f"{vault}.json")
        data: Dict[str, str] = {}
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                data = {str(k): str(v) for k, v in json.load(f).items()}
        with self._lock:
            self._cache[vault] = data
        return data

    def invalidate(self) -> None:
        with self._lock:
            self._cache.clear()

    def get_secret(self, vault: str, name: str) -> str:
        env = os.environ.get(self._env_key(vault, name))
        if env is not None:
            return env
        data = self._load_vault(vault)
        if name not in data:
            raise SecretNotFound(f"secret {name!r} not found in vault {vault!r}")
        return data[name]

    def set_secret(self, vault: str, name: str, value: str) -> str:
        """Write-through to the vault file; returns the canonical URI
        (the config-gen side mints URIs this way, DataX.Config.KeyVault).

        The vault dir/file get owner-only permissions — the local-file
        vault is only as private as its mode."""
        os.makedirs(self.vault_dir, mode=0o700, exist_ok=True)
        try:
            os.chmod(self.vault_dir, 0o700)
        except OSError:
            pass
        path = os.path.join(self.vault_dir, f"{vault}.json")
        data = dict(self._load_vault(vault))
        data[name] = value
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        with self._lock:
            self._cache[vault] = data
        return secret_uri(vault, name)

    # -- uri resolution ---------------------------------------------------
    def resolve_if_any(self, value: Any) -> Any:
        """Resolve a value if it is a secret URI, else return unchanged
        (KeyVaultClient.scala resolveSecretIfAny :108-125)."""
        if not isinstance(value, str):
            return value
        m = SECRET_URI_RE.match(value.strip())
        if not m:
            return value
        return self.get_secret(m.group(2), m.group(3))

    def resolve_deep(self, value: Any) -> Any:
        """Deep-resolve URIs in nested dict/list config structures."""
        if isinstance(value, dict):
            return {k: self.resolve_deep(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self.resolve_deep(v) for v in value]
        return self.resolve_if_any(value)


def secret_uri(vault: str, name: str) -> str:
    return f"keyvault://{vault}/{name}"


def is_secret_uri(value: Any) -> bool:
    return isinstance(value, str) and bool(SECRET_URI_RE.match(value.strip()))


# process-wide resolver (reference keeps a singleton KeyVault client)
_DEFAULT: Optional[SecretVault] = None
_DEFAULT_LOCK = threading.Lock()


def default_vault() -> SecretVault:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = SecretVault()
    return _DEFAULT


def reset_default_vault() -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None


def resolve_secret_if_any(value: Any) -> Any:
    return default_vault().resolve_if_any(value)
