"""Flat ``datax.job.*`` configuration dictionary with namespace grouping.

A job's entire feature set is switched on/off purely by presence of keys in
one flat string->string map — the same contract as the reference engine, so
flattened configs produced for the reference remain readable here.

reference: datax-core SettingDictionary.scala:20-150, SettingNamespace.scala:9-48

Copy of the JAX package's ``core/config.py``, with its flat ``.conf``
line parser (``parse_conf_lines``), which ``core/confmanager.py`` reads
conf files with.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, TypeVar

from ..constants import JobArgument, ProductConstant

T = TypeVar("T")


class EngineException(Exception):
    """Engine-level configuration/processing error (reference: EngineException.scala)."""


class SettingNamespace:
    """Well-known namespace prefixes. reference: SettingNamespace.scala:9-48"""

    DefaultSettingName = ""
    Separator = "."
    ValueSeparator = ";"
    Root = ProductConstant.ProductRoot  # "datax"
    RootPrefix = Root + Separator
    Job = "job"
    JobPrefix = RootPrefix + Job + Separator  # "datax.job."

    JobName = "name"
    JobNameFullPath = JobPrefix + JobName

    JobInput = "input.default"
    JobInputPrefix = JobPrefix + JobInput + Separator

    JobProcess = "process"
    JobProcessPrefix = JobPrefix + JobProcess + Separator

    JobOutput = "output"
    JobOutputPrefix = JobPrefix + JobOutput + Separator

    @staticmethod
    def build_setting_path(*names: Optional[str]) -> str:
        return SettingNamespace.Separator.join(n for n in names if n is not None)

    @staticmethod
    def get_sub_namespace(prop_name: str, start_index: int) -> Optional[str]:
        """First namespace component of ``prop_name`` after ``start_index``.

        reference: SettingNamespace.scala:37-47
        """
        if len(prop_name) > start_index:
            pos = prop_name.find(SettingNamespace.Separator, start_index)
            if pos >= 0:
                return prop_name[start_index:pos]
            return prop_name[start_index:]
        return None


_DURATION_UNITS = {
    "d": 86400.0, "day": 86400.0, "days": 86400.0,
    "h": 3600.0, "hour": 3600.0, "hours": 3600.0,
    "m": 60.0, "min": 60.0, "mins": 60.0, "minute": 60.0, "minutes": 60.0,
    "s": 1.0, "sec": 1.0, "secs": 1.0, "second": 1.0, "seconds": 1.0,
    "ms": 1e-3, "milli": 1e-3, "millis": 1e-3,
    "millisecond": 1e-3, "milliseconds": 1e-3,
    "us": 1e-6, "micro": 1e-6, "micros": 1e-6,
    "microsecond": 1e-6, "microseconds": 1e-6,
    "ns": 1e-9, "nano": 1e-9, "nanos": 1e-9,
    "nanosecond": 1e-9, "nanoseconds": 1e-9,
}

_DURATION_RE = re.compile(r"^\s*([+-]?\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*$")


def parse_duration_seconds(text: str) -> float:
    """Parse durations like ``"5 minutes"``, ``"0 second"``, ``"60"`` (secs).

    Matches the scala ``Duration.create`` strings used throughout flow
    configs (reference: SettingDictionary.scala:45-46, TimeWindowHandler
    reading ``process.timewindow.*`` / ``watermark``).
    """
    m = _DURATION_RE.match(text)
    if not m:
        raise EngineException(f"cannot parse duration: {text!r}")
    value = float(m.group(1))
    unit = m.group(2).lower()
    if unit == "":
        return value  # bare number: seconds
    if unit not in _DURATION_UNITS:
        raise EngineException(f"unknown duration unit in {text!r}")
    return value * _DURATION_UNITS[unit]


@dataclass(frozen=True)
class SettingDictionary:
    """Immutable flat string map with namespace-aware accessors.

    reference: SettingDictionary.scala:20-150
    """

    elems: Dict[str, str] = field(default_factory=dict)
    parent_prefix: str = SettingNamespace.DefaultSettingName

    # -- plain accessors -------------------------------------------------
    @property
    def dict(self) -> Dict[str, str]:
        return self.elems

    def __len__(self) -> int:
        return len(self.elems)

    @staticmethod
    def _resolve(value: Optional[str]) -> Optional[str]:
        """Transparent ``keyvault://vault/name`` resolution on read
        (reference: KeyVaultClient.scala:108-125 resolveSecretIfAny is
        applied to every config value the engine reads)."""
        if value is None or "://" not in value:
            return value
        from .secrets import resolve_secret_if_any

        return resolve_secret_if_any(value)

    def get(self, key: str) -> Optional[str]:
        return self._resolve(self.elems.get(key))

    def get_default(self) -> Optional[str]:
        return self._resolve(self.elems.get(SettingNamespace.DefaultSettingName))

    def _get_or_throw(self, value: Optional[T], key: str) -> T:
        if value is None:
            raise EngineException(
                f"config setting '{self.parent_prefix + key}' is not found"
            )
        return value

    def get_string(self, key: str) -> str:
        return self._get_or_throw(self._resolve(self.elems.get(key)), key)

    def get_or_else(self, key: str, default: Optional[str]) -> Optional[str]:
        v = self._resolve(self.elems.get(key))
        return default if v is None else v

    def get_int_option(self, key: str) -> Optional[int]:
        v = self.elems.get(key)
        return None if v is None else int(v)

    def get_long_option(self, key: str) -> Optional[int]:
        return self.get_int_option(key)

    def get_long(self, key: str) -> int:
        return self._get_or_throw(self.get_int_option(key), key)

    def get_double_option(self, key: str) -> Optional[float]:
        v = self.elems.get(key)
        return None if v is None else float(v)

    def get_double(self, key: str) -> float:
        return self._get_or_throw(self.get_double_option(key), key)

    def get_bool_option(self, key: str) -> Optional[bool]:
        v = self.elems.get(key)
        if v is None:
            return None
        lowered = v.strip().lower()
        if lowered in ("true", "1", "yes"):
            return True
        if lowered in ("false", "0", "no"):
            return False
        raise EngineException(f"cannot parse boolean setting {key}={v!r}")

    def get_duration_option(self, key: str) -> Optional[float]:
        """Duration in (float) seconds."""
        v = self.elems.get(key)
        return None if v is None else parse_duration_seconds(v)

    def get_duration(self, key: str) -> float:
        return self._get_or_throw(self.get_duration_option(key), key)

    def get_string_seq_option(self, key: str) -> Optional[list]:
        v = self.elems.get(key)
        if v is None:
            return None
        seq = [s for s in v.split(SettingNamespace.ValueSeparator) if s]
        return seq if seq else None

    # -- namespace operations -------------------------------------------
    def _find_with_prefix(self, prefix: str) -> Dict[str, str]:
        return {k: v for k, v in self.elems.items() if k.startswith(prefix)}

    @staticmethod
    def _strip_keys(d: Dict[str, str], start: int) -> Dict[str, str]:
        return {k[start:]: v for k, v in d.items() if k is not None and len(k) > start}

    @staticmethod
    def _strip_keys_by_namespace(d: Dict[str, str], namespace: str) -> Dict[str, str]:
        # a key equal to the namespace itself becomes the "" default setting
        # (reference: SettingDictionary.scala:59-67)
        prefix_len = len(namespace + SettingNamespace.Separator)
        out: Dict[str, str] = {}
        for k, v in d.items():
            if k is None or len(k) < len(namespace):
                continue
            if k == namespace:
                out[SettingNamespace.DefaultSettingName] = v
            else:
                out[k[prefix_len:]] = v
        return out

    def group_by_sub_namespace(
        self, prefix: Optional[str] = None
    ) -> Dict[str, "SettingDictionary"]:
        """Strip ``prefix`` and group remaining keys by first namespace part.

        reference: SettingDictionary.scala:77-86
        """
        if not prefix:
            sub = dict(self.elems)
        else:
            sub = self._strip_keys(self._find_with_prefix(prefix), len(prefix))

        groups: Dict[str, Dict[str, str]] = {}
        for k, v in sub.items():
            ns = SettingNamespace.get_sub_namespace(k, 0)
            if ns is None:
                continue
            groups.setdefault(ns, {})[k] = v

        return {
            ns: SettingDictionary(
                self._strip_keys_by_namespace(kv, ns),
                self.parent_prefix + (prefix or "") + ns + SettingNamespace.Separator,
            )
            for ns, kv in groups.items()
        }

    def get_sub_dictionary(self, prefix: str) -> "SettingDictionary":
        """reference: SettingDictionary.scala:93-95"""
        return SettingDictionary(
            self._strip_keys(self._find_with_prefix(prefix), len(prefix)),
            self.parent_prefix + prefix,
        )

    def build_config_map(
        self,
        builder: Callable[["SettingDictionary", str], T],
        prefix: Optional[str] = None,
    ) -> Dict[str, T]:
        """reference: SettingDictionary.scala:102-105"""
        return {
            k: builder(v, k) for k, v in self.group_by_sub_namespace(prefix).items()
        }

    # -- well-known settings --------------------------------------------
    def get_app_name(self) -> str:
        return self.elems.get(
            JobArgument.ConfName_AppName, ProductConstant.DefaultAppName
        )

    def get_job_name(self) -> str:
        return self.elems.get(SettingNamespace.JobNameFullPath, self.get_app_name())

    def get_metric_app_name(self) -> str:
        return ProductConstant.MetricAppNamePrefix + self.get_job_name()

    def get_app_configuration_file(self) -> Optional[str]:
        return self.elems.get(JobArgument.ConfName_AppConf)

    def with_settings(self, extra: Dict[str, str]) -> "SettingDictionary":
        merged = dict(self.elems)
        merged.update(extra)
        return SettingDictionary(merged, self.parent_prefix)


def parse_conf_lines(
    lines: Iterable[str], replacements: Optional[Dict[str, str]] = None
) -> Dict[str, str]:
    """Parse flat ``key=value`` conf lines with ``${token}`` replacement.

    reference: ConfigManager.scala:98-135
    """
    out: Dict[str, str] = {}
    for line in lines:
        if line is None:
            continue
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        pos = stripped.find("=")
        if pos == 0:
            key, value = "", stripped
        elif pos > 0:
            key, value = stripped[:pos].strip(), stripped[pos + 1:].strip()
        else:
            # flag-only line: store empty string so the key still registers
            # as present (the reference keeps the key with a null value;
            # features are switched purely by key presence)
            key, value = stripped, ""
        out[key] = replace_tokens(_unescape_value(value), replacements)
    return out


def _unescape_value(value: str) -> str:
    """java-properties-style escapes: multi-line values (projection steps,
    inline snippets) are written as literal ``\\n`` in the flat .conf the
    flattener produces; ``\\\\`` preserves literal backslashes (regexes,
    Windows paths)."""
    if "\\" not in value:
        return value
    out = []
    i, n = 0, len(value)
    while i < n:
        ch = value[i]
        if ch == "\\" and i + 1 < n:
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "t":
                out.append("\t")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def replace_tokens(src: Optional[str], tokens: Optional[Dict[str, str]]) -> Optional[str]:
    """Literal ``${name}`` substitution. reference: ConfigManager.scala:83-88"""
    if not tokens or src is None or src == "":
        return src
    for name, value in tokens.items():
        if value is not None:
            src = src.replace("${" + name + "}", value)
    return src
