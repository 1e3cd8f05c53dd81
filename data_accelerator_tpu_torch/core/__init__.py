"""Core primitives: config dictionary, schemas, columnar batches."""

from .config import SettingDictionary, SettingNamespace, parse_duration_seconds

__all__ = [
    "SettingDictionary",
    "SettingNamespace",
    "parse_duration_seconds",
]
