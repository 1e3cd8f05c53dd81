"""Schema-driven flattener: hierarchical flow/job JSON -> flat conf keys.

The runtime engine reads a flat ``datax.job.*`` key=value map; the design
side produces hierarchical JSON. A flattener schema (same JSON format as
the reference's ``flattenerConfig.json``) maps one onto the other, so
flow documents written for the reference flatten identically here.

Mapping node types (reference: DataX.Config/ConfigDataModel/Flattener/*.cs,
golden behavior: DataX.Config.Test/Resource/Flattener/{input.json,config.json,
output.conf}):

- ``"fieldname"`` (bare string)          -> emit ``<ns>.<fieldname>=value``
- ``{"type": "object"}``                 -> recurse with namespace appended
- ``{"type": "scopedObject",
     "namespaceField": f}``              -> namespace extended by value[f]
- ``{"type": "array", "element": m}``    -> apply ``m`` per element
- ``{"type": "map", "fields": ...}``     -> per-key scoped object
- ``{"type": "stringList"}``             -> values joined with ";"
- ``{"type": "mapProps"}``               -> emit every key/value under ns
- ``{"type": "excludeDefaultValue",
     "defaultValue": v}``                -> emit only when value != v

Copy of the JAX package's ``compile/flattener.py``, unchanged, over the
port's ``core/config.py``; the control plane's generation flattens with
the port's ``compile/flattener_schema.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from ..core.config import SettingNamespace

JsonVal = Union[dict, list, str, int, float, bool, None]


def _join(prefix: Optional[str], ns: Optional[str]) -> str:
    parts = [p for p in (prefix, ns) if p]
    return SettingNamespace.Separator.join(parts)


def _scalar(value: JsonVal) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


class ConfigFlattener:
    """reference: InternalService/ConfigFlattener.cs + Flattener/*.cs"""

    def __init__(self, schema: dict):
        self.schema = schema

    def flatten(self, config: dict) -> Dict[str, str]:
        out: Dict[str, str] = {}
        self._apply(self.schema, config, "", out)
        return out

    def flatten_to_conf(self, config: dict) -> str:
        return "\n".join(f"{k}={v}" for k, v in self.flatten(config).items())

    # -- node dispatch ---------------------------------------------------
    def _apply(
        self, mapping: Union[str, dict], value: JsonVal, prefix: str, out: Dict[str, str]
    ) -> None:
        if value is None:
            return
        if isinstance(mapping, str):
            out[_join(prefix, mapping)] = _scalar(value)
            return

        mtype = mapping.get("type", "object")
        ns = mapping.get("namespace")

        if mtype == "object":
            self._apply_fields(mapping.get("fields", {}), value, _join(prefix, ns), out)
        elif mtype == "scopedObject":
            ns_field = mapping.get("namespaceField")
            if not isinstance(value, dict):
                return
            scope = value.get(ns_field) if ns_field else None
            self._apply_fields(
                mapping.get("fields", {}), value, _join(_join(prefix, ns), scope), out
            )
        elif mtype == "array":
            element = mapping.get("element")
            if not isinstance(value, list):
                return
            for item in value:
                # element namespace nests under the array's own namespace
                self._apply(element, item, _join(prefix, ns), out)
        elif mtype == "map":
            if not isinstance(value, dict):
                return
            base = _join(prefix, ns)
            for key, sub in value.items():
                self._apply_fields(mapping.get("fields", {}), sub, _join(base, key), out)
        elif mtype == "stringList":
            if not isinstance(value, list):
                return
            joined = SettingNamespace.ValueSeparator.join(_scalar(v) for v in value)
            out[_join(prefix, ns)] = joined
        elif mtype == "mapProps":
            if not isinstance(value, dict):
                return
            base = _join(prefix, ns)
            for key, sub in value.items():
                if sub is not None:
                    out[_join(base, key)] = _scalar(sub)
        elif mtype == "excludeDefaultValue":
            if value != mapping.get("defaultValue"):
                out[_join(prefix, ns)] = _scalar(value)
        else:
            raise ValueError(f"unknown flattener mapping type: {mtype!r}")

    def _apply_fields(
        self, fields: Dict[str, Union[str, dict]], value: JsonVal, prefix: str,
        out: Dict[str, str],
    ) -> None:
        if not isinstance(value, dict):
            return
        for field_name, mapping in fields.items():
            if field_name in value:
                self._apply(mapping, value[field_name], prefix, out)
