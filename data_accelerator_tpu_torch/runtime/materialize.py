"""Device table -> host rows: the sink/display boundary.

Decodes dictionary ids back to strings, restores absolute timestamps from
the batch base, renders deferred string templates (CONCAT et al.), and
folds flattened struct/array columns back into nested JSON values —
producing the same row JSON the reference's sinks serialize
(OutputManager.scala:103-126 to_json(struct(cols))).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..compile.exprs import WS_MARKER
from ..compile.planner import TableData, ViewSchema
from ..core.schema import StringDictionary


def _render_value(v, t: str, dictionary: StringDictionary, base_ms: int):
    if t == "string":
        return dictionary.decode(int(v))
    if t == "timestamp":
        return int(v) + base_ms
    if t == "tssec":
        return int(v) + base_ms // 1000
    if t == "boolean":
        return bool(v)
    if t == "double":
        return float(v)
    return int(v)


def materialize_rows(
    table: TableData,
    schema: ViewSchema,
    dictionary: StringDictionary,
    base_ms: int = 0,
    max_rows: Optional[int] = None,
) -> List[dict]:
    """Valid rows as JSON-ready dicts with nested structs re-assembled.
    ``table`` holds host data: numpy arrays or CPU tensors."""
    cols = {k: np.asarray(v) for k, v in table.cols.items()}
    valid = np.asarray(table.valid)
    idx = np.nonzero(valid)[0]
    if max_rows is not None:
        idx = idx[:max_rows]

    # organize flattened names into nesting groups
    device_cols = [
        c for c in schema.types if not c.startswith("__defer.")
    ]

    out: List[dict] = []
    for i in idx:
        row: dict = {}
        for c in device_cols:
            if c.endswith(".__valid"):
                continue
            v = _render_value(cols[c][i], schema.types[c], dictionary, base_ms)
            _bury(row, c, v)
        # deferred string templates. CONCAT: a NULL part nulls the
        # whole result (matching the device hash tier). CONCAT_WS
        # (WS_MARKER-tagged): null ARGUMENTS are skipped and the rest
        # join on the separator — both per Spark semantics.
        for name, parts in schema.deferred.items():
            ws_sep = None
            if parts and isinstance(parts[0], str) \
                    and parts[0].startswith(WS_MARKER):
                ws_sep = parts[0][len(WS_MARKER):]
                parts = parts[1:]
            pieces = []
            for p in parts:
                if isinstance(p, str):
                    pieces.append(p)
                    continue
                hidden, t = p
                rendered = _render_value(
                    cols[hidden][i], t, dictionary, base_ms
                )
                if rendered is None:
                    if ws_sep is not None:
                        continue  # concat_ws skips null arguments
                    pieces = None
                    break
                pieces.append(
                    f"{rendered:g}" if t == "double" else str(rendered)
                )
            if pieces is None:
                value = None
            elif ws_sep is not None:
                value = ws_sep.join(pieces)
            else:
                value = "".join(pieces)
            _bury(row, name, value)
        # array/struct validity: drop nulled-out branches
        row = _apply_validity(row, cols, schema, i)
        out.append(row)
    return out


def _apply_validity(row: dict, cols, schema: ViewSchema, i: int) -> dict:
    """Remove subtrees whose ``__valid`` flag is False; collapse arrays
    (numeric-keyed dicts) into lists of surviving elements."""
    valid_flags = {
        c[: -len(".__valid")]: bool(cols[c][i])
        for c in schema.types
        if c.endswith(".__valid")
    }

    def prune(obj, path: str):
        if not isinstance(obj, dict):
            return obj
        if path in valid_flags and not valid_flags[path]:
            return None
        keys = list(obj.keys())
        if keys and all(k.isdigit() for k in keys):
            items = []
            for k in sorted(keys, key=int):
                sub = prune(obj[k], f"{path}.{k}" if path else k)
                if sub is not None:
                    items.append(sub)
            return items
        out = {}
        for k in keys:
            sub = prune(obj[k], f"{path}.{k}" if path else k)
            if sub is not None or (f"{path}.{k}" if path else k) not in valid_flags:
                out[k] = sub
        return out

    return {k: prune(v, k) for k, v in row.items()}


def _bury(obj: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    cur = obj
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value
