"""Whole-transform pipeline compilation.

Chains every ``--DataXQuery--`` statement of a flow into one program
over columnar tables. The runtime calls ``Pipeline.run`` once per
micro-batch, inside its step —
replacing the reference's per-batch loop of ``spark.sql`` calls
(CommonProcessorFactory.scala:249-293 route()).

Accumulation tables ("--DataXStates--" DDL; reference:
StateTableHandler.scala:17-129) appear as both inputs (previous state)
and view outputs (new state); a statement assigning to the table name
reads the old state and its result becomes the new state the runtime
persists and feeds back next batch.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..core.config import EngineException
from ..core.schema import StringDictionary
from .planner import (
    CompiledView,
    PlannerConfig,
    SelectCompiler,
    TableData,
    ViewSchema,
)
from .sqlparser import parse_select
from .transform_parser import COMMAND_TYPE_QUERY, ParsedResult, TransformParser


@dataclass
class Pipeline:
    views: List[CompiledView]
    catalog: Dict[str, ViewSchema]
    capacities: Dict[str, int]
    input_names: List[str]
    state_tables: List[str] = field(default_factory=list)
    # dictionary-table registry for device string ops (stringops.py);
    # the runtime materializes AuxTableBuilder(aux_registry, dictionary)
    # .tables() per batch and passes it as tables["__aux"]
    aux_registry: Optional[object] = None

    def run(
        self, tables: Dict[str, TableData], base_s, now_rel_ms, aux=None,
        around: Optional[Dict[str, Callable]] = None,
    ) -> Dict[str, TableData]:
        """Execute all statements; returns every view (inputs included).

        Pure function of its inputs. ``aux``: the string-op dictionary
        tables ({key: tensor}); required when the flow uses string functions
        (``aux_registry`` non-empty). ``around``: {view name: a context
        manager factory} entered around that view's statement (the
        runtime's ``window-group`` clock).
        """
        env: Dict[str, TableData] = dict(tables)
        if aux is not None:
            env["__aux"] = aux
        if "__aux" not in env:
            if self.aux_registry is not None and not self.aux_registry.empty:
                raise EngineException(
                    "this pipeline uses string functions; pass aux= "
                    "(AuxTableBuilder.tables()) to Pipeline.run"
                )
            env["__aux"] = {}
        around = around or {}
        for view in self.views:
            with around.get(view.name, contextlib.nullcontext)():
                env[view.name] = view.fn(env, base_s, now_rel_ms)
        return env

    def schema_of(self, name: str) -> ViewSchema:
        return self.catalog[name]

    def view_by_name(self, name: str) -> Optional[CompiledView]:
        # LAST definition wins, matching run()'s env overwrite and the
        # catalog (a reassigned view name must not resolve to the stale
        # first definition's host-order metadata)
        for v in reversed(self.views):
            if v.name == name:
                return v
        return None


def _referenced_tables(sel) -> List[str]:
    """Table names a parsed select reads (FROM/JOIN, union branches)."""
    out: List[str] = []
    cur = sel
    while cur is not None:
        if cur.from_table is not None:
            out.append(cur.from_table.name)
        for j in cur.joins:
            out.append(j.table.name)
        cur = cur.union
    return out


_DDL_COL_RE = re.compile(r"\s*(`[^`]+`|[A-Za-z_][\w.]*)\s+([A-Za-z]+)\s*$")

_DDL_TYPES = {
    "long": "long", "int": "long", "integer": "long", "bigint": "long",
    "double": "double", "float": "double", "boolean": "boolean",
    "string": "string", "timestamp": "timestamp",
}


def parse_state_table_schema(schema_text: str) -> ViewSchema:
    """Parse accumulation-table DDL columns: ``a long, b string, ...``.

    reference: the CREATE TABLE bodies extracted by codegen
    (Engine.cs:559-579) and stored as ``process.statetable.<name>.schema``.
    """
    types: Dict[str, str] = {}
    for part in schema_text.split(","):
        part = part.strip()
        if not part:
            continue
        m = _DDL_COL_RE.match(part)
        if not m:
            raise EngineException(f"cannot parse state table column {part!r}")
        col = m.group(1).strip("`")
        t = _DDL_TYPES.get(m.group(2).lower())
        if t is None:
            raise EngineException(f"unsupported state table type {m.group(2)!r}")
        types[col] = t
    return ViewSchema(types)


class PipelineCompiler:
    def __init__(
        self,
        dictionary: StringDictionary,
        udfs: Optional[dict] = None,
        config: PlannerConfig = PlannerConfig(),
        aux: Optional[object] = None,
    ):
        from .stringops import AuxRegistry

        self.dictionary = dictionary
        self.udfs = udfs or {}
        self.config = config
        # one registry per flow: projections and every statement share
        # dictionary tables for identical string expressions
        self.aux = aux if aux is not None else AuxRegistry()

    def compile_transform(
        self,
        transform: str | ParsedResult,
        inputs: Dict[str, Tuple[ViewSchema, int]],
        state_tables: Optional[Dict[str, Tuple[ViewSchema, int]]] = None,
    ) -> Pipeline:
        """Compile a full transform script.

        inputs: table name -> (schema, capacity) for source tables
        (DataXProcessedInput, its TIMEWINDOW variants, reference data).
        state_tables: accumulation tables (previous-state inputs).
        """
        parsed = (
            transform
            if isinstance(transform, ParsedResult)
            else TransformParser.parse_text(transform)
        )
        catalog: Dict[str, ViewSchema] = {}
        capacities: Dict[str, int] = {}
        for name, (schema, cap) in inputs.items():
            catalog[name] = schema
            capacities[name] = cap
        state_names: List[str] = []
        for name, (schema, cap) in (state_tables or {}).items():
            catalog[name] = schema
            capacities[name] = cap
            state_names.append(name)

        views: List[CompiledView] = []
        host_limited: Dict[str, str] = {}  # view name -> why
        for cmd in parsed.commands:
            if cmd.command_type != COMMAND_TYPE_QUERY or cmd.name is None:
                # bare commands (CACHE TABLE etc.) are execution hints the
                # pipeline doesn't need: every view is computed once per
                # batch already
                continue
            sel = parse_select(cmd.text)
            # a LIMIT deferred to host ordering only applies at output
            # materialization — a later statement reading that view would
            # silently see ALL rows, so the reference must fail loudly
            for ref in _referenced_tables(sel):
                if ref in host_limited:
                    raise EngineException(
                        f"view '{ref}' uses LIMIT with ORDER BY on a "
                        "computed-string column, which applies at output "
                        "materialization; it cannot feed statement "
                        f"'{cmd.name}' — order/limit in the final "
                        "statement instead"
                    )
            compiler = SelectCompiler(
                catalog, capacities, self.dictionary, self.udfs, self.config,
                aux=self.aux,
            )
            view = compiler.compile_select(cmd.name, sel)
            if view.host_order and view.host_limit is not None:
                host_limited[view.name] = "host-limited"
            elif view.name in host_limited:
                host_limited.pop(view.name)  # reassigned without limit
            views.append(view)
            catalog[view.name] = view.schema
            capacities[view.name] = view.capacity

        return Pipeline(
            views=views,
            catalog=catalog,
            capacities=capacities,
            input_names=list(inputs) + state_names,
            state_tables=state_names,
            aux_registry=self.aux,
        )
