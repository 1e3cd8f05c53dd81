"""Multi-pass static analyzer over a whole flow config.

Copy of the JAX package's ``analysis/analyzer.py``, untrimmed: the
semantic tier reads flow JSON and imports nothing of JAX.

Takes the same flow JSON the designer saves (``serve/flowbuilder.py``
gui contract, or a full flow document wrapping it) and returns typed
diagnostics without executing anything. Every stage reuses the
production toolchain — ``compile/codegen.py`` expands rules/TIMEWINDOW/
OUTPUT exactly as S450 generation does, ``compile/transform_parser.py``
and ``compile/sqlparser.py`` parse exactly what the runtime compiles —
so analysis cannot drift from runtime semantics.

Passes (see diagnostics.CODES for the full registry):

1. reference resolution — unbound tables/columns, dangling sink/UDF
   references, forward/cyclic view references (DX00x)
2. type propagation — a small lattice seeded from the input schemas,
   flagging mismatched comparisons/join keys/CASTs (DX01x)
3. aggregation/window legality — aggregates outside aggregation
   contexts, window retention vs the state-capacity budget, accumulator
   misuse (DX02x)
4. dead-flow detection — views that never reach a sink, metric,
   accumulator or downstream view (DX03x)
5. device-compilation risk — patterns the planner can only lower with
   host round-trips or per-batch table rebuilds (DX04x)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..compile.codegen import CodegenEngine, RulesCode
from ..compile.sqlparser import (
    BinOp,
    Col,
    Select,
    SqlParseError,
    Star,
    parse_select,
)
from ..compile.transform_parser import (
    COMMAND_TYPE_QUERY,
    SqlCommand,
    TransformParser,
)
from ..constants import DatasetName
from ..core.config import parse_duration_seconds
from ..runtime.timewindow import num_slots
from ..serve.flowbuilder import RuleDefinitionGenerator
from .diagnostics import AnalysisReport, Diagnostic, Span, make
from .typeprop import (
    ExprChecker,
    SelectScope,
    TableScope,
    ddl_to_types,
    incompatible,
    schema_to_types,
)

# Windowed-table retention budget: ring rows = slots x batch capacity.
# Beyond this the window state alone dwarfs the job's working set
# (runtime/statetable.py + timewindow.py hold it all in device memory).
DEFAULT_MAX_STATE_ROWS = 16 * 1024 * 1024

_RAW_PASSTHROUGH = re.compile(r"^\s*Raw\.\*\s*$")


@dataclass
class FlowContext:
    """Everything the passes need, extracted from one flow config."""

    name: str = ""
    # design-time-known tables: name -> TableScope (inputs, windows,
    # state tables; views are added as statements are processed)
    tables: Dict[str, TableScope] = field(default_factory=dict)
    input_tables: List[str] = field(default_factory=list)
    state_tables: Dict[str, Optional[Dict[str, str]]] = field(
        default_factory=dict
    )
    windows: Dict[str, str] = field(default_factory=dict)  # table -> duration
    sinks: frozenset = frozenset()  # declared sink ids (gui.outputs)
    udfs: frozenset = frozenset()  # upper-cased declared function ids
    outputs: List[Tuple[str, str]] = field(default_factory=list)
    batch_interval_s: float = 1.0
    watermark_s: float = 0.0
    batch_capacity: int = 65536
    max_state_rows: int = DEFAULT_MAX_STATE_ROWS


class FlowAnalyzer:
    """Run all passes over a flow config; see ``analyze_flow``."""

    def __init__(self, max_state_rows: int = DEFAULT_MAX_STATE_ROWS):
        self.max_state_rows = max_state_rows

    # -- public entry ----------------------------------------------------
    def analyze_flow(self, flow: dict) -> AnalysisReport:
        gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
        diags: List[Diagnostic] = []
        ctx = self._build_context(gui, diags)
        code = self._generate_transform(gui, ctx, diags)
        if code is not None:
            self._analyze_transform(code, ctx, diags)
        return AnalysisReport(self._ordered(diags))

    def analyze_script(
        self, script: str, ctx: Optional[FlowContext] = None
    ) -> AnalysisReport:
        """Analyze a raw transform script against an explicit context
        (tests and conf-driven callers; no codegen involved — the script
        is taken as the runtime sees it)."""
        ctx = ctx or FlowContext()
        if DatasetName.DataStreamProjection not in ctx.tables:
            ctx.tables[DatasetName.DataStreamProjection] = TableScope(
                DatasetName.DataStreamProjection, None
            )
            ctx.input_tables.append(DatasetName.DataStreamProjection)
        diags: List[Diagnostic] = []
        self._analyze_transform(script, ctx, diags)
        return AnalysisReport(self._ordered(diags))

    # -- context construction -------------------------------------------
    def _build_context(self, gui: dict, diags: List[Diagnostic]) -> FlowContext:
        ctx = FlowContext(name=gui.get("name") or "",
                          max_state_rows=self.max_state_rows)
        iprops = (gui.get("input") or {}).get("properties") or {}
        proc = gui.get("process") or {}

        def table_from(schema_json, snippet, name) -> TableScope:
            # a custom normalization snippet can project anything; only
            # Raw.* passthrough (or no snippet) keeps the schema columns
            if snippet and not _RAW_PASSTHROUGH.match(str(snippet)):
                return TableScope(name, None)
            return TableScope(name, schema_to_types(schema_json))

        main = DatasetName.DataStreamProjection
        ctx.tables[main] = table_from(
            iprops.get("inputSchemaFile"),
            iprops.get("normalizationSnippet"), main,
        )
        ctx.input_tables.append(main)

        for src in (gui.get("input") or {}).get("sources") or []:
            sname = src.get("id") or src.get("name")
            if not sname:
                continue
            sprops = src.get("properties") or {}
            target = sprops.get("target") or sname
            ctx.tables[target] = table_from(
                sprops.get("inputSchemaFile"),
                sprops.get("normalizationSnippet"), target,
            )
            ctx.input_tables.append(target)

        ctx.sinks = frozenset(
            o.get("id") for o in gui.get("outputs") or [] if o.get("id")
        )
        ctx.udfs = frozenset(
            str(f.get("id")).upper()
            for f in proc.get("functions") or [] if f.get("id")
        )

        jobconf = proc.get("jobconfig") or {}
        try:
            ctx.batch_capacity = int(
                jobconf.get("jobBatchCapacity") or 65536
            )
        except (TypeError, ValueError):
            pass
        try:
            ctx.batch_interval_s = float(
                iprops.get("windowDuration")
                or iprops.get("intervalInSeconds") or 1
            )
        except (TypeError, ValueError):
            pass
        watermark = proc.get("watermark") or (
            f"{iprops.get('watermarkValue', 0)} "
            f"{iprops.get('watermarkUnit', 'second')}"
        )
        try:
            ctx.watermark_s = parse_duration_seconds(watermark)
        except Exception:  # noqa: BLE001 — malformed watermark: keep 0
            pass
        return ctx

    def _generate_transform(
        self, gui: dict, ctx: FlowContext, diags: List[Diagnostic]
    ) -> Optional[str]:
        """Run the production codegen (S450 semantics) and register the
        tables it derives (windows, accumulators) plus the OUTPUT map."""
        queries = (gui.get("process") or {}).get("queries") or []
        code = "\n".join(q if isinstance(q, str) else str(q) for q in queries)
        rules_json = RuleDefinitionGenerator().generate(
            gui.get("rules") or [], ctx.name
        )
        windowable = {DatasetName.DataStreamProjection, *ctx.input_tables}
        try:
            rc: RulesCode = CodegenEngine().generate_code(
                code, rules_json, ctx.name, windowable_tables=windowable
            )
        except ValueError as e:
            diags.append(make("DX009", "", str(e)))
            return None
        except Exception as e:  # noqa: BLE001 — any codegen blowup is a finding
            diags.append(make("DX008", "", f"codegen failed: {e}"))
            return None

        ctx.outputs = list(rc.outputs)
        ctx.windows = dict(rc.time_windows)
        for wname, duration in rc.time_windows.items():
            src = next(
                (t for t in ctx.input_tables
                 if wname.startswith(t + "_")), None
            )
            base = ctx.tables.get(src)
            ctx.tables[wname] = TableScope(
                wname, None if base is None else base.types
            )
        for sname, ddl in rc.accumulation_tables.items():
            types = ddl_to_types(ddl)
            ctx.state_tables[sname] = types
            ctx.tables[sname] = TableScope(sname, types)
        return rc.code

    # -- transform analysis ---------------------------------------------
    def _analyze_transform(
        self, code: str, ctx: FlowContext, diags: List[Diagnostic]
    ) -> None:
        parsed = self._parse(code, diags)
        if parsed is None:
            return
        queries = [
            c for c in parsed.commands
            if c.command_type == COMMAND_TYPE_QUERY and c.name
        ]
        all_views = {c.name for c in queries}
        defined: set = set()

        for cmd in queries:
            span = Span(cmd.line or 0, 1, cmd.end_line or None)
            sql = cmd.text.rstrip().rstrip(";")
            try:
                sel = parse_select(sql)
            except SqlParseError as e:
                col = getattr(e, "pos", None)
                diags.append(make(
                    "DX008", cmd.name, str(e),
                    Span(cmd.line or 0, (col or 0) + 1, cmd.end_line or None),
                ))
                defined.add(cmd.name)
                ctx.tables[cmd.name] = TableScope(cmd.name, None)
                continue
            out_scope = self._check_statement(
                cmd, sel, ctx, defined, all_views, diags, span
            )
            defined.add(cmd.name)
            if cmd.name in ctx.state_tables:
                self._check_state_update(cmd, out_scope, ctx, diags, span)
                # the accumulator keeps its declared shape downstream
            else:
                ctx.tables[cmd.name] = out_scope

        self._check_outputs(ctx, parsed, diags)
        self._check_windows(ctx, diags)
        self._check_state_tables(ctx, defined, diags)
        self._check_dead_views(ctx, parsed, diags)

    def _parse(self, code: str, diags: List[Diagnostic]):
        try:
            return TransformParser.parse_text(code)
        except Exception as e:  # noqa: BLE001 — surfaced as a finding
            diags.append(make("DX008", "", str(e)))
            return None

    # -- per-statement checks (passes 1, 2, 3, 5) ------------------------
    def _check_statement(
        self,
        cmd: SqlCommand,
        sel: Select,
        ctx: FlowContext,
        defined: set,
        all_views: set,
        diags: List[Diagnostic],
        span: Span,
    ) -> TableScope:
        out_types: Dict[str, str] = {}
        out_computed: set = set()
        out_open = False  # a * over an open table makes the output open
        first = True
        # walk the UNION chain: every branch resolves in the same
        # known-table universe; the first branch names the output columns
        branch: Optional[Select] = sel
        while branch is not None:
            scope = self._select_scope(
                cmd, branch, ctx, defined, all_views, diags, span
            )

            def emit(code_: str, message: str, _span=span, _cmd=cmd):
                diags.append(make(code_, _cmd.name or "", message, _span))

            checker = ExprChecker(scope, ctx.udfs, emit)
            grouped = bool(branch.group_by)

            names_seen: set = set()
            for item in branch.items:
                if isinstance(item.expr, Star):
                    if first:
                        out_open |= self._expand_star(
                            item.expr, scope, out_types, out_computed
                        )
                    continue
                info = checker.check(item.expr, agg_allowed=True)
                name = item.alias or self._item_name(item.expr)
                if first:
                    if name in names_seen:
                        emit("DX007", f"duplicate output column '{name}'")
                    names_seen.add(name)
                    out_types.setdefault(name, info.type)
                    if info.computed_string:
                        out_computed.add(name)

            # WHERE/GROUP BY/HAVING/ORDER BY also see the select-list
            # aliases (two-tier resolution, planner._OrderKeyScope role);
            # source bindings come first so shadowing resolves source-side
            alias_scope = SelectScope(list(scope.bindings))
            alias_scope.add("", TableScope(
                "", dict(out_types) if (out_types and not out_open) else None,
                frozenset(out_computed),
            ))
            achecker = ExprChecker(alias_scope, ctx.udfs, emit)

            if branch.where is not None:
                achecker.check(branch.where, agg_allowed=False)
            for g in branch.group_by:
                achecker.check(g, agg_allowed=False)
            if branch.having is not None:
                achecker.check(branch.having, agg_allowed=grouped)
            for j in branch.joins:
                self._check_join_keys(cmd, j.on, checker, diags, span)
                checker.check(j.on, agg_allowed=False)
            for ob in branch.order_by:
                info = achecker.check(ob.expr, agg_allowed=grouped)
                name = (
                    ob.expr.parts[-1] if isinstance(ob.expr, Col) else None
                )
                if info.computed_string or (name and name in out_computed):
                    diags.append(make(
                        "DX040", cmd.name or "",
                        "ORDER BY over a computed string sorts on the host "
                        "after materialization (device round-trip per batch)",
                        span,
                    ))
            first = False
            branch = branch.union

        return TableScope(
            cmd.name or "",
            None if (out_open or not out_types) else out_types,
            frozenset(out_computed),
        )

    def _select_scope(
        self, cmd, sel: Select, ctx, defined: set, all_views: set,
        diags, span,
    ) -> SelectScope:
        scope = SelectScope()
        refs = []
        if sel.from_table is not None:
            refs.append(sel.from_table)
        refs.extend(j.table for j in sel.joins)
        for ref in refs:
            t = ctx.tables.get(ref.name)
            if t is None or (
                ref.name in all_views and ref.name not in defined
                and ref.name not in ctx.state_tables
                and ref.name not in ctx.input_tables
            ):
                if ref.name in all_views and ref.name not in defined:
                    diags.append(make(
                        "DX005", cmd.name or "",
                        f"view '{ref.name}' is referenced before its "
                        "definition — a cycle needs a --DataXStates-- "
                        "accumulation table",
                        span,
                    ))
                elif t is None:
                    diags.append(make(
                        "DX001", cmd.name or "",
                        f"unknown table '{ref.name}' in FROM/JOIN",
                        span,
                    ))
                scope.add(ref.binding, TableScope(ref.name, None))
            else:
                scope.add(ref.binding, t)
        return scope

    @staticmethod
    def _expand_star(star: Star, scope: SelectScope, out_types,
                     out_computed) -> bool:
        """Expand ``*``/``t.*`` into out_types; returns True when any
        matched table is open (the output shape is then unknowable)."""
        any_open = False
        for binding, t in scope.bindings:
            if star.table is not None and binding != star.table \
                    and t.name != star.table:
                continue
            if t.open:
                any_open = True
                continue
            for c, typ in (t.types or {}).items():
                out_types.setdefault(c, typ)
                if c in t.computed:
                    out_computed.add(c)
        return any_open

    @staticmethod
    def _item_name(expr) -> str:
        if isinstance(expr, Col):
            return expr.parts[-1]
        return "expr"

    def _check_join_keys(self, cmd, on, checker: ExprChecker, diags, span):
        """ON a.x = b.y with disagreeing key types (pass 2, DX011)."""

        def walk(e):
            if not isinstance(e, BinOp):
                return
            if e.op in ("AND", "OR"):
                walk(e.left)
                walk(e.right)
                return
            if e.op == "=" and isinstance(e.left, Col) \
                    and isinstance(e.right, Col):
                lt, _ = checker.scope.resolve(e.left.parts)
                rt, _ = checker.scope.resolve(e.right.parts)
                if lt and rt and incompatible(lt.type, rt.type):
                    diags.append(make(
                        "DX011", cmd.name or "",
                        f"join keys disagree: {e.left.dotted} is {lt.type}, "
                        f"{e.right.dotted} is {rt.type}",
                        span,
                    ))

        walk(on)

    # -- flow-level checks (passes 1, 3, 4) ------------------------------
    def _check_outputs(self, ctx: FlowContext, parsed, diags) -> None:
        produced = {
            c.name for c in parsed.commands
            if c.command_type == COMMAND_TYPE_QUERY and c.name
        } | set(ctx.state_tables) | set(ctx.tables)
        for tables, sink in ctx.outputs:
            for table in (t.strip() for t in tables.split(",")):
                if table and table not in produced:
                    diags.append(make(
                        "DX003", table,
                        f"OUTPUT routes '{table}' to sink '{sink}' but no "
                        "transform statement produces it — the job would "
                        "deploy producing nothing",
                    ))
            if sink and sink.lower() != "metrics" and ctx.sinks \
                    and sink not in ctx.sinks:
                diags.append(make(
                    "DX004", "",
                    f"OUTPUT routes to sink '{sink}' which gui.outputs does "
                    "not declare (generation would silently default it to a "
                    "metric sink)",
                ))

    def _check_windows(self, ctx: FlowContext, diags) -> None:
        for wname, duration in ctx.windows.items():
            try:
                dur_s = parse_duration_seconds(duration)
            except Exception:  # noqa: BLE001
                diags.append(make(
                    "DX021", wname,
                    f"unparseable TIMEWINDOW duration '{duration}'",
                    severity="error",
                ))
                continue
            slots = num_slots(dur_s, ctx.watermark_s, ctx.batch_interval_s)
            rows = slots * ctx.batch_capacity
            if rows > ctx.max_state_rows:
                diags.append(make(
                    "DX021", wname,
                    f"window '{duration}' needs {slots} ring slots x "
                    f"{ctx.batch_capacity} batch capacity = {rows} retained "
                    f"rows, over the {ctx.max_state_rows}-row state budget",
                ))

    def _check_state_update(self, cmd, out_scope: TableScope, ctx, diags,
                            span) -> None:
        declared = ctx.state_tables.get(cmd.name)
        if declared is None or out_scope.types is None:
            return
        want, got = set(declared), set(out_scope.types)
        if want != got:
            diags.append(make(
                "DX022", cmd.name,
                f"accumulation update columns {sorted(got)} disagree with "
                f"the declared schema {sorted(want)}",
                span,
            ))

    def _check_state_tables(self, ctx: FlowContext, defined: set, diags):
        for sname in ctx.state_tables:
            if sname not in defined:
                diags.append(make(
                    "DX022", sname,
                    f"accumulation table '{sname}' is declared but no "
                    "statement ever assigns it",
                ))

    def _check_dead_views(self, ctx: FlowContext, parsed, diags) -> None:
        routed: set = set()
        for tables, _sink in ctx.outputs:
            routed.update(t.strip() for t in tables.split(","))
        queries = [
            c for c in parsed.commands
            if c.command_type == COMMAND_TYPE_QUERY and c.name
        ]
        for cmd in queries:
            refs = parsed.view_reference_count.get(cmd.name, 0)
            if refs == 0 and cmd.name not in routed \
                    and cmd.name not in ctx.state_tables:
                diags.append(make(
                    "DX030", cmd.name,
                    f"view '{cmd.name}' is computed but never reaches a "
                    "sink, metric, accumulator or downstream view",
                    Span(cmd.line or 0, 1, cmd.end_line or None),
                ))
        if queries and not ctx.outputs and not ctx.state_tables:
            diags.append(make(
                "DX031", "",
                "flow has transform statements but routes nothing to any "
                "sink or accumulator",
            ))

    @staticmethod
    def _ordered(diags: List[Diagnostic]) -> List[Diagnostic]:
        """Stable order: errors first, then by source line, then code."""
        return sorted(
            diags,
            key=lambda d: (d.severity != "error", d.span.line, d.code),
        )


def analyze_flow(flow: dict, **kw) -> AnalysisReport:
    """Analyze a flow config (gui JSON or full flow document)."""
    return FlowAnalyzer(**kw).analyze_flow(flow)


def analyze_script(script: str, ctx: Optional[FlowContext] = None,
                   **kw) -> AnalysisReport:
    """Analyze a raw transform script against an explicit context."""
    return FlowAnalyzer(**kw).analyze_script(script, ctx)
