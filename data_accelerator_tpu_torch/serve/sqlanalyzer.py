"""Design-time DataXQuery analysis for the query editor.

reference: DataX.Flow/DataX.Flow.SqlParser/{SqlParser,Analyzer}.cs —
parses the user's script into a table graph and projects each derived
table's output columns so the UI can offer intellisense
(SqlParser.cs:17-54). Reuses the production transform parser and SQL
parser — design-time analysis and runtime compilation cannot drift.

Copy of the JAX package's ``serve/sqlanalyzer.py``, unchanged, over the
port's ``compile/sqlparser.py`` and ``compile/transform_parser.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..compile.sqlparser import (
    BinOp,
    CaseWhen,
    Cast,
    Col,
    Func,
    InList,
    IsNull,
    Literal,
    Select,
    SqlParseError,
    Star,
    UnaryOp,
    parse_select,
)
from ..compile.transform_parser import (
    COMMAND_TYPE_QUERY,
    TransformParser,
)
from ..constants import DatasetName


@dataclass
class TableInfo:
    name: str
    columns: List[str] = field(default_factory=list)
    depends_on: List[str] = field(default_factory=list)
    sql: str = ""


@dataclass
class AnalysisResult:
    tables: List[TableInfo] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    def table(self, name: str) -> Optional[TableInfo]:
        for t in self.tables:
            if t.name == name:
                return t
        return None


def _expr_name(expr) -> str:
    """Display name for an un-aliased select item (Spark-ish)."""
    if isinstance(expr, Col):
        return expr.parts[-1]
    if isinstance(expr, Func):
        args = ", ".join(_expr_name(a) for a in expr.args)
        return f"{expr.name.lower()}({args})"
    if isinstance(expr, Literal):
        return str(expr.value)
    if isinstance(expr, (Cast, CaseWhen, BinOp, UnaryOp, InList, IsNull)):
        return "expr"
    return "expr"


_TIMEWINDOW_RE = re.compile(
    rf"\b{DatasetName.DataStreamProjection}_(\d+\w+)\b"
)


class SqlAnalyzer:
    """Analyze a transform script against known input columns."""

    def analyze(
        self,
        script: str,
        input_columns: Optional[List[str]] = None,
    ) -> AnalysisResult:
        res = AnalysisResult()
        known: Dict[str, List[str]] = {}
        base_cols = list(input_columns or [])
        known[DatasetName.DataStreamProjection] = base_cols
        try:
            parsed = TransformParser.parse(script.splitlines())
        except Exception as e:  # noqa: BLE001 — surfaced to the editor
            res.errors.append(str(e))
            return res

        for cmd in parsed.commands:
            if cmd.command_type != COMMAND_TYPE_QUERY or not cmd.name:
                continue
            # the runtime transform has semicolons stripped by codegen
            # (Engine.cs cleanup); tolerate them in raw editor text here
            sql = cmd.text.rstrip().rstrip(";")
            info = TableInfo(name=cmd.name, sql=sql)
            try:
                sel = parse_select(sql)
                info.depends_on = self._source_tables(sel)
                info.columns = self._project_columns(
                    sel, known, res.errors, cmd.name
                )
            except SqlParseError as e:
                res.errors.append(f"{cmd.name}: {e}")
            except Exception as e:  # noqa: BLE001
                res.errors.append(f"{cmd.name}: {e}")
            # windowed views of the input share its columns
            for dep in info.depends_on:
                if dep not in known and _TIMEWINDOW_RE.match(dep):
                    known[dep] = base_cols
            known[cmd.name] = info.columns
            res.tables.append(info)
        return res

    @staticmethod
    def _source_tables(sel: Select) -> List[str]:
        out = []
        if sel.from_table is not None:
            out.append(sel.from_table.name)
        for j in sel.joins:
            out.append(j.table.name)
        return out

    def _project_columns(
        self,
        sel: Select,
        known: Dict[str, List[str]],
        errors: Optional[List[str]] = None,
        table_name: str = "",
    ) -> List[str]:
        # FROM/JOIN scope in declaration order: binding (alias or name)
        # -> upstream columns, so ``t.*`` expands only t's columns and a
        # bare ``*`` is the union across every joined table
        scope: List[tuple] = []
        refs = ([sel.from_table] if sel.from_table is not None else [])
        refs += [j.table for j in sel.joins]
        for ref in refs:
            scope.append((ref.binding, ref.name, known.get(ref.name)))

        cols: List[str] = []
        explicit: set = set()
        for item in sel.items:
            if isinstance(item.expr, Star):
                for binding, name, upstream in scope:
                    if item.expr.table is not None and item.expr.table not in (
                        binding, name
                    ):
                        continue
                    for c in upstream or []:
                        if c not in cols:
                            cols.append(c)
                continue
            name = item.alias or _expr_name(item.expr)
            # "expr" is the display placeholder for unnamed expressions,
            # not a real output name — colliding there is not an error
            if name in explicit and name != "expr" and errors is not None:
                errors.append(
                    f"{table_name}: duplicate output column '{name}' — "
                    "alias one of the colliding select items"
                )
            explicit.add(name)
            if name not in cols:
                cols.append(name)
        return cols
