"""Parser for the DataXQuery transform dialect.

A transform script is a sequence of sections separated by ``--DataXQuery--``
lines; each section is either a named assignment ``name = SELECT ...`` (a
*Query* creating a temp view) or a bare statement (a *Command*). The parser
also counts how many later statements reference each created view, which
the pipeline executor uses to decide caching/materialization.

reference: datax-host sql/TransformSqlParser.scala:18-105
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..constants import ProductConstant
from ..core.config import EngineException

COMMAND_TYPE_QUERY = "Query"
COMMAND_TYPE_COMMAND = "Command"

_SEPARATOR_RE = re.compile(ProductConstant.ProductQuery)
_STATES_SEPARATOR_RE = re.compile(ProductConstant.ProductStates)
_COMMENT_RE = re.compile(r"^\s*--")
_ASSIGN_RE = re.compile(r"^\s*([a-zA-Z0-9_]+)\s*=(.*)$", re.DOTALL)


@dataclass(frozen=True)
class SqlCommand:
    text: str
    name: Optional[str]
    command_type: str
    # 1-based source span of the statement body in the parsed script
    # (0 = unknown, for callers constructing commands by hand); the
    # analyzer points diagnostics here
    line: int = 0
    end_line: int = 0


@dataclass(frozen=True)
class ParsedResult:
    commands: List[SqlCommand] = field(default_factory=list)
    view_reference_count: Dict[str, int] = field(default_factory=dict)


class TransformParser:
    """reference: TransformSqlParser.scala:18-105 (same semantics)."""

    @staticmethod
    def parse(lines: Sequence[str]) -> ParsedResult:
        commands: List[SqlCommand] = []
        view_refs: Dict[str, int] = {}
        statement_buffer: List[str] = []
        table_name: Optional[str] = None
        start_line = end_line = 0  # 1-based span of the current buffer

        def append_table(name: Optional[str]) -> None:
            sql = " ".join(s for s in statement_buffer if s)
            ctype = COMMAND_TYPE_COMMAND if name is None else COMMAND_TYPE_QUERY
            commands.append(
                SqlCommand(sql, name, ctype, line=start_line,
                           end_line=end_line)
            )
            if name:
                if name in view_refs:
                    raise EngineException(
                        f"dataset name '{name}' has been created, please check the "
                        "query to make sure it is not created again"
                    )
                view_refs[name] = 0
                for k in view_refs:
                    if re.search(rf"\b{re.escape(k)}\b", sql):
                        view_refs[k] += 1

        for lineno, line in enumerate(lines, start=1):
            if not line.strip():
                continue
            if _SEPARATOR_RE.match(line):
                if statement_buffer:
                    append_table(table_name)
                table_name = None
                statement_buffer.clear()
            elif _COMMENT_RE.match(line):
                continue
            else:
                if not statement_buffer:
                    start_line = lineno
                    m = _ASSIGN_RE.match(line)
                    if m:
                        table_name = m.group(1)
                        statement_buffer.append(m.group(2).strip())
                    else:
                        statement_buffer.append(line.strip())
                else:
                    statement_buffer.append(line.strip())
                end_line = lineno

        # flush the trailing section; unlike the reference (which only keeps
        # it when named, TransformSqlParser.scala:88-92) we also keep a
        # trailing unnamed command rather than silently dropping it
        if statement_buffer and (table_name is not None or statement_buffer[0]):
            append_table(table_name)

        return ParsedResult(commands, view_refs)

    @staticmethod
    def parse_text(text: str) -> ParsedResult:
        return TransformParser.parse(text.split("\n"))

    @staticmethod
    def replace_table_names(statement: str, mappings: Dict[str, str]) -> str:
        """reference: TransformSqlParser.scala:97-104"""
        for old, new in mappings.items():
            statement = re.sub(rf"\b{re.escape(old)}\b", new, statement)
        return statement

    @staticmethod
    def split_states_sections(text: str) -> tuple:
        """Split a script into (states_ddl_lines, transform_lines).

        ``--DataXStates--`` sections carry ``CREATE TABLE`` DDL for
        accumulation tables; everything else is the transform proper.
        reference: the C# codegen splits these before writing the
        transform file (Engine.cs state handling); the Scala engine sees
        state tables via ``process.statetable.*`` conf instead.
        """
        states: List[str] = []
        transform: List[str] = []
        in_states = False
        for line in text.split("\n"):
            if _STATES_SEPARATOR_RE.match(line):
                in_states = True
                continue
            if _SEPARATOR_RE.match(line):
                in_states = False
            (states if in_states else transform).append(line)
        return states, transform
