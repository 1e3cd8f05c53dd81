"""SQL subset parser for DataXQuery statements.

Parses the SELECT dialect used by flows (reference queries all flow
through Spark SQL — ``spark.sql(statement)`` at
CommonProcessorFactory.scala:257 — so the subset here mirrors what the
reference's sample flows, rule templates, and codegen actually emit):

  SELECT [DISTINCT] expr [AS alias], ...
  FROM table [alias] [ [INNER|LEFT] JOIN table [alias] ON cond ]*
  [WHERE cond] [GROUP BY expr, ...] [UNION [ALL] select]

Expressions: literals, (back)quoted/dotted identifiers, arithmetic,
comparison, AND/OR/NOT, IN (...), function calls (incl. aggregate
functions, CAST(x AS type), IF, CASE WHEN, MAP/STRUCT/Array literals),
``*`` and ``t.*``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union


class SqlParseError(Exception):
    """Parse failure; ``pos`` (when known) is the 0-based character
    offset of the offending token in the statement text, so design-time
    diagnostics can point at the exact source location."""

    def __init__(self, message: str, pos: Optional[int] = None):
        super().__init__(message)
        self.pos = pos


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Literal:
    value: Union[int, float, str, bool, None]
    kind: str  # "int" | "float" | "str" | "bool" | "null"


@dataclass(frozen=True)
class Col:
    parts: Tuple[str, ...]  # dotted path, possibly table-qualified

    @property
    def dotted(self) -> str:
        return ".".join(self.parts)


@dataclass(frozen=True)
class Star:
    table: Optional[str] = None  # for "t.*"


@dataclass(frozen=True)
class Func:
    name: str  # upper-cased
    args: Tuple["Expr", ...]
    distinct: bool = False  # COUNT(DISTINCT x)


@dataclass(frozen=True)
class Cast:
    expr: "Expr"
    target: str  # upper-cased type name


@dataclass(frozen=True)
class BinOp:
    op: str  # +,-,*,/,%, =,!=,<,<=,>,>=, AND, OR
    left: "Expr"
    right: "Expr"


@dataclass(frozen=True)
class UnaryOp:
    op: str  # NOT, -
    operand: "Expr"


@dataclass(frozen=True)
class InList:
    expr: "Expr"
    options: Tuple["Expr", ...]
    negated: bool = False


@dataclass(frozen=True)
class CaseWhen:
    whens: Tuple[Tuple["Expr", "Expr"], ...]
    otherwise: Optional["Expr"]


@dataclass(frozen=True)
class IsNull:
    expr: "Expr"
    negated: bool = False


@dataclass(frozen=True)
class LikeOp:
    """``expr [NOT] LIKE 'pattern'`` / ``expr RLIKE 'regex'``."""

    expr: "Expr"
    pattern: "Expr"  # must be a string literal at compile time
    negated: bool = False
    regex: bool = False  # RLIKE / REGEXP


Expr = Union[
    Literal, Col, Star, Func, Cast, BinOp, UnaryOp, InList, CaseWhen,
    IsNull, LikeOp,
]


@dataclass(frozen=True)
class OrderItem:
    expr: "Expr"
    ascending: bool = True


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str]


@dataclass(frozen=True)
class TableRef:
    name: str
    alias: Optional[str] = None

    @property
    def binding(self) -> str:
        return self.alias or self.name


@dataclass(frozen=True)
class JoinClause:
    table: TableRef
    kind: str  # "INNER" | "LEFT"
    on: Expr


@dataclass(frozen=True)
class Select:
    items: Tuple[SelectItem, ...]
    from_table: Optional[TableRef]
    joins: Tuple[JoinClause, ...] = ()
    where: Optional[Expr] = None
    group_by: Tuple[Expr, ...] = ()
    having: Optional[Expr] = None
    order_by: Tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    distinct: bool = False
    union: Optional["Select"] = None  # UNION ALL chain
    union_distinct: bool = False


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------
_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<bq>`[^`]*`)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><>|!=|<=|>=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "ORDER", "LIMIT",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "ON", "AS", "AND",
    "OR", "NOT", "IN", "IS", "NULL", "TRUE", "FALSE", "UNION", "ALL",
    "CASE", "WHEN", "THEN", "ELSE", "END", "CAST", "LIKE", "BETWEEN",
}

# contextual keywords: recognized only in their clause position, so
# columns/aliases named "desc", "having", "regexp" etc. keep parsing
# (they are not reserved words in this dialect's existing surface)
_CONTEXTUAL = ("HAVING", "ASC", "DESC", "RLIKE", "REGEXP")


@dataclass
class Token:
    kind: str  # "num" | "str" | "ident" | "bq" | "op" | "kw" | "eof"
    value: str
    pos: int = -1  # 0-based character offset in the source text


def tokenize(text: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SqlParseError(
                f"unexpected character {text[pos]!r} at {pos}: ...{text[max(0,pos-20):pos+20]!r}",
                pos=pos,
            )
        start = pos
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        kind, value = m.lastgroup, m.group()
        if kind == "ident" and value.upper() in KEYWORDS:
            tokens.append(Token("kw", value.upper(), start))
        else:
            tokens.append(Token(kind, value, start))
    tokens.append(Token("eof", "", len(text)))
    return tokens


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------
class _Parser:
    def __init__(self, tokens: List[Token], text: str):
        self.toks = tokens
        self.i = 0
        self.text = text

    # -- primitives ------------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "kw" and t.value in kws:
            self.next()
            return t.value
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlParseError(
                f"expected {kw}, got {self.peek().value!r} in: {self.text[:200]}",
                pos=self.peek().pos,
            )

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.value == op:
            self.next()
            return True
        return False

    def accept_ctx_kw(self, *words: str) -> Optional[str]:
        """Accept a contextual keyword (plain ident matched by value)."""
        t = self.peek()
        if t.kind == "ident" and t.value.upper() in words:
            self.next()
            return t.value.upper()
        return None

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlParseError(
                f"expected {op!r}, got {self.peek().value!r} in: {self.text[:200]}",
                pos=self.peek().pos,
            )

    # -- grammar ---------------------------------------------------------
    def parse_select(self) -> Select:
        self.expect_kw("SELECT")
        distinct = bool(self.accept_kw("DISTINCT"))
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())

        from_table = None
        joins: List[JoinClause] = []
        if self.accept_kw("FROM"):
            from_table = self.parse_table_ref()
            while True:
                kind = None
                if self.accept_kw("INNER"):
                    self.expect_kw("JOIN")
                    kind = "INNER"
                elif self.accept_kw("LEFT"):
                    self.accept_kw("OUTER")
                    self.expect_kw("JOIN")
                    kind = "LEFT"
                elif self.accept_kw("JOIN"):
                    kind = "INNER"
                else:
                    break
                table = self.parse_table_ref()
                self.expect_kw("ON")
                on = self.parse_expr()
                joins.append(JoinClause(table, kind, on))

        where = None
        if self.accept_kw("WHERE"):
            where = self.parse_expr()

        group_by: List[Expr] = []
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())

        having = None
        if self.accept_ctx_kw("HAVING"):
            having = self.parse_expr()

        union = None
        union_distinct = False
        if self.accept_kw("UNION"):
            union_distinct = not self.accept_kw("ALL")
            union = self.parse_select()

        # trailing ORDER BY / LIMIT (after a UNION chain they apply to
        # the whole union, which the planner honors by hoisting)
        order_by: List[OrderItem] = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                asc = self.accept_ctx_kw("ASC", "DESC") != "DESC"
                order_by.append(OrderItem(e, asc))
                if not self.accept_op(","):
                    break

        limit = None
        if self.accept_kw("LIMIT"):
            t = self.next()
            if t.kind != "num" or "." in t.value:
                raise SqlParseError(
                    f"LIMIT expects an integer, got {t.value!r}", pos=t.pos
                )
            limit = int(t.value)

        return Select(
            items=tuple(items),
            from_table=from_table,
            joins=tuple(joins),
            where=where,
            group_by=tuple(group_by),
            having=having,
            order_by=tuple(order_by),
            limit=limit,
            distinct=distinct,
            union=union,
            union_distinct=union_distinct,
        )

    def parse_table_ref(self) -> TableRef:
        t = self.next()
        if t.kind not in ("ident", "bq"):
            raise SqlParseError(
                f"expected table name, got {t.value!r}", pos=t.pos
            )
        name = t.value.strip("`")
        alias = None
        if self.accept_kw("AS"):
            alias = self.next().value
        elif (
            self.peek().kind == "ident"
            and self.peek().value.upper() not in _CONTEXTUAL
        ):
            # bare alias — but not a clause word in clause position
            # (FROM t HAVING ... / ORDER BY x DESC must not eat it)
            alias = self.next().value
        return TableRef(name, alias)

    def parse_select_item(self) -> SelectItem:
        # "*" or "t.*"
        if self.peek().kind == "op" and self.peek().value == "*":
            self.next()
            return SelectItem(Star(), None)
        if (
            self.peek().kind == "ident"
            and self.peek(1).kind == "op" and self.peek(1).value == "."
            and self.peek(2).kind == "op" and self.peek(2).value == "*"
        ):
            table = self.next().value
            self.next()  # .
            self.next()  # *
            return SelectItem(Star(table), None)
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            t = self.next()
            alias = t.value.strip("`")
        elif self.peek().kind in ("ident", "bq"):
            alias = self.next().value.strip("`")
        return SelectItem(expr, alias)

    # precedence: OR < AND < NOT < comparison < additive < multiplicative < unary
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.accept_kw("OR"):
            left = BinOp("OR", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.accept_kw("AND"):
            left = BinOp("AND", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.accept_kw("NOT"):
            return UnaryOp("NOT", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        left = self.parse_additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return BinOp(op, left, self.parse_additive())
        negated = False
        if (
            self.peek().kind == "kw" and self.peek().value == "NOT"
            and self.peek(1).value.upper()
            in ("IN", "LIKE", "RLIKE", "REGEXP", "BETWEEN")
        ):
            self.next()
            negated = True
        if self.accept_kw("LIKE"):
            return LikeOp(left, self.parse_additive(), negated, regex=False)
        if self.accept_ctx_kw("RLIKE", "REGEXP"):
            return LikeOp(left, self.parse_additive(), negated, regex=True)
        if self.accept_kw("IN"):
            self.expect_op("(")
            options = [self.parse_expr()]
            while self.accept_op(","):
                options.append(self.parse_expr())
            self.expect_op(")")
            return InList(left, tuple(options), negated)
        if self.accept_kw("IS"):
            neg = bool(self.accept_kw("NOT"))
            self.expect_kw("NULL")
            return IsNull(left, neg)
        if self.accept_kw("BETWEEN"):
            lo = self.parse_additive()
            self.expect_kw("AND")
            hi = self.parse_additive()
            if negated:
                # NOT BETWEEN desugars to strict comparisons, NOT to
                # NOT(range): comparisons over NULL are false on both
                # sides, so NULL rows stay excluded (Spark semantics),
                # where a bare NOT would flip them to included
                return BinOp(
                    "OR", BinOp("<", left, lo), BinOp(">", left, hi)
                )
            return BinOp("AND", BinOp(">=", left, lo), BinOp("<=", left, hi))
        if negated:
            raise SqlParseError(
                "NOT must be followed by IN/LIKE/RLIKE/BETWEEN near "
                f"{self.peek().value!r}",
                pos=self.peek().pos,
            )
        return left

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = BinOp(t.value, left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = BinOp(t.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> Expr:
        if self.accept_op("-"):
            return UnaryOp("-", self.parse_unary())
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "num":
            self.next()
            if "." in t.value or "e" in t.value or "E" in t.value:
                return Literal(float(t.value), "float")
            return Literal(int(t.value), "int")
        if t.kind == "str":
            self.next()
            return Literal(t.value[1:-1].replace("''", "'"), "str")
        if t.kind == "kw":
            if t.value in ("TRUE", "FALSE"):
                self.next()
                return Literal(t.value == "TRUE", "bool")
            if t.value == "NULL":
                self.next()
                return Literal(None, "null")
            if t.value == "CASE":
                return self.parse_case()
            if t.value == "CAST":
                self.next()
                self.expect_op("(")
                inner = self.parse_expr()
                self.expect_kw("AS")
                target = self.next().value.upper()
                self.expect_op(")")
                return Cast(inner, target)
        if t.kind == "op" and t.value == "(":
            self.next()
            inner = self.parse_expr()
            self.expect_op(")")
            return inner
        if t.kind in ("ident", "bq"):
            return self.parse_identifier_or_call()
        raise SqlParseError(
            f"unexpected token {t.value!r} in: {self.text[:200]}", pos=t.pos
        )

    def parse_case(self) -> Expr:
        self.expect_kw("CASE")
        whens = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            val = self.parse_expr()
            whens.append((cond, val))
        otherwise = None
        if self.accept_kw("ELSE"):
            otherwise = self.parse_expr()
        self.expect_kw("END")
        return CaseWhen(tuple(whens), otherwise)

    def parse_identifier_or_call(self) -> Expr:
        t = self.next()
        name = t.value.strip("`")
        # function call?
        if t.kind == "ident" and self.peek().kind == "op" and self.peek().value == "(":
            self.next()  # (
            if self.accept_op(")"):
                return Func(name.upper(), ())
            if self.peek().kind == "op" and self.peek().value == "*":
                self.next()
                self.expect_op(")")
                return Func(name.upper(), (Star(),))
            distinct = bool(self.accept_kw("DISTINCT"))
            args = [self.parse_expr()]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return Func(name.upper(), tuple(args), distinct)
        # dotted path: a.b.c (backquoted segments keep dots inside as one part)
        parts = [name]
        while (
            self.peek().kind == "op" and self.peek().value == "."
            and self.peek(1).kind in ("ident", "bq")
        ):
            self.next()
            parts.append(self.next().value.strip("`"))
        return Col(tuple(parts))


def parse_select(text: str) -> Select:
    p = _Parser(tokenize(text), text)
    sel = p.parse_select()
    if p.peek().kind != "eof":
        raise SqlParseError(
            f"trailing tokens starting at {p.peek().value!r} in: {text[:200]}",
            pos=p.peek().pos,
        )
    return sel
