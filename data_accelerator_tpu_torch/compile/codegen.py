"""Rules + DataXQuery code generation.

Copy of the JAX package's ``compile/codegen.py``, untrimmed.

Compiles the UI's no-code rules and the user's DataXQuery script into the
final transform script consumed by the engine, extracting along the way:
- ``OUTPUT <tables> TO <sinks>;`` statements -> table->sink map
- ``TIMEWINDOW('5 minutes')`` on DataXProcessedInput -> windowed table
  name + window config
- ``--DataXStates--`` ``CREATE TABLE name (schema);`` -> accumulation tables
- ``X WITH UPSERT Y`` -> ``Y = X`` accumulation upsert rewrite
- auto-generated metrics dashboard config for tables sent TO Metrics

reference: Services/DataX.Flow/DataX.Flow.CodegenRules/Engine.cs:32-644,
Rule.cs:17-280, Metrics.cs:17-202. Semantics preserved; output formatting
is this implementation's own (golden files live in tests/data/).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEFAULT_TARGET = "DataXProcessedInput"

# ---------------------------------------------------------------------------
# Query templates: one per rule type. Equivalent to the reference's
# defaultQueryTemplate.xml (Engine.cs embedded resource; test copy at
# DataX.Flow.CodegenRules.Tests/QueryTemplates.xml:6-57).
# ---------------------------------------------------------------------------
QUERY_TEMPLATES: Dict[str, str] = {
    "SimpleRule": (
        "--DataXQuery--\n"
        "$return = SELECT *, $arrayConditions AS Rules FROM DataXProcessedInput;"
    ),
    "SimpleAlert": (
        "--DataXQuery--\n"
        "sa1_$ruleCounter = SELECT *, '$ruleId' AS ruleId, '$ruleDescription' AS ruleDescription,"
        " '$severity' AS severity, '$tag' AS Tag FROM DataXProcessedInput\n"
        "WHERE $condition;\n"
        "\n"
        "--DataXQuery--\n"
        "sa2_$ruleCounter = ApplyTemplate(sa1_$ruleCounter, $outputTemplate);\n"
        "\n"
        "--DataXQuery--\n"
        "$tagAlert = SELECT DISTINCT DATE_TRUNC('second', current_timestamp()) AS EventTime,"
        " '$tagAlert' AS MetricName, 0 AS Metric, '$productId' AS Product,"
        " '$ruleDescription' AS Pivot1 FROM sa1_$ruleCounter;\n"
        "\n"
        "OUTPUT sa2_$ruleCounter TO $alertsinks;\n"
        "OUTPUT $tagAlert TO Metrics;"
    ),
    "AggregateRule": (
        "--DataXQuery--\n"
        "ar1_$ruleCounter = SELECT $aggs, $pivots, COUNT(*) AS Count\n"
        "FROM DataXProcessedInput\n"
        "GROUP BY $pivots;\n"
        "\n"
        "--DataXQuery--\n"
        "ar2_$ruleCounter = SELECT *, IF($condition,$ruleObject,NULL) AS RuleObject\n"
        "FROM ar1_$ruleCounter;\n"
        "\n"
        "--DataXQuery--\n"
        "ar3_$ruleCounter = ApplyTemplate(ar2_$ruleCounter, defaultAggOutputTemplate);"
    ),
    "AggregateAlert": (
        "--DataXQuery--\n"
        "aa1_$ruleCounter = SELECT $aggs, $pivots, COUNT(*) AS Count\n"
        "FROM DataXProcessedInput\n"
        "GROUP BY $pivots;\n"
        "\n"
        "--DataXQuery--\n"
        "aa2_$ruleCounter = SELECT *, $ruleObject AS RuleObject FROM aa1_$ruleCounter WHERE $condition;\n"
        "\n"
        "--DataXQuery--\n"
        "aa3_$ruleCounter = ApplyTemplate(aa2_$ruleCounter, $outputTemplate);\n"
        "\n"
        "--DataXQuery--\n"
        "$tagAlert = SELECT DISTINCT DATE_TRUNC('second', current_timestamp()) AS EventTime,"
        " '$tagAlert' AS MetricName, 0 AS Metric, '$productId' AS Product,"
        " RuleObject.ruleDescription AS Pivot1 FROM aa2_$ruleCounter;\n"
        "\n"
        "OUTPUT aa3_$ruleCounter TO $alertsinks;\n"
        "OUTPUT $tagAlert TO Metrics;"
    ),
}

# Equivalent to defaultOutputTemplate.xml (test copy: OutputTemplates.xml)
OUTPUT_TEMPLATES: Dict[str, str] = {
    "defaultAggOutputTemplate": (
        "MAP(\n"
        "  $pivotstemplate\n"
        ") AS pivots,\n"
        "$aggstemplate,\n"
        "Count AS count,\n"
        "MAP(\n"
        "  'ruleId', '$ruleId',\n"
        "  '$tagname', '$tag',\n"
        "  'description', '$ruleDescription',\n"
        "  'severity', '$severity'\n"
        ") AS result"
    ),
}


@dataclass
class Rule:
    """A no-code rule definition. reference: Rule.cs:17-75 ($-prefixed JSON)."""

    rule_id: str = ""
    product_id: str = ""
    rule_type: str = "SimpleRule"
    rule_description: str = ""
    rule_category: str = ""
    severity: str = ""
    condition: str = ""
    aggs: List[str] = field(default_factory=list)
    pivots: List[str] = field(default_factory=list)
    tagname: str = ""
    tag: str = ""
    fact: str = ""
    id: str = ""
    output_template: str = ""
    sinks: List[str] = field(default_factory=list)
    alertsinks: List[str] = field(default_factory=list)
    is_alert: bool = False
    target_table: str = DEFAULT_TARGET

    @staticmethod
    def from_json(obj: dict) -> "Rule":
        return Rule(
            rule_id=obj.get("$ruleId") or "",
            product_id=obj.get("$productId") or "",
            rule_type=obj.get("$ruleType") or "SimpleRule",
            rule_description=obj.get("$ruleDescription") or "",
            rule_category=obj.get("$ruleCategory") or "",
            severity=obj.get("$severity") or "",
            condition=obj.get("$condition") or "",
            aggs=obj.get("$aggs") or [],
            pivots=obj.get("$pivots") or [],
            tagname=obj.get("$tagname") or "",
            tag=obj.get("$tag") or "",
            fact=obj.get("$fact") or "",
            id=obj.get("$id") or "",
            output_template=obj.get("$outputTemplate") or "",
            sinks=obj.get("$sinks") or [],
            alertsinks=obj.get("$alertsinks") or obj.get("$alertSinks") or [],
            is_alert=bool(obj.get("$isAlert", obj.get("$isalert", False))),
            target_table=obj.get("schemaTableName") or DEFAULT_TARGET,
        )

    # -- helpers mirroring Rule.cs -------------------------------------
    _AGG_RE = re.compile(r"(.*)\((.*?)\)")

    def _agg_alias(self, agg: str) -> str:
        """``AVG(Temperature)`` -> ``Temperature_AVG``; backticked columns
        keep the backtick at the end. reference: Rule.cs AggsToSelect."""
        m = self._AGG_RE.match(agg)
        op, col = m.group(1), m.group(2)
        if col.endswith("`"):
            return f"{col[:-1]}_{op}`"
        return f"{col.replace('.', '')}_{op}"

    def aggs_to_select(self) -> str:
        if not self.aggs:
            return ""
        return ", ".join(f"{agg} AS {self._agg_alias(agg)}" for agg in self.aggs)

    def condition_to_sql(self) -> str:
        """Rewrite agg calls in the condition to their aliases; strip pivot
        qualifiers. reference: Rule.cs ConditionToSQL."""
        if not self.aggs:
            return self.condition
        result = self.condition
        for agg in self.aggs:
            result = result.replace(agg, self._agg_alias(agg))
        for pivot in self.pivots:
            if not pivot.startswith("`") and "." in pivot:
                result = result.replace(pivot, pivot.split(".")[-1])
        return result

    def aggs_to_template(self) -> str:
        """Nested MAP('col', MAP('op', alias, ...)) AS aggs.
        reference: Rule.cs AggsToTemplate."""
        if not self.aggs:
            return ""
        by_col: Dict[str, List[str]] = {}
        for agg in self.aggs:
            m = self._AGG_RE.match(agg)
            op, col = m.group(1), m.group(2)
            by_col.setdefault(col, []).append(op)
        parts = []
        for col, ops in by_col.items():
            if col.endswith("`"):
                inner = ", ".join(f"'{op}', {col[:-1]}_{op}`" for op in ops)
            else:
                inner = ", ".join(f"'{op}', {col.replace('.', '')}_{op}" for op in ops)
            parts.append(f"'{col}', MAP({inner})")
        return "MAP(" + ", ".join(parts) + ") AS aggs"

    def pivots_to_template(self) -> str:
        if not self.pivots:
            return ""
        parts = []
        for pivot in self.pivots:
            if pivot.strip().endswith("`"):
                parts.append(f"'{pivot}', {pivot}")
            else:
                parts.append(f"'{pivot}', {pivot.split('.')[-1]}")
        return ", ".join(parts)

    def rules_object(self) -> str:
        return (
            "MAP("
            f"'ruleId', '{self.rule_id}', "
            f"'ruleDescription', '{self.rule_description}', "
            f"'severity', '{self.severity}', "
            f"'{self.tagname}', '{self.tag}')"
        )


@dataclass
class RulesCode:
    """reference: Rule.cs RulesCode class."""

    code: str = ""
    outputs: List[Tuple[str, str]] = field(default_factory=list)
    accumulation_tables: Dict[str, str] = field(default_factory=dict)
    time_windows: Dict[str, str] = field(default_factory=dict)
    metrics_root: dict = field(default_factory=dict)


def _list_to_string(items: List[str]) -> str:
    return ", ".join(items)


class CodegenEngine:
    """reference: Engine.cs:18-644 (same pass ordering and regexes)."""

    def __init__(
        self,
        query_templates: Optional[Dict[str, str]] = None,
        output_templates: Optional[Dict[str, str]] = None,
    ):
        self.query_templates = query_templates or QUERY_TEMPLATES
        self.output_templates = output_templates or OUTPUT_TEMPLATES

    def generate_code(
        self, code: str, rules_json: str, product_id: str,
        windowable_tables=None,
    ) -> RulesCode:
        """``windowable_tables``: table names TIMEWINDOW may target
        (None = unrestricted, for direct compiler users); generation
        passes the main projection + declared source targets so a typo
        fails HERE with a clear message instead of silently windowing
        the wrong table at runtime."""
        self._code = code
        self._windowable = (
            {t.lower() for t in windowable_tables}
            if windowable_tables is not None else None
        )
        self._statement_number = 0
        self._rule_counter = 1
        self._all_rules = [Rule.from_json(o) for o in json.loads(rules_json or "[]")]

        self._auto_codegen_alerts(product_id)
        self._process_alerts(product_id)
        self._process_rules(product_id)
        self._process_aggregate_rules(product_id)
        self._process_aggregate_alerts(product_id)
        self._process_create_metrics(product_id)

        outputs = self._process_outputs()
        accumulation_tables = self._process_accumulation_tables()
        time_windows = self._process_time_windows()
        metrics_root = self._generate_metrics_config(outputs)
        self._process_upsert()

        code_out = self._code.replace(";", "")
        code_out = self._cleanup(code_out)

        return RulesCode(
            code=code_out,
            outputs=outputs,
            accumulation_tables=accumulation_tables,
            time_windows=time_windows,
            metrics_root=metrics_root,
        )

    # -- rule selection --------------------------------------------------
    def _select_rules(
        self, product_id: str, rule_type: str, target: str, alerts_only: bool
    ) -> List[Rule]:
        out = []
        for r in self._all_rules:
            if product_id and r.product_id != product_id:
                continue
            if r.rule_type != rule_type or r.target_table != target:
                continue
            if alerts_only and not r.is_alert:
                continue
            out.append(r)
        return out

    # -- passes ----------------------------------------------------------
    def _auto_codegen_alerts(self, product_id: str) -> None:
        """Append ProcessAlerts()/ProcessAggregateAlerts() calls for alert
        rules the user's script didn't reference. reference: Engine.cs:142-198"""
        rules = [
            r
            for r in self._all_rules
            if r.is_alert and (not product_id or r.product_id == product_id)
        ]
        seen: Dict[str, List[str]] = {}
        for r in rules:
            seen.setdefault(r.target_table, [])
            if r.rule_type not in seen[r.target_table]:
                seen[r.target_table].append(r.rule_type)
        for target, rule_types in seen.items():
            for rule_type in rule_types:
                if rule_type == "SimpleRule":
                    pat = re.compile(
                        rf"ProcessAlerts\s*\(\s*{re.escape(target)}\s*\)", re.I
                    )
                    if not pat.search(self._code):
                        self._code += f"\nProcessAlerts({target});"
                else:
                    pat = re.compile(
                        rf"ProcessAggregateAlerts\s*\(\s*{re.escape(target)}\s*\)",
                        re.I,
                    )
                    if not pat.search(self._code):
                        self._code += f"\nProcessAggregateAlerts({target});"

    def _process_alerts(self, product_id: str) -> None:
        """reference: Engine.cs:200-230"""
        for m in list(re.finditer(r"ProcessAlerts\s*\(\s*(.*?)\s*\)", self._code, re.I)):
            self._statement_number += 1
            target = m.group(1) or DEFAULT_TARGET
            rules = self._select_rules(product_id, "SimpleRule", target, True)
            s = self._expand_rules(rules, self.query_templates["SimpleAlert"], target)
            self._code = self._code.replace(m.group(0), s)

    def _process_rules(self, product_id: str) -> None:
        """reference: Engine.cs:232-268"""
        for m in list(
            re.finditer(r"(\S+)\s*=\s*ProcessRules\s*\(\s*(.*?)\s*\)", self._code, re.I)
        ):
            self._statement_number += 1
            target = m.group(2) or DEFAULT_TARGET
            rules = self._select_rules(product_id, "SimpleRule", target, False)
            s = self.query_templates["SimpleRule"].replace(
                "$arrayConditions", self._array_conditions(rules)
            )
            s = s.replace("$return", m.group(1))
            s = s.replace(DEFAULT_TARGET, target)
            self._code = self._code.replace(m.group(0), s)

    def _process_aggregate_alerts(self, product_id: str) -> None:
        """reference: Engine.cs:270-300"""
        for m in list(
            re.finditer(r"ProcessAggregateAlerts\s*\(\s*(.*?)\s*\)", self._code, re.I)
        ):
            self._statement_number += 1
            target = m.group(1) or DEFAULT_TARGET
            rules = self._select_rules(product_id, "AggregateRule", target, True)
            s = self._expand_rules(
                rules, self.query_templates["AggregateAlert"], target
            )
            self._code = self._code.replace(m.group(0), s)

    def _process_aggregate_rules(self, product_id: str) -> None:
        """reference: Engine.cs:302-356 (expansion + UNION of ar3_* + $return)"""
        for m in list(
            re.finditer(
                r"(\S+)\s*=\s*ProcessAggregateRules\s*\(\s*(.*?)\s*\)", self._code, re.I
            )
        ):
            self._statement_number += 1
            target = m.group(2) or DEFAULT_TARGET
            rules = self._select_rules(product_id, "AggregateRule", target, False)
            s = self._expand_rules(rules, self.query_templates["AggregateRule"], target)
            n = self._statement_number
            s += f"\n\n--DataXQuery--\nar4_{n} = "
            s += " UNION ".join(
                f"SELECT * FROM ar3_{n}_{i}" for i in range(1, self._rule_counter)
            )
            s += f"\n\n--DataXQuery--\n{m.group(1)} = SELECT * FROM ar4_{n}"
            self._code = self._code.replace(m.group(0), s)

    def _process_create_metrics(self, product_id: str) -> None:
        """``X = CreateMetric(t, col)`` expansion. reference: Engine.cs:358-383"""
        for m in list(
            re.finditer(
                r"(\S+)\s*=\s*CreateMetric\s*\(\s*(.*?)\s*,\s*(.*?)\s*\)",
                self._code,
                re.I,
            )
        ):
            out_table, from_table, metric = m.group(1), m.group(2), m.group(3)
            s = (
                "\n\n--DataXQuery--\n"
                f"{out_table} = SELECT DISTINCT DATE_TRUNC('second', current_timestamp()) AS EventTime,"
                f" '{out_table}' AS MetricName, {metric} AS Metric, '{product_id}' AS Product,"
                f" '' AS Pivot1 FROM {from_table}"
                " GROUP BY EventTime, MetricName, Metric, Product, Pivot1;"
            )
            self._code = self._code.replace(m.group(0), s)

    def _array_conditions(self, rules: List[Rule]) -> str:
        """reference: Engine.cs:385-401 CreateArrayConditions"""
        if not rules:
            return "'NULL'"
        parts = [f"IF({r.condition}, {r.rules_object()}, NULL)" for r in rules]
        return "filterNull(Array(" + ", ".join(parts) + "))"

    def _expand_rules(
        self, rules: List[Rule], template: str, input_table: str
    ) -> str:
        """Expand one template per rule. reference: Engine.cs:403-494"""
        if not rules:
            return ""
        self._rule_counter = 1
        result = ""
        for rule in rules:
            s = template.strip()

            # ApplyTemplate(t, name|$outputTemplate) resolution
            for m in list(
                re.finditer(r"ApplyTemplate\s*\(\s*(.*?)\s*,\s*(.*?)\s*\)", s, re.I)
            ):
                tmpl_name = m.group(2)
                tmpl = None
                if tmpl_name == "$outputTemplate":
                    if rule.output_template:
                        tmpl = self.output_templates.get(rule.output_template)
                    elif "aggregate" in rule.rule_type.lower():
                        tmpl = self.output_templates.get("defaultAggOutputTemplate")
                else:
                    tmpl = self.output_templates.get(tmpl_name)
                if tmpl is None:
                    repl = f"SELECT * FROM {m.group(1)}"
                else:
                    body = tmpl.replace("$aggstemplate", rule.aggs_to_template())
                    body = body.replace("$pivotstemplate", rule.pivots_to_template())
                    repl = f"SELECT {body} FROM {m.group(1)}"
                s = s.replace(m.group(0), repl)

            # alert sink routing (reference: Engine.cs:452-462)
            if not rule.alertsinks or rule.alertsinks == ["Metrics"]:
                s = s.replace("OUTPUT aa3_$ruleCounter TO $alertsinks;", "")
                s = s.replace("OUTPUT sa2_$ruleCounter TO $alertsinks;", "")
            else:
                s = s.replace(
                    "$alertsinks",
                    _list_to_string([x for x in rule.alertsinks if x != "Metrics"]),
                )

            s = s.replace("$productId", rule.product_id)
            s = s.replace("$ruleId", rule.rule_id)
            s = s.replace(
                "$ruleCounter", f"{self._statement_number}_{self._rule_counter}"
            )
            s = s.replace("$ruleDescription", rule.rule_description)
            s = s.replace("$ruleCategory", rule.rule_category)
            s = s.replace("$ruleType", rule.rule_type)
            s = s.replace("$severity", rule.severity)
            s = s.replace("$aggs", rule.aggs_to_select())
            s = s.replace("$condition", rule.condition_to_sql())
            s = s.replace("$tagname", rule.tagname)
            # $tagAlert before $tag: "$tagAlert" contains "$tag" as prefix
            s = s.replace("$tagAlert", f"{rule.tag}Alert")
            s = s.replace("$tag", rule.tag)
            s = s.replace("$sinks", _list_to_string(rule.sinks))
            s = s.replace("$ruleObject", rule.rules_object())
            s = s.replace("$id", rule.id)
            s = s.replace("$fact", rule.fact)
            s = s.replace(DEFAULT_TARGET, input_table)
            if not rule.pivots:
                s = s.replace("GROUP BY $pivots", "")
                s = s.replace("$pivots,", "")
            else:
                s = s.replace("$pivots", _list_to_string(rule.pivots))

            result += s + "\n\n"
            self._rule_counter += 1
        return result

    def _process_outputs(self) -> List[Tuple[str, str]]:
        """Extract ``OUTPUT t1, t2 TO s1, s2;``. reference: Engine.cs:496-515"""
        table_sink: List[Tuple[str, str]] = []
        for m in list(
            re.finditer(r"OUTPUT\s+(.*?)\s+TO\s+([^;]*);", self._code, re.I)
        ):
            tables, sinks = m.group(1), m.group(2).split(",")
            for sink in sinks:
                table_sink.append((tables, sink.strip()))
            self._code = self._code.replace(m.group(0), "")
        return table_sink

    def _process_accumulation_tables(self) -> Dict[str, str]:
        """reference: Engine.cs:559-579"""
        tables: Dict[str, str] = {}
        for m in list(
            re.finditer(r"CREATE TABLE\s+(.*?)\s*\((.*?)\)\s*;", self._code, re.I | re.S)
        ):
            tables[m.group(1)] = re.sub(r"\s+", " ", m.group(2)).strip()
            self._code = self._code.replace(m.group(0), "")
        self._code = self._code.replace("--DataXStates--", "")
        return tables

    def _process_upsert(self) -> None:
        """``X WITH UPSERT Y`` -> ``Y = X``. reference: Engine.cs:582-595"""
        for m in list(
            re.finditer(
                r"\s*--DataXQuery--\s*([^;]*)WITH\s+UPSERT\s+([^;\s]*)",
                self._code,
                re.I,
            )
        ):
            new_query = (
                "\n\n--DataXQuery--\n" + m.group(2).strip() + " = " + m.group(1).strip() + "\n"
            )
            self._code = self._code.replace(m.group(0), new_query)

    def _process_time_windows(self) -> Dict[str, str]:
        """``FROM <table> TIMEWINDOW('5 minutes')`` ->
        ``FROM <table>_5minutes`` + window conf.
        reference: Engine.cs:597-630 — which restricts windows to
        DataXProcessedInput in FROM position; here ANY projected table
        may be windowed, in FROM or JOIN position (multi-source flows
        window the joined stream's table, the cross-stream
        sliding-window-join shape; the engine validates the table name
        at compile time). One TIMEWINDOW per statement."""
        windows: Dict[str, str] = {}
        pattern = re.compile(
            r"--DataXQuery--\s*([^;]*?(?:FROM|JOIN)\s+)(\S+)(\s+)"
            r"TIMEWINDOW\s*\(\s*(.*?)\s*\)\s*([^;]*?)",
            re.I,
        )
        # fixpoint scan: a statement windowing BOTH join sides needs two
        # passes (the lazy prefix reaches the next TIMEWINDOW once the
        # first is rewritten)
        while True:
            m = pattern.search(self._code)
            if m is None:
                break
            window_str = m.group(4).strip().replace("'", "")
            src_table = m.group(2).strip()
            if (
                self._windowable is not None
                and src_table.lower() not in self._windowable
            ):
                raise ValueError(
                    f"TIMEWINDOW target '{src_table}' is not a projected "
                    f"input table (windowable: "
                    f"{sorted(self._windowable)})"
                )
            new_table = src_table + "_" + window_str.replace(" ", "")
            # replace ONLY the matched table occurrence (a blanket
            # case-insensitive word substitution would also rename
            # same-named columns/aliases in the statement)
            g0 = m.group(0)
            t_start = m.start(2) - m.start(0)
            t_end = m.end(2) - m.start(0)
            new_query = g0[:t_start] + new_table + g0[t_end:]
            new_query = new_query.replace(m.group(4).strip(), "")
            new_query = re.sub(
                r"TIMEWINDOW\s*\(\s*\)\s*", "", new_query, flags=re.I
            )
            windows.setdefault(new_table, window_str)
            self._code = (
                self._code[: m.start(0)] + new_query
                + self._code[m.end(0):]
            )
        return windows

    def _generate_metrics_config(self, outputs: List[Tuple[str, str]]) -> dict:
        """Auto dashboard config for tables sent TO Metrics.
        reference: Engine.cs:517-534 + Metrics.cs:17-202"""
        sources, widgets = [], []
        for tables, sink in outputs:
            if sink.strip().lower() != "metrics":
                continue
            name = tables
            is_alert = "alert" in name.lower() and "," not in name
            metric_keys = [
                {"name": f"_FLOW_:{n.strip()}", "displayName": n.strip()}
                for n in name.split(",")
            ]
            sources.append(
                {
                    "name": name,
                    "input": {
                        "type": "MetricDetailsApi" if is_alert else "MetricApi",
                        "pollingInterval": 60000,
                        "metricKeys": metric_keys,
                    },
                    "output": {
                        "type": "DirectTable" if is_alert else "DirectTimeChart",
                        "data": {
                            "timechart": not is_alert,
                            "current": False,
                            "table": is_alert,
                        },
                        "chartTimeWindowInMs": 3600000,
                    },
                }
            )
            widgets.append(
                {
                    "name": name,
                    "displayName": name,
                    "data": name + ("_table" if is_alert else "_timechart"),
                    "position": "TimeCharts",
                    "type": "DetailsList" if is_alert else "MultiLineChart",
                }
            )
        # standing engine-health alert tile: the string-dictionary
        # overflow counter. Over-capacity keys collapse to NULL with
        # only this metric as the tell (core/schema.py degradation
        # semantics), so every generated dashboard carries it as an
        # alert tile — any non-zero sample means GROUP BY/JOIN string
        # keys are being lost.
        overflow_metric = "Input_string_dictionary_overflow_Count"
        sources.append(
            {
                "name": "DictionaryOverflow",
                "input": {
                    "type": "MetricApi",
                    "pollingInterval": 60000,
                    "metricKeys": [{
                        "name": f"_FLOW_:{overflow_metric}",
                        "displayName": "String dictionary overflow",
                    }],
                },
                "output": {
                    "type": "DirectTimeChart",
                    "data": {"timechart": True, "current": True,
                             "table": False},
                    "chartTimeWindowInMs": 3600000,
                    "alert": {
                        "threshold": 0,
                        "message": "string dictionary at capacity: new "
                                   "keys collapse to NULL (raise "
                                   "process.stringdictionary.maxsize)",
                    },
                },
            }
        )
        widgets.append(
            {
                "name": "DictionaryOverflow",
                "displayName": "String dictionary overflow",
                "data": "DictionaryOverflow_timechart",
                "position": "Alerts",
                "type": "MultiLineChart",
                "alertTile": True,
            }
        )
        # standing alert rules (obs/alerts.py): every generated
        # dashboard ships the default rule set — the runtime host
        # evaluates the same rules from its conf, and the SPA renders
        # the firing set as annotations on these widgets
        from ..obs.alerts import default_rules

        return {
            "metrics": {
                "sources": sources,
                "widgets": widgets,
                "alertRules": default_rules(),
                "initParameters": {
                    "widgetSets": ["direct"],
                    "jobNames": {"type": "getCPSparkJobNames"},
                },
            }
        }

    @staticmethod
    def _cleanup(code: str) -> str:
        """Collapse empty query sections. reference: Engine.cs:536-556"""
        code = code.strip().strip("\n\r\t")
        code = re.sub(r"(--DataXQuery--\s*)+--DataXQuery--", "--DataXQuery--", code)
        code = re.sub(r"--DataXQuery--\s*$", "", code)
        # drop blank runs left by removed OUTPUT/CREATE statements
        code = re.sub(r"\n{3,}", "\n\n", code)
        return code.strip()
