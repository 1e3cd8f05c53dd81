"""Flow document construction from designer ("gui") JSON.

Copy of the JAX package's ``serve/flowbuilder.py``, untrimmed: the
template's job tokens keep the reference's names, so flow documents
written for either package build the same way.

reference: DataX.Config/ConfigDataModel/FlowConfigBuilder + the default
flow template seeded into the config store
(DataX.Config.Local/Resources/*, DeploymentCloud/Deployment.Common/
CosmosDB/flowCommonTemplate.json) and
InternalService/RuleDefinitionGenerator.cs:31-32 (gui rules ->
rule-definition JSON consumed by CodegenRules).

A flow document is::

    {"name", "displayName", "gui": {...designer state...},
     "commonProcessor": {"template": {... _S_{token} placeholders ...},
                         "jobCommonTokens": {...}, "jobs": [...]},
     "metrics": {...}, "jobNames": [...]}

The template keeps the reference's shape and token names
(HomeAutomationLocal.json commonProcessor.template) so flow documents
written for the reference generate here unchanged; job tokens are
TPU-flavored (chips/mesh instead of executors/memory).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Default flow template. Same placeholder vocabulary as the reference's
# commonProcessor.template; resolved by RuntimeConfigGeneration.
# ---------------------------------------------------------------------------
DEFAULT_TEMPLATE: Dict[str, Any] = {
    "name": "_S_{name}",
    "input": {
        "inputType": "_S_{inputType}",
        "eventhub": {
            "connectionString": "_S_{inputEventHubConnectionString}",
            "consumerGroup": "_S_{inputEventHubConsumerGroup}",
            "checkpointDir": "_S_{inputEventHubCheckpointDir}",
            "checkpointInterval": "_S_{inputEventHubCheckpointInterval}",
            "maxRate": "_S_{inputEventHubMaxRate}",
            "flushExistingCheckpoints": "_S_{inputEventHubFlushExistingCheckpoints}",
        },
        "streaming": {
            "checkpointDir": "_S_{inputStreamingCheckpointDir}",
            "intervalInSeconds": "_S_{inputStreamingIntervalInSeconds}",
        },
        "blobSchemaFile": "_S_{inputSchemaFilePath}",
        "referenceData": "_S_{inputReferenceData}",
    },
    "process": {
        "metric": {"httppost": "_S_{localMetricsHttpEndpoint}"},
        "timestampColumn": "_S_{processTimestampColumn}",
        "watermark": "_S_{processWatermark}",
        "jarUDAFs": "_S_{processJarUDAFs}",
        "jarUDFs": "_S_{processJarUDFs}",
        "azureFunctions": "_S_{processAzureFunctions}",
        "projections": "_S_{processProjections}",
        "timeWindows": "_S_{processTimeWindows}",
        "transform": "_S_{processTransforms}",
        "appendEventTags": {},
        "accumulationTables": "_S_{processStateTables}",
    },
    "outputs": "_S_{outputs}",
}

DEFAULT_JOB_COMMON_TOKENS: Dict[str, str] = {
    "jobName": "_S_{name}",
    "tpuJobName": "DataXTpu-${name}",
    "jobDriverLogLevel": "WARN",
    "jobNumChips": "_S_{guiJobNumChips}",
    "jobBatchCapacity": "_S_{guiJobBatchCapacity}",
    "jobPipelineDepth": "_S_{guiJobPipelineDepth}",
    "jobDecoderThreads": "_S_{guiJobDecoderThreads}",
    "jobObservabilityPort": "_S_{guiJobObservabilityPort}",
    "jobCompileJitCacheCap": "_S_{guiJobCompileJitCacheCap}",
    "processedSchemaPath": "_S_{processedSchemaPath}",
}

DEFAULT_COMMON_PROCESSOR: Dict[str, Any] = {
    "jobConfigFolder": "_S_{cpConfigFolderBase}/${name}",
    "template": DEFAULT_TEMPLATE,
    "jobCommonTokens": DEFAULT_JOB_COMMON_TOKENS,
    "jobs": [{"partitionJobNumber": "1"}],
}


def _deep_merge(base: Any, override: Any) -> Any:
    """override wins; dicts merge recursively (reference: template merge
    in FlowConfigBuilder / S200 defaults merge)."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for k, v in override.items():
            out[k] = _deep_merge(base.get(k), v) if k in base else v
        return out
    return override if override is not None else base


class FlowConfigBuilder:
    """Build/refresh a flow document from designer gui JSON."""

    def build(self, gui: dict, existing: Optional[dict] = None) -> dict:
        name = gui.get("name") or (existing or {}).get("name")
        if not name:
            raise ValueError("gui.name is required")
        doc = copy.deepcopy(existing) if existing else {}
        doc["name"] = name
        doc["displayName"] = gui.get("displayName") or name
        doc.setdefault("icon", "/img/iot.png")
        doc["gui"] = gui
        doc["commonProcessor"] = _deep_merge(
            copy.deepcopy(DEFAULT_COMMON_PROCESSOR),
            doc.get("commonProcessor") or {},
        )
        return doc


# ---------------------------------------------------------------------------
# gui rules -> rule-definition JSON for the codegen engine
# ---------------------------------------------------------------------------

def _q(v) -> str:
    """SQL single-quoted literal with quote doubling — designer values
    like O'Brien must not break (or splice into) the generated SQL."""
    return "'" + str(v).replace("'", "''") + "'"


def _lk(v) -> str:
    """LIKE pattern body, quote-escaped (wildcards added by caller)."""
    return str(v).replace("'", "''")


# gui condition operator -> SQL fragment builder. The gui's no-code rule
# tree (datax-pipeline rule builder) emits these operator names.
_OPERATORS = {
    "equal": lambda f, v: f"{f} = {v}",
    "notEqual": lambda f, v: f"{f} != {v}",
    "greaterThan": lambda f, v: f"{f} > {v}",
    "lessThan": lambda f, v: f"{f} < {v}",
    "greaterThanOrEqual": lambda f, v: f"{f} >= {v}",
    "lessThanOrEqual": lambda f, v: f"{f} <= {v}",
    "stringEqual": lambda f, v: f"{f} = {_q(v)}",
    "stringNotEqual": lambda f, v: f"{f} != {_q(v)}",
    "contains": lambda f, v: f"{f} LIKE '%{_lk(v)}%'",
    "notContains": lambda f, v: f"{f} NOT LIKE '%{_lk(v)}%'",
    "startsWith": lambda f, v: f"{f} LIKE '{_lk(v)}%'",
    "endsWith": lambda f, v: f"{f} LIKE '%{_lk(v)}'",
    "isNull": lambda f, v: f"{f} IS NULL",
    "isNotNull": lambda f, v: f"{f} IS NOT NULL",
}


def _condition_sql(node: dict, aggregate_mode: bool) -> str:
    """gui conditions tree -> SQL boolean expression."""
    if not node:
        return ""
    if node.get("type") == "group":
        # keep (child, sql) pairs aligned so each child's conjunction
        # joins its own fragment even when siblings produce no SQL
        rendered = [
            (c, _condition_sql(c, aggregate_mode))
            for c in node.get("conditions") or []
        ]
        rendered = [(c, sql) for c, sql in rendered if sql]
        if not rendered:
            return ""
        joined = []
        for i, (child, sql) in enumerate(rendered):
            if i > 0:
                joined.append((child.get("conjunction") or "and").upper())
            joined.append(f"({sql})" if child.get("type") == "group" else sql)
        return " ".join(joined)
    field = node.get("field") or ""
    if aggregate_mode and node.get("aggregate"):
        field = f"{node['aggregate'].upper()}({field})"
    op = _OPERATORS.get(node.get("operator") or "equal", _OPERATORS["equal"])
    return op(field, node.get("value"))


def _collect_aggs(node: dict, out: List[str]) -> None:
    if not node:
        return
    if node.get("type") == "group":
        for c in node.get("conditions") or []:
            _collect_aggs(c, out)
        return
    if node.get("aggregate") and node.get("field"):
        agg = f"{node['aggregate'].upper()}({node['field']})"
        if agg not in out:
            out.append(agg)


class RuleDefinitionGenerator:
    """gui rules list -> rule-definition JSON string.

    reference: InternalService/RuleDefinitionGenerator.cs:31-32 — the
    gui rule's ``properties`` object *is* the definition; ``_S_``-prefixed
    designer property names map to the ``$``-prefixed keys the codegen
    rule parser reads (DataX.Flow.CodegenRules/Rule.cs:19-73). When the
    designer supplied a conditions tree but no precomputed condition,
    derive the SQL here.
    """

    def generate(self, gui_rules: List[dict], product_id: str = "") -> str:
        defs = []
        for r in gui_rules or []:
            props = dict(r.get("properties") or {})
            d: Dict[str, Any] = {}
            for k, v in props.items():
                if k.startswith("_S_"):
                    d["$" + k[len("_S_"):]] = v
                elif k.startswith("$") or k in ("schemaTableName", "conditions"):
                    d[k] = v
            d.setdefault("$ruleId", r.get("id") or "")
            if product_id and not d.get("$productId"):
                d["$productId"] = product_id
            rule_type = d.get("$ruleType") or "SimpleRule"
            aggregate_mode = rule_type.startswith("Aggregate")
            tree = props.get("conditions")
            if tree and not d.get("$condition"):
                d["$condition"] = _condition_sql(tree, aggregate_mode)
            if tree and aggregate_mode and not d.get("$aggs"):
                aggs: List[str] = []
                _collect_aggs(tree, aggs)
                d["$aggs"] = aggs
            # normalize key casing differences between designer and parser
            if "$tagName" in d and "$tagname" not in d:
                d["$tagname"] = d.pop("$tagName")
            if "$alertSinks" in d and "$alertsinks" not in d:
                d["$alertsinks"] = d.pop("$alertSinks")
            # a rule routed to alert sinks is an alert unless said otherwise
            # (the designer's Alert toggle maps here)
            if d.get("$alertsinks") and "$isAlert" not in d:
                d["$isAlert"] = True
            defs.append(d)
        return json.dumps(defs)
