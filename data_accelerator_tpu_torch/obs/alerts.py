"""Declarative alert rules + an SLO/burn-rate evaluation engine.

reference: the reference platform's operators watched AppInsights live
metrics and alerted by hand (SURVEY §1 "babysitting"); production
stream processors instead declare alert rules over the live metric
stream and let the runtime evaluate them (Prometheus alerting rules,
multiwindow burn-rate alerts from the SRE workbook — PAPERS.md). This
module is that engine for the runtime: rules are plain dicts
(JSON-serializable, shipped inside the generated flow conf under
``datax.job.process.alerts.rules``), evaluation reads the SAME live
surfaces the dashboards read (MetricStore points, histogram
percentiles, HealthState batch counters), and the firing set is served
uniformly by ``GET /alerts``, the Prometheus exposition
(``datax_alert_firing``) and the ``Alerts_Firing`` store series.

Rule shapes (see ``RULE_SCHEMA`` / ``validate_rules``):

- **threshold rule** — aggregate a metric over a trailing window and
  compare::

      {"name": "batch-p99-latency-slo", "metric": "Latency-Batch-p99",
       "op": ">", "threshold": 5000, "windowSeconds": 120,
       "forSeconds": 30, "severity": "page"}

  ``metric`` is the ``DATAX-<flow>:<metric>`` series name (the part
  after the colon). ``Latency-<Stage>-pNN`` names short-circuit to the
  live histogram percentile when a registry is wired — the exact same
  number the stat tiles show.

- **burn-rate rule** — error-budget burn over the batch success SLO::

      {"name": "batch-error-burn", "slo": {"objective": 0.99},
       "burnRate": 2.0, "windowSeconds": 300, "severity": "page"}

  burn = (failed/total over the window) / (1 - objective); the rule
  fires when burn exceeds ``burnRate`` (a burn of 1.0 consumes the
  whole error budget exactly at the SLO window's pace).

A rule's lifecycle is ok -> pending (condition true, waiting out
``forSeconds``) -> firing -> ok; evaluation is idempotent and cheap
(one pass over window points), so hosts run it every batch finish and
on every ``/alerts`` request.

Copy of the JAX package's ``obs/alerts.py``, unchanged but for this
note: ``ACTIONS`` is the port's ``pilot/controller.py::ACTION_KINDS``.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

AGGREGATES = ("avg", "max", "min", "sum", "last")
SEVERITIES = ("info", "warn", "page")

# the optional ``action`` a rule may request while firing — ONE
# vocabulary shared with the pilot's actuation kinds
# (pilot/controller.py ACTION_KINDS): a firing rule with an action is a
# standing vote the controller folds into its decision table, so alerts
# and autopilot can never drift apart on what "backpressure" means
from ..pilot.controller import ACTION_KINDS as ACTIONS  # noqa: E402

# the declarative rule contract (documented in OBSERVABILITY.md "Alert
# rules"); validate_rules() enforces it — the CI satellite asserts every
# default-generated rule passes
RULE_SCHEMA = {
    "name": (str, True),
    "description": (str, False),
    "severity": (str, False),        # info | warn | page
    "action": (str, False),          # pilot actuation vote (ACTIONS)
    "windowSeconds": ((int, float), False),
    "forSeconds": ((int, float), False),
    # threshold form
    "metric": (str, False),
    "op": (str, False),              # > >= < <=
    "threshold": ((int, float), False),
    "aggregate": (str, False),       # avg | max | min | sum | last
    # burn-rate form
    "slo": (dict, False),            # {"objective": 0.99}
    "burnRate": ((int, float), False),
}


def validate_rules(rules) -> List[str]:
    """Schema-check a rule list; returns human-readable errors (empty =
    valid). Never raises — the caller decides whether bad rules are
    fatal (CLI --validate) or skipped (runtime engine)."""
    errors: List[str] = []
    if not isinstance(rules, list):
        return [f"rules must be a list, got {type(rules).__name__}"]
    seen = set()
    for i, r in enumerate(rules):
        where = f"rule[{i}]"
        if not isinstance(r, dict):
            errors.append(f"{where}: must be an object")
            continue
        name = r.get("name")
        if not name or not isinstance(name, str):
            errors.append(f"{where}: 'name' (string) is required")
        else:
            where = f"rule[{i}] {name!r}"
            if name in seen:
                errors.append(f"{where}: duplicate rule name")
            seen.add(name)
        for key, (types, _req) in RULE_SCHEMA.items():
            if key in r and not isinstance(r[key], types):
                errors.append(f"{where}: '{key}' has wrong type")
        unknown = set(r) - set(RULE_SCHEMA)
        if unknown:
            errors.append(f"{where}: unknown keys {sorted(unknown)}")
        is_threshold = "metric" in r
        is_burn = "slo" in r
        if not is_threshold and not is_burn:
            errors.append(f"{where}: needs 'metric' (threshold rule) "
                          "or 'slo' (burn-rate rule)")
        if is_threshold and is_burn:
            errors.append(f"{where}: 'metric' and 'slo' are exclusive")
        if is_threshold:
            if r.get("op") not in OPS:
                errors.append(
                    f"{where}: 'op' must be one of {sorted(OPS)}"
                )
            if not isinstance(r.get("threshold"), (int, float)) \
                    or isinstance(r.get("threshold"), bool):
                errors.append(f"{where}: numeric 'threshold' required")
            if r.get("aggregate") is not None \
                    and r["aggregate"] not in AGGREGATES:
                errors.append(
                    f"{where}: 'aggregate' must be one of {AGGREGATES}"
                )
        if is_burn:
            slo = r.get("slo") or {}
            obj = slo.get("objective")
            if not isinstance(obj, (int, float)) or isinstance(obj, bool) \
                    or not (0.0 < float(obj) < 1.0):
                errors.append(
                    f"{where}: slo.objective must be in (0, 1)"
                )
            unknown_slo = set(slo) - {"objective"}
            if unknown_slo:
                errors.append(
                    f"{where}: unknown slo keys {sorted(unknown_slo)}"
                )
            if not isinstance(r.get("burnRate"), (int, float)) \
                    or isinstance(r.get("burnRate"), bool):
                errors.append(f"{where}: numeric 'burnRate' required")
        if r.get("severity") is not None \
                and r.get("severity") not in SEVERITIES:
            errors.append(
                f"{where}: 'severity' must be one of {SEVERITIES}"
            )
        if r.get("action") is not None and r.get("action") not in ACTIONS:
            errors.append(
                f"{where}: 'action' must be one of {ACTIONS}"
            )
    return errors


def default_rules(flow: Optional[str] = None) -> List[dict]:
    """The standing rule set every auto-generated metrics config ships
    (codegen ``_generate_metrics_config``) and every generated conf
    carries: the p99 batch-latency SLO, conformance-ratio bounds over
    the embedded cost model, pipeline stall, and the batch error-budget
    burn rate. All names resolve through ``constants.MetricName`` —
    tier-1 asserts it."""
    return [
        {
            "name": "batch-p99-latency-slo",
            "metric": "Latency-Batch-p99",
            "op": ">", "threshold": 5000.0,
            "windowSeconds": 120, "forSeconds": 20,
            "severity": "page",
            "description": "p99 whole-batch latency above the 5 s SLO",
        },
        {
            "name": "conformance-d2h-drift",
            "metric": "Conformance_D2HBytes_Ratio",
            "op": ">", "threshold": 1.5,
            "windowSeconds": 300, "forSeconds": 30,
            "severity": "warn",
            "description": "observed D2H bytes drifting above the "
                           "cost model's per-batch prediction",
        },
        {
            "name": "pipeline-stall",
            "metric": "Pipeline_Stall_Ms",
            "op": ">", "threshold": 2000.0, "aggregate": "avg",
            "windowSeconds": 120, "forSeconds": 20,
            "severity": "warn",
            "description": "dispatch loop persistently stalled on the "
                           "window's oldest batch",
        },
        {
            # pending landings sustained above the default pipeline
            # depth (process.pipeline.depth, default 2): the background
            # transfer thread can't keep up with the dispatch loop, so
            # backpressure is about to serialize the pipeline
            "name": "background-transfer-backlog",
            "metric": "Transfer_Background_Pending",
            "op": ">", "threshold": 2.0, "aggregate": "avg",
            "windowSeconds": 120, "forSeconds": 20,
            "severity": "warn",
            # while firing, this rule votes for source backpressure in
            # the pilot's decision table (one rule vocabulary)
            "action": "backpressure",
            "description": "background result landings queuing beyond "
                           "the pipeline depth — sinks or D2H transfers "
                           "are slower than the dispatch loop",
        },
        {
            # LiveQuery serving plane SLO: p99 end-to-end execute
            # latency (queue wait + coalesced dispatch, the
            # Latency-LQExec histogram lq/service.py feeds) over the
            # interactive threshold. While firing it votes for source
            # backpressure in the pilot's decision table — the serving
            # plane and the streaming path share one chip, so shedding
            # ingest load is the actuator that frees device time
            "name": "lq-latency-slo",
            "metric": "Latency-LQExec-p99",
            "op": ">", "threshold": 1000.0,
            "windowSeconds": 120, "forSeconds": 20,
            "severity": "page",
            "action": "backpressure",
            "description": "p99 LiveQuery execute latency above the "
                           "1 s interactive SLO",
        },
        {
            "name": "batch-error-burn",
            "slo": {"objective": 0.99}, "burnRate": 2.0,
            "windowSeconds": 300,
            "severity": "page",
            "description": "batch failures burning the 99% success "
                           "error budget at 2x the sustainable rate",
        },
    ]


class AlertEngine:
    """Evaluates a rule list against the live metric surfaces.

    ``store``/``histograms``/``health`` are the same objects the
    exposition endpoints read — the engine adds no new measurement
    path, only judgement. All state is per-rule (pending/firing
    timestamps), so the engine is cheap to re-evaluate and safe to
    evaluate from both the batch loop and HTTP handler threads."""

    def __init__(
        self,
        rules: List[dict],
        flow: str = "",
        store=None,
        histograms=None,
        health=None,
        app_name: Optional[str] = None,
        now_fn=time.time,
    ):
        errors = validate_rules(rules)
        if errors:
            # runtime posture: drop invalid rules loudly, keep the rest
            logger.warning("invalid alert rules skipped: %s", errors)
            valid_names = set()
            checked = []
            for r in rules:
                if isinstance(r, dict) and not validate_rules([r]):
                    if r["name"] not in valid_names:
                        valid_names.add(r["name"])
                        checked.append(r)
            rules = checked
        self.rules = list(rules)
        self.flow = flow
        self.store = store
        self.histograms = histograms
        self.health = health
        self.app_name = app_name or (f"DATAX-{flow}" if flow else "")
        self.now = now_fn
        # rule name -> {"pending_since", "firing_since", "value"}
        self._state: Dict[str, dict] = {
            r["name"]: {"pending_since": None, "firing_since": None,
                        "value": None}
            for r in self.rules
        }
        # (epoch s, processed, failed) ring for burn-rate windows
        self._health_samples: List[Tuple[float, int, int]] = []

    @classmethod
    def from_conf(cls, dict_, flow: str = "", store=None,
                  histograms=None, health=None) -> Optional["AlertEngine"]:
        """Build from ``datax.job.process.alerts.rules`` (a JSON array,
        written by config generation); None when the conf carries no
        rules."""
        raw = dict_.get_sub_dictionary(
            "datax.job.process.alerts."
        ).get("rules")
        if not raw:
            return None
        try:
            rules = json.loads(raw)
        except ValueError:
            logger.warning("unparseable alerts.rules conf; alerts off")
            return None
        return cls(rules, flow=flow, store=store, histograms=histograms,
                   health=health)

    # -- value sources ---------------------------------------------------
    def _percentile_value(self, metric: str) -> Optional[float]:
        """``Latency-<Stage>-pNN`` straight from the live histograms."""
        if self.histograms is None or not metric.startswith("Latency-"):
            return None
        stem, _, q = metric.rpartition("-p")
        if not q.isdigit():
            return None
        from ..constants import MetricName

        for stage in MetricName.STAGES:
            if MetricName.stage_metric(stage) == stem:
                return self.histograms.percentile(
                    self.flow, stage, float(q)
                )
        return None

    def _window_points(self, metric: str, window_s: float,
                       now: float) -> List[float]:
        if self.store is None:
            return []
        key = f"{self.app_name}:{metric}" if self.app_name else metric
        pts = self.store.points(
            key, (now - window_s) * 1000.0, now * 1000.0
        )
        return [
            float(p["val"]) for p in pts
            if isinstance(p.get("val"), (int, float))
            and not isinstance(p.get("val"), bool)
        ]

    def _metric_value(self, rule: dict, now: float) -> Optional[float]:
        metric = rule["metric"]
        window_s = float(rule.get("windowSeconds") or 60)
        agg = rule.get("aggregate") or "avg"
        vals = self._window_points(metric, window_s, now)
        if not vals:
            # live histogram fallback for percentile series (a host
            # evaluating before its first store flush, or a rule over a
            # pctl the host doesn't export)
            return self._percentile_value(metric)
        if agg == "avg":
            return sum(vals) / len(vals)
        if agg == "max":
            return max(vals)
        if agg == "min":
            return min(vals)
        if agg == "sum":
            return float(sum(vals))
        return vals[-1]  # last

    def _burn_value(self, rule: dict, now: float) -> Optional[float]:
        """Error-budget burn rate over the rule's window from the
        HealthState batch counters."""
        if self.health is None:
            return None
        window_s = float(rule.get("windowSeconds") or 300)
        processed = self.health.batches_processed
        failed = self.health.batches_failed
        self._health_samples.append((now, processed, failed))
        # bound the ring to the largest plausible window
        cutoff = now - max(window_s, 3600.0)
        while self._health_samples and self._health_samples[0][0] < cutoff:
            self._health_samples.pop(0)
        base = None
        for t, p, f in self._health_samples:
            if t >= now - window_s:
                base = (p, f)
                break
        if base is None:
            base = (0, 0)
        d_total = (processed - base[0]) + (failed - base[1])
        if d_total <= 0:
            return None  # no batches in the window: nothing to judge
        error_rate = (failed - base[1]) / d_total
        budget = 1.0 - float(rule["slo"]["objective"])
        return error_rate / budget if budget > 0 else None

    # -- evaluation ------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the firing set (see
        ``firing``)."""
        now = self.now() if now is None else now
        for rule in self.rules:
            st = self._state[rule["name"]]
            if "slo" in rule:
                value = self._burn_value(rule, now)
                violated = (
                    value is not None and value > float(rule["burnRate"])
                )
            else:
                value = self._metric_value(rule, now)
                violated = value is not None and OPS[rule["op"]](
                    value, float(rule["threshold"])
                )
            st["value"] = value
            if not violated:
                st["pending_since"] = None
                st["firing_since"] = None
                continue
            if st["pending_since"] is None:
                st["pending_since"] = now
            if st["firing_since"] is None and (
                now - st["pending_since"] >= float(rule.get("forSeconds") or 0)
            ):
                st["firing_since"] = now
        return self.firing()

    def firing(self) -> List[dict]:
        out = []
        for rule in self.rules:
            st = self._state[rule["name"]]
            if st["firing_since"] is None:
                continue
            out.append({
                "name": rule["name"],
                "severity": rule.get("severity") or "warn",
                "since": st["firing_since"],
                "value": st["value"],
                "threshold": (
                    rule.get("threshold") if "metric" in rule
                    else rule.get("burnRate")
                ),
                "metric": rule.get("metric") or "batch-error-burn-rate",
                "description": rule.get("description") or "",
                **(
                    {"action": rule["action"]} if rule.get("action") else {}
                ),
            })
        return out

    def snapshot(self, evaluate: bool = True) -> dict:
        """The ``GET /alerts`` payload: every rule with its state plus
        the firing subset."""
        if evaluate:
            self.evaluate()
        rules = []
        for rule in self.rules:
            st = self._state[rule["name"]]
            state = (
                "firing" if st["firing_since"] is not None
                else "pending" if st["pending_since"] is not None
                else "ok"
            )
            rules.append({
                **{k: rule.get(k) for k in (
                    "name", "metric", "op", "threshold", "aggregate",
                    "windowSeconds", "forSeconds", "severity",
                    "description", "slo", "burnRate", "action",
                ) if rule.get(k) is not None},
                "state": state,
                "value": st["value"],
                "since": st["firing_since"],
            })
        return {
            "flow": self.flow,
            "rules": rules,
            "firing": self.firing(),
        }
