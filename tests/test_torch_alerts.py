"""The alert engine of the PyTorch port (``obs/alerts.py``, a copy of the
JAX package's) against the JAX package's: every engine, schema,
threshold, burn-rate, ``/alerts``-against-Prometheus and readiness test
of ``tests/test_alerts.py`` runs on each package's modules, and the same
scenario gives both the same firing sets and snapshots. Also here: the
port's host serves ``GET /alerts`` and ``datax_alert_firing`` from the
conf's rules, and its pilot takes the alert votes again."""

import json
import re
import types
import urllib.request

import pytest

from data_accelerator_tpu.obs import alerts as jalerts
from data_accelerator_tpu.obs import exposition as jexposition
from data_accelerator_tpu.obs import histogram as jhistogram
from data_accelerator_tpu.obs import store as jstore
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.obs import alerts as talerts
from data_accelerator_tpu_torch.obs import exposition as texposition
from data_accelerator_tpu_torch.obs import histogram as thistogram
from data_accelerator_tpu_torch.obs import store as tstore
from data_accelerator_tpu_torch.pilot.controller import ACTION_KINDS
from data_accelerator_tpu_torch.runtime import host as thost_mod
from test_torch_host import _host_conf

PACKAGES = {
    pkg: types.SimpleNamespace(
        AlertEngine=a.AlertEngine, default_rules=a.default_rules,
        validate_rules=a.validate_rules, HealthState=e.HealthState,
        ObservabilityServer=e.ObservabilityServer,
        render_prometheus=e.render_prometheus,
        HistogramRegistry=h.HistogramRegistry, MetricStore=s.MetricStore,
    )
    for pkg, (a, e, h, s) in {
        "jax": (jalerts, jexposition, jhistogram, jstore),
        "torch": (talerts, texposition, thistogram, tstore),
    }.items()
}


@pytest.fixture(params=sorted(PACKAGES))
def m(request):
    return PACKAGES[request.param]


def _engine(m, rules, now=None, **kw):
    clock = {"t": 1000.0}
    kw.setdefault("store", m.MetricStore())
    eng = m.AlertEngine(
        rules, flow="F", now_fn=lambda: clock["t"], **kw
    )
    return eng, clock


# -- schema ------------------------------------------------------------------

def test_validate_rules_accepts_defaults_and_rejects_garbage(m):
    assert m.validate_rules(m.default_rules()) == []
    assert m.validate_rules("nope")
    errs = m.validate_rules([{"metric": "X"}])          # no name
    assert any("name" in e for e in errs)
    errs = m.validate_rules([{"name": "a"}])            # neither form
    assert any("metric" in e for e in errs)
    errs = m.validate_rules([{"name": "a", "metric": "M", "op": "!",
                            "threshold": 1}])
    assert any("op" in e for e in errs)
    errs = m.validate_rules([{"name": "a", "metric": "M", "op": ">",
                            "threshold": 1, "bogus": True}])
    assert any("unknown keys" in e for e in errs)
    errs = m.validate_rules([
        {"name": "a", "metric": "M", "op": ">", "threshold": 1},
        {"name": "a", "metric": "M", "op": ">", "threshold": 2},
    ])
    assert any("duplicate" in e for e in errs)
    errs = m.validate_rules([{"name": "a", "slo": {"objective": 2.0},
                            "burnRate": 1}])
    assert any("objective" in e for e in errs)
    errs = m.validate_rules([{"name": "a", "metric": "M", "op": ">",
                            "threshold": 1, "severity": "loud"}])
    assert any("severity" in e for e in errs)


def test_engine_drops_invalid_rules_keeps_valid(m):
    eng, _ = _engine(m, [
        {"name": "good", "metric": "M", "op": ">", "threshold": 5},
        {"name": "bad"},
    ])
    assert [r["name"] for r in eng.rules] == ["good"]


# -- threshold rules ---------------------------------------------------------

def test_threshold_rule_fires_after_for_seconds_and_clears(m):
    store = m.MetricStore()
    eng, clock = _engine(
        m,         [{"name": "lat", "metric": "Latency-Batch-p99", "op": ">",
          "threshold": 100.0, "windowSeconds": 60, "forSeconds": 30}],
        store=store,
    )
    # healthy points: no fire
    store.add_point("DATAX-F:Latency-Batch-p99", int(990 * 1000), 50.0)
    assert eng.evaluate() == []
    # violating point: pending, not yet firing (forSeconds)
    store.add_point("DATAX-F:Latency-Batch-p99", int(999 * 1000), 500.0)
    assert eng.evaluate() == []
    assert eng.snapshot(evaluate=False)["rules"][0]["state"] == "pending"
    # still violating after the hold-down: firing
    clock["t"] = 1031.0
    store.add_point("DATAX-F:Latency-Batch-p99", int(1030 * 1000), 500.0)
    firing = eng.evaluate()
    assert [a["name"] for a in firing] == ["lat"]
    assert firing[0]["value"] > 100.0
    # recovery clears immediately
    clock["t"] = 1100.0
    store.add_point("DATAX-F:Latency-Batch-p99", int(1099 * 1000), 10.0)
    assert eng.evaluate() == []
    assert eng.snapshot(evaluate=False)["rules"][0]["state"] == "ok"


def test_threshold_aggregates(m):
    store = m.MetricStore()
    for i, v in enumerate((10.0, 20.0, 90.0)):
        store.add_point("DATAX-F:M", int((995 + i) * 1000), v)
    for agg, expect_fire in (("avg", False), ("max", True),
                            ("min", False), ("last", True)):
        eng, _ = _engine(
        m,             [{"name": "r", "metric": "M", "op": ">", "threshold": 50.0,
              "aggregate": agg, "windowSeconds": 60}],
            store=store,
        )
        assert bool(eng.evaluate()) is expect_fire, agg


def test_percentile_rule_falls_back_to_live_histograms(m):
    hist = m.HistogramRegistry()
    for v in (10.0, 2000.0, 2000.0, 2000.0):
        hist.observe("F", "batch", v)
    eng, _ = _engine(
        m,         [{"name": "p99", "metric": "Latency-Batch-p99", "op": ">",
          "threshold": 100.0}],
        histograms=hist,
    )
    assert [a["name"] for a in eng.evaluate()] == ["p99"]


def test_no_data_never_fires(m):
    eng, _ = _engine(
        m,         [{"name": "r", "metric": "Nothing", "op": ">", "threshold": 0}],
    )
    assert eng.evaluate() == []


# -- burn-rate rules ---------------------------------------------------------

def test_burn_rate_rule_fires_on_error_budget_burn(m):
    health = m.HealthState(flow="F")
    eng, clock = _engine(
        m,         [{"name": "burn", "slo": {"objective": 0.9}, "burnRate": 2.0,
          "windowSeconds": 300}],
        health=health,
    )
    # 100 clean batches: burn 0
    for _ in range(100):
        health.record_batch(1, ok=True)
    assert eng.evaluate() == []
    # 50% failures over the window: error_rate 0.33 / budget 0.1 => >2x
    clock["t"] = 1010.0
    for _ in range(50):
        health.record_batch(1, ok=False)
    firing = eng.evaluate()
    assert [a["name"] for a in firing] == ["burn"]
    assert firing[0]["value"] > 2.0


# -- agreement: GET /alerts vs Prometheus exposition -------------------------

def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as r:
        body = r.read()
        return r.status, body


def test_alerts_endpoint_and_prometheus_agree_on_firing_set(m):
    store = m.MetricStore()
    store.add_point("DATAX-F:M", int(999 * 1000), 100.0)
    health = m.HealthState(flow="F")
    eng = m.AlertEngine(
        [
            {"name": "hot", "metric": "M", "op": ">", "threshold": 1.0},
            {"name": "cold", "metric": "M", "op": "<", "threshold": 0.0},
        ],
        flow="F", store=store, now_fn=lambda: 1000.0,
    )
    srv = m.ObservabilityServer(
        health, m.HistogramRegistry(), store, port=0, alerts=eng
    )
    srv.start()
    try:
        status, body = _get(srv.port, "/alerts")
        assert status == 200
        payload = json.loads(body)
        firing_api = {a["name"] for a in payload["firing"]}
        assert firing_api == {"hot"}
        states = {r["name"]: r["state"] for r in payload["rules"]}
        assert states == {"hot": "firing", "cold": "ok"}

        status, body = _get(srv.port, "/metrics")
        text = body.decode()
        firing_prom = {
            m.group(1)
            for m in re.finditer(
                r'datax_alert_firing\{flow="F",rule="([^"]+)"[^}]*\} 1',
                text,
            )
        }
        assert firing_prom == firing_api
        assert 'datax_alerts_firing{flow="F"} 1' in text
    finally:
        srv.stop()


def test_render_prometheus_alert_gauges_zero_when_ok(m):
    eng = m.AlertEngine(
        [{"name": "r", "metric": "M", "op": ">", "threshold": 1.0}],
        flow="F", store=m.MetricStore(),
    )
    text = m.render_prometheus(m.HistogramRegistry(), None, None, alerts=eng)
    assert 'datax_alert_firing{flow="F",rule="r",severity="warn"} 0' in text
    assert 'datax_alerts_firing{flow="F"} 0' in text


# -- readiness wiring --------------------------------------------------------

def test_readyz_reports_firing_alerts_and_fails_on_sustained_stall(m):
    health = m.HealthState(flow="F", batch_interval_s=1.0)
    health.record_batch(1000, ok=True, latency_ms=5.0)
    assert health.readiness() == []
    health.record_alerts([{"name": "hot", "severity": "page"}])
    payload = health.health()
    assert payload["firingAlerts"] == ["hot"]
    assert health.readiness() == []  # alerts inform, they don't fail
    # sustained stall past the threshold fails readiness
    for _ in range(30):
        health.record_stall(60_000.0)
    reasons = health.readiness()
    assert any("pipeline stall" in r for r in reasons)
    assert health.health()["pipelineStallMs"] > 10_000
    # recovery: stalls back to normal clears the reason
    for _ in range(60):
        health.record_stall(10.0)
    assert health.readiness() == []


def test_single_stall_spike_does_not_fail_readiness(m):
    health = m.HealthState(flow="F", batch_interval_s=1.0)
    health.record_batch(1000, ok=True)
    health.record_stall(30_000.0)  # one spike, EWMA-damped
    for _ in range(20):
        health.record_stall(5.0)
    assert health.readiness() == []



# -- the two packages agree ------------------------------------------------------
def test_default_rules_and_actions_match_jax():
    assert talerts.default_rules("F") == jalerts.default_rules("F")
    assert talerts.ACTIONS == jalerts.ACTIONS == ACTION_KINDS
    assert talerts.RULE_SCHEMA == jalerts.RULE_SCHEMA


def test_same_scenario_same_snapshots():
    """One store history and health record through both engines: the
    same firing set and rule states, evaluation after evaluation."""
    rules = jalerts.default_rules("F") + [
        {"name": "hot", "metric": "M", "op": ">", "threshold": 5.0,
         "windowSeconds": 30, "forSeconds": 10, "action": "backpressure"},
        {"name": "burn", "slo": {"objective": 0.9}, "burnRate": 2.0,
         "windowSeconds": 300},
    ]
    snaps = {}
    for pkg, mod in PACKAGES.items():
        clock = {"t": 1000.0}
        store, health = mod.MetricStore(), mod.HealthState(flow="F")
        eng = mod.AlertEngine(rules, flow="F", store=store, health=health,
                              now_fn=lambda c=clock: c["t"])
        out = []
        for step in range(40):
            clock["t"] = 1000.0 + step
            store.add_point("DATAX-F:M", int(clock["t"] * 1000), float(step % 11))
            store.add_point("DATAX-F:Transfer_Background_Pending",
                            int(clock["t"] * 1000), float(step // 4))
            health.record_batch(int(clock["t"] * 1000), ok=step % 3 != 0)
            firing = eng.evaluate()
            snap = eng.snapshot(evaluate=False)
            out.append(([a["name"] for a in firing],
                        [(r["name"], r["state"]) for r in snap["rules"]]))
        snaps[pkg] = out
    assert snaps["torch"] == snaps["jax"]
    assert any(f for f, _s in snaps["torch"])


def test_port_host_serves_alerts_and_votes_the_pilot():
    """The port's host builds the engine from ``process.alerts.rules``,
    evaluates it after each batch, answers ``GET /alerts`` and
    ``datax_alert_firing`` with one firing set, records it in the
    health payload, and hands the firing rule's action to the pilot."""
    rules = [{"name": "always", "metric": "Output_HeatAvg_Events_Count",
              "op": ">=", "threshold": 0.0, "action": "backpressure"}]
    conf = _host_conf("HostAlerts", "torch", {
        "datax.job.process.alerts.rules": json.dumps(rules),
        "datax.job.process.observability.port": "0",
        "datax.job.process.pilot.enabled": "true",
    })
    host = thost_mod.StreamingHost(SettingDictionary(conf), device="cpu")
    try:
        assert host.pilot.alerts is host.alerts
        host.run_pipelined(max_batches=2)
        base = f"http://127.0.0.1:{host.obs_server.port}"
        with urllib.request.urlopen(base + "/alerts", timeout=10) as r:
            payload = json.loads(r.read())
        assert [a["name"] for a in payload["firing"]] == ["always"]
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert re.search(r'datax_alert_firing\{flow="HostAlerts",rule="always"[^}]*\} 1', text)
        assert host.health.health()["firingAlerts"] == ["always"]
        assert host.metric_logger.store.points("DATAX-HostAlerts:Alerts_Firing")[-1]["val"] == 1.0
        assert host.pilot.read_signals().alert_actions == ("backpressure",)
    finally:
        host.stop()
