"""The port's LiveQuery serving plane (``data_accelerator_tpu_torch/lq/``)
against the JAX package's (``data_accelerator_tpu/lq/``).

Every test of ``tests/test_lq.py`` but the REST surface and the
generation knobs (the control plane, not ported yet) runs here on both
packages with the same numpy-seeded rows: the port with
``device="cpu"``, the JAX package on the CPU as its own tests run it.
Results must be equal (headers, rows, ints exact, floats within
``RTOL``), and so must the stats both packages expose:
``coalescer.stats()``, the cache's entries, evictions, re-warms,
compiles and step-cache entries, ``SessionManager.stats()`` and the
``lq_metrics()`` keys. The cache's bytes differ by design (the port
prices entries with its device plan's resident bytes, held against
``FlowProcessor.device_bytes``, where the JAX package charges
``hbmBytes``), and so does its default budget; the tests of the port's
own byte model, budget and memory release close the file.
"""

import gc
import json
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from data_accelerator_tpu.lq import coalescer as jax_coalescer
from data_accelerator_tpu.lq import service as jax_service
from data_accelerator_tpu.lq import session as jax_session
from data_accelerator_tpu.lq import warmcache as jax_warmcache
from data_accelerator_tpu.serve import livequery as jax_livequery
from data_accelerator_tpu_torch.lq import coalescer as torch_coalescer
from data_accelerator_tpu_torch.lq import service as torch_service
from data_accelerator_tpu_torch.lq import session as torch_session
from data_accelerator_tpu_torch.lq import warmcache as torch_warmcache
from data_accelerator_tpu_torch.serve import livequery as torch_livequery

# floats of one row: MAX is exact; the tolerance covers any float32 path
RTOL = 1e-6

SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "temperature", "type": "double", "nullable": False,
     "metadata": {}},
    {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
     "metadata": {}},
]})
BASE = 1_700_000_000_000
QUERY = (
    "Agg = SELECT deviceId, COUNT(*) AS Cnt, MAX(temperature) AS MaxTemp "
    "FROM DataXProcessedInput GROUP BY deviceId"
)
WINDOW_QUERY = (
    "W = SELECT deviceId, COUNT(*) AS Cnt "
    "FROM DataXProcessedInput_5seconds GROUP BY deviceId"
)
PKGS = ("jax", "torch")
MOD = {
    "jax": (jax_session, jax_warmcache, jax_coalescer, jax_service, jax_livequery),
    "torch": (torch_session, torch_warmcache, torch_coalescer, torch_service,
              torch_livequery),
}
# what each package's device-taking objects are given
DEV = {"jax": {}, "torch": {"device": "cpu"}}
CACHE_COUNTS = ("entries", "evictions", "rewarms", "compiles", "stepCacheEntries")


def rows_for(n=5, key=0, seed=None):
    """``tests/test_lq.py``'s rows; with a seed, numpy-drawn
    temperatures at three decimals."""
    temps = (
        None if seed is None
        else np.round(np.random.RandomState(seed).uniform(0, 100, n), 3)
    )
    return [
        {"deviceId": (i + key) % 7,
         "temperature": (20.0 + ((i + key) % 13)) if temps is None
         else float(temps[i]),
         "eventTimeStamp": BASE + i}
        for i in range(n)
    ]


def svc_of(pkg, **kw):
    return MOD[pkg][3].LiveQueryService(**DEV[pkg], **kw)


def kernels_of(pkg, **kw):
    return MOD[pkg][4].KernelService(**DEV[pkg], **kw)


def serial_golden(pkg, rows, query=QUERY, max_rows=100):
    """The per-tenant ground truth: one legacy kernel, one execute."""
    svc = kernels_of(pkg)
    kid = svc.create_kernel("LQFlow", SCHEMA, sample_rows=rows)
    return svc.execute(kid, query, max_rows)


def same_result(port, ref, rtol=RTOL):
    """Headers and table equal; rows equal with ints exact and floats
    within ``rtol``."""
    assert port["headers"] == ref["headers"]
    assert port.get("table") == ref.get("table")
    assert len(port["result"]) == len(ref["result"])
    for p, r in zip(port["result"], ref["result"]):
        assert p.keys() == r.keys()
        for k, pv in p.items():
            rv = r[k]
            if isinstance(rv, float):
                assert isinstance(pv, float) and pv == pytest.approx(rv, rel=rtol), k
            else:
                assert pv == rv, k


def cache_counts(lq):
    st = lq.cache.stats()
    return {k: st[k] for k in CACHE_COUNTS}


# ---------------------------------------------------------------------------
# SessionManager: quotas, TTL, typed rejections (a copy: equal stats)
# ---------------------------------------------------------------------------
class TestSessionManager:
    @staticmethod
    def _both(scenario):
        out = {pkg: scenario(MOD[pkg][0]) for pkg in PKGS}
        assert out["torch"] == out["jax"]
        return out["torch"]

    def test_tenant_session_quota_rejects_typed(self):
        def run(m):
            mgr = m.SessionManager(tenant_max_sessions=2)
            mgr.create("t1", "F")
            mgr.create("t1", "F")
            with pytest.raises(m.AdmissionRejected) as ei:
                mgr.create("t1", "F")
            body = ei.value.to_dict()
            mgr.create("t2", "F")
            return (ei.value.kind, ei.value.tenant, body["kind"],
                    body["retryAfterSeconds"], mgr.stats())

        kind, tenant, body_kind, retry, stats = self._both(run)
        assert (kind, tenant, body_kind) == ("tenant-sessions", "t1", "tenant-sessions")
        assert retry > 0 and stats["rejected"]["tenant-sessions"] == 1

    def test_service_session_cap_rejects(self):
        def run(m):
            mgr = m.SessionManager(max_sessions=2, tenant_max_sessions=10)
            mgr.create("a", "F")
            mgr.create("b", "F")
            with pytest.raises(m.AdmissionRejected) as ei:
                mgr.create("c", "F")
            return ei.value.kind, mgr.stats()

        kind, stats = self._both(run)
        assert kind == "service-sessions" and stats["rejectedTotal"] == 1

    def test_qps_quota_rejects_with_retry_hint(self):
        def run(m):
            clock = [1000.0]
            mgr = m.SessionManager(tenant_max_qps=2.0, now_fn=lambda: clock[0])
            s = mgr.create("t", "F")
            mgr.admit_execute(s)
            mgr.admit_execute(s)
            with pytest.raises(m.AdmissionRejected) as ei:
                mgr.admit_execute(s)
            # the quota bucket refills on the process's monotonic clock
            return ei.value.kind, round(ei.value.retry_after_s, 2), mgr.stats()

        kind, retry, stats = self._both(run)
        assert kind == "tenant-qps" and 0 < retry <= 1.0
        assert stats["rejected"]["tenant-qps"] == 1

    def test_ttl_reaps_on_every_access_path(self):
        def run(m):
            clock = [0.0]
            mgr = m.SessionManager(ttl_s=10.0, now_fn=lambda: clock[0])
            s = mgr.create("t", "F")
            clock[0] = 11.0
            listed = mgr.list()
            with pytest.raises(KeyError):
                mgr.get(s.id)
            return listed, mgr.stats()

        listed, stats = self._both(run)
        assert listed == [] and stats["reaped"] == 1 and stats["sessions"] == 0

    def test_touch_keeps_session_alive(self):
        def run(m):
            clock = [0.0]
            mgr = m.SessionManager(ttl_s=10.0, now_fn=lambda: clock[0])
            s = mgr.create("t", "F")
            clock[0] = 8.0
            mgr.get(s.id)
            clock[0] = 16.0
            return mgr.get(s.id).id == s.id, mgr.stats()

        alive, _stats = self._both(run)
        assert alive

    def test_legacy_evict_on_full_policy(self):
        def run(m):
            clock = [0.0]
            mgr = m.SessionManager(now_fn=lambda: clock[0])
            kw = dict(evict_on_full=True, cap=2)
            a = mgr.create(m.LEGACY_TENANT, "F", **kw)
            clock[0] = 1.0
            b = mgr.create(m.LEGACY_TENANT, "F", **kw)
            clock[0] = 2.0
            c = mgr.create(m.LEGACY_TENANT, "F", **kw)
            ids = {s.id for s in mgr.list(tenant=m.LEGACY_TENANT)}
            return (ids == {b.id, c.id}, a.id in ids, mgr.stats())

        kept, a_kept, stats = self._both(run)
        assert kept and not a_kept and stats["rejectedTotal"] == 0


# ---------------------------------------------------------------------------
# The coalescing invariant
# ---------------------------------------------------------------------------
class TestCoalescingInvariant:
    def test_256_sessions_one_compiled_entry_golden_equal(self):
        """256 same-signature sessions: one compiled entry and one
        step-cache entry, flat over 3 rounds, 3 dispatches for 768
        calls, every result equal to the serial kernel's and the JAX
        package's."""
        rows = rows_for(50, seed=1)
        out = {}
        for pkg in PKGS:
            golden = serial_golden(pkg, rows)
            lq = svc_of(pkg)
            sids = [
                lq.create_session(f"tenant-{i}", "LQFlow", SCHEMA,
                                  sample_rows=rows)["id"]
                for i in range(256)
            ]
            sigs = {
                MOD[pkg][1].signature_for(lq.sessions.get(sid), QUERY,
                                          lq.cache.compile_conf).key
                for sid in sids
            }
            assert len(sigs) == 1
            sizes = []
            for _round in range(3):
                pendings = [lq.coalescer.submit(lq.sessions.get(sid), QUERY)
                            for sid in sids]
                lq.coalescer.flush()
                for p in pendings:
                    same_result(p.wait(30.0), golden, rtol=0)
                sizes.append((len(lq.cache), lq.cache.step_cache_entries()))
            out[pkg] = (golden, sizes, lq.coalescer.stats(), cache_counts(lq),
                        lq.sessions.stats())
            lq.stop()
        golden, sizes, co, cache, sess = out["torch"]
        same_result(golden, out["jax"][0])
        assert out["torch"][1:] == out["jax"][1:]
        assert sizes == [(1, 1)] * 3
        assert (co["dispatches"], co["calls"], co["coalesced"]) == (3, 768, 765)

    def test_distinct_payloads_share_compiled_entry(self):
        variants = [rows_for(40 + i, key=i, seed=10 + i) for i in range(4)]
        out = {}
        for pkg in PKGS:
            lq = svc_of(pkg)
            sids = [lq.create_session(f"t{i}", "LQFlow", SCHEMA,
                                      sample_rows=v)["id"]
                    for i, v in enumerate(variants)]
            pendings = [lq.coalescer.submit(lq.sessions.get(sid), QUERY)
                        for sid in sids]
            lq.coalescer.flush()
            results = [p.wait(30.0) for p in pendings]
            for v, r in zip(variants, results):
                same_result(r, serial_golden(pkg, v), rtol=0)
            out[pkg] = (results, lq.coalescer.stats(), cache_counts(lq))
            lq.stop()
        for p, r in zip(out["torch"][0], out["jax"][0]):
            same_result(p, r)
        assert out["torch"][1:] == out["jax"][1:]
        co, cache = out["torch"][1:]
        assert co["dispatches"] == 4
        assert cache["entries"] == 1 and cache["stepCacheEntries"] == 1

    def test_bucket_lattice_bounds_entries(self):
        small, large = rows_for(10, seed=2), rows_for(100, seed=3)
        out = {}
        for pkg in PKGS:
            lq = svc_of(pkg)
            results = []
            for i in range(6):
                sid = lq.create_session(f"t{i}", "LQFlow", SCHEMA,
                                        sample_rows=small if i % 2 else large)["id"]
                results.append(lq.execute(sid, QUERY))
            out[pkg] = (results, cache_counts(lq), lq.coalescer.stats())
            lq.stop()
        for p, r in zip(out["torch"][0], out["jax"][0]):
            same_result(p, r)
        assert out["torch"][1:] == out["jax"][1:]
        assert out["torch"][1]["entries"] == 2

    def test_concurrent_ticker_load_golden_and_flat_cache(self):
        rows = rows_for(30, seed=4)
        conf = {
            "datax.job.process.lq.maxbatchwaitms": "4",
            "datax.job.process.lq.tenant.maxqps": "100000",
            "datax.job.process.lq.tenant.maxsessions": "64",
            "datax.job.process.lq.maxsessions": "4096",
        }
        goldens = {}
        for pkg in PKGS:
            golden = goldens[pkg] = serial_golden(pkg, rows)
            lq = svc_of(pkg, ticker=True, conf=conf)
            sids = [lq.create_session(f"t{i % 8}", "LQFlow", SCHEMA,
                                      sample_rows=rows)["id"]
                    for i in range(32)]
            with ThreadPoolExecutor(16) as ex:
                results = list(ex.map(lambda sid: lq.execute(sid, QUERY), sids * 4))
            for r in results:
                same_result(r, golden, rtol=0)
            assert len(lq.cache) == 1 and lq.cache.step_cache_entries() == 1
            assert lq.coalescer.stats()["coalesced"] > 0
            lq.stop()
        same_result(goldens["torch"], goldens["jax"])

    def test_mid_tick_kernel_failure_isolated_and_recovers(self, monkeypatch):
        good_rows = rows_for(20, seed=5)
        bad_rows = [{"deviceId": 999, "temperature": 1.0,
                     "eventTimeStamp": BASE}] + rows_for(19)
        out = {}
        for pkg in PKGS:
            golden = serial_golden(pkg, good_rows)
            kernel_cls = MOD[pkg][4].Kernel
            orig = kernel_cls.execute

            def boom(self, query, max_rows=100, orig=orig):
                if self.sample_rows and self.sample_rows[0]["deviceId"] == 999:
                    raise RuntimeError("injected mid-tick kernel failure")
                return orig(self, query, max_rows)

            monkeypatch.setattr(kernel_cls, "execute", boom)
            lq = svc_of(pkg)
            good = [lq.create_session(f"g{i}", "LQFlow", SCHEMA,
                                      sample_rows=good_rows)["id"]
                    for i in range(3)]
            bad = lq.create_session("b", "LQFlow", SCHEMA,
                                    sample_rows=bad_rows)["id"]
            pendings = {sid: lq.coalescer.submit(lq.sessions.get(sid), QUERY)
                        for sid in good + [bad]}
            lq.coalescer.flush()
            for sid in good:
                same_result(pendings[sid].wait(30.0), golden, rtol=0)
            with pytest.raises(RuntimeError, match="injected"):
                pendings[bad].wait(30.0)
            p = lq.coalescer.submit(lq.sessions.get(good[0]), QUERY)
            lq.coalescer.flush()
            same_result(p.wait(30.0), golden, rtol=0)
            out[pkg] = (golden, lq.coalescer.stats(), cache_counts(lq))
            lq.stop()
            monkeypatch.setattr(kernel_cls, "execute", orig)
        same_result(out["torch"][0], out["jax"][0])
        assert out["torch"][1:] == out["jax"][1:]
        co, cache = out["torch"][1:]
        assert co["failedDispatches"] == 1 and cache["rewarms"] == 1


# ---------------------------------------------------------------------------
# WarmKernelCache: budget, evictions, re-warm
# ---------------------------------------------------------------------------
def _entry(lq, n_rows, query=QUERY, key=0):
    sid = lq.create_session(f"t{n_rows}-{key}", "LQFlow", SCHEMA,
                            sample_rows=rows_for(n_rows, key=key))["id"]
    lq.execute(sid, query)
    return sid


# each package's budget between one entry and two: the JAX test's 6000 B
# for its model's prices; for the port, twice the 64-row entry's price
# (the 128-row entry costs about twice the 64-row one)
def _tight_budget(pkg, lq):
    if pkg == "jax":
        return 6000
    return 2 * next(iter(lq.cache._entries.values())).hbm_bytes


class TestWarmKernelCache:
    def test_entries_priced_by_model(self):
        for pkg in PKGS:
            lq = svc_of(pkg)
            _entry(lq, 10)
            entry = next(iter(lq.cache._entries.values()))
            assert entry.sized_by == "model" and entry.hbm_bytes > 0
            lq.stop()

    def test_budget_eviction_counted_lru(self):
        out = {}
        for pkg in PKGS:
            lq = svc_of(pkg, conf={"datax.job.process.lq.hbmbudgetmb": "1"})
            assert lq.cache.budget_bytes == 1024 * 1024
            _entry(lq, 10)
            first_key = next(iter(lq.cache._entries))
            lq.cache.budget_bytes = _tight_budget(pkg, lq)
            _entry(lq, 100)
            assert first_key not in lq.cache._entries  # LRU went first
            assert lq.cache.resident_bytes() <= max(
                lq.cache.budget_bytes,
                max(e.hbm_bytes for e in lq.cache._entries.values()),
            )
            out[pkg] = cache_counts(lq)
            lq.stop()
        assert out["torch"] == out["jax"]
        assert out["torch"]["evictions"] >= 1

    def test_rewarm_counted_on_readmit(self):
        out = {}
        for pkg in PKGS:
            lq = svc_of(pkg)
            sid_small = _entry(lq, 10)
            lq.cache.budget_bytes = _tight_budget(pkg, lq)
            _entry(lq, 100)
            assert lq.cache.evictions >= 1
            lq.execute(sid_small, QUERY)
            out[pkg] = cache_counts(lq)
            lq.stop()
        assert out["torch"] == out["jax"]
        assert out["torch"]["rewarms"] == 1

    def test_evict_flow_drops_resident_kernels(self):
        for pkg in PKGS:
            lq = svc_of(pkg)
            _entry(lq, 10)
            assert len(lq.cache) == 1
            assert lq.cache.evict_flow("LQFlow") == 1
            assert len(lq.cache) == 0
            lq.stop()


# ---------------------------------------------------------------------------
# Quota rejection never dispatches
# ---------------------------------------------------------------------------
class TestNoDispatchOnReject:
    def test_rejected_execute_never_reaches_coalescer(self, monkeypatch):
        out = {}
        for pkg in PKGS:
            lq = svc_of(pkg, conf={"datax.job.process.lq.tenant.maxqps": "1"})
            sid = lq.create_session("t", "LQFlow", SCHEMA,
                                    sample_rows=rows_for(5))["id"]
            lq.execute(sid, QUERY)
            before = lq.coalescer.stats()["dispatches"]

            def no_submit(*a, **k):
                raise AssertionError("coalescer.submit called for a "
                                     "quota-rejected execute")

            monkeypatch.setattr(lq.coalescer, "submit", no_submit)
            for _ in range(3):
                with pytest.raises(MOD[pkg][0].AdmissionRejected) as ei:
                    lq.execute(sid, QUERY)
                assert ei.value.kind == "tenant-qps"
            assert lq.coalescer.stats()["dispatches"] == before
            out[pkg] = (lq.sessions.stats(),
                        lq.lq_metrics()["LQ_Admission_Rejected_Count"])
            lq.stop()
        assert out["torch"] == out["jax"]
        assert out["torch"][0]["rejected"]["tenant-qps"] == 3
        assert out["torch"][1] == 3.0


# ---------------------------------------------------------------------------
# Conf block and alert rule
# ---------------------------------------------------------------------------
class TestConfAndAlerts:
    def test_service_reads_lq_conf_block(self):
        from data_accelerator_tpu.core.config import SettingDictionary as JaxSD
        from data_accelerator_tpu_torch.core.config import SettingDictionary

        conf = {
            "datax.job.process.lq.maxbatchwaitms": "16",
            "datax.job.process.lq.maxfanin": "32",
            "datax.job.process.lq.sessionttlseconds": "60",
            "datax.job.process.lq.maxsessions": "99",
            "datax.job.process.lq.tenant.maxsessions": "3",
            "datax.job.process.lq.tenant.maxqps": "7.5",
            "datax.job.process.lq.hbmbudgetmb": "256",
        }
        out = {}
        for pkg, sd in (("jax", JaxSD), ("torch", SettingDictionary)):
            lq = svc_of(pkg, conf=sd(conf))
            out[pkg] = (lq.max_wait_ms, lq.coalescer.max_fanin, lq.sessions.ttl_s,
                        lq.sessions.max_sessions, lq.sessions.tenant_max_sessions,
                        lq.sessions.tenant_max_qps, lq.cache.budget_bytes,
                        lq.ticking, lq.conf_audit.unknown, lq.conf_audit.out_of_bounds)
            lq.stop()
        assert out["torch"] == out["jax"]
        assert out["torch"][:8] == (16.0, 32, 60.0, 99, 3, 7.5, 256 * 1024 * 1024, False)

    def test_default_budget_comes_from_cost_model(self):
        """The port's default budget is 0.25 of the device's memory: on
        the CPU of ``constants.CPU_DEVICE_MEMORY_BYTES``, a size of the
        port's own, where the JAX package takes its fleet-spec chip."""
        from data_accelerator_tpu_torch.analysis.costmodel import (
            DEFAULT_LQ_CACHE_HEADROOM,
            warm_kernel_cache_budget_bytes,
        )
        from data_accelerator_tpu_torch.constants import CPU_DEVICE_MEMORY_BYTES

        lq = svc_of("torch")
        assert lq.cache.budget_bytes == warm_kernel_cache_budget_bytes(device="cpu")
        assert lq.cache.budget_bytes == int(
            CPU_DEVICE_MEMORY_BYTES * DEFAULT_LQ_CACHE_HEADROOM)
        assert DEFAULT_LQ_CACHE_HEADROOM == 0.25
        assert warm_kernel_cache_budget_bytes(1000, device="cpu") == 250
        lq.stop()

    def test_lq_latency_slo_default_rule(self):
        from data_accelerator_tpu.constants import MetricName as JaxMetricName
        from data_accelerator_tpu.obs.alerts import default_rules as jax_rules
        from data_accelerator_tpu_torch.constants import MetricName
        from data_accelerator_tpu_torch.obs.alerts import default_rules, validate_rules

        rules = default_rules("AnyFlow")
        assert validate_rules(rules) == []
        rule = {r["name"]: r for r in rules}["lq-latency-slo"]
        assert rule == {r["name"]: r for r in jax_rules("AnyFlow")}["lq-latency-slo"]
        assert rule["metric"] == "Latency-LQExec-p99"
        assert rule["action"] == "backpressure"
        assert JaxMetricName.is_runtime_metric(rule["metric"])
        assert "lq-exec" in MetricName.STAGES
        assert MetricName.stage_metric("lq-exec") == "Latency-LQExec"
        assert torch_service.LQ_EXEC_STAGE == jax_service.LQ_EXEC_STAGE

    def test_lq_alert_fires_on_slow_exec_histogram(self):
        from data_accelerator_tpu.obs import alerts as jax_alerts
        from data_accelerator_tpu.obs import histogram as jax_histogram
        from data_accelerator_tpu_torch.obs import alerts, histogram

        out = {}
        for pkg, al, hi in (("jax", jax_alerts, jax_histogram),
                            ("torch", alerts, histogram)):
            hist = hi.HistogramRegistry()
            for _ in range(50):
                hist.observe("LiveQuery", "lq-exec", 5000.0)
            clock = [1000.0]
            eng = al.AlertEngine(
                [r for r in al.default_rules() if r["name"] == "lq-latency-slo"],
                flow="LiveQuery", histograms=hist, now_fn=lambda: clock[0],
            )
            pending = eng.evaluate()
            clock[0] += 30.0
            firing = eng.evaluate()
            out[pkg] = (pending, [(f["name"], f["action"]) for f in firing])
        assert out["torch"] == out["jax"]
        assert out["torch"] == ([], [("lq-latency-slo", "backpressure")])


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------
class TestObservability:
    def test_exported_metrics_all_registered(self):
        """The port keeps no registry of metric names: its exported
        ``LQ_*`` and ``Latency-LQExec-pNN`` names are held against the
        JAX package's ``MetricName.is_runtime_metric``, and the key set
        against the JAX service's."""
        from data_accelerator_tpu.constants import MetricName
        from data_accelerator_tpu.obs.store import MetricStore as JaxStore
        from data_accelerator_tpu_torch.obs.store import MetricStore

        names = {}
        for pkg, store in (("jax", JaxStore()), ("torch", MetricStore())):
            lq = svc_of(pkg, store=store)
            sid = lq.create_session("t", "LQFlow", SCHEMA,
                                    sample_rows=rows_for(5))["id"]
            lq.execute(sid, QUERY)
            exported = lq.export_metrics()
            keys = store.keys("DATAX-LiveQuery:")
            names[pkg] = {k.partition(":")[2] for k in keys}
            # the store also holds the boot conf audit's Conf_* gauges
            assert set(exported) <= names[pkg]
            lq.stop()
        assert names["torch"] == names["jax"]
        assert not sorted(n for n in names["torch"]
                          if not MetricName.is_runtime_metric(n))
        for required in (
            "LQ_Sessions", "LQ_Qps", "LQ_Backlog", "LQ_CoalesceFanin",
            "LQ_Dispatch_Count", "LQ_KernelEvict_Count",
            "LQ_Admission_Rejected_Count", "Latency-LQExec-p99",
        ):
            assert required in names["torch"], required

    def test_exec_histogram_carries_session_exemplar(self):
        lq = svc_of("torch")
        sid = lq.create_session("t", "LQFlow", SCHEMA,
                                sample_rows=rows_for(5))["id"]
        lq.execute(sid, QUERY)
        ex = lq.histograms.get(torch_service.LQ_FLOW,
                               torch_service.LQ_EXEC_STAGE).exemplar()
        assert ex is not None and ex["traceId"] == sid
        lq.stop()

    def test_closed_session_cancels_queued_calls(self):
        out = {}
        for pkg in PKGS:
            lq = svc_of(pkg)
            sid = lq.create_session("t", "LQFlow", SCHEMA,
                                    sample_rows=rows_for(5))["id"]
            pending = lq.coalescer.submit(lq.sessions.get(sid), QUERY)
            assert lq.coalescer.backlog() == 1
            lq.close_session(sid)
            assert lq.coalescer.backlog() == 0
            with pytest.raises(MOD[pkg][2].ExecCancelled, match="closed before"):
                pending.wait(0.5)
            out[pkg] = (lq.coalescer.stats(), lq.sessions.stats())
            lq.stop()
        assert out["torch"] == out["jax"]

    def test_lq_metrics_keys_equal_the_jax_service(self):
        out = {}
        for pkg in PKGS:
            lq = svc_of(pkg)
            before = set(lq.lq_metrics())
            sid = lq.create_session("t", "LQFlow", SCHEMA,
                                    sample_rows=rows_for(5))["id"]
            lq.execute(sid, QUERY)
            m = lq.lq_metrics()
            out[pkg] = (before, set(m),
                        {k: v for k, v in m.items()
                         if k not in ("LQ_Qps", "LQ_KernelBytes")
                         and not k.startswith("Latency-")})
            lq.stop()
        assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# The port's own: byte model, budget, memory release, device
# ---------------------------------------------------------------------------
class TestPortByteModel:
    def test_byte_model_prices_and_grows_with_the_bucket(self):
        lq = svc_of("torch")
        for n in (10, 100, 1000):
            _entry(lq, n)
        by_bucket = {e.signature.row_bucket: e for e in lq.cache._entries.values()}
        assert sorted(by_bucket) == [64, 128, 1024]
        assert all(e.sized_by == "model" for e in by_bucket.values())
        sizes = [by_bucket[b].hbm_bytes for b in sorted(by_bucket)]
        assert 0 < sizes[0] < sizes[1] < sizes[2]
        assert lq.lq_metrics()["LQ_KernelBytes"] == float(sum(sizes))
        lq.stop()

    def test_byte_model_equals_the_processor_tensors(self):
        """On the CPU every tensor a kernel's processors keep is visible
        to the collector: the model equals the storages that appeared
        across the build and first execute and are still held."""
        def live():
            out = {}
            with warnings.catch_warnings():
                # the scan touches torch's deprecated module aliases
                warnings.simplefilter("ignore", FutureWarning)
                tensors = [o for o in gc.get_objects() if torch.is_tensor(o)]
            for o in tensors:
                st = o.untyped_storage()
                if st.data_ptr():
                    out[st.data_ptr()] = st.nbytes()
            return out

        svc = kernels_of("torch")
        kid = svc.create_kernel("F", SCHEMA, sample_rows=rows_for(300, seed=6))
        gc.collect()
        before = live()
        svc.execute(kid, QUERY)
        svc.execute(kid, "W = SELECT deviceId, COUNT(*) AS Cnt "
                         "FROM DataXProcessedInput_5seconds GROUP BY deviceId")
        gc.collect()
        grown = sum(v for k, v in live().items() if k not in before)
        model = sum(p.device_bytes() for p in svc.get(kid)._processors.values())
        assert model == grown > 0

    def test_price_comes_from_deviceplan_and_equals_device_bytes(self):
        """The warm cache prices each entry with ``analyze_processor``
        (persistent bytes, one transfer slot per output); on the CPU that
        equals what the kernel's processors hold, byte for byte."""
        from data_accelerator_tpu_torch.analysis.deviceplan import analyze_processor

        lq = svc_of("torch")
        for n, query in ((10, QUERY), (300, QUERY), (100, WINDOW_QUERY)):
            _entry(lq, n, query=query)
        assert len(lq.cache._entries) == 3
        for entry in lq.cache._entries.values():
            procs = list(entry.kernel._processors.values())
            model = sum(
                analyze_processor(p, output_slots=1).totals()["persistentBytes"]
                for p in procs
            )
            held = sum(p.device_bytes() for p in procs)
            assert entry.sized_by == "model"
            assert entry.hbm_bytes == entry.model_bytes == model
            assert entry.measured_bytes == held == model > 0
        lq.stop()

    def test_model_outside_the_band_prices_by_the_measurement(self, monkeypatch):
        """A model that misses what the processors hold by more than
        ``MODEL_BAND`` gives way to the measurement (two slots counted
        where a kernel holds one)."""
        monkeypatch.setattr(torch_warmcache, "KERNEL_OUTPUT_SLOTS", 2)
        lq = svc_of("torch")
        _entry(lq, 300)
        entry = next(iter(lq.cache._entries.values()))
        assert entry.model_bytes > torch_warmcache.MODEL_BAND[1] * entry.measured_bytes
        assert entry.sized_by == "measured"
        assert entry.hbm_bytes == entry.measured_bytes
        lq.stop()

    def test_fallback_price_when_the_model_fails(self, monkeypatch):
        from data_accelerator_tpu_torch.analysis import deviceplan

        def broken(*a, **k):
            raise RuntimeError("no model")

        monkeypatch.setattr(deviceplan, "analyze_processor", broken)
        lq = svc_of("torch")
        _entry(lq, 10)
        entry = next(iter(lq.cache._entries.values()))
        assert entry.sized_by == "fallback"
        assert entry.hbm_bytes == torch_warmcache.FALLBACK_KERNEL_BYTES
        lq.stop()

    def test_an_evicted_kernel_frees_its_processor_without_the_collector(self):
        gc.collect()
        gc.disable()
        try:
            lq = svc_of("torch")
            _entry(lq, 10)
            entry = next(iter(lq.cache._entries.values()))
            proc = weakref.ref(next(iter(entry.kernel._processors.values())))
            del entry
            lq.cache.budget_bytes = _tight_budget("torch", lq)
            _entry(lq, 100)
            assert lq.cache.evictions == 1
            assert proc() is None
            # a stopped service drops the rest
            rest = weakref.ref(next(iter(
                next(iter(lq.cache._entries.values())).kernel._processors.values())))
            lq.stop()
            assert len(lq.cache) == 0 and rest() is None
        finally:
            gc.enable()

    def test_a_dropped_service_frees_its_kernels_without_the_collector(self):
        """Nothing the service owns holds it in a cycle (the reap hook
        holds the coalescer's method), so dropping a ticking service
        frees its processors by reference counting."""
        gc.collect()
        gc.disable()
        try:
            lq = svc_of("torch", ticker=True)
            sid = lq.create_session("t", "LQFlow", SCHEMA,
                                    sample_rows=rows_for(5))["id"]
            lq.execute(sid, QUERY)
            proc = weakref.ref(next(iter(
                next(iter(lq.cache._entries.values())).kernel._processors.values())))
            svc_ref = weakref.ref(lq)
            lq.stop_ticker()
            del lq
            assert svc_ref() is None and proc() is None
        finally:
            gc.enable()

    def test_services_default_to_the_card_and_raise_without_one(self, monkeypatch):
        from data_accelerator_tpu_torch.core.config import EngineException

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (torch_service.LiveQueryService,
                     torch_livequery.KernelService,
                     torch_warmcache.WarmKernelCache):
            with pytest.raises(EngineException, match="no CUDA device"):
                make()
        from data_accelerator_tpu_torch.analysis.costmodel import (
            warm_kernel_cache_budget_bytes,
        )

        with pytest.raises(RuntimeError, match="no CUDA device"):
            warm_kernel_cache_budget_bytes()

    def test_stop_releases_the_ticker_and_the_cache(self):
        lq = svc_of("torch", ticker=True)
        assert lq.ticking
        sid = lq.create_session("t", "LQFlow", SCHEMA,
                                sample_rows=rows_for(5))["id"]
        lq.execute(sid, QUERY)
        assert len(lq.cache) == 1
        lq.stop()
        assert not lq.ticking and len(lq.cache) == 0
        assert lq.cache.evictions == 0  # a stop is not an eviction


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_execute_on_the_card_equals_the_cpu(card):
    """One execute through ``LiveQueryService(device="cuda")`` equals the
    CPU's; its entry is priced in allocator blocks, and a stop gives the
    card's memory back."""
    rows = rows_for(60, seed=7)
    out = {}
    before = torch.cuda.memory_allocated()
    for dev in ("cuda", "cpu"):
        lq = torch_service.LiveQueryService(device=dev)
        sid = lq.create_session("t", "LQFlow", SCHEMA, sample_rows=rows)["id"]
        out[dev] = lq.execute(sid, QUERY)
        entry = next(iter(lq.cache._entries.values()))
        if dev == "cuda":
            # the card holds each tensor in 512-byte allocator blocks,
            # and the card plan rounds each resident stage to whole
            # blocks too, so the model equals the measurement there
            assert entry.measured_bytes % 512 == 0
        assert entry.sized_by == "model" and entry.hbm_bytes > 0
        assert entry.hbm_bytes == entry.model_bytes == entry.measured_bytes
        del entry
        lq.stop()
    same_result(out["cuda"], out["cpu"], rtol=1e-4)
    assert torch.cuda.memory_allocated() == before
