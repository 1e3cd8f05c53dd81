"""Control-plane fleet view: cross-replica telemetry rollup, trace
lineage, and the delivery-conservation audit (DX54x).

The pull/merge half of the fleet telemetry plane (push half:
obs/publisher.py). ``FleetView`` lists the telemetry frames replicas
published to the shared object store (``<prefix>/fleet/<flow>/
<replica>/<window>.json``) and aggregates them into fleet-level series:

- **counters summed** across replicas and windows (each frame carries
  windowed deltas, so the running sum is the fleet lifetime total and
  the per-frame points written into the fleet ``MetricStore`` are a
  merge-by-addition time series under the same ``DATAX-<flow>:<metric>``
  keys the per-process stack uses);
- **fixed-bucket histograms merged exactly** via
  ``LatencyHistogram.merge`` (bucket counts added element-wise, raw
  sample windows unioned — merged percentiles equal percentiles over
  the unioned observations);
- **per-replica breakdowns retained** (the SPA fleet tab and
  ``obs fleet`` render both the rollup and the per-replica rows);
- replicas quiet for more than ``stale_windows`` windows are marked
  **stale** unless their last frame carried the ``final`` drain marker
  (then they are **completed** — a clean handoff, not a death).

On top of the rollup:

- **fleet-scope alerts**: an ``AlertEngine`` per flow evaluates the
  same rule dicts (obs/alerts.py, verbatim — ``default_rules`` unless
  injected) over the MERGED store/histograms/health, so an error-budget
  burn is computed over fleet totals, not any single replica's slice;
- **trace lineage**: the replica succession of a flow across
  rescale/handoff, from the job registry's records (``replicaOf`` /
  ``statePartitionMap``, serve/jobs.py) when available, else derived
  from frame arrival order — what ``obs trace`` and the SPA use to
  stitch one continuous cross-replica tree;
- the **delivery-conservation audit**::

      | code  | name                   | meaning |
      |-------|------------------------|---------|
      | DX540 | delivery-loss          | Σ ingested > Σ emitted on the audited output across the lineage — events entered the lineage and never came out |
      | DX541 | delivery-duplication   | Σ emitted > Σ ingested — an offset range was emitted by more than one replica |
      | DX542 | stale-replica          | a replica went quiet past the stale horizon without its final drain frame — its in-flight window is unaccounted |

  Frames count ``ingested`` per source from the post-filter
  ``Input_*_Events_Count`` deltas of acked batches only (a failed batch
  never reaches ``_finish_tail``'s metric emit), and ``emitted`` per
  output from ``Output_*_Events_Count`` — so for a passthrough output
  the two conserve exactly across a rescale lineage, which is what the
  chaos drill asserts (serve/scenarios.py). Aggregating outputs
  (windowed GROUP BYs) under-emit by construction; the audit therefore
  judges one output — the caller's choice, defaulting to the output
  with the highest emitted total.

**Fail-open**: a corrupt/truncated/unreadable frame is skipped and
counted (``Fleet_FrameDecodeError_Count``) — the aggregator never
crashes on bad input, and a flaky store only delays the rollup
(tested with an injected-transport stub, tests/test_fleetview.py).

Copy of the JAX package's ``obs/fleetview.py``, whole. The control
plane that serves it (``GET /fleet/metrics``, ``GET /fleet/flows/<flow>``
in ``serve/restapi.py``, the website's Prometheus exposition, the SPA
fleet tab) is not ported yet (slice 9); until then the JAX control plane
serves frames that port hosts publish, and ``python -m
data_accelerator_tpu_torch.obs fleet`` reads it. Without the port's job
registry (``serve/jobs.py``, slice 9) a caller passes no ``lineage_fn``,
and the frames supply the lineage: the reference's fallback.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..constants import MetricName
from .histogram import HistogramRegistry, LatencyHistogram
from .store import MetricStore

logger = logging.getLogger(__name__)

# delivery-conservation audit code registry (documented in
# OBSERVABILITY.md "Delivery-conservation audit (DX54x)")
AUDIT_CODES: Dict[str, str] = {
    "DX540": "delivery-loss",
    "DX541": "delivery-duplication",
    "DX542": "stale-replica",
}

# a frame must carry these to be aggregatable at all; anything less is
# a corrupt frame (skip-and-count)
_REQUIRED_FRAME_FIELDS = ("flow", "replica", "window", "counters")


class _ReplicaState:
    """Everything the view has folded in from one replica's frames."""

    def __init__(self, replica: str):
        self.replica = replica
        self.replica_index = 1
        self.replica_count = 1
        self.windows: List[int] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, LatencyHistogram] = {}
        self.ingested: Dict[str, float] = {}
        self.emitted: Dict[str, float] = {}
        self.offsets: Dict[str, List] = {}
        self.health: Optional[dict] = None
        self.alerts: List[dict] = []
        self.batches = 0
        self.last_published_ms = 0
        self.last_window_s = 10.0
        self.final = False
        self.first_seen_ms: Optional[int] = None

    def fold(self, frame: dict) -> None:
        self.replica_index = int(frame.get("replicaIndex") or 1)
        self.replica_count = int(frame.get("replicaCount") or 1)
        self.windows.append(int(frame["window"]))
        for k, v in (frame.get("counters") or {}).items():
            self.counters[k] = self.counters.get(k, 0.0) + float(v)
        for k, v in (frame.get("gauges") or {}).items():
            self.gauges[k] = float(v)
        # histograms ship as cumulative state: the LATEST frame's copy
        # supersedes earlier ones (no double counting across windows)
        for stage, state in (frame.get("histograms") or {}).items():
            self.histograms[stage] = LatencyHistogram.from_state(state)
        delivery = frame.get("delivery") or {}
        for src, n in (delivery.get("ingested") or {}).items():
            self.ingested[src] = self.ingested.get(src, 0.0) + float(n)
        for out, n in (delivery.get("emitted") or {}).items():
            self.emitted[out] = self.emitted.get(out, 0.0) + float(n)
        watermark = frame.get("watermark") or {}
        for key, rng in (watermark.get("offsets") or {}).items():
            cur = self.offsets.get(key)
            if cur is None:
                self.offsets[key] = list(rng)
            else:
                cur[0] = min(cur[0], rng[0])
                cur[1] = max(cur[1], rng[1])
        if frame.get("health") is not None:
            self.health = frame["health"]
        self.alerts = list(frame.get("alerts") or [])
        self.batches += int(frame.get("batches") or 0)
        pub = int(frame.get("publishedAtMs") or 0)
        self.last_published_ms = max(self.last_published_ms, pub)
        if self.first_seen_ms is None:
            self.first_seen_ms = pub
        self.last_window_s = float(frame.get("windowSeconds") or 10.0)
        self.final = self.final or bool(frame.get("final"))

    def status(self, now_ms: float, stale_windows: int) -> str:
        if self.final:
            return "completed"
        horizon_ms = stale_windows * max(self.last_window_s, 1.0) * 1000.0
        if now_ms - self.last_published_ms > horizon_ms:
            return "stale"
        return "live"


class _FleetHealth:
    """Duck-typed health for the fleet AlertEngine's burn-rate rules:
    batch counters summed across the lineage's latest health payloads
    (the same two fields obs/alerts.py samples on a per-process
    HealthState)."""

    def __init__(self):
        self.batches_processed = 0
        self.batches_failed = 0


class FleetView:
    """Aggregates published telemetry frames into fleet-level series."""

    def __init__(
        self,
        client=None,
        url: Optional[str] = None,
        prefix: str = "",
        stale_windows: int = 2,
        rules_fn: Optional[Callable[[str], List[dict]]] = None,
        lineage_fn: Optional[Callable[[str], List[dict]]] = None,
        now_fn=time.time,
    ):
        """``client`` is an ObjectStoreClient (or anything with
        ``list(prefix)``/``get(key)``); ``url`` builds one from an
        ``objstore://host:port/bucket[/prefix]`` reference instead.
        ``lineage_fn(flow)`` optionally supplies job-registry lineage
        records (serve/jobs.py); frames are the fallback source."""
        if client is None:
            if not url:
                raise ValueError("FleetView needs a client or an url")
            from ..compile.aotcache import _parse_objstore_url
            from ..serve.objectstore import ObjectStoreClient

            endpoint, bucket, prefix = _parse_objstore_url(url)
            client = ObjectStoreClient(endpoint, bucket)
        self._client = client
        self._prefix = prefix.strip("/")
        self.stale_windows = int(stale_windows)
        self.rules_fn = rules_fn
        self.lineage_fn = lineage_fn
        self._now = now_fn
        self._lock = threading.Lock()
        self._seen_keys: set = set()
        self._flows: Dict[str, Dict[str, _ReplicaState]] = {}
        # merged surfaces the fleet AlertEngines evaluate over: one
        # MetricStore of per-window delta points and one registry of
        # merged histograms, refreshed on every refresh()
        self.store = MetricStore()
        self.histograms = HistogramRegistry()
        self._health: Dict[str, _FleetHealth] = {}
        self._engines: Dict[str, object] = {}
        self.decode_errors = 0
        self.last_merge_ms = 0.0

    @classmethod
    def from_url(cls, url: str, **kw) -> "FleetView":
        return cls(url=url, **kw)

    # -- ingestion --------------------------------------------------------
    def _list_prefix(self) -> str:
        return f"{self._prefix}/fleet/" if self._prefix else "fleet/"

    def refresh(self) -> int:
        """Pull frames published since the last refresh and fold them
        into the rollup. Returns the number of NEW frames ingested.
        Fail-open everywhere: an unlistable store yields 0 new frames;
        a corrupt frame is skipped and counted."""
        t0 = self._now()
        try:
            keys = sorted(self._client.list(self._list_prefix()))
        except Exception:  # noqa: BLE001 — a flaky store delays, never crashes
            logger.warning("fleet frame listing failed", exc_info=True)
            return 0
        ingested = 0
        for key in keys:
            with self._lock:
                if key in self._seen_keys:
                    continue
                self._seen_keys.add(key)
            if self._ingest_key(key):
                ingested += 1
        if ingested:
            self._rebuild_merged()
        self.last_merge_ms = (self._now() - t0) * 1000.0
        return ingested

    def _ingest_key(self, key: str) -> bool:
        try:
            body = self._client.get(key)
            if body is None:
                raise ValueError("frame vanished between list and get")
            frame = json.loads(body.decode("utf-8"))
            if not isinstance(frame, dict):
                raise ValueError("frame is not an object")
            for field in _REQUIRED_FRAME_FIELDS:
                if field not in frame:
                    raise ValueError(f"frame missing {field!r}")
            if int(frame.get("version") or 0) > FRAME_VERSION_MAX:
                raise ValueError(
                    f"frame version {frame.get('version')} unsupported"
                )
            self.ingest_frame(frame)
            return True
        except Exception as e:  # noqa: BLE001 — skip-and-count, never crash
            with self._lock:
                self.decode_errors += 1
            logger.warning(
                "skipping corrupt telemetry frame %s: %s (%d skipped "
                "so far)", key, e, self.decode_errors,
            )
            return False

    def ingest_frame(self, frame: dict) -> None:
        """Fold one already-decoded frame (tests and the drill call
        this directly; ``refresh`` is the store-backed path)."""
        flow = str(frame["flow"])
        replica = str(frame["replica"])
        with self._lock:
            rep = self._flows.setdefault(flow, {}).setdefault(
                replica, _ReplicaState(replica)
            )
            rep.fold(frame)
        # merged counter series: each frame's windowed deltas land as
        # points under the SAME DATAX-<flow>:<metric> keys a one-box
        # store holds, so fleet alert rules written against per-process
        # series evaluate unchanged over the rollup
        ts = int(
            frame.get("publishedAtMs")
            or (frame.get("watermark") or {}).get("batchTimeMs")
            or self._now() * 1000
        )
        app = MetricName.metric_app_name(flow)
        for metric, value in (frame.get("counters") or {}).items():
            self.store.add_point(f"{app}:{metric}", ts, float(value))
        for metric, value in (frame.get("gauges") or {}).items():
            self.store.add_point(f"{app}:{metric}", ts, float(value))

    def _rebuild_merged(self) -> None:
        """Rebuild the merged histogram registry + fleet health sums
        from the per-replica states (cheap: replicas x stages)."""
        with self._lock:
            flows = {
                flow: list(reps.values())
                for flow, reps in self._flows.items()
            }
        for flow, reps in flows.items():
            stages: Dict[str, LatencyHistogram] = {}
            health = _FleetHealth()
            for rep in reps:
                for stage, hist in rep.histograms.items():
                    cur = stages.get(stage)
                    stages[stage] = (
                        hist if cur is None else cur.merge(hist)
                    )
                if rep.health:
                    health.batches_processed += int(
                        rep.health.get("batchesProcessed") or 0
                    )
                    health.batches_failed += int(
                        rep.health.get("batchesFailed") or 0
                    )
            for stage, merged in stages.items():
                self.histograms.put(flow, stage, merged)
            self._health[flow] = health

    # -- rollup surfaces --------------------------------------------------
    def flows(self) -> List[str]:
        with self._lock:
            return sorted(self._flows)

    def _replicas(self, flow: str) -> List[_ReplicaState]:
        with self._lock:
            return list(self._flows.get(flow, {}).values())

    def fleet_metrics(self, flow: str) -> dict:
        """The merged fleet series for one flow + per-replica
        breakdowns (the ``/fleet/flows/<flow>`` payload)."""
        reps = self._replicas(flow)
        now_ms = self._now() * 1000.0
        counters: Dict[str, float] = {}
        for rep in reps:
            for k, v in rep.counters.items():
                counters[k] = counters.get(k, 0.0) + v
        hist_rollup = {}
        for stage in self.histograms.stages(flow):
            h = self.histograms.get(flow, stage)
            hist_rollup[stage] = {
                "count": h.count,
                "p50": h.percentile(50),
                "p95": h.percentile(95),
                "p99": h.percentile(99),
            }
        statuses = {
            rep.replica: rep.status(now_ms, self.stale_windows)
            for rep in reps
        }
        return {
            "flow": flow,
            "counters": counters,
            "histograms": hist_rollup,
            "replicas": {
                rep.replica: {
                    "status": statuses[rep.replica],
                    "replicaIndex": rep.replica_index,
                    "replicaCount": rep.replica_count,
                    "frames": len(rep.windows),
                    "windows": (
                        [min(rep.windows), max(rep.windows)]
                        if rep.windows else []
                    ),
                    "batches": rep.batches,
                    "lastSeenMs": rep.last_published_ms,
                    "final": rep.final,
                    "counters": dict(rep.counters),
                    "gauges": dict(rep.gauges),
                    "alerts": rep.alerts,
                    "offsets": {
                        k: list(v) for k, v in rep.offsets.items()
                    },
                }
                for rep in reps
            },
            "staleReplicas": sorted(
                r for r, s in statuses.items() if s == "stale"
            ),
            "alerts": self.evaluate_alerts(flow),
            "lineage": self.lineage(flow),
            "audit": self.audit(flow),
        }

    def summary(self) -> dict:
        """The ``/fleet/metrics`` payload: every flow's rollup plus
        aggregator self-stats."""
        return {
            "flows": {f: self.fleet_metrics(f) for f in self.flows()},
            "decodeErrors": self.decode_errors,
            "mergeMs": round(self.last_merge_ms, 3),
        }

    # -- fleet-scope alerts ----------------------------------------------
    def evaluate_alerts(self, flow: str) -> List[dict]:
        """Evaluate the flow's alert rules — the SAME rule dicts the
        per-process engines run (obs/alerts.py) — over the merged
        store/histograms/health. Burn-rate/SLO rules therefore compute
        error-budget burn on fleet totals."""
        from .alerts import AlertEngine, default_rules

        engine = self._engines.get(flow)
        if engine is None:
            rules = (
                self.rules_fn(flow) if self.rules_fn is not None
                else default_rules(flow)
            )
            engine = AlertEngine(
                rules,
                flow=flow,
                store=self.store,
                histograms=self.histograms,
                health=self._health.setdefault(flow, _FleetHealth()),
                now_fn=self._now,
            )
            self._engines[flow] = engine
        else:
            # health object identity must track the latest rebuild
            engine.health = self._health.get(flow, engine.health)
        try:
            return engine.evaluate()
        except Exception:  # noqa: BLE001 — alert evaluation is advisory
            logger.exception("fleet alert evaluation failed for %s", flow)
            return []

    # -- lineage ----------------------------------------------------------
    def lineage(self, flow: str) -> List[dict]:
        """The flow's replica succession, oldest first. Job-registry
        records win when a ``lineage_fn`` is wired (they carry the
        authoritative ``statePartitionMap``); frames are the fallback
        — ordered by first publication, which tracks generation order
        across a rescale handoff."""
        if self.lineage_fn is not None:
            try:
                records = self.lineage_fn(flow)
                if records:
                    return records
            except Exception:  # noqa: BLE001 — registry outage falls back
                logger.warning(
                    "lineage_fn failed for %s; deriving lineage from "
                    "frames", flow, exc_info=True,
                )
        reps = sorted(
            self._replicas(flow), key=lambda r: (r.first_seen_ms or 0)
        )
        now_ms = self._now() * 1000.0
        return [
            {
                "replica": rep.replica,
                "replicaIndex": rep.replica_index,
                "replicaCount": rep.replica_count,
                "firstSeenMs": rep.first_seen_ms,
                "lastSeenMs": rep.last_published_ms,
                "status": rep.status(now_ms, self.stale_windows),
            }
            for rep in reps
        ]

    # -- delivery-conservation audit (DX54x) ------------------------------
    def audit(self, flow: str, output: Optional[str] = None) -> dict:
        """Check Σ ingested == Σ emitted across the flow's lineage and
        flag stale replicas. Returns at most ONE DX540-or-DX541 event
        per flow (loss and duplication are mutually exclusive on the
        same totals) and one DX542 per stale replica — repeated audits
        of the same state yield the same events, so "fires exactly
        once" holds by construction."""
        reps = self._replicas(flow)
        now_ms = self._now() * 1000.0
        total_ingested = 0.0
        emitted_by_output: Dict[str, float] = {}
        for rep in reps:
            total_ingested += sum(rep.ingested.values())
            for out, n in rep.emitted.items():
                emitted_by_output[out] = emitted_by_output.get(out, 0.0) + n
        if output is None and emitted_by_output:
            # aggregating outputs (windowed GROUP BYs) under-emit by
            # construction; the passthrough output — the one that
            # conserves — has the highest emitted total
            output = max(emitted_by_output, key=emitted_by_output.get)
        total_emitted = emitted_by_output.get(output or "", 0.0)
        events: List[dict] = []
        if reps and total_ingested > total_emitted:
            events.append({
                "code": "DX540",
                "name": AUDIT_CODES["DX540"],
                "flow": flow,
                "output": output,
                "ingested": total_ingested,
                "emitted": total_emitted,
                "message": (
                    f"delivery loss on {flow}/{output}: "
                    f"{total_ingested:.0f} ingested vs "
                    f"{total_emitted:.0f} emitted across the lineage"
                ),
            })
        elif reps and total_emitted > total_ingested:
            events.append({
                "code": "DX541",
                "name": AUDIT_CODES["DX541"],
                "flow": flow,
                "output": output,
                "ingested": total_ingested,
                "emitted": total_emitted,
                "message": (
                    f"delivery duplication on {flow}/{output}: "
                    f"{total_emitted:.0f} emitted vs "
                    f"{total_ingested:.0f} ingested across the lineage"
                ),
            })
        for rep in reps:
            if rep.status(now_ms, self.stale_windows) == "stale":
                events.append({
                    "code": "DX542",
                    "name": AUDIT_CODES["DX542"],
                    "flow": flow,
                    "replica": rep.replica,
                    "message": (
                        f"replica {rep.replica} of {flow} went quiet "
                        f"without its final drain frame — its in-flight "
                        f"window is unaccounted"
                    ),
                })
        counts = {code: 0 for code in AUDIT_CODES}
        for ev in events:
            counts[ev["code"]] += 1
        return {
            "flow": flow,
            "output": output,
            "ingested": total_ingested,
            "emitted": emitted_by_output,
            "conserved": not any(
                e["code"] in ("DX540", "DX541") for e in events
            ),
            "events": events,
            "counts": counts,
        }


# newest frame schema this aggregator understands (frames from a newer
# publisher are skip-and-count, not a crash)
FRAME_VERSION_MAX = 1


def render_fleet_prometheus(view: FleetView) -> str:
    """The fleet rollup as Prometheus text — appended to the website's
    ``/metrics`` exposition beside the per-process families
    (obs/exposition.py render_prometheus)."""
    out: List[str] = []
    out.append("# TYPE datax_fleet_metric_total gauge")
    for flow in view.flows():
        fm = view.fleet_metrics(flow)
        for metric, value in sorted(fm["counters"].items()):
            out.append(
                f'datax_fleet_metric_total{{flow="{flow}",'
                f'metric="{metric}"}} {value}'
            )
    out.append("# TYPE datax_fleet_replicas gauge")
    for flow in view.flows():
        fm = view.fleet_metrics(flow)
        by_status: Dict[str, int] = {}
        for rep in fm["replicas"].values():
            by_status[rep["status"]] = by_status.get(rep["status"], 0) + 1
        for status, n in sorted(by_status.items()):
            out.append(
                f'datax_fleet_replicas{{flow="{flow}",'
                f'status="{status}"}} {n}'
            )
    out.append("# TYPE datax_fleet_stage_latency_ms summary")
    for flow in view.flows():
        for stage in view.histograms.stages(flow):
            h = view.histograms.get(flow, stage)
            for q in (50, 95, 99):
                v = h.percentile(q)
                if v is not None:
                    out.append(
                        f'datax_fleet_stage_latency_ms{{flow="{flow}",'
                        f'stage="{stage}",quantile="0.{q}"}} {v:.3f}'
                    )
    out.append("# TYPE datax_fleet_frame_decode_errors_total counter")
    out.append(
        f"datax_fleet_frame_decode_errors_total {view.decode_errors}"
    )
    out.append("# TYPE datax_fleet_audit_events gauge")
    for flow in view.flows():
        audit = view.audit(flow)
        for code, n in sorted(audit["counts"].items()):
            out.append(
                f'datax_fleet_audit_events{{flow="{flow}",'
                f'code="{code}"}} {n}'
            )
    return "\n".join(out) + "\n"
