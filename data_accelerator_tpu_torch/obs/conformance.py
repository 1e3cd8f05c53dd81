"""Model-vs-observed conformance: runtime drift detection (DX5xx).

The static analysis tiers predict what a deployed flow will cost — the
DX2xx device-plan model of the JAX package's lowering
(``analysis/costmodel.py``), and the fleet placer admits jobs on those
numbers. Nothing until now checked the *running* job against them.
Config generation embeds the flow's machine-readable cost-model report
into the generated conf (``datax.job.process.conformance.model``, a
compact JSON produced by ``DevicePlanReport.runtime_model()``); at
runtime a ``ConformanceMonitor`` on each host compares windowed
observations — ``Transfer_D2HBytes``, per-output occupancy, retrace
counts — against those predictions and exports:

- ``Conformance_*`` gauges (observed/predicted ratios, merged into the
  per-batch metric dict so they ride the normal store/Prometheus/SPA
  path), and
- typed **drift events** into the flight recorder and metric store:

  | code | name | meaning |
  |---|---|---|
  | DX501 | d2h-bytes-drift | windowed observed D2H bytes exceed the modeled per-batch transfer by more than the tolerance band |
  | DX502 | occupancy-vs-modeled-cardinality | an output's observed row occupancy exceeds the modeled group/join cardinality — the capacity planning input was wrong |
  | DX503 | unmodeled-retrace | the step was rebuilt after warmup; steady state is modeled as rebuild-free |
  | DX510 | ici-bytes-drift | windowed observed mesh collective bytes (``Mesh_ICI_Bytes``) exceed the DX7xx sharding model's wire prediction by more than the tolerance band |
  | DX511 | mesh-collective-count-drift | the executed mesh step's collective-op census (``Mesh_Reshard_Count``) changed from its post-warmup baseline — a rebuilt step repartitioned the flow |
  | DX520 | stage-time-drift | a stage's observed latency p50 exceeds the calibrated roofline prediction (``max(bytes/BW, flops/F) + dispatch overhead`` over the measured machine profile, obs/calibrate.py) by more than the band |
  | DX521 | dispatch-overhead-dominated | DX520's condition on a stage whose *model* is all fixed dispatch overhead — the slowdown is per-dispatch cost, not data movement |
  | DX522 | hbm-footprint-drift | live HBM peak (``Hbm_PeakBytes``, the per-window ``memory_stats`` sample) drifted above the DX2xx modeled footprint band |

The DX52x trio is the *time* half of the loop: S620 embeds the
byte+FLOP closed forms, and per-stage predicted milliseconds (computed
by ``latency_predictions`` from the host's calibrated machine profile,
or an operator pin) are judged against the same windowed
``Latency-<Stage>-p50`` histogram series the dashboards read.

The DX51x pair is the runtime half of the mesh tier
(``analysis/meshcheck.py``): config generation embeds the sharding
plan's collective model into mesh jobs' confs
(``datax.job.process.mesh.model``, the S660 stage), the mesh step
records its own collectives per batch (``dist/mesh.py
MeshCollectives`` -> ``Mesh_ICI_Bytes`` / ``Mesh_Reshard_Count``), and
this monitor judges one against the other. The band of DX510 is the
reference's (8x): it catches the model *missing* traffic wholesale.

Events fire on the *transition* into drift (and re-arm on recovery), so
a sustained drift is one event, not one per batch; the cumulative
``Conformance_Drift_Count`` gauge keeps the total visible.

Copy of the JAX package's ``obs/conformance.py``.

In the port ``Retrace_Count`` counts rebuilds of the step after init
(a UDF ``on_interval`` refresh): eager PyTorch has no trace, and a
rebuild is the work the steady-state model does not include.
``latency_predictions`` takes the step's launch count, which the host
counts on its processor (``deviceplan.count_step_launches``): the
eager step pays a dispatch overhead a kernel, the JAX package's jitted
step one.
"""

from __future__ import annotations

import json
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..constants import MetricName

logger = logging.getLogger(__name__)

# runtime drift code registry (documented in OBSERVABILITY.md
# "Conformance monitoring (DX5xx)")
DRIFT_CODES: Dict[str, str] = {
    "DX501": "d2h-bytes-drift",
    "DX502": "occupancy-vs-modeled-cardinality",
    "DX503": "unmodeled-retrace",
    "DX510": "ici-bytes-drift",
    "DX511": "mesh-collective-count-drift",
    "DX520": "stage-time-drift",
    "DX521": "dispatch-overhead-dominated",
    "DX522": "hbm-footprint-drift",
}

# observed/predicted ratio above which DX501 fires (sized transfer makes
# observed < predicted the healthy direction; exceeding the model means
# the model missed traffic)
DEFAULT_D2H_RATIO_HIGH = 1.5
# observed rows / modeled cardinality above which DX502 fires
DEFAULT_OCCUPANCY_FACTOR = 2.0
# observed/predicted ratio above which DX510 fires. The DX7xx model
# prices the planned-layout gathers, which the port's mesh step makes
# exactly (its census adds one all-reduce of the counts vector); the
# band stays the reference's, much wider than DX501's — it catches
# wholesale model misses (an unmodeled reshard storm, a rebuilt step
# multiplying the collective census), not a few bytes. DX511's
# count-drift check is the sharp instrument for repartitioning.
DEFAULT_ICI_RATIO_HIGH = 8.0
# observed p50 / predicted roofline ms above which DX520 fires. The
# latency closed forms are LOWER bounds (peak bandwidth, peak dense
# FLOP/s — analysis/costmodel.py stage_time_ms); achieved efficiency
# on gather/sort-heavy SQL stages legitimately runs several-fold under
# peak, so the band is wide: it catches a stage going
# wholesale slow (bandwidth regression, dispatch-overhead domination,
# an HBM re-layout), not roofline optimism.
DEFAULT_STAGE_TIME_RATIO_HIGH = 10.0
# predicted ms below which DX520/DX521 decline to judge a stage: a
# sub-millisecond roofline prediction means fixed host-side costs the
# device model deliberately does not cover (row materialization, GIL
# scheduling, tunnel RTT) dominate the observation, and any ratio
# against it is noise, not drift — the missing-prediction posture
# (silence) applies. An explicit conformance.latency PIN is always
# judged: the operator asserted the number.
DEFAULT_STAGE_TIME_FLOOR_MS = 1.0
# observed live HBM peak / the DX2xx modeled footprint above which
# DX522 fires — the byte model is exact (tier-1 asserts model ==
# lowering), so the band only needs to absorb allocator slack and
# runtime scratch, not model error
DEFAULT_HBM_RATIO_HIGH = 1.5
# windowed samples required before ratios are judged (and before a
# retrace counts as unmodeled — the first trace IS the model)
DEFAULT_WARMUP_BATCHES = 4
DEFAULT_WINDOW = 16


@dataclass
class DriftEvent:
    """One typed model-vs-observed drift detection."""

    code: str
    metric: str
    observed: float
    predicted: float
    ratio: float
    batch_time_ms: Optional[int] = None
    message: str = ""

    def to_props(self) -> dict:
        return {
            "code": self.code,
            "name": DRIFT_CODES.get(self.code, self.code),
            "metric": self.metric,
            "observed": round(self.observed, 2),
            "predicted": round(self.predicted, 2),
            "ratio": round(self.ratio, 4),
            "batchTime": self.batch_time_ms,
            "message": self.message,
        }


@dataclass
class ConformanceModel:
    """The embedded slice of the DX2xx cost report a running host can
    check itself against. All fields optional — a missing prediction
    simply disables its checks (the missing-prediction posture is
    silence, not failure)."""

    d2h_bytes_per_batch: Optional[float] = None
    hbm_bytes: Optional[float] = None
    # modeled FLOPs/batch across all stages (the compute side of the
    # DX520 roofline prediction)
    flops: Optional[float] = None
    # output dataset -> {"rows": modeled cardinality, "capacity": padded}
    outputs: Dict[str, dict] = field(default_factory=dict)
    # per-stage hbmBytes/d2hBytes/flops (the DX520 latency inputs; the
    # CLI/SPA also render it)
    stages: List[dict] = field(default_factory=list)
    # mesh sharding-plan predictions (datax.job.process.mesh.model, the
    # DX7xx analyzer's runtime artifact): modeled collective wire bytes
    # per batch and the planned reshard count — the DX510/DX511 inputs
    ici_wire_bytes_per_batch: Optional[float] = None
    reshard_count: Optional[float] = None

    @classmethod
    def from_json(
        cls, text: str, mesh_text: Optional[str] = None,
    ) -> Optional["ConformanceModel"]:
        obj: Optional[dict] = None
        if text:
            try:
                parsed = json.loads(text)
                obj = parsed if isinstance(parsed, dict) else None
            except ValueError:
                logger.warning("unparseable conformance model; monitor off")
                obj = None
        mesh_totals: dict = {}
        if mesh_text:
            try:
                mesh_obj = json.loads(mesh_text)
                if isinstance(mesh_obj, dict):
                    mesh_totals = mesh_obj.get("totals") or {}
            except ValueError:
                logger.warning("unparseable mesh model; DX51x checks off")
        if obj is None and not mesh_totals:
            return None
        obj = obj or {}
        totals = obj.get("totals") or {}
        return cls(
            d2h_bytes_per_batch=totals.get("d2hBytesPerBatch"),
            hbm_bytes=totals.get("hbmBytes"),
            flops=totals.get("flops"),
            outputs={
                k: v for k, v in (obj.get("outputs") or {}).items()
                if isinstance(v, dict)
            },
            stages=list(obj.get("stages") or []),
            ici_wire_bytes_per_batch=mesh_totals.get("iciWireBytesPerBatch"),
            reshard_count=mesh_totals.get("reshardCount"),
        )

    @classmethod
    def from_conf(cls, dict_) -> Optional["ConformanceModel"]:
        raw = dict_.get_sub_dictionary(
            "datax.job.process.conformance."
        ).get("model")
        mesh_raw = dict_.get_sub_dictionary(
            "datax.job.process.mesh."
        ).get("model")
        if not raw and not mesh_raw:
            return None
        return cls.from_json(raw or "", mesh_raw)

    def latency_predictions(self, profile: dict, launches: int = 1) -> tuple:
        """The DX520 comparison baseline: roofline per-stage latency
        under ``profile`` (a calibrated ``MachineProfile.to_dict()``),
        one dispatch overhead for each of the step's ``launches``.
        Bytes and FLOPs travel in the conf-embedded model; this turns
        them into milliseconds on the machine that will be judged.
        Returns ``(predictions, compute_ms, overhead_ms)`` —
        predictions keyed by runtime histogram stage, and the model's
        compute-vs-dispatch-overhead split (the DX521 input: a stage
        whose predicted time is all fixed overhead has nothing to gain
        from bandwidth, only from batching/fusing dispatches)."""
        from ..analysis.costmodel import (
            latency_model,
            stage_latency_predictions,
        )

        model = latency_model(
            self.stages,
            {
                "d2hBytesPerBatch": self.d2h_bytes_per_batch,
                "flops": self.flops,
            },
            profile,
            profile_source="calibrated",
            launches=launches,
        )
        totals = model["totals"]
        return (
            stage_latency_predictions(model),
            float(totals["computeMs"]),
            float(totals["dispatchOverheadMs"]),
        )


class ConformanceMonitor:
    """Windowed model-vs-observed comparison, fed once per batch finish
    with the batch's metric dict (``FlowProcessor`` collect output plus
    the host's additions). Returns gauges to merge into the same dict
    and the drift events that fired this batch."""

    def __init__(
        self,
        model: ConformanceModel,
        flow: str = "",
        window: int = DEFAULT_WINDOW,
        warmup: int = DEFAULT_WARMUP_BATCHES,
        d2h_ratio_high: float = DEFAULT_D2H_RATIO_HIGH,
        occupancy_factor: float = DEFAULT_OCCUPANCY_FACTOR,
        stage_time_ratio_high: float = DEFAULT_STAGE_TIME_RATIO_HIGH,
        stage_time_floor_ms: float = DEFAULT_STAGE_TIME_FLOOR_MS,
        hbm_ratio_high: float = DEFAULT_HBM_RATIO_HIGH,
        ici_ratio_high: float = DEFAULT_ICI_RATIO_HIGH,
    ):
        self.model = model
        self.flow = flow
        self.window = max(1, int(window))
        self.warmup = max(1, int(warmup))
        self.d2h_ratio_high = float(d2h_ratio_high)
        self.occupancy_factor = float(occupancy_factor)
        self.stage_time_ratio_high = float(stage_time_ratio_high)
        self.stage_time_floor_ms = float(stage_time_floor_ms)
        self.hbm_ratio_high = float(hbm_ratio_high)
        self.ici_ratio_high = float(ici_ratio_high)
        # DX520/DX521 state: runtime-stage -> predicted roofline ms,
        # set by set_latency() once the host has a calibrated profile
        # (or pinned from the conf's conformance.latency override);
        # the compute/overhead split routes drift to DX521 when the
        # model says the stage is all fixed dispatch cost
        self.latency: Dict[str, float] = {}
        self.latency_pinned = False
        self._latency_compute_ms = 0.0
        self._latency_overhead_ms = 0.0
        self.batches = 0
        self.drift_count = 0
        self._d2h: deque = deque(maxlen=self.window)
        self._hbm: deque = deque(maxlen=self.window)
        self._ici: deque = deque(maxlen=self.window)
        self._occupancy: Dict[str, deque] = {}
        # the executed mesh step's first post-warmup collective-op
        # count — DX511's self-baseline (a change means a rebuilt step
        # repartitioned the flow)
        self._collective_baseline: Optional[float] = None
        # codes (keyed per metric) currently in drift — events fire on
        # the transition in, re-arm on recovery
        self._active: set = set()

    @classmethod
    def from_conf(cls, dict_, flow: str = "") -> Optional["ConformanceMonitor"]:
        model = ConformanceModel.from_conf(dict_)
        sub = dict_.get_sub_dictionary("datax.job.process.conformance.")
        # operator latency pin: conformance.latency = JSON stage->ms
        # replaces the computed roofline predictions outright (the
        # injected-slowdown acceptance drill uses the same door)
        pin: Optional[Dict[str, float]] = None
        lat_raw = sub.get("latency")
        if lat_raw:
            try:
                parsed = json.loads(lat_raw)
                if isinstance(parsed, dict):
                    pin = {
                        str(k): float(v) for k, v in parsed.items()
                        if isinstance(v, (int, float))
                    }
            except ValueError:
                logger.warning(
                    "unparseable conformance.latency pin; ignored"
                )
        if model is None:
            # a valid pin alone arms the monitor (DX520/521 only) —
            # the operator asserted the numbers, no byte model needed
            if not pin:
                return None
            model = ConformanceModel()
        window = sub.get_int_option("window")
        warmup = sub.get_int_option("warmup")
        high = sub.get_double_option("d2hratiohigh")
        occ = sub.get_double_option("occupancyfactor")
        stage_t = sub.get_double_option("stagetimeratiohigh")
        stage_floor = sub.get_double_option("stagetimefloorms")
        hbm = sub.get_double_option("hbmratiohigh")
        ici = sub.get_double_option("iciratiohigh")
        mon = cls(
            model,
            flow=flow,
            window=window if window is not None else DEFAULT_WINDOW,
            warmup=warmup if warmup is not None else DEFAULT_WARMUP_BATCHES,
            d2h_ratio_high=(
                high if high is not None else DEFAULT_D2H_RATIO_HIGH
            ),
            occupancy_factor=(
                occ if occ is not None else DEFAULT_OCCUPANCY_FACTOR
            ),
            stage_time_ratio_high=(
                stage_t if stage_t is not None
                else DEFAULT_STAGE_TIME_RATIO_HIGH
            ),
            stage_time_floor_ms=(
                stage_floor if stage_floor is not None
                else DEFAULT_STAGE_TIME_FLOOR_MS
            ),
            hbm_ratio_high=(
                hbm if hbm is not None else DEFAULT_HBM_RATIO_HIGH
            ),
            ici_ratio_high=(
                ici if ici is not None else DEFAULT_ICI_RATIO_HIGH
            ),
        )
        if pin:
            mon.set_latency(pin, pinned=True)
        return mon

    def set_latency(
        self,
        predictions: Dict[str, float],
        compute_ms: float = 0.0,
        overhead_ms: float = 0.0,
        pinned: bool = False,
    ) -> None:
        """Arm the DX520/DX521 checks with per-stage predicted ms
        (``ConformanceModel.latency_predictions`` output, or an
        explicit conf pin — a pin wins over computed predictions and
        is never overwritten by the host's calibration)."""
        if self.latency_pinned and not pinned:
            return
        self.latency = {
            k: float(v) for k, v in (predictions or {}).items() if v
        }
        self._latency_compute_ms = float(compute_ms)
        self._latency_overhead_ms = float(overhead_ms)
        self.latency_pinned = self.latency_pinned or pinned

    # -- transitions -----------------------------------------------------
    def _transition(
        self, key: str, in_drift: bool, make_event,
    ) -> Optional[DriftEvent]:
        if in_drift and key not in self._active:
            self._active.add(key)
            self.drift_count += 1
            return make_event()
        if not in_drift:
            self._active.discard(key)
        return None

    # -- the per-batch pass ----------------------------------------------
    def observe(
        self, metrics: Dict[str, float],
        batch_time_ms: Optional[int] = None,
    ) -> tuple:
        """Feed one finished batch's metrics. Returns
        ``(gauges, events)``: gauges are ``Conformance_*`` entries for
        the batch's metric dict; events are the drift transitions that
        fired (typed, flight-recorder-bound)."""
        self.batches += 1
        gauges: Dict[str, float] = {}
        events: List[DriftEvent] = []
        warmed = self.batches > self.warmup

        # DX501: observed D2H bytes vs the modeled per-batch transfer
        d2h = metrics.get("Transfer_D2HBytes")
        predicted_d2h = self.model.d2h_bytes_per_batch
        if d2h is not None and predicted_d2h:
            self._d2h.append(float(d2h))
            mean = sum(self._d2h) / len(self._d2h)
            ratio = mean / float(predicted_d2h)
            gauges["Conformance_D2HBytes_Ratio"] = ratio
            ev = self._transition(
                "DX501", warmed and ratio > self.d2h_ratio_high,
                lambda: DriftEvent(
                    "DX501", "Transfer_D2HBytes", mean,
                    float(predicted_d2h), ratio, batch_time_ms,
                    f"windowed D2H bytes {mean:.0f} exceed modeled "
                    f"{float(predicted_d2h):.0f}/batch by "
                    f"{ratio:.2f}x (> {self.d2h_ratio_high}x)",
                ),
            )
            if ev:
                events.append(ev)

        # DX502: per-output occupancy vs modeled cardinality
        for name, pred in self.model.outputs.items():
            rows_pred = pred.get("rows")
            if not rows_pred:
                continue
            observed = metrics.get(f"Output_{name}_Events_Count")
            if observed is None:
                continue
            win = self._occupancy.setdefault(
                name, deque(maxlen=self.window)
            )
            win.append(float(observed))
            mean = sum(win) / len(win)
            ratio = mean / float(rows_pred)
            gauges[f"Conformance_Occupancy_{name}_Ratio"] = ratio
            ev = self._transition(
                f"DX502:{name}",
                warmed and ratio > self.occupancy_factor,
                lambda n=name, m=mean, rp=float(rows_pred), r=ratio: DriftEvent(
                    "DX502", f"Output_{n}_Events_Count", m, rp, r,
                    batch_time_ms,
                    f"output '{n}' occupancy {m:.0f} rows/batch vs "
                    f"modeled cardinality {rp:.0f} "
                    f"({r:.2f}x > {self.occupancy_factor}x) — re-check "
                    "declared key cardinality (DX200/DX202 inputs)",
                ),
            )
            if ev:
                events.append(ev)

        # DX510: observed mesh collective bytes vs the sharding model's
        # wire prediction (the DX7xx runtime counterpart)
        ici = metrics.get("Mesh_ICI_Bytes")
        predicted_ici = self.model.ici_wire_bytes_per_batch
        if ici is not None and predicted_ici:
            self._ici.append(float(ici))
            mean = sum(self._ici) / len(self._ici)
            ratio = mean / float(predicted_ici)
            gauges["Conformance_MeshIci_Ratio"] = ratio
            ev = self._transition(
                "DX510", warmed and ratio > self.ici_ratio_high,
                lambda: DriftEvent(
                    "DX510", "Mesh_ICI_Bytes", mean,
                    float(predicted_ici), ratio, batch_time_ms,
                    f"windowed mesh collective bytes {mean:.0f} exceed "
                    f"the sharding model's {float(predicted_ici):.0f}"
                    f"/batch by {ratio:.2f}x (> {self.ici_ratio_high}x) "
                    f"— the DX7xx partition plan missed traffic "
                    f"(re-validate with --mesh)",
                ),
            )
            if ev:
                events.append(ev)

        # DX511: the executed mesh step's collective-op census vs its
        # own post-warmup baseline (a change = a rebuilt step
        # repartitioned the flow — the plan no longer describes it)
        n_coll = metrics.get("Mesh_Reshard_Count")
        if n_coll is not None:
            if warmed and self._collective_baseline is None:
                self._collective_baseline = float(n_coll)
            base = self._collective_baseline
            drifted = base is not None and float(n_coll) != base
            ev = self._transition(
                "DX511", drifted,
                lambda: DriftEvent(
                    "DX511", "Mesh_Reshard_Count", float(n_coll),
                    base or 0.0,
                    (float(n_coll) / base) if base else 0.0,
                    batch_time_ms,
                    f"mesh collective-op count changed "
                    f"{base:.0f} -> {n_coll:.0f} after warmup — the "
                    f"step was rebuilt into a different partition "
                    f"(dictionary growth or UDF refresh under the "
                    f"mesh; see DX204/DX600)",
                ),
            )
            if ev:
                events.append(ev)

        # DX520/DX521: observed per-stage latency p50 vs the roofline
        # prediction (the calibrated time model). The host merges the
        # windowed histogram percentiles into the metric dict BEFORE
        # this observe, so the comparison input is the same
        # Latency-<Stage>-p50 series every dashboard reads. DX521
        # replaces DX520 for a stage whose predicted time is all fixed
        # dispatch overhead (bytes*BW + flops/F tiny): going slow there
        # is dispatch-overhead domination, and more bandwidth won't fix
        # it — fewer/fused dispatches will.
        for stage, predicted_ms in self.latency.items():
            camel = MetricName.stage_metric(stage)[len("Latency-"):]
            observed_ms = metrics.get(f"Latency-{camel}-p50")
            if observed_ms is None or not predicted_ms:
                continue
            ratio = float(observed_ms) / float(predicted_ms)
            gauges[f"Conformance_StageTime_{camel}_Ratio"] = ratio
            # DX521 routing needs a known compute/overhead split (a
            # pinned prediction has none — drift there is plain DX520)
            overhead_bound = (
                stage == "device-step"
                and self._latency_overhead_ms > 0
                and self._latency_compute_ms <= self._latency_overhead_ms
            )
            code = "DX521" if overhead_bound else "DX520"
            # sub-floor predictions decline to judge (host-side fixed
            # costs dominate the observation); an explicit latency pin
            # is always judged
            judged = (
                self.latency_pinned
                or float(predicted_ms) >= self.stage_time_floor_ms
            )
            ev = self._transition(
                f"DX52x:{stage}",
                warmed and judged and ratio > self.stage_time_ratio_high,
                lambda s=stage, c=code, cm=camel, o=float(observed_ms),
                p=float(predicted_ms), r=ratio: DriftEvent(
                    c, f"Latency-{cm}-p50",
                    o, p, r, batch_time_ms,
                    (
                        f"stage '{s}' p50 {o:.2f}ms vs roofline "
                        f"{p:.2f}ms ({r:.1f}x > "
                        f"{self.stage_time_ratio_high}x)"
                        + (
                            " — the model is dispatch-overhead bound "
                            "(bytes/BW and flops/F are negligible): "
                            "the time is going into per-dispatch fixed "
                            "cost, not data movement; batch more work "
                            "per dispatch"
                            if c == "DX521" else
                            " — bandwidth regression, HBM re-layout or "
                            "an unmodeled slow path; re-profile with "
                            "POST /profile and re-validate with "
                            "--device"
                        )
                    ),
                ),
            )
            if ev:
                events.append(ev)

        # DX522: live HBM peak vs the DX2xx modeled footprint. The
        # observation is the per-window Hbm_PeakBytes sample
        # (the allocator's memory stats — absent on the CPU,
        # where the posture is silence like every missing input).
        hbm_peak = metrics.get("Hbm_PeakBytes")
        predicted_hbm = self.model.hbm_bytes
        if hbm_peak is not None and predicted_hbm:
            self._hbm.append(float(hbm_peak))
            mean = sum(self._hbm) / len(self._hbm)
            ratio = mean / float(predicted_hbm)
            gauges["Conformance_Hbm_Ratio"] = ratio
            ev = self._transition(
                "DX522", warmed and ratio > self.hbm_ratio_high,
                lambda m=mean, p=float(predicted_hbm), r=ratio: DriftEvent(
                    "DX522", "Hbm_PeakBytes", m, p, r, batch_time_ms,
                    f"live HBM peak {m:.0f}B drifted above the modeled "
                    f"footprint {p:.0f}B by {r:.2f}x "
                    f"(> {self.hbm_ratio_high}x) — fragmentation forcing "
                    f"re-layout, an unmodeled allocation, or stale "
                    f"capacity planning (re-run --device / --fleet)",
                ),
            )
            if ev:
                events.append(ev)

        # DX503: re-traces after warmup (steady state is trace-free)
        retraces = metrics.get("Retrace_Count")
        if retraces:
            ev = self._transition(
                "DX503", warmed,
                lambda: DriftEvent(
                    "DX503", "Retrace_Count", float(retraces), 0.0,
                    float(retraces), batch_time_ms,
                    f"{retraces:.0f} step rebuild(s) after warmup — "
                    "the cost model assumes a trace-free steady state "
                    "(see DX204/DX3xx for static retrace hazards)",
                ),
            )
            if ev:
                events.append(ev)
        else:
            self._active.discard("DX503")

        if self.drift_count:
            gauges["Conformance_Drift_Count"] = float(self.drift_count)
        return gauges, events
