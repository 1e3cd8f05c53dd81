"""Autopilot: the closed-loop runtime controller.

reference: the reference platform's control plane deploys and MONITORS
Spark jobs — AppInsights live metrics, scheduled probe scenarios — but
never *acts* on what it sees (SURVEY §1: operators watch dashboards
and retune ``maxRate``/executor counts by hand). ROADMAP item 5 asks
ours to *pilot* them: this module closes the loop from the existing
signal surface (windowed ``Pipeline_Stall_Ms``, landing backlog,
``HealthState`` stall EWMAs, alert rules, malformed-input counters) to
bounded runtime actuations.

Shape of the loop (one pass per evaluation window):

    signals ──snapshot──▶ decision table ──budget/cooldown──▶ actuators

- **Signals** (``SignalSnapshot``): read from the SAME live surfaces
  the dashboards and probes read — ``HealthState`` (the conf'd stall
  EWMA, so ``/readyz`` and the pilot agree on "stalled"), the
  MetricStore (landing backlog), host counters (poll saturation,
  malformed rate) and the ``AlertEngine`` firing set (rules carrying an
  ``action`` field share one vocabulary with the pilot).
- **Decision table** (``decide``): a pure, ordered rule list mapping a
  snapshot to intended actuations. Pure means the replay CLI
  can re-run it offline over a recorded flight-recorder JSONL byte-for-byte.
- **Budget + cooldown**: at most ``budget`` actuations are APPLIED per
  window, each actuator honors a per-kind cooldown, and a kind that
  just actuated one direction must wait out a doubled cooldown before
  reversing — the no-flap property the unit suite asserts under an
  oscillating synthetic signal.
- **Actuators** (typed ``Actuator`` interface): pipeline depth within
  ``[1, maxdepth]`` (the host drains the in-flight window down to the
  new depth in FIFO order, so commit/requeue invariants are untouched),
  source backpressure (the ``TokenBucket`` the ingestor consults), and
  replica scale-out/in (``ScaleActuator`` -> ``JobOperation.rescale``,
  so the fleet admission gate still vets every scale-up).

Every evaluation is a ``pilot/evaluate`` trace in the flight recorder;
every decision — applied or suppressed — is a ``pilot/decide`` child
span carrying the signal snapshot, the rule fired and the actuation
taken. ``Pilot_Actuations_Count`` / ``Pilot_Depth`` /
``Pilot_Backpressure_Tokens`` export the loop's state as registry
metric series.

Copy of the JAX package's ``pilot/controller.py``; its replay CLI is
``pilot/__main__.py``.
"""

from __future__ import annotations

import logging
import time
import weakref
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional

from .backpressure import TokenBucket

logger = logging.getLogger(__name__)

# actuation kinds — also the vocabulary of the alert rules' optional
# ``action`` field (obs/alerts.py ACTIONS mirrors this tuple; a firing
# rule with an action is a standing vote for that actuation)
ACTION_KINDS = (
    "depth-down", "depth-up", "backpressure", "backpressure-release",
    "rescale-up", "rescale-down",
)

# kind -> the actuator family it belongs to (cooldowns are per family;
# the reverse map is what makes "depth-up right after depth-down" a
# flap the controller refuses)
_FAMILY = {
    "depth-down": "depth", "depth-up": "depth",
    "backpressure": "backpressure",
    "backpressure-release": "backpressure",
    "rescale-up": "rescale", "rescale-down": "rescale",
}


@dataclass
class PilotConfig:
    """Conf surface ``datax.job.process.pilot.*`` (designer
    ``jobPilot*`` knobs, generation stage S640)."""

    enabled: bool = True
    window_s: float = 5.0          # evaluation cadence
    cooldown_s: float = 15.0       # per-family min seconds between acts
    budget: int = 2                # max actuations applied per window
    min_depth: int = 1
    max_depth: int = 8
    stall_high_ms: float = 500.0   # smoothed stall above this: depth down
    stall_low_ms: float = 50.0     # below this the device has headroom
    backlog_high: float = 2.0      # pending landings >= this: backpressure
    saturation_high: float = 0.8   # full-poll fraction above this: scale out
    lag_high_ms: float = 30_000.0  # source watermark lag: scale out
    malformed_high: float = 0.3    # malformed/total row ratio: backpressure
    max_replicas: int = 4
    min_poll_fraction: float = 0.125

    @classmethod
    def from_setting_dictionary(cls, sub) -> "PilotConfig":
        """Build from the ``datax.job.process.pilot.`` sub-dictionary
        (conf keys are the lowercase field names without underscores,
        matching the flat-conf convention: ``windowseconds``,
        ``cooldownseconds``, ``budget``, ``maxdepth``, ...)."""
        def f(key, default):
            v = sub.get(key)
            return float(v) if v not in (None, "") else default

        def i(key, default):
            v = sub.get(key)
            return int(v) if v not in (None, "") else default

        return cls(
            enabled=(sub.get_or_else("enabled", "true") or "").lower()
            != "false",
            window_s=f("windowseconds", cls.window_s),
            cooldown_s=f("cooldownseconds", cls.cooldown_s),
            budget=i("budget", cls.budget),
            min_depth=i("mindepth", cls.min_depth),
            max_depth=i("maxdepth", cls.max_depth),
            stall_high_ms=f("stallhighms", cls.stall_high_ms),
            stall_low_ms=f("stalllowms", cls.stall_low_ms),
            backlog_high=f("backloghigh", cls.backlog_high),
            saturation_high=f("saturationhigh", cls.saturation_high),
            lag_high_ms=f("laghighms", cls.lag_high_ms),
            malformed_high=f("malformedhigh", cls.malformed_high),
            max_replicas=i("maxreplicas", cls.max_replicas),
            min_poll_fraction=f("minpollfraction", cls.min_poll_fraction),
        )


@dataclass
class SignalSnapshot:
    """One evaluation window's observed state — everything ``decide``
    is allowed to look at, and exactly what the ``pilot/decide`` span
    records (so the replay CLI sees what the live controller saw)."""

    now: float = 0.0
    stall_ms: float = 0.0           # HealthState smoothed stall EWMA
    backlog: float = 0.0            # pending background landings
    source_lag_ms: float = 0.0      # wall clock - event-time watermark
    saturation: float = 0.0         # fraction of polls that came back full
    malformed_ratio: float = 0.0    # malformed/total rows this window
    depth: int = 1                  # live pipeline depth
    tokens: float = 0.0             # backpressure bucket balance
    rate_fraction: float = 1.0      # bucket refill rate / base rate
    replicas: int = 1
    batches: int = 0                # batches finished in the window
    alert_actions: tuple = ()       # actions requested by firing rules

    def to_props(self) -> Dict[str, object]:
        out = {}
        for fld in fields(self):
            v = getattr(self, fld.name)
            out[fld.name] = (
                round(v, 3) if isinstance(v, float) else
                list(v) if isinstance(v, tuple) else v
            )
        return out

    @classmethod
    def from_props(cls, props: Dict[str, object]) -> "SignalSnapshot":
        names = {f.name for f in fields(cls)}
        kw = {k: v for k, v in (props or {}).items() if k in names}
        if isinstance(kw.get("alert_actions"), list):
            kw["alert_actions"] = tuple(kw["alert_actions"])
        return cls(**kw)


@dataclass
class Decision:
    """One intended actuation: the rule that fired and its argument."""

    rule: str
    action: str          # one of ACTION_KINDS
    value: object = None  # target depth / replica count / rate factor
    applied: bool = False
    suppressed: Optional[str] = None  # "budget" | "cooldown" | "unactuated"


def decide(snap: SignalSnapshot, cfg: PilotConfig) -> List[Decision]:
    """The decision table: snapshot in, intended actuations out.

    Ordered by safety: load-shedding first (backpressure, depth down),
    recovery and scale-out after — the per-window budget then applies
    the most protective subset first. PURE: no clocks, no state — the
    same snapshot always yields the same decisions (the replay
    contract, and what makes the table unit-testable row by row).
    Hysteresis lives in the thresholds (``stall_high_ms`` ≫
    ``stall_low_ms``) and in the controller's cooldowns, not here.
    """
    out: List[Decision] = []
    alert_votes = set(snap.alert_actions or ())

    # 1. sink/landing pressure -> engage source backpressure
    if snap.backlog >= cfg.backlog_high or "backpressure" in alert_votes:
        out.append(Decision(
            rule=(
                "alert-requested-backpressure"
                if snap.backlog < cfg.backlog_high else
                "landing-backlog-backpressure"
            ),
            action="backpressure", value=0.5,
        ))

    # 2. malformed-input flood -> shrink polls (don't burn batch
    # capacity decoding garbage at full rate)
    if snap.malformed_ratio >= cfg.malformed_high:
        out.append(Decision(
            rule="malformed-flood-backpressure",
            action="backpressure", value=0.5,
        ))

    # 3. sustained stall -> the window is saturated past the device;
    # shrink it (the sized transfer's EWMA sizing, for the whole pipeline)
    if snap.stall_ms > cfg.stall_high_ms and snap.depth > cfg.min_depth:
        out.append(Decision(
            rule="stall-high-depth-down",
            action="depth-down", value=snap.depth - 1,
        ))

    # 4. drained and healthy -> release backpressure
    if (
        snap.rate_fraction < 1.0
        and snap.backlog <= 0
        and snap.malformed_ratio < cfg.malformed_high
        and snap.stall_ms < cfg.stall_high_ms
    ):
        out.append(Decision(
            rule="drained-backpressure-release",
            action="backpressure-release", value=2.0,
        ))

    # 5. ingest saturated with an idle device -> deepen the window for
    # more overlap before asking for more hardware
    if (
        snap.saturation >= cfg.saturation_high
        and snap.stall_ms < cfg.stall_low_ms
        and snap.backlog <= 0
        and snap.rate_fraction >= 1.0
        and snap.depth < cfg.max_depth
    ):
        out.append(Decision(
            rule="saturated-depth-up",
            action="depth-up", value=snap.depth + 1,
        ))

    # 6. sustained lag the pipeline can't absorb -> scale out (the
    # admission gate still vets the submit)
    if (
        (
            snap.source_lag_ms > cfg.lag_high_ms
            or (
                snap.saturation >= cfg.saturation_high
                and snap.depth >= cfg.max_depth
            )
            or "rescale-up" in alert_votes
        )
        and snap.replicas < cfg.max_replicas
        and snap.rate_fraction >= 1.0  # never scale while load-shedding
    ):
        out.append(Decision(
            rule="sustained-lag-rescale-up",
            action="rescale-up", value=snap.replicas + 1,
        ))

    # 7. lag drained with replicas to spare -> scale back in
    if (
        snap.replicas > 1
        and snap.source_lag_ms < cfg.lag_high_ms / 4.0
        and snap.saturation < cfg.saturation_high / 2.0
        and snap.backlog <= 0
    ):
        out.append(Decision(
            rule="lag-drained-rescale-down",
            action="rescale-down", value=snap.replicas - 1,
        ))
    return out


# ---------------------------------------------------------------------------
# Actuators
# ---------------------------------------------------------------------------
class Actuator:
    """Typed actuation surface: ``kinds`` names the ACTION_KINDS this
    actuator serves; ``apply`` performs one bounded change and returns
    True when anything actually changed (a no-op apply does not spend
    budget)."""

    kinds: tuple = ()
    name = "actuator"

    def apply(self, decision: Decision) -> bool:
        raise NotImplementedError


def _weak_method(method, dead_value):
    """``method`` called through a weak reference to its object; once
    the object is gone the call returns ``dead_value``."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        bound = ref()
        return dead_value if bound is None else bound(*args)

    return call


class DepthActuator(Actuator):
    """Pipeline depth within ``[min_depth, max_depth]``. The setter
    (``StreamingHost.request_depth``) only RECORDS the target; the
    dispatch loop applies it at the window boundary by draining the
    in-flight FIFO down to the new depth first, so strict-FIFO commit
    and whole-window requeue are untouched by a resize."""

    kinds = ("depth-down", "depth-up")
    name = "depth"

    def __init__(self, get_depth: Callable[[], int],
                 set_depth: Callable[[int], None],
                 min_depth: int = 1, max_depth: int = 8):
        self.get_depth = get_depth
        self.set_depth = set_depth
        self.min_depth = min_depth
        self.max_depth = max_depth

    def apply(self, decision: Decision) -> bool:
        target = max(self.min_depth, min(self.max_depth, int(decision.value)))
        if target == self.get_depth():
            return False
        self.set_depth(target)
        decision.value = target
        return True


class BackpressureActuator(Actuator):
    """Source admission through the ``TokenBucket`` the ingestor
    consults: ``backpressure`` halves the refill rate (floored),
    ``backpressure-release`` doubles it back toward base."""

    kinds = ("backpressure", "backpressure-release")
    name = "backpressure"

    def __init__(self, bucket: TokenBucket):
        self.bucket = bucket

    def apply(self, decision: Decision) -> bool:
        before = self.bucket.rate
        if decision.action == "backpressure":
            after = self.bucket.throttle(float(decision.value or 0.5))
        else:
            after = self.bucket.recover(float(decision.value or 2.0))
        decision.value = round(after / self.bucket.base_rate, 4)
        return after != before


class ScaleActuator(Actuator):
    """Replica scale-out/in through ``JobOperation.rescale`` — the
    SAME path the REST surface uses, so the fleet admission gate vets
    every scale-up and the ``PlacementReplanner`` refreshes placement
    after every change. A rejected scale-up (``FleetAdmissionError``)
    is a no-op here: the fleet said no, and retrying won't change it
    until capacity frees."""

    kinds = ("rescale-up", "rescale-down")
    name = "rescale"

    def __init__(self, job_ops, job_name: str, max_replicas: int = 4):
        self.job_ops = job_ops
        self.job_name = job_name
        self.max_replicas = max_replicas

    def apply(self, decision: Decision) -> bool:
        target = max(1, min(self.max_replicas, int(decision.value)))
        try:
            records = self.job_ops.rescale(self.job_name, target)
        except Exception as e:  # noqa: BLE001 — admission reject / client err
            logger.warning("pilot rescale to %d rejected: %s", target, e)
            decision.suppressed = f"rejected: {e}"
            return False
        decision.value = len(records)
        return True


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------
class PilotController:
    """One per host (or one per replayed trace). Call ``tick()`` from
    the batch loop; every ``window_s`` it snapshots signals, runs the
    decision table, applies the budget/cooldown-bounded subset through
    the actuators, traces everything, and exports the ``Pilot_*``
    series."""

    def __init__(
        self,
        config: PilotConfig,
        flow: str = "",
        health=None,
        store=None,
        alerts=None,
        tracer=None,
        metric_logger=None,
        bucket: Optional[TokenBucket] = None,
        actuators: Optional[List[Actuator]] = None,
        now_fn=time.time,
    ):
        self.config = config
        self.flow = flow
        self.health = health
        self.store = store
        self.alerts = alerts
        self.tracer = tracer
        self.metric_logger = metric_logger
        self.bucket = bucket
        self.now = now_fn
        self.actuators: Dict[str, Actuator] = {}
        for a in (actuators or []):
            for kind in a.kinds:
                self.actuators[kind] = a
        # window accounting
        self._last_eval: Optional[float] = None
        self._window_batches_base = 0
        # host-fed poll signals, smoothed per poll (EWMAs, like the
        # stall gauge — no window reset, so an evaluation can never
        # blind the next one to a sustained condition)
        self._saturation = 0.0
        self._malformed_ewma = 0.0
        # anti-flap state: family -> (last actuation time, last action)
        self._last_act: Dict[str, tuple] = {}
        # totals
        self.actuations_count = 0
        self.suppressed_count = 0
        self.decisions: List[Decision] = []  # last window's decisions
        self.replicas = 1
        self._depth_probe: Callable[[], int] = lambda: 1

    # -- construction ------------------------------------------------------
    @classmethod
    def from_conf(cls, dict_, host) -> Optional["PilotController"]:
        """Build from ``datax.job.process.pilot.*`` for a
        ``StreamingHost``; None when disabled. Default ON: every host
        runs piloted unless the conf (or designer ``jobPilot`` knob)
        says otherwise."""
        sub = dict_.get_sub_dictionary("datax.job.process.pilot.")
        cfg = PilotConfig.from_setting_dictionary(sub)
        if not cfg.enabled:
            return None
        bucket = TokenBucket(
            base_rate=max(1.0, host.max_rate / max(host.interval_s, 1e-3)),
            min_fraction=cfg.min_poll_fraction,
        )
        # the host holds the pilot, so the pilot holds the host's methods
        # weakly: a stopped host (and the device tensors of its
        # processor) is freed by reference counting, not at the cyclic
        # collector's next run
        live_depth = _weak_method(host.live_depth, 1)
        actuators: List[Actuator] = [
            DepthActuator(
                get_depth=live_depth,
                set_depth=_weak_method(host.request_depth, None),
                min_depth=cfg.min_depth,
                max_depth=cfg.max_depth,
            ),
            BackpressureActuator(bucket),
        ]
        pilot = cls(
            cfg,
            flow=dict_.get_job_name(),
            health=host.health,
            store=host.metric_logger.store,
            tracer=host.tracer,
            metric_logger=host.metric_logger,
            alerts=host.alerts,
            bucket=bucket,
            actuators=actuators,
        )
        pilot._depth_probe = live_depth
        return pilot

    # -- host feed ---------------------------------------------------------
    def admit_events(self, requested: int) -> int:
        """The ingestor's admission point. Pass-through until the pilot
        has actually engaged backpressure (rate below base) — an
        unpaced loop must never be starved by its own poll cadence —
        then the token bucket meters polls until release."""
        if self.bucket is None or not self.bucket.engaged:
            return requested
        return self.bucket.take(requested)

    # EWMA weight for the per-poll signals (matches the stall gauge's
    # posture: recent polls dominate, one poll can't flip a rule)
    POLL_EWMA_ALPHA = 0.3

    def observe_poll(self, requested: int, received: int,
                     malformed: int = 0) -> None:
        """Per-poll accounting from the host: how full polls come back
        (saturation — sustained full polls mean producers outpace us)
        and how much of the stream is garbage (malformed-flood
        signal). Both smoothed, never reset."""
        a = self.POLL_EWMA_ALPHA
        full = 1.0 if received >= requested > 0 else 0.0
        self._saturation = a * full + (1.0 - a) * self._saturation
        ratio = max(0, malformed) / max(1, received + max(0, malformed))
        self._malformed_ewma = a * ratio + (1.0 - a) * self._malformed_ewma

    # -- signals -----------------------------------------------------------
    def read_signals(self, now: Optional[float] = None) -> SignalSnapshot:
        now = self.now() if now is None else now
        stall = 0.0
        lag = 0.0
        batches = 0
        if self.health is not None:
            # the SAME smoothed gauge /readyz judges (conf'd EWMA
            # half-life observability.stallewmams) — controller and
            # readiness probe agree on "stalled" by construction
            stall = float(self.health.pipeline_stall_ms or 0.0)
            lag = float(self.health.source_lag_ms(now) or 0.0)
            batches = (
                self.health.batches_processed - self._window_batches_base
            )
        backlog = 0.0
        if self.store is not None:
            key = f"DATAX-{self.flow}:Transfer_Background_Pending"
            pts = self.store.points(
                key, (now - self.config.window_s) * 1000.0, now * 1000.0
            ) or self.store.points(key)
            vals = [
                float(p["val"]) for p in pts[-8:]
                if isinstance(p.get("val"), (int, float))
            ]
            if vals:
                backlog = max(vals)
        actions = ()
        if self.alerts is not None:
            actions = tuple(sorted({
                r.get("action") for r in self.alerts.rules
                if r.get("action")
                and any(
                    f["name"] == r["name"] for f in self.alerts.firing()
                )
            }))
        return SignalSnapshot(
            now=now,
            stall_ms=stall,
            backlog=backlog,
            source_lag_ms=lag,
            saturation=self._saturation,
            malformed_ratio=self._malformed_ewma,
            depth=int(self._depth_probe()),
            tokens=self.bucket.tokens() if self.bucket else 0.0,
            rate_fraction=(
                self.bucket.rate_fraction() if self.bucket else 1.0
            ),
            replicas=self.replicas,
            batches=batches,
            alert_actions=actions,
        )

    # -- the loop ----------------------------------------------------------
    def tick(self, now: Optional[float] = None,
             batch_time_ms: Optional[int] = None) -> Optional[List[Decision]]:
        """Call from the batch loop after every iteration; evaluates at
        most once per ``window_s``. Returns the window's decisions when
        an evaluation ran, else None."""
        now = self.now() if now is None else now
        if self._last_eval is None:
            # arm the first window — never actuate on a cold snapshot
            self._last_eval = now
            if self.health is not None:
                self._window_batches_base = self.health.batches_processed
            return None
        if now - self._last_eval < self.config.window_s:
            return None
        return self.evaluate(now, batch_time_ms=batch_time_ms)

    def evaluate(self, now: Optional[float] = None,
                 batch_time_ms: Optional[int] = None) -> List[Decision]:
        """One full pass: snapshot -> decide -> bound -> actuate ->
        trace -> export. Safe to call directly (tests, replay)."""
        now = self.now() if now is None else now
        snap = self.read_signals(now)
        decisions = self.apply(decide(snap, self.config), snap, now)
        self._last_eval = now
        if self.health is not None:
            self._window_batches_base = self.health.batches_processed
        self.decisions = decisions
        self._export(snap, batch_time_ms)
        return decisions

    def apply(self, decisions: List[Decision], snap: SignalSnapshot,
              now: float) -> List[Decision]:
        """Bound and actuate: per-window budget, per-family cooldown
        (doubled against direction flips), every outcome traced as a
        ``pilot/decide`` span whether applied or suppressed."""
        trace = None
        if self.tracer is not None:
            trace = self.tracer.begin("pilot/evaluate", **snap.to_props())
        applied = 0
        try:
            for d in decisions:
                family = _FAMILY.get(d.action, d.action)
                actuator = self.actuators.get(d.action)
                if actuator is None:
                    d.suppressed = "unactuated"
                elif applied >= self.config.budget:
                    d.suppressed = "budget"
                else:
                    last = self._last_act.get(family)
                    cooldown = self.config.cooldown_s
                    if last is not None:
                        last_t, last_action = last
                        if last_action != d.action:
                            cooldown *= 2.0  # direction flip: wait longer
                        if now - last_t < cooldown:
                            d.suppressed = "cooldown"
                    if d.suppressed is None:
                        if actuator.apply(d):
                            d.applied = True
                            applied += 1
                            self.actuations_count += 1
                            self._last_act[family] = (now, d.action)
                            if d.action.startswith("rescale") and isinstance(
                                d.value, int
                            ):
                                self.replicas = max(1, d.value)
                if not d.applied and d.suppressed is None:
                    d.suppressed = "noop"
                if d.suppressed in ("budget", "cooldown"):
                    self.suppressed_count += 1
                if trace is not None:
                    with trace.span(
                        "pilot/decide",
                        rule=d.rule, action=d.action, value=d.value,
                        applied=d.applied, suppressed=d.suppressed,
                        **snap.to_props(),
                    ):
                        pass
                logger.info(
                    "pilot %s: rule=%s action=%s value=%s%s",
                    "actuated" if d.applied else "held",
                    d.rule, d.action, d.value,
                    "" if d.applied else f" ({d.suppressed})",
                )
        finally:
            if trace is not None:
                trace.end(decisions=len(decisions), applied=applied)
        return decisions

    # -- export ------------------------------------------------------------
    def _export(self, snap: SignalSnapshot,
                batch_time_ms: Optional[int]) -> None:
        if self.metric_logger is None:
            return
        try:
            self.metric_logger.send_batch_metrics({
                "Pilot_Actuations_Count": float(self.actuations_count),
                "Pilot_Suppressed_Count": float(self.suppressed_count),
                "Pilot_Depth": float(snap.depth),
                "Pilot_Backpressure_Tokens": float(snap.tokens),
            }, batch_time_ms)
        except Exception:  # noqa: BLE001 — metrics must not fail the loop
            logger.exception("pilot metric export failed")

    # -- offline -----------------------------------------------------------
    def replay(self, snapshots: List[SignalSnapshot]) -> List[List[Decision]]:
        """Re-run the decision loop over recorded snapshots with the
        same budget/cooldown state machine but NO live actuators — the
        offline debugging story (``__main__ --replay``). Actuations
        that would have fired are marked applied."""
        out: List[List[Decision]] = []
        for snap in snapshots:
            decisions = decide(snap, self.config)
            now = snap.now
            applied = 0
            for d in decisions:
                family = _FAMILY.get(d.action, d.action)
                if applied >= self.config.budget:
                    d.suppressed = "budget"
                    continue
                last = self._last_act.get(family)
                cooldown = self.config.cooldown_s
                if last is not None:
                    if last[1] != d.action:
                        cooldown *= 2.0
                    if now - last[0] < cooldown:
                        d.suppressed = "cooldown"
                        continue
                d.applied = True
                applied += 1
                self.actuations_count += 1
                self._last_act[family] = (now, d.action)
            out.append(decisions)
        return out
