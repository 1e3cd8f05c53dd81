"""The port's autopilot, the mirror of the host-facing cases of
``test_pilot.py`` on ``data_accelerator_tpu_torch``: the controller's
budget and cooldown bounds, the depth and backpressure actuators, the
token bucket, the conf plumbing, and on a live ``StreamingHost`` (on the
CPU) the depth retarget through ``request_depth`` and the token bucket
metering its polls. The decision-table rows, the alert-rule action
field and the replay CLI (``pilot/__main__.py``, not ported) stay in
``test_pilot.py``."""

import functools
import json

import pytest

from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.pilot import (
    BackpressureActuator,
    Decision,
    DepthActuator,
    PilotConfig,
    PilotController,
    ScaleActuator,
    SignalSnapshot,
    TokenBucket,
    decide,
)
from data_accelerator_tpu_torch.runtime import host as host_mod

# the tests ask for the CPU; the entry points default to the card
StreamingHost = functools.partial(host_mod.StreamingHost, device="cpu")


def _controller(cfg=None, **kw):
    cfg = cfg or PilotConfig(window_s=1.0, cooldown_s=10.0, budget=2)
    depth = {"d": 4}
    ctl = PilotController(
        cfg,
        actuators=[
            DepthActuator(
                lambda: depth["d"],
                lambda v: depth.update(d=v),
                max_depth=cfg.max_depth,
            ),
        ],
        **kw,
    )
    ctl._depth_probe = lambda: depth["d"]
    return ctl, depth


class TestControllerBounds:
    def test_budget_caps_applied_actuations(self):
        cfg = PilotConfig(budget=1, cooldown_s=0.0)
        bucket = TokenBucket(base_rate=100.0)
        depth = {"d": 4}
        ctl = PilotController(cfg, bucket=bucket, actuators=[
            DepthActuator(lambda: depth["d"], lambda v: depth.update(d=v)),
            BackpressureActuator(bucket),
        ])
        snap = SignalSnapshot(
            stall_ms=cfg.stall_high_ms + 1, backlog=cfg.backlog_high,
            depth=4,
        )
        ds = ctl.apply(decide(snap, cfg), snap, now=100.0)
        assert sum(d.applied for d in ds) == 1
        assert [d.suppressed for d in ds if not d.applied] == ["budget"]
        assert ctl.actuations_count == 1
        assert ctl.suppressed_count == 1

    def test_cooldown_suppresses_within_family(self):
        cfg = PilotConfig(budget=4, cooldown_s=10.0)
        ctl, depth = _controller(cfg)
        snap = SignalSnapshot(stall_ms=cfg.stall_high_ms + 1, depth=4)
        ds1 = ctl.apply(decide(snap, cfg), snap, now=100.0)
        assert ds1[0].applied and depth["d"] == 3
        snap2 = SignalSnapshot(stall_ms=cfg.stall_high_ms + 1, depth=3)
        ds2 = ctl.apply(decide(snap2, cfg), snap2, now=105.0)  # < 10s later
        assert not ds2[0].applied and ds2[0].suppressed == "cooldown"
        assert depth["d"] == 3
        ds3 = ctl.apply(decide(snap2, cfg), snap2, now=111.0)  # elapsed
        assert ds3[0].applied and depth["d"] == 2

    def test_direction_flip_waits_doubled_cooldown(self):
        cfg = PilotConfig(budget=4, cooldown_s=10.0)
        ctl, depth = _controller(cfg)
        down = SignalSnapshot(stall_ms=cfg.stall_high_ms + 1, depth=4)
        ctl.apply(decide(down, cfg), down, now=100.0)
        assert depth["d"] == 3
        up = SignalSnapshot(saturation=1.0, stall_ms=0.0, depth=3)
        # ordinary cooldown elapsed, flip cooldown (2x) has not
        ds = ctl.apply(decide(up, cfg), up, now=112.0)
        assert not ds[0].applied and ds[0].suppressed == "cooldown"
        ds = ctl.apply(decide(up, cfg), up, now=121.0)
        assert ds[0].applied and depth["d"] == 4

    def test_no_flap_under_oscillating_signal(self):
        """The no-flap property: a signal oscillating between
        stall-high and saturated-idle every window must not drag depth
        up and down with it — direction flips are separated by at
        least the doubled cooldown, so at most one flip lands per
        2*cooldown_s."""
        cfg = PilotConfig(budget=4, cooldown_s=10.0, window_s=1.0)
        ctl, depth = _controller(cfg)
        changes = []
        t = 100.0
        for i in range(40):  # 40 windows, signal flips every window
            if i % 2 == 0:
                snap = SignalSnapshot(
                    stall_ms=cfg.stall_high_ms + 1, depth=depth["d"],
                )
            else:
                snap = SignalSnapshot(
                    saturation=1.0, stall_ms=0.0, depth=depth["d"],
                )
            before = depth["d"]
            ctl.apply(decide(snap, cfg), snap, now=t)
            if depth["d"] != before:
                changes.append((t, depth["d"] - before))
            t += cfg.window_s
        flips = [
            (t2, d2) for (t1, d1), (t2, d2) in zip(changes, changes[1:])
            if (d1 > 0) != (d2 > 0)
        ]
        for (t1, _), (t2, _) in zip(changes, changes[1:]):
            assert t2 - t1 >= cfg.cooldown_s
        for t1, _ in flips:
            prev = max(t for t, _ in changes if t < t1)
            assert t1 - prev >= 2.0 * cfg.cooldown_s
        # and the loop does not amplify: 40 oscillations, few changes
        assert len(changes) <= 4

    def test_noop_apply_spends_no_budget(self):
        cfg = PilotConfig(budget=1, cooldown_s=0.0)
        ctl, depth = _controller(cfg)
        depth["d"] = 1
        # decision targets the current depth -> actuator reports no-op
        snap = SignalSnapshot(depth=1)
        ds = ctl.apply(
            [Decision(rule="synthetic", action="depth-down", value=1)],
            snap, now=100.0,
        )
        assert not ds[0].applied and ds[0].suppressed == "noop"
        assert ctl.actuations_count == 0

    def test_unactuated_kind_is_marked(self):
        ctl, _ = _controller()
        snap = SignalSnapshot()
        ds = ctl.apply(
            [Decision(rule="synthetic", action="rescale-up", value=2)],
            snap, now=100.0,
        )
        assert ds[0].suppressed == "unactuated"

    def test_tick_arms_then_respects_window(self):
        cfg = PilotConfig(window_s=5.0, cooldown_s=0.0)
        ctl, _ = _controller(cfg)
        now = [100.0]
        ctl.now = lambda: now[0]
        assert ctl.tick() is None          # first tick only arms
        now[0] += 2.0
        assert ctl.tick() is None          # window not elapsed
        now[0] += 4.0
        assert ctl.tick() is not None      # 6s > window_s


# ---------------------------------------------------------------------------
# actuators
# ---------------------------------------------------------------------------
class TestActuators:
    def test_depth_actuator_clamps(self):
        depth = {"d": 4}
        act = DepthActuator(
            lambda: depth["d"], lambda v: depth.update(d=v),
            min_depth=1, max_depth=4,
        )
        d = Decision(rule="r", action="depth-up", value=99)
        assert act.apply(d) is False  # clamped to 4 == current: no-op
        d = Decision(rule="r", action="depth-down", value=-3)
        assert act.apply(d) is True
        assert depth["d"] == 1 and d.value == 1

    def test_scale_actuator_records_rejection(self):
        class RejectingOps:
            def rescale(self, name, n):
                raise RuntimeError("DX400 oversubscribed")

        act = ScaleActuator(RejectingOps(), "job", max_replicas=4)
        d = Decision(rule="r", action="rescale-up", value=2)
        assert act.apply(d) is False
        assert "DX400" in d.suppressed


# ---------------------------------------------------------------------------
# token bucket
# ---------------------------------------------------------------------------
class TestTokenBucket:
    def test_rejects_nonpositive_rate(self):
        with pytest.raises(ValueError):
            TokenBucket(base_rate=0)

    def test_passthrough_until_engaged(self):
        b = TokenBucket(base_rate=100.0)
        assert not b.engaged
        assert b.rate_fraction() == 1.0

    def test_throttle_floors_and_clamps_tokens(self):
        b = TokenBucket(base_rate=100.0, min_fraction=0.125)
        for _ in range(10):
            b.throttle()
        assert b.rate == pytest.approx(12.5)
        assert b.engaged
        # stored tokens clamped down with the rate (no stale burst);
        # the wall-clock refill between calls stays sub-token
        assert b.tokens() <= b.rate + 1.0

    def test_take_grants_at_least_one(self):
        b = TokenBucket(base_rate=100.0, now_fn=lambda: 0.0)
        b.throttle(1e-9)
        assert b.take(50) >= 1  # flow must keep moving to see drains

    def test_take_is_metered_by_refill(self):
        t = {"now": 0.0}
        b = TokenBucket(base_rate=100.0, now_fn=lambda: t["now"])
        b.throttle()  # rate 50/s, tokens clamped to 50
        assert b.take(1000) == 50
        t["now"] += 1.0  # one second refills 50
        assert b.take(1000) == 50

    def test_recover_returns_to_base(self):
        b = TokenBucket(base_rate=100.0)
        b.throttle()
        b.throttle()
        b.recover()
        b.recover()
        b.recover()
        assert b.rate == 100.0 and not b.engaged


# ---------------------------------------------------------------------------
# conf plumbing
# ---------------------------------------------------------------------------
class TestConf:
    def test_config_parses_flat_conf_keys(self):
        from data_accelerator_tpu_torch.core.config import SettingDictionary

        sub = SettingDictionary({
            "windowseconds": "2.5", "cooldownseconds": "30",
            "budget": "3", "maxdepth": "6", "stallhighms": "750",
            "maxreplicas": "8",
        })
        cfg = PilotConfig.from_setting_dictionary(sub)
        assert cfg.enabled
        assert cfg.window_s == 2.5
        assert cfg.cooldown_s == 30.0
        assert cfg.budget == 3
        assert cfg.max_depth == 6
        assert cfg.stall_high_ms == 750.0
        assert cfg.max_replicas == 8

    def test_config_disabled(self):
        from data_accelerator_tpu_torch.core.config import SettingDictionary

        sub = SettingDictionary({"enabled": "false"})
        assert not PilotConfig.from_setting_dictionary(sub).enabled

    def test_stall_ewma_half_life_conf(self):
        """Satellite: observability.stallewmams is a half-life in ms of
        batch time — after one half-life of batches a level shift
        covers half the distance; absent, the legacy alpha applies."""
        from data_accelerator_tpu_torch.obs.exposition import HealthState

        legacy = HealthState(flow="f", batch_interval_s=1.0)
        assert legacy.stall_ewma_alpha == HealthState.STALL_EWMA_ALPHA

        h = HealthState(
            flow="f", batch_interval_s=1.0,
            stall_ewma_half_life_ms=1000.0,  # one batch per half-life
        )
        assert h.stall_ewma_alpha == pytest.approx(0.5)
        h.record_stall(100.0)  # first sample seeds the gauge
        assert h.pipeline_stall_ms == pytest.approx(100.0)
        h.record_stall(0.0)    # one half-life covers half the distance
        assert h.pipeline_stall_ms == pytest.approx(50.0)
        h.record_stall(0.0)
        assert h.pipeline_stall_ms == pytest.approx(25.0)

    def test_snapshot_props_round_trip(self):
        snap = SignalSnapshot(
            now=12.5, stall_ms=300.125, backlog=2.0, depth=3,
            alert_actions=("backpressure",), replicas=2,
        )
        back = SignalSnapshot.from_props(
            json.loads(json.dumps(snap.to_props()))
        )
        assert back.stall_ms == pytest.approx(snap.stall_ms)
        assert back.depth == 3
        assert back.alert_actions == ("backpressure",)
        # unknown props are ignored, not fatal (forward compat)
        assert SignalSnapshot.from_props({"depth": 2, "novel": 1}).depth == 2


# ---------------------------------------------------------------------------
# the pilot on a live host
# ---------------------------------------------------------------------------
SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
]})


def _host(tmp_path, name, extra=None):
    t = tmp_path / "t.transform"
    t.write_text("--DataXQuery--\nOut = SELECT k, v FROM DataXProcessedInput\n")
    conf = {
        "datax.job.name": name,
        "datax.job.input.default.inputtype": "local",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.input.default.eventhub.maxrate": "64",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.transform": str(t),
        "datax.job.process.batchcapacity": "64",
        "datax.job.process.pipeline.depth": "4",
        # no evaluation window elapses in a test: only the test actuates
        "datax.job.process.pilot.windowseconds": "3600",
        "datax.job.output.Out.console.maxrows": "0",
    }
    conf.update(extra or {})
    return StreamingHost(SettingDictionary(conf))


def test_host_is_piloted_by_default_and_depth_retargets_at_the_window(tmp_path):
    """The pilot is on by default; its depth actuator drives the host
    through ``live_depth``/``request_depth``, and ``run_pipelined``
    applies a retarget at the window boundary."""
    host = _host(tmp_path, "PilotDepth")
    try:
        assert host.pilot is not None
        depth_act = host.pilot.actuators["depth-down"]
        assert host.live_depth() == 4
        d = Decision(rule="r", action="depth-down", value=2)
        assert depth_act.apply(d) is True
        assert host.live_depth() == 2  # the pending target
        seen = []
        send = host.metric_logger.send_batch_metrics
        host.metric_logger.send_batch_metrics = (
            lambda m, ts: (seen.append(m["Pipeline_Depth"]), send(m, ts)))
        host.run_pipelined(max_batches=6)
        assert host._live_depth == 2 and host.live_depth() == 2
        assert host.batches_processed == 6
        # a finish retires the oldest of depth + 1 batches in flight
        assert max(seen) == 3.0  # depth 2, not the conf's 4
    finally:
        host.stop()


def test_pilot_token_bucket_meters_host_polls(tmp_path):
    """Once the backpressure actuator engages the token bucket, the
    host's polls ask for what the bucket grants, not the whole batch."""
    host = _host(tmp_path, "PilotBucket", {
        "datax.job.process.pipeline.depth": "1",
    })
    try:
        bucket = host.pilot.bucket
        assert not bucket.engaged
        m = host.run_batch()
        assert m["Input_DataXProcessedInput_Events_Count"] == 64.0
        bp = host.pilot.actuators["backpressure"]
        for _ in range(4):
            bp.apply(Decision(rule="r", action="backpressure", value=0.5))
        assert bucket.engaged and bucket.rate < bucket.base_rate
        bucket._tokens = 5.0  # a drained bucket: five events' worth
        polls = []
        poll = host.source.poll_columns
        host.source.poll_columns = lambda n, d: (polls.append(n), poll(n, d))[1]
        host.run_batch()
        assert polls and polls[0] < 64
    finally:
        host.stop()
