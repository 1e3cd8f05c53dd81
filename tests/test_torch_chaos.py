"""The chaos drills of ``tests/test_chaos.py`` on the port's host, beside
the JAX package's: the port's ``serve/scenarios.py`` ``chaos_*`` drills
against the JAX package's ``serve/scenarios.py`` on the same events.

Each of the five faults (preemption mid-window, sink outage, hot-key
skew, malformed flood, rescale with state), pilot off and on, at depth
2 with the buffer sanitizer and the protocol monitor armed, on the CPU
at the reference's sizes (4 events a poll). The port's drill must
deliver every event exactly once, with 0 poison hits and 0 protocol
violations, and (pilot on) the fault's actuation; its witness rows
(``Out``) equal the JAX host's on the same events: ints exactly, floats
within rtol 1e-5.
"""

import pytest

import chip_smoke
from data_accelerator_tpu.serve.scenario import ScenarioContext
from data_accelerator_tpu.serve.scenarios import (
    chaos_hot_key_skew,
    chaos_suite,
    chaos_malformed_flood,
    chaos_preemption,
    chaos_rescale_with_state,
    chaos_sink_outage,
)
from data_accelerator_tpu_torch.pilot.chaos import RecordingRescaler
from data_accelerator_tpu_torch.pilot.controller import Decision, ScaleActuator
from data_accelerator_tpu_torch.serve import scenarios as port_scenarios

JAX_DRILLS = {
    "preemption": chaos_preemption,
    "sink-outage": chaos_sink_outage,
    "hot-key-skew": chaos_hot_key_skew,
    "malformed-flood": chaos_malformed_flood,
    "rescale-state": chaos_rescale_with_state,
}
ACTUATION = {
    "preemption": "rescale-up",
    "sink-outage": "backpressure",
    "hot-key-skew": "depth-down",
    "malformed-flood": "backpressure",
    "rescale-state": "rescale-up",
}


PORT_DRILLS = {
    "preemption": port_scenarios.chaos_preemption,
    "sink-outage": port_scenarios.chaos_sink_outage,
    "hot-key-skew": port_scenarios.chaos_hot_key_skew,
    "malformed-flood": port_scenarios.chaos_malformed_flood,
    "rescale-state": port_scenarios.chaos_rescale_with_state,
}


def _run(drills, fault, pilot, tmp_path, **kw):
    """One package's drill, run to its end; returns its context."""
    import logging

    logging.disable(logging.ERROR)
    try:
        scenario = drills[fault](pilot=pilot, depth=2, **kw)
        ctx = ScenarioContext({"workdir": str(tmp_path)})
        result = scenario.run(ctx)
    finally:
        logging.disable(logging.NOTSET)
    assert result.success, (result.failed_step,
                            "".join(s.error or "" for s in result.steps))
    return ctx


def _rows(ctx):
    return [r for sink in ctx["sinks"] for _t, rows in sink.batches for r in rows]


def _flow(fault):
    """The reference drills' own flow and sizes, on the CPU."""
    return (port_scenarios.state_drill_flow(device="cpu") if fault == "rescale-state"
            else port_scenarios.DrillFlow(device="cpu"))


@pytest.mark.parametrize("pilot", [False, True], ids=["pilot-off", "pilot-on"])
@pytest.mark.parametrize("fault", chip_smoke.CHAOS_FAULTS)
def test_drill_delivers_the_jax_hosts_rows(fault, pilot, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ctx = _run(PORT_DRILLS, fault, pilot, tmp_path / "port", flow=_flow(fault))
    hosts = ctx["hosts"]
    assert sum(h.processor.buffer_sanitizer.poison_hits for h in hosts) == 0
    assert sum(h.protocol_monitor.violations for h in hosts) == 0
    assert sum(h.protocol_monitor.batches_sealed for h in hosts) > 0
    assert ctx.get("actuations", []) == ([ACTUATION[fault]] if pilot else [])
    if pilot:
        assert any(h.pilot is not None and h.pilot.actuations_count > 0
                   for h in hosts)
    else:
        assert all(h.pilot is None for h in hosts)
    got = sorted(_rows(ctx), key=lambda r: r["seq"])
    want = sorted(_rows(_run(JAX_DRILLS, fault, pilot, tmp_path / "jax")),
                  key=lambda r: r["seq"])
    assert [r["seq"] for r in got] == [r["seq"] for r in want] == list(range(ctx["n_events"]))
    assert [r["k"] for r in got] == [r["k"] for r in want]
    assert [r["v"] for r in got] == pytest.approx([r["v"] for r in want], rel=1e-5)


def test_drills_count_every_event_of_their_payload():
    """The drills' event counts are the reference's at 4 events a poll,
    and scale with the poll (the card runs them at a batch a poll)."""
    assert port_scenarios.DrillFlow().poll == 4
    assert port_scenarios.DrillFlow().events("preemption", 8) == 32
    flow = chip_smoke.chaos_main_flow(poll=64, device="cpu")
    assert flow.events("preemption", 8) == 512
    line = chip_smoke.iot_chaos_line({"k": 3, "v": 12.5, "seq": 7})
    assert '"deviceId":4' in line and '"seq":7' in line
    rows = [{"k": i % 4, "v": float(i), "seq": i} for i in range(5)]
    assert flow.payload(rows).count(b"\n") == 5
    flood = flow.malformed(rows, flood_ratio=0.5)
    assert flood.count(b'"seq":') == 5 and b'{"k": ' not in flood


@pytest.mark.parametrize("pilot", [False, True], ids=["pilot-off", "pilot-on"])
def test_chaos_suite_is_the_references_matrix_on_its_device(pilot, tmp_path):
    """``chaos_suite`` lists the JAX package's five drills in its order,
    and its ``device`` reaches every drill's host: the suite's malformed
    flood runs on the CPU."""
    suite = port_scenarios.chaos_suite(pilot=pilot, device="cpu")
    assert [sc.name for sc in suite] == [sc.name for sc in chaos_suite(pilot=pilot)]
    ctx = ScenarioContext({"workdir": str(tmp_path)})
    (flood,) = [sc for sc in suite if sc.name.startswith("ChaosMalformedFlood")]
    result = flood.run(ctx)
    assert result.success, (result.failed_step,
                            "".join(s.error or "" for s in result.steps))
    assert [str(h.processor.device) for h in ctx["hosts"]] == ["cpu"]


def test_scale_actuator_applies_through_a_recording_rescaler():
    """``test_pilot.py``'s chaos case: a scale-up through the recording
    stand-in is clamped to ``max_replicas`` and reports the live count."""
    ops = RecordingRescaler()
    act = ScaleActuator(ops, "job", max_replicas=3)
    d = Decision(rule="r", action="rescale-up", value=9)
    assert act.apply(d) is True
    assert ops.calls == [3]
    assert d.value == 3


def test_main_flow_drill_on_the_cpu(tmp_path):
    """The card's drill flow (the main path, the anomaly query and an
    event-id witness) at 64 events a poll: the malformed flood delivers
    every valid event once and the anomaly query's rows equal a plain
    run of the same events."""
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    flow = chip_smoke.chaos_main_flow(poll=64, device="cpu", udf=anomalyscore())
    ctx = chip_smoke.run_chaos_drill("malformed-flood", False, str(tmp_path), flow)
    assert ctx["events"] == 256
    assert sorted(r["seq"] for r in chip_smoke.chaos_rows(ctx)) == list(range(256))
    replay = chip_smoke.chaos_cpu_replay(flow, ctx["event_rows"])
    for out in ("OpenDoors", "AnomalyAlerts"):
        chip_smoke.same_multiset(chip_smoke.chaos_rows(ctx, out), replay[out], out)
