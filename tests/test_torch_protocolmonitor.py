"""The port's protocol monitor (``runtime/protocolmonitor.py``) and its
rule table (``analysis/protospec.py``) against the JAX package's: the
unit cases of ``test_protocheck.py`` on both packages, and the same
verdicts on every ordering of a batch tail's events. The port's host
records the JAX host's sequences batch for batch in
``test_torch_fleet.py``; its depth drills, armed, are in
``test_torch_recovery.py``."""

import itertools

import pytest

from data_accelerator_tpu.analysis import protospec as jspec
from data_accelerator_tpu.runtime import protocolmonitor as jmon
from data_accelerator_tpu_torch.analysis import protospec as tspec
from data_accelerator_tpu_torch.runtime import protocolmonitor as tmon

MODULES = {"jax": (jmon, jspec), "torch": (tmon, tspec)}


@pytest.fixture(params=sorted(MODULES))
def pkg(request):
    return MODULES[request.param]


def _well_ordered_batch(pm):
    pm.record("SINK_EMIT", detail="dispatcher.dispatch")
    pm.record("POINTER_FLIP", detail="processor.commit")
    pm.record("FIFO_ACK", source="default")
    pm.record("DURABLE_WRITE", detail="window_checkpointer.save")
    pm.record("STATE_PUSH", detail="push_window_partitions")
    pm.record("OFFSET_COMMIT", detail="checkpoint_batch")


def test_monitor_well_ordered_batch_seals_silent(pkg):
    pm = pkg[0].ProtocolMonitor()
    _well_ordered_batch(pm)
    assert pm.seal_batch(batch_time_ms=12.5) == 0
    assert pm.violations == 0
    assert pm.batches_sealed == 1
    assert pm.drain_events() == []
    # events flow every drain; the violation counter stays SILENT on
    # health
    assert pm.drain_metric_deltas() == {"Protocol_Events_Count": 6.0}
    assert pm.drain_metric_deltas() == {}


def test_monitor_ack_before_flip_on_failed_batch_fires_one_dx906(pkg):
    pm = pkg[0].ProtocolMonitor()
    pm.record("FIFO_ACK", source="default")
    pm.record("REQUEUE", source="default")
    assert pm.seal_batch(batch_time_ms=3.0, failed=True) == 1
    assert pm.violations == 1
    events = pm.drain_events()
    assert len(events) == 1
    ev = events[0]
    assert ev["code"] == "DX906"
    assert ev["rule"] == "DX900"
    assert ev["failed"] is True
    assert ev["sequence"] == ["FIFO_ACK", "REQUEUE"]
    assert "DX906" in ev["message"] and "DX900" in ev["message"]
    assert pm.drain_events() == []
    deltas = pm.drain_metric_deltas()
    assert deltas["Protocol_Violation_Count"] == 1.0
    assert deltas["Protocol_Events_Count"] == 2.0


def test_monitor_double_ack_same_source_is_dx902(pkg):
    pm = pkg[0].ProtocolMonitor()
    pm.record("POINTER_FLIP")
    pm.record("FIFO_ACK", source="default")
    pm.record("FIFO_ACK", source="default")
    assert pm.seal_batch() == 1
    (ev,) = pm.drain_events()
    assert ev["rule"] == "DX902"


def test_monitor_history_ring_keeps_sealed_linearizations(pkg):
    pm = pkg[0].ProtocolMonitor()
    _well_ordered_batch(pm)
    pm.seal_batch(batch_time_ms=1.0)
    recent = pm.recent_sequences()
    assert len(recent) == 1
    assert recent[0]["violations"] == []
    assert [e["kind"] for e in recent[0]["sequence"]][0] == "SINK_EMIT"
    # an empty tail (no events) seals to nothing — no phantom batches
    assert pm.seal_batch() == 0
    assert pm.batches_sealed == 1


def test_check_sequence_is_the_shared_rule_table(pkg):
    check_sequence = pkg[1].check_sequence
    ok = [{"kind": "SINK_EMIT"}, {"kind": "POINTER_FLIP"},
          {"kind": "FIFO_ACK", "source": "a"}]
    assert check_sequence(ok) == []
    bad = [{"kind": "FIFO_ACK", "source": "a"}, {"kind": "REQUEUE"}]
    assert [c for c, _ in check_sequence(bad, failed=True)] == ["DX900"]


def test_from_conf_arms_only_on_true(pkg):
    class _Dbg:
        def __init__(self, v):
            self.v = v

        def get_or_else(self, key, default):
            return self.v if key == "protocolmonitor" else default

    from_conf = pkg[0].from_conf
    assert isinstance(from_conf(_Dbg("true")), pkg[0].ProtocolMonitor)
    assert isinstance(from_conf(_Dbg("True")), pkg[0].ProtocolMonitor)
    assert from_conf(_Dbg("false")) is None
    assert from_conf(_Dbg(None)) is None


def test_rule_tables_are_equal():
    assert tspec.RULES == tuple(
        tspec.ProtocolRule(r.code, r.name, r.description, r.runtime) for r in jspec.RULES)
    assert tspec.EVENT_KINDS == jspec.EVENT_KINDS
    assert tspec.EFFECT_KINDS == jspec.EFFECT_KINDS
    assert [r.code for r in tspec.RUNTIME_RULES] == [r.code for r in jspec.RUNTIME_RULES]


# every ordering of a two-source tail's events, on a healthy and a failed batch
_TAIL = [("SINK_EMIT", ""), ("POINTER_FLIP", ""), ("FIFO_ACK", "a"),
         ("FIFO_ACK", "b"), ("REQUEUE", "a")]


@pytest.mark.parametrize("failed", [False, True])
def test_monitors_agree_on_every_ordering(failed):
    for order in itertools.permutations(_TAIL):
        seq = [{"kind": k, "source": s, "detail": ""} for k, s in order]
        assert tspec.check_sequence(seq, failed) == jspec.check_sequence(seq, failed)
        mons = [m.ProtocolMonitor() for m in (jmon, tmon)]
        for pm in mons:
            for k, s in order:
                pm.record(k, source=s)
            pm.seal_batch(7, failed=failed)
        (jm, tm) = mons
        assert tm.drain_events() == jm.drain_events()
        assert tm.drain_metric_deltas() == jm.drain_metric_deltas()
        assert tm.recent_sequences() == jm.recent_sequences()
