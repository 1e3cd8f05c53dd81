"""The DECLARED exactly-once delivery protocol (shared by the static
``--protocol`` tier and the runtime ``ProtocolMonitor``).

The engine's delivery guarantee is an ordering contract over a small
vocabulary of effect events:

    sink emit  ->  durable checkpoint / pointer flip  ->  FIFO ack
                                                     ->  offset commit

plus the rescale A/B handoff (pull the owned-partition plan before the
first successor dispatch) and the failure half (a failed batch requeues
its whole unacked window before re-raising). Until this module, that
contract existed only as hand-ordered statements in ``runtime/host.py``
/ ``runtime/checkpoint.py`` / ``runtime/statetable.py`` /
``serve/jobs.py``, sampled by chaos drills. Here it is a TABLE: the
static pass (``analysis/protocheck.py``, DX900-DX905) checks every
engine entry point's extracted effect trace against it, and the runtime
monitor (``runtime/protocolmonitor.py``, DX906) checks every live
batch's recorded linearization against the SAME rule objects via
``check_sequence``.

Event kinds
-----------
- ``SINK_EMIT``     — rows handed to external sinks (dispatcher fan-out)
- ``DURABLE_WRITE`` — bytes forced to stable storage (fsync / durable
  replace / local state-store file put / window snapshot save)
- ``POINTER_FLIP``  — the atomic commit point: an A/B pointer flip or
  state-table persist (``processor.commit()``)
- ``FIFO_ACK``      — upstream FIFO told the batch is consumed
- ``OFFSET_COMMIT`` — source offsets checkpointed (the at-least-once
  replay cursor; legitimately AFTER the ack)
- ``STATE_PUSH``    — owned window partitions shipped to the state
  mirror for a rescale successor
- ``REQUEUE``       — unacked window pushed back for redelivery
- ``DRAIN_MARKER``  — landing-queue settle/drain barrier
- ``HANDOFF_PULL``  — a rescale successor's owned-partition plan
  computed / stamped into its record
- ``DISPATCH``      — a successor job record submitted to the cluster

Rules DX900-DX902 are also enforced at runtime (``runtime=True``):
they are orderings of per-batch events the monitor observes directly.
DX903-DX905 are static-only — requeue coverage and the rescale handoff
are control-flow properties of the SOURCE (except-handler shape, call
order across a config-build function), not of one batch's event list.

Copy of the JAX package's ``analysis/protospec.py``, whole. The static
tier (``analysis/protocheck.py``) reads it, and the port's
``runtime/protocolmonitor.py`` reads the runtime rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

SINK_EMIT = "SINK_EMIT"
DURABLE_WRITE = "DURABLE_WRITE"
POINTER_FLIP = "POINTER_FLIP"
FIFO_ACK = "FIFO_ACK"
OFFSET_COMMIT = "OFFSET_COMMIT"
STATE_PUSH = "STATE_PUSH"
REQUEUE = "REQUEUE"
DRAIN_MARKER = "DRAIN_MARKER"
HANDOFF_PULL = "HANDOFF_PULL"
DISPATCH = "DISPATCH"

EVENT_KINDS = (
    SINK_EMIT, DURABLE_WRITE, POINTER_FLIP, FIFO_ACK, OFFSET_COMMIT,
    STATE_PUSH, REQUEUE, DRAIN_MARKER, HANDOFF_PULL, DISPATCH,
)

# externally visible WRITES — the events whose placement relative to
# the ack decides exactly-once vs lost-or-duplicated
EFFECT_KINDS = frozenset({
    SINK_EMIT, DURABLE_WRITE, POINTER_FLIP, OFFSET_COMMIT, STATE_PUSH,
})


@dataclass(frozen=True)
class ProtocolRule:
    """One ordering invariant of the delivery protocol."""

    code: str
    name: str
    description: str
    runtime: bool  # also enforced per-batch by the ProtocolMonitor


RULES: Tuple[ProtocolRule, ...] = (
    ProtocolRule(
        "DX900", "durability-before-ack",
        "the pointer flip (and any os.replace's tmp-file + dir fsync "
        "pair) must happen before the upstream FIFO ack — an ack "
        "before durability loses the batch on a crash",
        runtime=True,
    ),
    ProtocolRule(
        "DX901", "sink-before-pointer-commit",
        "sink emit must precede the pointer flip: committing state for "
        "rows the sinks have not accepted double-counts them on replay",
        runtime=True,
    ),
    ProtocolRule(
        "DX902", "ack-at-most-once-per-batch",
        "each source is acked at most once per batch — a second ack "
        "releases a window the failure path still expects to requeue",
        runtime=True,
    ),
    ProtocolRule(
        "DX903", "requeue-covers-unacked-window",
        "a function that acks must requeue the WHOLE unacked window "
        "(every source the ack loop covers) in its failure handler",
        runtime=False,
    ),
    ProtocolRule(
        "DX904", "effect-outside-requeue-scope",
        "pre-ack effects must sit inside a try whose handler requeues; "
        "post-ack effects are at-least-once territory and must carry "
        "an explicit `# dx-proto: post-commit` marker",
        runtime=False,
    ),
    ProtocolRule(
        "DX905", "handoff-pull-before-first-dispatch",
        "a rescale must pull/stamp the successor's owned-partition "
        "plan before the first successor dispatch, or the new replica "
        "boots without its state assignment",
        runtime=False,
    ),
)

RULES_BY_CODE: Dict[str, ProtocolRule] = {r.code: r for r in RULES}
RUNTIME_RULES: Tuple[ProtocolRule, ...] = tuple(
    r for r in RULES if r.runtime
)


def check_sequence(
    events: List[dict], failed: bool = False,
) -> List[Tuple[str, str]]:
    """Validate ONE sealed batch linearization against the runtime
    rules. ``events`` is the recorded sequence, each a dict with at
    least ``kind`` (an ``EVENT_KINDS`` member) and optionally
    ``source`` (for per-source ack accounting). Returns at most one
    ``(rule_code, message)`` per rule — a batch that acks three
    sources before the flip is ONE protocol violation, not three."""
    out: List[Tuple[str, str]] = []
    first: Dict[str, int] = {}
    for i, ev in enumerate(events):
        first.setdefault(ev.get("kind", ""), i)

    ack = first.get(FIFO_ACK)
    flip = first.get(POINTER_FLIP)
    sink = first.get(SINK_EMIT)

    # DX900: an ack with no earlier pointer flip — on a failed batch
    # this is exactly the ack-before-durability reorder (the acked
    # window is gone AND requeued/aborted)
    if ack is not None and (flip is None or ack < flip):
        out.append((
            "DX900",
            "FIFO ack recorded before the durable pointer flip"
            + (" on a FAILED batch" if failed else ""),
        ))

    # DX901: pointer flip before the first sink emit (both observed)
    if flip is not None and sink is not None and flip < sink:
        out.append((
            "DX901",
            "pointer flip recorded before the sink emit",
        ))

    # DX902: a source acked more than once in one batch
    acked: Dict[str, int] = {}
    for ev in events:
        if ev.get("kind") == FIFO_ACK:
            src = str(ev.get("source", ""))
            acked[src] = acked.get(src, 0) + 1
    dup = sorted(s for s, n in acked.items() if n > 1)
    if dup:
        out.append((
            "DX902",
            f"source(s) acked more than once in one batch: "
            f"{', '.join(dup)}",
        ))
    return out
