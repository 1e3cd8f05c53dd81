"""Pilot replay CLI: re-run the decision loop offline over a recorded
flight-recorder JSONL.

    python -m data_accelerator_tpu_torch.pilot --replay <tracefile> [--json]
        [--window S] [--cooldown S] [--budget N] [--max-depth N]

The debugging story for every pilot regression: the live controller
records a ``pilot/evaluate`` span per evaluation window whose
properties ARE the signal snapshot it acted on, so this CLI can replay
the exact decision table — same rules, same budget/cooldown state
machine, optionally different knobs — and print the actuations it
*would* have taken. Flags override ``PilotConfig`` fields, so "would a
30s cooldown have prevented that flap?" is one re-run, no cluster.

Recordings from a pilot-OFF run carry no ``pilot/evaluate`` spans; the
CLI then reconstructs coarse snapshots from the batch ``sync`` spans
(stall only) and says so — enough to ask "would the pilot have
reacted?", not enough to reproduce backpressure/rescale decisions.

Copy of the JAX package's ``pilot/__main__.py`` over the port's
``pilot/controller.py``: on the same recording it prints the same
decision table.
"""

from __future__ import annotations

import gzip
import json
import sys
from typing import List, Optional

from .controller import Decision, PilotConfig, PilotController, SignalSnapshot

USAGE = __doc__.split("\n\n")[0] + "\n"


def _read_lines(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue  # the recorder mixes log lines in some setups


def load_snapshots(
    path: str, window_s: float = 5.0
) -> tuple:
    """(snapshots, source) — ``source`` is ``"recorded"`` when the
    trace carries ``pilot/evaluate`` spans, ``"reconstructed"`` when
    the snapshots were rebuilt from batch sync spans."""
    evaluates = []
    syncs = []
    for rec in _read_lines(path):
        if rec.get("type") != "span":
            continue
        if rec.get("name") == "pilot/evaluate":
            evaluates.append(rec)
        elif rec.get("name") == "sync":
            syncs.append(rec)
    if evaluates:
        evaluates.sort(key=lambda r: r.get("startTs") or 0)
        snaps = []
        for rec in evaluates:
            snap = SignalSnapshot.from_props(rec.get("properties") or {})
            if not snap.now:
                snap.now = float(rec.get("startTs") or 0.0)
            snaps.append(snap)
        return snaps, "recorded"
    # coarse reconstruction: bucket sync spans into evaluation windows,
    # EWMA their durations the way HealthState.record_stall does
    syncs.sort(key=lambda r: r.get("startTs") or 0)
    snaps: List[SignalSnapshot] = []
    if not syncs:
        return snaps, "reconstructed"
    alpha = 0.3
    ewma: Optional[float] = None
    window_start = float(syncs[0].get("startTs") or 0.0)
    batches = 0
    for rec in syncs:
        ts = float(rec.get("startTs") or 0.0)
        dur = float(rec.get("durationMs") or 0.0)
        ewma = dur if ewma is None else alpha * dur + (1 - alpha) * ewma
        batches += 1
        if ts - window_start >= window_s:
            snaps.append(SignalSnapshot(
                now=ts, stall_ms=ewma, batches=batches,
            ))
            window_start = ts
            batches = 0
    if batches:
        snaps.append(SignalSnapshot(
            now=float(syncs[-1].get("startTs") or 0.0),
            stall_ms=ewma or 0.0, batches=batches,
        ))
    return snaps, "reconstructed"


def _fmt_decision(d: Decision) -> str:
    mark = "ACTUATE" if d.applied else f"held({d.suppressed})"
    return f"{mark:18s} {d.rule:32s} {d.action:22s} -> {d.value}"


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    path = None
    as_json = False
    overrides = {}
    flag_fields = {
        "--window": ("window_s", float),
        "--cooldown": ("cooldown_s", float),
        "--budget": ("budget", int),
        "--max-depth": ("max_depth", int),
    }
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--replay":
            i += 1
            if i >= len(args):
                sys.stderr.write(USAGE)
                return 2
            path = args[i]
        elif a == "--json":
            as_json = True
        elif a in flag_fields:
            i += 1
            if i >= len(args):
                sys.stderr.write(USAGE)
                return 2
            name, conv = flag_fields[a]
            try:
                overrides[name] = conv(args[i])
            except ValueError:
                sys.stderr.write(f"bad value for {a}: {args[i]}\n")
                return 2
        elif a.startswith("--"):
            sys.stderr.write(f"unknown flag {a}\n{USAGE}")
            return 2
        else:
            path = a
        i += 1
    if not path:
        sys.stderr.write(USAGE)
        return 2

    cfg = PilotConfig(**overrides) if overrides else PilotConfig()
    try:
        snaps, source = load_snapshots(path, window_s=cfg.window_s)
    except OSError as e:
        sys.stderr.write(f"cannot read {path}: {e}\n")
        return 1
    pilot = PilotController(cfg)
    rounds = pilot.replay(snaps)

    if as_json:
        print(json.dumps({
            "tracefile": path,
            "snapshots": source,
            "evaluations": [
                {
                    "now": s.now,
                    "signals": s.to_props(),
                    "decisions": [
                        {"rule": d.rule, "action": d.action,
                         "value": d.value, "applied": d.applied,
                         "suppressed": d.suppressed}
                        for d in ds
                    ],
                }
                for s, ds in zip(snaps, rounds)
            ],
            "actuations": pilot.actuations_count,
        }, indent=2, default=str))
        return 0

    print(f"replaying {len(snaps)} evaluation window(s) "
          f"({source} snapshots) from {path}")
    for snap, decisions in zip(snaps, rounds):
        print(
            f"\n@{snap.now:.3f} stall={snap.stall_ms:.1f}ms "
            f"backlog={snap.backlog:.0f} lag={snap.source_lag_ms:.0f}ms "
            f"sat={snap.saturation:.2f} bad={snap.malformed_ratio:.2f} "
            f"depth={snap.depth} rate={snap.rate_fraction:.2f} "
            f"replicas={snap.replicas}"
        )
        if not decisions:
            print("  steady — no rule fired")
        for d in decisions:
            print("  " + _fmt_decision(d))
    print(f"\n{pilot.actuations_count} actuation(s) would have been taken")
    return 0


if __name__ == "__main__":
    sys.exit(main())
