"""Observability CLI of the port: ``python -m data_accelerator_tpu_torch.obs``.

``python -m data_accelerator_tpu_torch.obs trace <batch_id> [--file F] [--json]``
reconstructs one micro-batch's span tree from the JSONL flight recorder
(the ``tracefile`` writer of obs/telemetry.py). ``<batch_id>`` is the
batch time in epoch ms (what ``streaming/batch/begin`` logs as
``batchTime``) or a raw trace id. Under cross-process propagation
(``datax.job.process.telemetry.parenttrace``) the rendered tree spans
the control-plane request down to the batch spans it caused.

Rotated segments (``<file>.N`` / ``<file>.N.gz`` — JsonlWriter
keep/compress rotation) are read oldest-first when present, so a batch
that rotated out mid-trace still reconstructs completely.

``python -m data_accelerator_tpu_torch.obs alerts [--url U] [--json]``
fetches a host's (or the website's) ``GET /alerts`` and renders the
rule table with firing state; ``alerts --validate rules.json``
schema-checks a rule file (obs/alerts.py RULE_SCHEMA) and exits
non-zero on errors.

``python -m data_accelerator_tpu_torch.obs profile <url> [--seconds N]``
POSTs ``/profile?seconds=N`` on a live host's observability port —
the on-demand ``torch.profiler`` surface (obs/profiler.py) — and prints
the capture path the host returned.

``python -m data_accelerator_tpu_torch.obs spans [--aggregate] [--file F]``
reads the flight recorder's span records; with ``--aggregate`` it
renders the flame table — stage -> count / total ms / p50 / p99 —
the offline rollup of the same per-stage decomposition the live
histograms serve.

``python -m data_accelerator_tpu_torch.obs fleet [--url U] [--flow F]
[--output O] [--json]`` queries the control plane's fleet telemetry
rollup (``GET /fleet/metrics`` / ``/fleet/flows/<flow>``,
obs/fleetview.py): merged counters and histograms, per-replica status,
replica lineage, and the DX54x delivery-conservation audit.

``obs trace ... --stitch`` additionally groups the rendered spans by
the ``replica`` tag each host stamps on its batch spans, following the
flow's replica lineage across a rescale/handoff as one continuous
cross-replica tree (segments ordered by first activity, handoff
connectors between them).

Copy of the JAX package's ``obs/__main__.py``; the commands, their
output and their exit codes are the reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional


def _rotated_paths(path: str) -> List[str]:
    """Every on-disk segment of a rotated flight recorder, oldest
    first: ``<path>.N[.gz] .. <path>.1[.gz]`` then the active file
    (JsonlWriter keep/compress rotation)."""
    import glob as _glob

    rotated = []
    for p in _glob.glob(path + ".*"):
        suffix = p[len(path) + 1:]
        if suffix.endswith(".gz"):
            suffix = suffix[:-3]
        if suffix.isdigit():
            rotated.append((int(suffix), p))
    out = [p for _, p in sorted(rotated, reverse=True)]
    if os.path.exists(path):
        out.append(path)
    return out


def load_spans(path: str) -> List[dict]:
    import gzip

    spans: List[dict] = []
    for p in _rotated_paths(path):
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("type") == "span":
                    spans.append(rec)
    return spans


def find_traces(spans: List[dict], batch_id: str) -> List[str]:
    """Trace ids whose root span matches ``batch_id`` (batchTime or
    trace id). Batch roots carry ``batchTime``; under cross-process
    propagation they also carry a ``parent`` pointing into the
    control-plane trace, so the match keys on the property alone."""
    ids: List[str] = []
    for s in spans:
        if s.get("trace") == batch_id and s["trace"] not in ids:
            ids.append(s["trace"])
    for s in spans:
        bt = (s.get("properties") or {}).get("batchTime")
        if bt is not None and str(bt) == str(batch_id) \
                and s["trace"] not in ids:
            ids.append(s["trace"])
    return ids


def format_tree(spans: List[dict]) -> str:
    """Render one trace's spans as an indented tree ordered by start."""
    by_id: Dict[str, dict] = {s["span"]: s for s in spans}
    children: Dict[Optional[str], List[dict]] = {}
    for s in spans:
        parent = s.get("parent")
        if parent is not None and parent not in by_id:
            parent = None  # orphan (rotation cut its parent) -> top level
        children.setdefault(parent, []).append(s)
    for kids in children.values():
        kids.sort(key=lambda s: (s.get("startTs") or 0))

    lines: List[str] = []

    def emit(span: dict, prefix: str, is_last: bool, depth: int) -> None:
        props = span.get("properties") or {}
        extras = " ".join(
            f"{k}={v}" for k, v in sorted(props.items())
        )
        dur = span.get("durationMs")
        head = "" if depth == 0 else prefix + ("└─ " if is_last else "├─ ")
        lines.append(
            f"{head}{span.get('name')} "
            f"{dur:.2f} ms" + (f"  [{extras}]" if extras else "")
        )
        kids = children.get(span["span"], [])
        child_prefix = (
            "" if depth == 0 else prefix + ("   " if is_last else "│  ")
        )
        for i, k in enumerate(kids):
            emit(k, child_prefix, i == len(kids) - 1, depth + 1)

    roots = children.get(None, [])
    for i, r in enumerate(roots):
        emit(r, "", i == len(roots) - 1, 0)
    return "\n".join(lines)


def _replica_of_trace(tspans: List[dict]) -> Optional[str]:
    """The replica tag of a trace: hosts publishing to the fleet plane
    stamp ``replica=<name>`` on their batch spans (runtime/host.py), so
    any tagged span identifies the segment."""
    for s in tspans:
        rep = (s.get("properties") or {}).get("replica")
        if rep:
            return str(rep)
    return None


def stitch_lineage(spans: List[dict],
                   trace_ids: List[str]) -> List[tuple]:
    """Group traces into replica lineage segments, ordered by first
    activity — the succession order a rescale handoff produces.
    Returns ``(replica, [trace ids])`` pairs; untagged traces land in a
    single ``(none)`` segment."""
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        if s.get("trace") in trace_ids:
            by_trace.setdefault(s["trace"], []).append(s)
    segments: Dict[str, List[str]] = {}
    first_ts: Dict[str, float] = {}
    for tid, tspans in by_trace.items():
        rep = _replica_of_trace(tspans) or "(none)"
        segments.setdefault(rep, []).append(tid)
        ts = min(float(s.get("startTs") or 0) for s in tspans)
        first_ts[rep] = min(first_ts.get(rep, ts), ts)
        for lst in segments.values():
            lst.sort(key=lambda t: min(
                float(s.get("startTs") or 0) for s in by_trace[t]
            ))
    return sorted(segments.items(), key=lambda kv: first_ts[kv[0]])


def cmd_trace(args) -> int:
    spans = load_spans(args.file)
    if not spans:
        print(f"no spans found in {args.file}", file=sys.stderr)
        return 2
    if getattr(args, "stitch", False):
        return _trace_stitched(spans, args)
    trace_ids = find_traces(spans, args.batch_id)
    if not trace_ids:
        roots = sorted(
            {
                str((s.get("properties") or {}).get("batchTime"))
                for s in spans
                if (s.get("properties") or {}).get("batchTime") is not None
            }
        )
        print(
            f"no trace for batch {args.batch_id!r}; known batch ids: "
            f"{', '.join(roots[-10:]) or '(none)'}",
            file=sys.stderr,
        )
        return 1
    for tid in trace_ids:
        tspans = [s for s in spans if s.get("trace") == tid]
        if args.json:
            print(json.dumps(tspans, indent=1, default=str))
            continue
        print(f"trace {tid} ({len(tspans)} span(s))")
        print(format_tree(tspans))
    return 0


def _trace_stitched(spans: List[dict], args) -> int:
    """One continuous cross-replica tree: every trace matching
    ``batch_id`` — or, when the id is ``all``, every replica-tagged
    trace in the recorder — grouped into lineage segments."""
    if args.batch_id == "all":
        trace_ids = []
        for s in spans:
            if (s.get("properties") or {}).get("replica") \
                    and s["trace"] not in trace_ids:
                trace_ids.append(s["trace"])
    else:
        trace_ids = find_traces(spans, args.batch_id)
    if not trace_ids:
        print(f"no trace for {args.batch_id!r} to stitch",
              file=sys.stderr)
        return 1
    segments = stitch_lineage(spans, trace_ids)
    if args.json:
        print(json.dumps(
            [{"replica": rep, "traces": tids} for rep, tids in segments],
            indent=1,
        ))
        return 0
    print(f"replica lineage — {len(segments)} segment(s), "
          f"{len(trace_ids)} trace(s)")
    for i, (rep, tids) in enumerate(segments):
        if i:
            print("└→ handoff")
        nspans = sum(1 for s in spans if s.get("trace") in tids)
        print(f"■ replica {rep} ({len(tids)} trace(s), {nspans} span(s))")
        for tid in tids:
            tspans = [s for s in spans if s.get("trace") == tid]
            print(f"  trace {tid}")
            for line in format_tree(tspans).splitlines():
                print(f"    {line}")
    return 0


def cmd_alerts(args) -> int:
    from .alerts import validate_rules

    if args.validate:
        try:
            with open(args.validate, encoding="utf-8") as f:
                rules = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read rules file: {e}", file=sys.stderr)
            return 2
        errors = validate_rules(rules)
        if errors:
            for e in errors:
                print(e, file=sys.stderr)
            return 2
        print(f"{len(rules)} rule(s) valid")
        return 0
    import urllib.request

    url = args.url.rstrip("/") + "/alerts"
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            payload = json.loads(r.read() or b"{}")
    except OSError as e:
        print(f"cannot reach {url}: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(payload, indent=1, default=str))
        return 0
    firing = {a["name"] for a in payload.get("firing") or []}
    rules = payload.get("rules") or []
    flow = payload.get("flow") or ""
    print(f"alerts for {flow or '(unnamed)'} — "
          f"{len(firing)} firing / {len(rules)} rule(s)")
    for r in rules:
        state = r.get("state") or ("firing" if r["name"] in firing else "ok")
        mark = "!" if state == "firing" else (
            "~" if state == "pending" else " "
        )
        val = r.get("value")
        val_s = f"{val:.4g}" if isinstance(val, (int, float)) else "-"
        thr = r.get("threshold", r.get("burnRate"))
        print(f" {mark} {r['name']:<28} {state:<8} "
              f"value={val_s} threshold={thr} "
              f"severity={r.get('severity') or 'warn'}")
    return 1 if firing else 0


def _pctl(sorted_vals: List[float], q: float) -> float:
    """numpy-'linear' percentile over pre-sorted values (matches
    obs/histogram.py LatencyHistogram.percentile)."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = (q / 100.0) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def cmd_spans(args) -> int:
    spans = load_spans(args.file)
    if not spans:
        print(f"no spans found in {args.file}", file=sys.stderr)
        return 2
    if not args.aggregate:
        for s in spans[-args.limit:]:
            print(
                f"{s.get('trace')} {s.get('name'):<20} "
                f"{s.get('durationMs', 0):>10.2f} ms"
            )
        return 0
    # flame table: stage -> count/total/p50/p99 (+ the exemplar-style
    # max trace id, so the worst observation is one `obs trace` away)
    groups: Dict[str, List[dict]] = {}
    for s in spans:
        groups.setdefault(s.get("name") or "?", []).append(s)
    if args.json:
        out = []
        for name, ss in groups.items():
            durs = sorted(float(s.get("durationMs") or 0.0) for s in ss)
            worst = max(ss, key=lambda s: float(s.get("durationMs") or 0.0))
            out.append({
                "stage": name,
                "count": len(durs),
                "totalMs": round(sum(durs), 2),
                "p50Ms": round(_pctl(durs, 50), 3),
                "p99Ms": round(_pctl(durs, 99), 3),
                "maxMs": round(durs[-1], 3),
                "maxTrace": worst.get("trace"),
            })
        out.sort(key=lambda r: -r["totalMs"])
        print(json.dumps(out, indent=1))
        return 0
    rows = []
    for name, ss in groups.items():
        durs = sorted(float(s.get("durationMs") or 0.0) for s in ss)
        worst = max(ss, key=lambda s: float(s.get("durationMs") or 0.0))
        rows.append((
            name, len(durs), sum(durs), _pctl(durs, 50), _pctl(durs, 99),
            durs[-1], worst.get("trace"),
        ))
    rows.sort(key=lambda r: -r[2])
    print(f"{'stage':<24} {'count':>7} {'total ms':>12} "
          f"{'p50 ms':>10} {'p99 ms':>10} {'max ms':>10}  max trace")
    for name, n, total, p50, p99, mx, trace in rows:
        print(f"{name:<24} {n:>7} {total:>12.1f} "
              f"{p50:>10.2f} {p99:>10.2f} {mx:>10.2f}  {trace}")
    return 0


def cmd_profile(args) -> int:
    import urllib.parse
    import urllib.request

    url = (
        args.url.rstrip("/")
        + "/profile?"
        + urllib.parse.urlencode({"seconds": args.seconds})
    )
    try:
        req = urllib.request.Request(url, data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            payload = json.loads(r.read() or b"{}")
            status = r.status
    except OSError as e:
        body = getattr(e, "read", lambda: b"")()
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            payload = {}
        if not payload:
            print(f"cannot reach {url}: {e}", file=sys.stderr)
            return 2
        status = getattr(e, "code", 500)
    if args.json:
        print(json.dumps(payload, indent=1))
        return 0 if status == 200 else 1
    if "error" in payload:
        print(f"profiler error: {payload['error']}", file=sys.stderr)
        return 1
    print(
        f"capture armed for {payload.get('seconds')}s -> "
        f"{payload.get('path')}"
    )
    print("open <path>/trace.json in chrome://tracing or Perfetto")
    return 0


def cmd_fleet(args) -> int:
    import urllib.parse
    import urllib.request

    base = args.url.rstrip("/")
    if args.flow:
        url = f"{base}/fleet/flows/{urllib.parse.quote(args.flow)}"
        if args.output:
            url += "?" + urllib.parse.urlencode({"output": args.output})
    else:
        url = f"{base}/fleet/metrics"
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            payload = json.loads(r.read() or b"{}")
    except OSError as e:
        print(f"cannot reach {url}: {e}", file=sys.stderr)
        return 2
    payload = payload.get("result", payload)
    if args.json:
        print(json.dumps(payload, indent=1, default=str))
        return 0
    if not args.flow:
        flows = payload.get("flows") or {}
        print(f"fleet — {len(flows)} flow(s), "
              f"decode errors {payload.get('decodeErrors', 0)}, "
              f"last merge {payload.get('mergeMs', 0)} ms")
        for name in sorted(flows):
            f = flows[name]
            reps = f.get("replicas") or {}
            statuses = [r.get("status") for r in reps.values()]
            counts = (f.get("audit") or {}).get("counts") or {}
            bad = " ".join(
                f"{c}x{n}" for c, n in sorted(counts.items()) if n
            )
            print(f"  {name:<24} replicas={len(reps)} "
                  f"live={statuses.count('live')} "
                  f"stale={statuses.count('stale')} "
                  f"completed={statuses.count('completed')} "
                  f"alerts={len(f.get('alerts') or [])} "
                  f"audit={bad or 'conserved'}")
        return 0
    print(f"fleet flow {payload.get('flow')}")
    reps = payload.get("replicas") or {}
    for name in sorted(reps):
        r = reps[name]
        print(f"  {name:<20} {r.get('status'):<10} "
              f"frames={r.get('frames', 0)} batches={r.get('batches', 0)} "
              f"windows={r.get('windows')}")
    hists = payload.get("histograms") or {}
    for stage in sorted(hists):
        hh = hists[stage]
        print(f"  {stage:<20} n={hh.get('count')} p50={hh.get('p50')}ms "
              f"p95={hh.get('p95')}ms p99={hh.get('p99')}ms")
    lineage = payload.get("lineage") or []
    if lineage:
        print("  lineage: " + " -> ".join(
            str(seg.get("replica")) for seg in lineage
        ))
    audit = payload.get("audit") or {}
    mark = "conserved" if audit.get("conserved") else "NOT CONSERVED"
    print(f"  delivery: ingested={audit.get('ingested')} "
          f"emitted={audit.get('emitted')} [{mark}]")
    for e in audit.get("events") or []:
        print(f"   {e.get('code')}: {e.get('name')} "
              f"{e.get('description') or ''}")
    for a in payload.get("alerts") or []:
        print(f"   firing {a.get('severity') or 'warn'}: {a.get('name')}")
    return 1 if (audit.get("events") or payload.get("alerts")) else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m data_accelerator_tpu_torch.obs",
        description="Observability tools over the JSONL flight recorder "
                    "and the /alerts surface.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    tp = sub.add_parser(
        "trace", help="reconstruct one batch's span tree"
    )
    tp.add_argument("batch_id", help="batch time in epoch ms, or a trace id")
    tp.add_argument(
        "--file",
        default=os.environ.get("DATAX_TRACE_FILE", "telemetry.jsonl"),
        help="JSONL flight-recorder path (default: $DATAX_TRACE_FILE "
             "or ./telemetry.jsonl)",
    )
    tp.add_argument("--json", action="store_true", help="raw span JSON")
    tp.add_argument(
        "--stitch", action="store_true",
        help="group traces into replica lineage segments (the replica "
             "tag hosts stamp on batch spans); batch_id 'all' stitches "
             "every tagged trace in the recorder",
    )
    ap = sub.add_parser(
        "alerts", help="show a host's alert rules and firing set, or "
                       "validate a rules file"
    )
    ap.add_argument(
        "--url", default="http://127.0.0.1:8080",
        help="base URL of a host/website observability endpoint "
             "(GET <url>/alerts)",
    )
    ap.add_argument(
        "--validate", metavar="RULES_JSON",
        help="schema-check a rule file instead of querying a host",
    )
    ap.add_argument("--json", action="store_true", help="raw JSON payload")
    sp = sub.add_parser(
        "spans", help="span records from the flight recorder; "
                      "--aggregate renders the per-stage flame table"
    )
    sp.add_argument(
        "--file",
        default=os.environ.get("DATAX_TRACE_FILE", "telemetry.jsonl"),
        help="JSONL flight-recorder path (default: $DATAX_TRACE_FILE "
             "or ./telemetry.jsonl)",
    )
    sp.add_argument(
        "--aggregate", action="store_true",
        help="roll spans up per stage (count/total/p50/p99/max trace)",
    )
    sp.add_argument(
        "--limit", type=int, default=50,
        help="without --aggregate: how many recent spans to list",
    )
    sp.add_argument("--json", action="store_true", help="JSON rollup")
    pp = sub.add_parser(
        "profile", help="arm an on-demand torch.profiler capture on a "
                        "live host (POST <url>/profile)"
    )
    pp.add_argument(
        "url", help="base URL of a host observability endpoint "
                    "(process.observability.port)",
    )
    pp.add_argument(
        "--seconds", type=float, default=5.0,
        help="capture window in seconds (default 5)",
    )
    pp.add_argument("--json", action="store_true", help="raw JSON payload")
    fleet_help = (
        "cross-replica telemetry rollup from the control plane (GET "
        "<url>/fleet/metrics); the JAX package's control plane serves it "
        "until the port has its own"
    )
    fp = sub.add_parser("fleet", help=fleet_help, description=fleet_help)
    fp.add_argument(
        "--url", default="http://127.0.0.1:5000",
        help="control-plane base URL (default http://127.0.0.1:5000)",
    )
    fp.add_argument(
        "--flow", help="drill into one flow "
                       "(GET <url>/fleet/flows/<flow>)",
    )
    fp.add_argument(
        "--output", help="audit this output's emitted counts instead "
                         "of the busiest one (with --flow)",
    )
    fp.add_argument("--json", action="store_true", help="raw JSON payload")
    args = parser.parse_args(argv)
    if args.cmd == "trace":
        return cmd_trace(args)
    if args.cmd == "alerts":
        return cmd_alerts(args)
    if args.cmd == "spans":
        return cmd_spans(args)
    if args.cmd == "profile":
        return cmd_profile(args)
    if args.cmd == "fleet":
        return cmd_fleet(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
