"""The plain reference of ``iot_alerts`` (``reference/iot.py``'s rules
over the streaming loop's batches) and the comparison that decides a
run's ``correct``.

From the run it takes only the framing the benchmark recorded around
the source and the processor: which consecutive events of the stream
each batch consumed, and the batch's time. It covers every batch from
the first fill batch on, and every row the three outputs' sinks wrote.
The window state the fill batches left is recomputed, not read.
"""

from __future__ import annotations

from streambench.reference import iot

# each compared number's limit; PERF.md gives the readings they were set from
LIMITS = {
    "rows_wrong": 0,
    "events_lost": 0,
    "avgt_rel_err": 1e-5,
    "score_abs_err": 1e-5,
}


def expected(cell, record, precision: str = "float64"):
    ev = iot.Events(cell.mix, cell.seed, record["pool_events"], precision)
    framing = record["framing"]
    bts = [r["bt"] for r in framing]
    batches = [iot.expected_batch(ev, ev.take(r["frm"], r["to"])) for r in framing]
    win = cell.config["window"]
    heat = iot.window_means(batches, bts, win["duration_ms"], win["slots"], precision)
    return bts, batches, heat


def judge(cell, record, outputs=None) -> dict:
    """Compare ``outputs`` (the program's rows unless given) with the
    reference; also leaves each batch's row counts in
    ``record["ref_counts"]`` for the roofline's byte counts."""
    bts, batches, heat = expected(cell, record)
    got = record["outputs"] if outputs is None else outputs
    t = iot.Tally()
    t.rows_wrong += iot.stray_rows(got, set(bts))
    counts = {}
    for b, bt in enumerate(bts):
        e = batches[b]
        t.open_doors(got["OpenDoors"].get(bt, []), e["open_doors"], bt)
        t.alerts(got["AnomalyAlerts"].get(bt, []), e["alerts"])
        t.heat(got["HeatAvg"].get(bt, []), heat[b])
        counts[bt] = {
            "rows": e["rows"],
            "window_rows": sum(c for c, _m in heat[b].values()),
            "OpenDoors": sum(e["open_doors"].values()),
            "AnomalyAlerts": sum(r for _s, r in e["alerts"].values()),
            "HeatAvg": len(heat[b]),
        }
    record["ref_counts"] = counts
    v = iot.verdict(iot.checks(t, LIMITS, record["failed"]))
    v["lines"] = [f"compared {len(bts)} batches, rows {dict(t.rows)}"]
    return v


def control_outputs(cell, record) -> dict:
    """The control: the reference computed in bfloat16, in the
    program's place, over the same batches."""
    bts, batches, heat = expected(cell, record, "bfloat16")
    return iot.bf16_outputs(batches, bts, heat)
