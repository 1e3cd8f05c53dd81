"""The plain reference of ``iot_rescore`` (``reference/iot.py``'s
row-wise rules over every event of the archive, for every pass of the
batch job) and the comparison that decides a run's ``correct``.

From the run it takes only the passes' batch times: every pass reads
the whole archive, which the reference regenerates from the mix and the
seed. It covers every pass from the warm-up pass on, and every row the
two outputs' sinks wrote.
"""

from __future__ import annotations

from streambench.reference import iot

# each compared number's limit; PERF.md gives the readings they were set from
LIMITS = {
    "rows_wrong": 0,
    "events_lost": 0,
    "score_abs_err": 1e-5,
}


def expected(cell, precision: str = "float64") -> dict:
    a = cell.config["archive"]
    ev = iot.Events(cell.mix, cell.seed, a["files"] * a["events_per_file"], precision)
    return iot.expected_batch(ev, ev.take(0, ev.n))


def judge(cell, record, outputs=None) -> dict:
    e = expected(cell)
    got = record["outputs"] if outputs is None else outputs
    bts = [p["bt"] for p in record["passes"]]
    t = iot.Tally()
    t.rows_wrong += iot.stray_rows(got, set(bts))
    for bt in bts:
        t.open_doors(got["OpenDoors"].get(bt, []), e["open_doors"], bt)
        t.alerts(got["AnomalyAlerts"].get(bt, []), e["alerts"])
    record["ref_counts"] = {bt: {
        "rows": e["rows"],
        "OpenDoors": sum(e["open_doors"].values()),
        "AnomalyAlerts": sum(r for _s, r in e["alerts"].values()),
    } for bt in bts}
    v = iot.verdict(iot.checks(t, LIMITS, record["failed"]))
    v["lines"] = [f"compared {len(bts)} passes, rows {dict(t.rows)}"]
    return v


def control_outputs(cell, record) -> dict:
    """The control: the reference computed in bfloat16, in the
    program's place, for the same passes."""
    e = expected(cell, "bfloat16")
    bts = [p["bt"] for p in record["passes"]]
    return iot.bf16_outputs([e] * len(bts), bts)
