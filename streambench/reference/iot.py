"""The plain reference of the IoT alert rules, in NumPy, and the
comparison of the program's rows with it.

It works from the generator's own event columns (``traffic/generator.py``
regenerates them from the mix and the seed) and recomputes everything:

- a temperature as the payload carries it, three decimals, parsed as
  the JSON text ``ip.fff`` reads: ``ip + fff / 1000`` in float64, stored
  in float32 (the schema's ``double``);
- ``OpenDoors``: DoorLock events with ``status`` 0, one row each, at the
  batch's time;
- ``anomalyscore(temperature, deviceId)`` = ``1 / (1 + exp(-|x - mu| /
  (1 + |mu|)))`` in float64 from the float32 temperature, and
  ``AnomalyAlerts``: the events whose score is above 0.9;
- ``HeatAvg``: per device, the count and mean temperature of the events
  of every batch whose batch time lies within the window at or before
  the batch's own, the ring holding at most ``slots`` batches.

An event whose float64 score lies within ``GRAY`` of 0.9 may land on
either side of the threshold in a faithful float32 evaluation (the
kernel's float32 arithmetic is within about 2e-7 of float64): such an
alert may be present or absent; every other alert must be present, and
nothing else may be. Rows are compared as multisets per batch: a row
missing or extra, or a HeatAvg count that differs, is a wrong row; the
values are compared by the largest error.

The control (``precision="bfloat16"``) is this reference put in the
program's place one precision below the float32 it computes in:
temperatures, scores and means rounded to bfloat16, sums accumulated in
float32.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from streambench.traffic import generator

THRESHOLD = 0.9
GRAY = 1e-6
DOOR = generator.DOOR


def bf16(x) -> np.ndarray:
    """Round float32 values to bfloat16 (to nearest, ties to even), kept
    in float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def temperature_f32(temp_milli: np.ndarray) -> np.ndarray:
    ip = (temp_milli // 1000).astype(np.float64)
    fp = (temp_milli % 1000).astype(np.float64)
    return (ip + fp / 1000.0).astype(np.float32)


def score(t32: np.ndarray, device_id: np.ndarray, precision: str = "float64"):
    mu = device_id.astype(np.float64)
    if precision == "bfloat16":
        t = bf16(t32).astype(np.float64)
        d = bf16(np.abs(t - mu) / (1.0 + np.abs(mu))).astype(np.float64)
        return bf16(1.0 / (1.0 + np.exp(-d))).astype(np.float64)
    d = np.abs(t32.astype(np.float64) - mu) / (1.0 + np.abs(mu))
    return 1.0 / (1.0 + np.exp(-d))


class Events:
    """The pool's columns and what each event contributes."""

    def __init__(self, mix: dict, seed: int, n: int, precision: str = "float64"):
        c = generator.events(mix, seed, n)
        self.n = n
        self.device_id = c["device_id"]
        self.open_door = (c["type"] == DOOR) & (c["status"] == 0)
        t32 = temperature_f32(c["temp_milli"])
        self.temp = (bf16(t32) if precision == "bfloat16" else t32).astype(np.float64)
        self.score = score(t32, c["device_id"], precision)
        self.precision = precision

    def take(self, frm: int, to: int) -> np.ndarray:
        return np.arange(frm, to, dtype=np.int64) % self.n


def expected_batch(ev: Events, idx: np.ndarray) -> dict:
    """One batch's expected OpenDoors and AnomalyAlerts, and its per
    device counts and sums for the window."""
    dev = ev.device_id[idx]
    s = ev.score[idx]
    if ev.precision == "float64":
        lo, hi = THRESHOLD - GRAY, THRESHOLD + GRAY
    else:
        lo = hi = THRESHOLD
    alerts = {}
    keep = s > lo
    for d in np.unique(dev[keep]):
        sd = np.sort(s[keep & (dev == d)])[::-1]
        alerts[int(d)] = (sd, int((sd > hi).sum()))
    return {
        "rows": int(idx.size),
        "open_doors": Counter(int(d) for d in dev[ev.open_door[idx]]),
        "alerts": alerts,
        "cnt": np.bincount(dev, minlength=9)[:9],
        "sum": np.bincount(dev, weights=ev.temp[idx], minlength=9)[:9],
    }


def window_means(batches: list, bts: list, duration_ms: int, slots: int, precision: str):
    """Per batch: {device: (count, mean)} over its window."""
    out = []
    for b, bt in enumerate(bts):
        cnt = np.zeros(9, np.int64)
        tot = np.zeros(9, np.float64)
        for j in range(max(0, b - slots + 1), b + 1):
            if 0 <= bt - bts[j] <= duration_ms:
                cnt += batches[j]["cnt"]
                tot += batches[j]["sum"]
        means = {}
        for d in np.nonzero(cnt)[0]:
            m = tot[d] / cnt[d]
            if precision == "bfloat16":
                m = float(bf16(np.float32(m)))
            means[int(d)] = (int(cnt[d]), float(m))
        out.append(means)
    return out


class Tally:
    """The numbers compared, summed over batches."""

    def __init__(self):
        self.rows_wrong = 0
        self.avgt_rel_err = 0.0
        self.score_abs_err = 0.0
        self.rows = Counter()

    def open_doors(self, rows: list, want: Counter, bt: int) -> None:
        got = Counter(int(r["deviceId"]) for r in rows if int(r["eventTimeStamp"]) == bt)
        wrong_ts = sum(1 for r in rows if int(r["eventTimeStamp"]) != bt)
        self.rows_wrong += wrong_ts + sum(((got - want) + (want - got)).values())
        self.rows["OpenDoors"] += len(rows)

    def alerts(self, rows: list, want: dict) -> None:
        by_dev: dict = {}
        for r in rows:
            by_dev.setdefault(int(r["deviceId"]), []).append(float(r["score"]))
        for d in set(by_dev) | set(want):
            got = np.sort(np.asarray(by_dev.get(d, []), np.float64))[::-1]
            allowed, required = want.get(d, (np.zeros(0), 0))
            if got.size < required:
                self.rows_wrong += required - got.size
            elif got.size > allowed.size:
                self.rows_wrong += got.size - allowed.size
            k = min(got.size, allowed.size)
            if k:
                self.score_abs_err = max(
                    self.score_abs_err, float(np.abs(got[:k] - allowed[:k]).max()))
        self.rows["AnomalyAlerts"] += len(rows)

    def heat(self, rows: list, want: dict) -> None:
        seen = set()
        for r in rows:
            d = int(r["deviceId"])
            if d in seen or d not in want:
                self.rows_wrong += 1
                continue
            seen.add(d)
            if int(r["Cnt"]) != want[d][0]:
                self.rows_wrong += 1
                continue
            m = want[d][1]
            self.avgt_rel_err = max(
                self.avgt_rel_err, abs(float(r["AvgT"]) - m) / max(abs(m), 1e-30))
        self.rows_wrong += len(set(want) - seen)
        self.rows["HeatAvg"] += len(rows)


def checks(tally: Tally, limits: dict, lost: int) -> dict:
    values = {
        "rows_wrong": tally.rows_wrong,
        "events_lost": lost,
        "avgt_rel_err": tally.avgt_rel_err,
        "score_abs_err": tally.score_abs_err,
    }
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def verdict(out: dict) -> dict:
    ok = all(c["value"] <= c["limit"] for c in out.values())
    return {"correct": ok, "checks": out}


def stray_rows(outputs: dict, bts: set) -> int:
    """Rows written under a batch time that no batch of the run had."""
    return sum(len(rows) for by_bt in outputs.values()
               for bt, rows in by_bt.items() if bt not in bts)


def bf16_outputs(expected: list, bts: list, heat: list = None) -> dict:
    """The control's rows: the expected rows of a bfloat16 reference, in
    the program's output layout."""
    out = {"OpenDoors": {}, "AnomalyAlerts": {}}
    if heat is not None:
        out["HeatAvg"] = {}
    for b, bt in enumerate(bts):
        e = expected[b]
        out["OpenDoors"][bt] = [{"deviceId": d, "eventTimeStamp": bt}
                                for d, k in e["open_doors"].items() for _ in range(k)]
        out["AnomalyAlerts"][bt] = [{"deviceId": d, "score": float(s)}
                                    for d, (ss, _r) in e["alerts"].items() for s in ss]
        if heat is not None:
            out["HeatAvg"][bt] = [{"deviceId": d, "Cnt": c, "AvgT": m}
                                  for d, (c, m) in heat[b].items()]
    return out
