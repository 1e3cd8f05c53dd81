"""The plain reference of ``fleet_rollup``, in plain PyTorch on the CPU,
and the comparison that decides a run's ``correct``.

The deployment is the aggregate alert over a whole fleet:

    HotDevices = SELECT deviceId, COUNT(*) AS Cnt, AVG(temperature) AS AvgT,
                 MAX(temperature) AS MaxT FROM DataXProcessedInput_1minutes
                 GROUP BY deviceId HAVING AVG(temperature) > 95

From the run it takes only the framing the benchmark recorded around
the source and the processor: which consecutive events of the stream
each batch consumed, and the batch's time. The events are regenerated
from the mix and the seed (``traffic/generator.events``), and every
batch's window is recomputed, the fill batches' included:

- a batch's window holds the batches whose batch time lies within the
  window's duration at or before its own, among the ring's ``slots``
  latest (``iot.window_means``'s rule);
- per device, the window's event count and the exact int64 sum of its
  temperatures in thousandths of a degree (what the payload prints), and
  their maximum; the fleet's million devices are held as dense tables,
  moved from one batch's window to the next by adding the batches that
  enter and taking away those that leave, each batch's own per-device
  sums kept only while it can still be in a window;
- ``HAVING`` in float64 on the exact mean; a device whose exact mean
  lies within ``GRAY`` (relative) of the threshold may be present or
  absent, every other device above it must be present, and nothing
  else may be;
- ``MaxT`` is the float32 of the largest temperature's text, exactly.

Rows are compared by device a batch: a missing or extra device, a
device twice, or a wrong ``Cnt`` is a wrong row; ``AvgT`` and ``MaxT``
are compared by the largest error.

The control (``precision="bfloat16"``) is the same computation one
precision below the program's float32, in the program's place:
temperatures and means rounded to bfloat16.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from streambench.reference import iot
from streambench.traffic import generator

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the transform's HAVING AVG(temperature) > 95
THRESHOLD = 95.0
# a mean within this relative distance of the threshold may land on
# either side of it in a faithful float32 evaluation
GRAY = 1e-5
OUTPUT = "HotDevices"

# each compared number's limit; PERF.md gives the readings they were set from
LIMITS = {
    "rows_wrong": 0,
    "events_lost": 0,
    "avgt_rel_err": 1e-5,
    "maxt_abs_err": 1e-5,
}

CPU = torch.device("cpu")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16 (to nearest, ties to even),
    back in float64."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float64)


class Fleet:
    """The pool's events as tensors, and one batch's per-device sums."""

    def __init__(self, cell, record, precision: str):
        cols = generator.events(cell.mix, cell.seed, record["pool_events"])
        self.n = int(record["pool_events"])
        self.devices = int(cell.mix["device_id"][1]) + 1
        self.device_id = torch.from_numpy(cols["device_id"]).to(CPU, torch.int64)
        self.milli = torch.from_numpy(cols["temp_milli"]).to(CPU, torch.int64)
        self.precision = precision
        if precision == "bfloat16":
            # the temperature as parsed (float32), rounded to bfloat16
            self.value = _bf16(torch.from_numpy(iot.temperature_f32(cols["temp_milli"])))
        else:
            self.value = self.milli

    def batch(self, frm: int, to: int) -> dict:
        """The batch's devices (sorted), and per device its event count,
        sum and largest temperature in thousandths."""
        idx = torch.arange(frm, to, dtype=torch.int64, device=CPU) % self.n
        dev, inv = torch.unique(self.device_id[idx], return_inverse=True)
        k = dev.numel()
        cnt = torch.zeros(k, dtype=torch.int64, device=CPU).index_add_(
            0, inv, torch.ones(idx.numel(), dtype=torch.int64, device=CPU))
        tot = torch.zeros(k, dtype=self.value.dtype, device=CPU).index_add_(
            0, inv, self.value[idx])
        mx = torch.full((k,), -1, dtype=torch.int64, device=CPU).scatter_reduce_(
            0, inv, self.milli[idx], "amax")
        return {"rows": int(idx.numel()), "dev": dev, "cnt": cnt, "tot": tot, "mx": mx}


def windows(cell, record, precision: str = "float64"):
    """Per batch of the framing, in order: (batch time, its expected
    rows as tensors by device, its counts for the roofline)."""
    fleet = Fleet(cell, record, precision)
    win = cell.config["window"]
    dur, slots = int(win["duration_ms"]), int(win["slots"])
    framing = record["framing"]
    bts = [r["bt"] for r in framing]
    cnt_w = torch.zeros(fleet.devices, dtype=torch.int64, device=CPU)
    tot_w = torch.zeros(fleet.devices, dtype=fleet.value.dtype, device=CPU)
    kept = deque()  # (batch index, its sums) of the batches a window may still take
    inside = set()
    for b, r in enumerate(framing):
        stats = fleet.batch(r["frm"], r["to"])
        kept.append((b, stats))
        now = {j for j, _s in kept if j > b - slots and 0 <= bts[b] - bts[j] <= dur}
        for j, s in kept:
            sign = (j in now) - (j in inside)
            if sign:
                cnt_w.index_add_(0, s["dev"], sign * s["cnt"])
                tot_w.index_add_(0, s["dev"], sign * s["tot"])
        inside = now
        while kept[0][0] <= b - slots:
            kept.popleft()
        yield bts[b], expected(fleet, cnt_w, tot_w, [s for j, s in kept if j in now]), {
            "rows": stats["rows"],
            "window_rows": int(cnt_w.sum()),
            "groups": int(torch.count_nonzero(cnt_w)),
        }


def expected(fleet: Fleet, cnt_w: torch.Tensor, tot_w: torch.Tensor, batches: list) -> dict:
    """The window's HotDevices: every device that must be present or may
    be, its count, its mean and its largest temperature as the program
    holds them (float32 values)."""
    dev = torch.nonzero(cnt_w).flatten()
    cnt = cnt_w[dev]
    if fleet.precision == "bfloat16":
        mean = _bf16(tot_w[dev] / cnt.to(torch.float64))
        lo = hi = THRESHOLD
    else:
        mean = tot_w[dev].to(torch.float64) / (1000.0 * cnt.to(torch.float64))
        lo, hi = THRESHOLD * (1.0 - GRAY), THRESHOLD * (1.0 + GRAY)
    keep = mean > lo
    dev, cnt, mean = dev[keep], cnt[keep], mean[keep]
    mx = torch.full((dev.numel(),), -1, dtype=torch.int64, device=CPU)
    for s in batches:
        if not s["dev"].numel():
            continue
        pos = torch.searchsorted(s["dev"], dev).clamp(max=s["dev"].numel() - 1)
        hit = s["dev"][pos] == dev
        mx = torch.maximum(mx, torch.where(hit, s["mx"][pos], -1))
    maxt = torch.from_numpy(iot.temperature_f32(mx.numpy())).to(CPU, torch.float64)
    if fleet.precision == "bfloat16":
        maxt = _bf16(maxt)
    return {"dev": dev, "cnt": cnt, "mean": mean, "maxt": maxt, "required": mean > hi}


class Tally:
    """The numbers compared, summed over batches."""

    def __init__(self):
        self.rows_wrong = 0
        self.avgt_rel_err = 0.0
        self.maxt_abs_err = 0.0
        self.rows = 0

    def batch(self, rows: list, want: dict) -> None:
        self.rows += len(rows)
        got_dev = torch.tensor([int(r["deviceId"]) for r in rows], dtype=torch.int64, device=CPU)
        got_cnt = torch.tensor([int(r["Cnt"]) for r in rows], dtype=torch.int64, device=CPU)
        got_avg = torch.tensor([float(r["AvgT"]) for r in rows], dtype=torch.float64, device=CPU)
        got_max = torch.tensor([float(r["MaxT"]) for r in rows], dtype=torch.float64, device=CPU)
        dev = want["dev"]
        k = dev.numel()
        pos = torch.searchsorted(dev, got_dev).clamp(max=max(k - 1, 0))
        known = (dev[pos] == got_dev) if k else torch.zeros_like(got_dev, dtype=torch.bool)
        # a device twice: every copy after its first is wrong
        _u, first = np.unique(got_dev.numpy(), return_index=True)
        once = torch.zeros(got_dev.numel(), dtype=torch.bool, device=CPU)
        once[torch.from_numpy(first).to(CPU, torch.int64)] = True
        hit = known & once
        ok = torch.zeros_like(once)
        ok[hit] = got_cnt[hit] == want["cnt"][pos[hit]]
        self.rows_wrong += int((~ok).sum())
        seen = torch.zeros(k, dtype=torch.bool, device=CPU)
        seen[pos[ok]] = True
        self.rows_wrong += int((want["required"] & ~seen).sum())
        if bool(ok.any()):
            m = want["mean"][pos[ok]]
            self.avgt_rel_err = max(self.avgt_rel_err, float(
                ((got_avg[ok] - m).abs() / m.abs().clamp(min=1e-30)).max()))
            self.maxt_abs_err = max(self.maxt_abs_err, float(
                (got_max[ok] - want["maxt"][pos[ok]]).abs().max()))


def judge(cell, record, outputs=None) -> dict:
    """Compare ``outputs`` (the program's rows unless given) with the
    reference; also leaves each batch's counts in ``record["ref_counts"]``
    for the roofline's byte counts."""
    got = (record["outputs"] if outputs is None else outputs)[OUTPUT]
    t = Tally()
    counts = {}
    bts = []
    for bt, want, c in windows(cell, record):
        bts.append(bt)
        t.batch(got.get(bt, []), want)
        counts[bt] = dict(c, HotDevices=int((want["mean"] > THRESHOLD).sum()))
    t.rows_wrong += iot.stray_rows({OUTPUT: got}, set(bts))
    record["ref_counts"] = counts
    values = {"rows_wrong": t.rows_wrong, "events_lost": record["failed"],
              "avgt_rel_err": t.avgt_rel_err, "maxt_abs_err": t.maxt_abs_err}
    v = iot.verdict({k: {"value": values[k], "limit": LIMITS[k]} for k in LIMITS})
    v["lines"] = [f"compared {len(bts)} batches, {t.rows} {OUTPUT} rows"]
    return v


def control_outputs(cell, record) -> dict:
    """The control: the reference computed in bfloat16, in the program's
    place, over the same batches."""
    out = {}
    for bt, want, _c in windows(cell, record, "bfloat16"):
        out[bt] = [{"deviceId": d, "Cnt": c, "AvgT": m, "MaxT": x}
                   for d, c, m, x in zip(want["dev"].tolist(), want["cnt"].tolist(),
                                         want["mean"].tolist(), want["maxt"].tolist())]
    return {OUTPUT: out}
