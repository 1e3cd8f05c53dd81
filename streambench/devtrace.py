"""The benchmark's own ``torch.profiler`` window, and its reduction.

A traced run (``--trace 1``) profiles a few steady batches of the
window itself, so that the yardstick does not move with the program's
own capture surface. The Chrome trace that ``torch.profiler`` exports
gives every kernel, copy and memset on the card with its start and
length; a range opened at a known host time ties the trace's clock to
``time.time()``, on which the program's spans are stamped.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CLOCK_MARK = "streambench/clock"


class Capture:
    """One profiler window: ``start()`` and ``stop()`` from the thread
    that drives the batches; ``read()`` after the run."""

    def __init__(self, path: Path, cuda: bool):
        self.path = Path(path)
        self.cuda = cuda
        self._prof = None
        self.wall0 = self.wall1 = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        with torch.profiler.record_function(CLOCK_MARK):
            self.wall0 = time.time()

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.wall1 = time.time()
        self._prof.stop()

    def export(self) -> None:
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None

    def read(self) -> dict:
        """The card's operations as (start, end, name), in host-clock
        seconds, and the window's host-clock edges."""
        with open(self.path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
        offset = None
        device: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            if e.get("name") == CLOCK_MARK and offset is None:
                offset = self.wall0 - float(e["ts"]) * 1e-6
            elif e.get("cat") in DEVICE_CATS:
                t = float(e["ts"]) * 1e-6
                device.append((t, t + float(e.get("dur", 0.0)) * 1e-6, e["name"]))
        offset = offset or 0.0
        device = [(a + offset, b + offset, n) for a, b, n in device]
        return {"device": device, "wall0": self.wall0, "wall1": self.wall1}


def union(intervals) -> List[Tuple[float, float]]:
    """Merged [start, end) of the intervals, in order."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted((a, b) for a, b, *_ in intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_within(merged, lo: float, hi: float) -> float:
    """Seconds of ``merged`` inside [lo, hi)."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def top_ops(device, n: int = 10) -> list:
    totals: dict = {}
    for a, b, name in device:
        totals[name[:120]] = totals.get(name[:120], 0.0) + (b - a)
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def label_at(spans, t: float) -> str:
    """The innermost host span open at ``t`` (the shortest that holds
    it), or that none was."""
    best: Optional[Tuple[float, str]] = None
    for s in spans:
        if s["start"] <= t < s["end"] and (best is None or s["end"] - s["start"] < best[0]):
            best = (s["end"] - s["start"], s["name"])
    return best[1] if best else "(no span open)"


def idle_gaps(merged, lo: float, hi: float, spans, n: int = 10) -> list:
    """The device's idle time in [lo, hi), split at the host spans'
    edges and summed by the innermost host span open across each piece;
    the largest ``n``."""
    edges = sorted({t for s in spans for t in (s["start"], s["end"]) if lo < t < hi})
    totals: dict = {}
    edge = lo
    for a, b in merged + [(hi, hi)]:
        a, b = max(a, lo), min(b, hi)
        if a > edge:
            cuts = [edge] + [t for t in edges if edge < t < a] + [a]
            for x, y in zip(cuts, cuts[1:]):
                key = label_at(spans, (x + y) / 2.0)
                totals[key] = totals.get(key, 0.0) + (y - x)
        edge = max(edge, b)
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def read_spans(tracefile: Path) -> list:
    """The program's span records from its telemetry trace file (and the
    rotated segment before it), as dicts with host-clock ``start`` and
    ``end`` seconds, ``name``, ``trace`` and ``props``."""
    spans = []
    for p in (Path(str(tracefile) + ".1"), Path(tracefile)):
        if not p.exists():
            continue
        with open(p, encoding="utf-8") as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if r.get("type") != "span":
                    continue
                start = float(r["startTs"])
                spans.append({
                    "name": r["name"], "trace": r.get("trace"),
                    "start": start, "end": start + float(r["durationMs"]) / 1e3,
                    "ms": float(r["durationMs"]), "props": r.get("properties") or {},
                })
    return spans
