"""The streaming loop: ``StreamingHost.run``, the paced loop that
``runtime.host.main`` runs for every deployed streaming job, fed from
its socket source by the generator's open loop, and from one more socket
source a side stream of the mix (``traffic/generator.py``), each by a
generator process of its own.

Timeline of a run, on ``time.monotonic()``:

- ``t0``: the generator starts its schedule, event ``i`` due at
  ``t0 + i / rate``;
- ``t0 + interval``: the host's loop starts, so its first poll finds an
  interval's events;
- ``t_open = t0 + fill_batches * interval``: the window opens; the fill
  batches before it fill the 5 s window that HeatAvg reads;
- ``t_close = t_open + seconds``: the last event is due; the loop then
  runs until every event of the window is acked, for at most a minute.

An event's latency runs from its due time to the ack of the batch that
consumed it: the host acks its sources after the sinks wrote and the
processor committed. Latency is over the primary source's events; a
run's ``attempted`` and ``failed`` count those and every side stream's
readings due in the window, a reading never acked as lost. The
benchmark records, around every source's ``poll_raw`` and ``ack`` and
the processor's ``dispatch_batch``, which consecutive events or readings
each batch consumed of each source, its batch time, and when it was
polled and acked; that framing is all the plain reference takes from
the run.
"""

from __future__ import annotations

import collections
import gc
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np

from streambench import devtrace
from streambench.harness import HERE, boot_at, load_json
from streambench.outputs import read_outputs
from streambench.traffic import generator

GENERATOR = HERE / "traffic" / "generator.py"
# the stream cycles over this many distinct events (about 280 MB of JSON)
POOL_EVENTS = 1 << 21
# how long past the close the loop may take to ack the window's events
DRAIN_LIMIT_S = 60.0
# a traced run profiles this many batches, from the third after the open
PROFILE_AFTER = 2
PROFILE_BATCHES = 4
# a CPU rehearsal's offered rate (events/s)
REHEARSAL_RATE = 2000.0


def shrink(cell) -> None:
    """The cell at a CPU rehearsal's size: its offered rate cut."""
    cell.workload["rate"] = REHEARSAL_RATE


def _generator(cell, *args):
    return subprocess.Popen(
        [sys.executable, str(GENERATOR), "--mix", str(cell.mix_path),
         "--seed", str(cell.seed), "--mode", "socket", *args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
    )


def start_traffic(cell) -> dict:
    """Start a generator process a stream, keyed by the source it feeds
    (``None``: the primary); the main stream's builds its pool from the
    seed while the program starts."""
    gens = {None: _generator(cell, "--pool", str(POOL_EVENTS))}
    for name in cell.mix.get("streams", {}):
        gens[name] = _generator(cell, "--stream", name)
    return gens


def stop_traffic(gens: dict) -> None:
    for gen in gens.values():
        if gen.poll() is None:
            gen.kill()
        gen.wait(timeout=30)
        for f in (gen.stdin, gen.stdout):
            try:
                f.close()
            except OSError:
                pass


class Framing:
    """Wraps the host's sources and processor to record each batch: the
    primary source's events it consumed ``[frm, to)``, its batch time
    ``bt``, and its poll and ack instants on both clocks; and, under
    ``sources``, each source's consumed range and ack by source name."""

    def __init__(self, host, on_ack=None):
        self.polls = []
        self.on_ack = on_ack
        self.primary = host.processor.primary
        # each source's range in the batch being polled; after the
        # dispatch, (range, batch record) of the batches not yet acked
        self._polled = {}
        self._unacked = {name: collections.deque() for name in host.sources}
        for name, src in host.sources.items():
            self._wrap(name, src)
        proc = host.processor
        dispatch = proc.dispatch_batch

        def rec_dispatch(raw, batch_time_ms=None):
            rec = self.polls[-1]
            rec["bt"] = batch_time_ms
            rec["sources"], self._polled = self._polled, {}
            for name, r in rec["sources"].items():
                self._unacked[name].append((r, rec))
            return dispatch(raw, batch_time_ms)

        proc.dispatch_batch = rec_dispatch

    def _wrap(self, name, src) -> None:
        poll_raw, ack, key = src.poll_raw, src.ack, src.name
        primary = name == self.primary

        def rec_poll(max_events):
            t, w = time.monotonic(), time.time()
            blob, n, offsets = poll_raw(max_events)
            frm, to = offsets[(key, 0)]
            self._polled[name] = {"frm": frm, "to": to, "ack": None}
            if primary:
                self.polls.append({"i": len(self.polls), "poll": t, "poll_wall": w,
                                   "frm": frm, "to": to, "sources": {},
                                   "bt": None, "ack": None, "ack_wall": None})
            return blob, n, offsets

        def rec_ack():
            ack()
            t = time.monotonic()
            r, rec = self._unacked[name].popleft()
            r["ack"] = t
            if primary:
                rec["ack"], rec["ack_wall"] = t, time.time()
                if self.on_ack is not None:
                    self.on_ack(rec)

        src.poll_raw, src.ack = rec_poll, rec_ack

    def acked_to(self, name=None) -> int:
        """Every event of the primary source (or of source ``name``)
        before this index is acked (acks are in order)."""
        done = [s["to"] for r in self.polls
                for s in [r["sources"].get(name or self.primary)]
                if s is not None and s["ack"] is not None]
        return done[-1] if done else 0


class Profiling:
    """Starts the capture after the ack of the first batch polled at or
    after ``t_from`` and stops it after the ack of the
    ``PROFILE_BATCHES``-th batch polled after that, from the loop's own
    thread (whose pacing sleep follows each ack)."""

    def __init__(self, capture, framing: Framing, t_from: float):
        self.capture, self.framing, self.t_from = capture, framing, t_from
        self.first = None
        self.state = "armed"

    def __call__(self, rec) -> None:
        if self.state == "armed" and rec["poll"] >= self.t_from:
            self.capture.start()
            self.first = rec["i"] + 1
            self.state = "on"
        elif self.state == "on" and rec["i"] == self.first + PROFILE_BATCHES - 1:
            self.capture.stop()
            self.state = "done"

    def batches(self):
        if self.state != "done":
            return []
        return self.framing.polls[self.first:self.first + PROFILE_BATCHES]


def latencies(polls, t0, rate, i_open, total, end):
    """Latency (ms) of each event due in the window, and how many were
    never acked (counted at ``end``)."""
    out, covered = [], 0
    for r in polls:
        lo, hi = max(r["frm"], i_open), min(r["to"], total)
        if hi <= lo or r["ack"] is None:
            continue
        due = t0 + np.arange(lo, hi, dtype=np.float64) / rate
        out.append((r["ack"] - due) * 1e3)
        covered += hi - lo
    lost = (total - i_open) - covered
    if lost:
        acked = np.zeros(total - i_open, bool)
        for r in polls:
            lo, hi = max(r["frm"], i_open), min(r["to"], total)
            if hi > lo and r["ack"] is not None:
                acked[lo - i_open:hi - i_open] = True
        idx = np.nonzero(~acked)[0] + i_open
        out.append((end - (t0 + idx / rate)) * 1e3)
    return (np.concatenate(out) if out else np.zeros(0)), lost


def unacked(polls, name: str, lo: int, hi: int) -> int:
    """How many of source ``name``'s items ``[lo, hi)`` no acked batch
    consumed."""
    acked = np.zeros(max(0, hi - lo), bool)
    for r in polls:
        s = r["sources"].get(name)
        if s is not None and s["ack"] is not None:
            acked[max(s["frm"] - lo, 0):max(s["to"] - lo, 0)] = True
    return int((~acked).sum())


def span_totals(spans, polls) -> None:
    """Each batch's spans, summed by name, onto its framing record
    (``spans``); a batch is found by its root span's batch time."""
    by_trace = {s["trace"]: s["props"].get("batchTime")
                for s in spans if s["name"] == "streaming/batch"}
    by_bt = {r["bt"]: r for r in polls}
    for r in polls:
        r["spans"] = collections.Counter()
    for s in spans:
        r = by_bt.get(by_trace.get(s["trace"]))
        if r is not None:
            r["spans"][s["name"]] += s["ms"]


def profile_summary(cap, prof_batches, spans) -> dict:
    data = cap.read()
    merged = devtrace.union(data["device"])
    w0, w1 = data["wall0"], data["wall1"]
    batches = []
    for r in prof_batches:
        lo, hi = r["poll_wall"], r["ack_wall"]
        batches.append({
            "bt": r["bt"], "host_s": hi - lo,
            "busy_s": devtrace.busy_within(merged, lo, hi),
            "score_kernel_s": sum(
                b - a for a, b, n in data["device"]
                if "anomaly_score" in n and lo <= a < hi),
        })
    between = "(after the ack: the batch tail, the pacing sleep)"
    host_spans = spans + [{"name": between, "start": w0, "end": prof_batches[0]["poll_wall"]}] + [
        {"name": between, "start": a["ack_wall"], "end": b["poll_wall"]}
        for a, b in zip(prof_batches, prof_batches[1:])]
    return {
        "busy_s": devtrace.busy_within(merged, w0, w1),
        "window_s": w1 - w0,
        "batches": batches,
        "breakdown": {
            "device_ops": devtrace.top_ops(data["device"]),
            "idle_gaps": devtrace.idle_gaps(merged, w0, w1, host_spans),
        },
    }


def run(cell, gens, device) -> dict:
    import torch

    from data_accelerator_tpu_torch.core.confmanager import ConfigManager
    from data_accelerator_tpu_torch.runtime.host import StreamingHost

    marks = {"imported": boot_at(time.monotonic()) - cell.proc_start}

    job, out = cell.tmp / "job", cell.tmp / "out"
    job.mkdir(parents=True)
    out.mkdir(parents=True)
    tracefile = cell.tmp / "trace.jsonl"
    extra = {"datax.job.process.telemetry.tracefile": str(tracefile)} if cell.trace else {}
    conf = cell.materialize_conf(job, out, extra)
    ConfigManager.reset()
    ConfigManager.get_configuration_from_arguments([f"conf={conf}"])
    host = StreamingHost(ConfigManager.load_config(), device=device)
    marks["host_ready"] = boot_at(time.monotonic()) - cell.proc_start
    cuda = host.device.type == "cuda"
    framing = Framing(host)
    interval = host.interval_s
    rate = float(cell.workload["rate"])
    fill = int(cell.workload["fill_batches"])

    for name, gen in gens.items():
        ready = gen.stdout.readline().split()
        if not ready or ready[0] != "ready":
            raise RuntimeError(f"the traffic generator of {name or 'the primary'} "
                               f"did not start: {ready}")
    marks["traffic_ready"] = boot_at(time.monotonic()) - cell.proc_start
    t0 = time.monotonic() + 0.1
    t_open = t0 + fill * interval
    t_close = t_open + cell.seconds
    total = int(round((t_close - t0) * rate))
    i_open = int(math.ceil((t_open - t0) * rate))
    # each side stream's readings [open, total) fall due in the window
    sides = {}
    for name in gens:
        if name is not None:
            spec = cell.mix["streams"][name]
            sides[name] = {
                "open": generator.due_before(spec, fill * interval),
                "total": generator.due_before(spec, fill * interval + cell.seconds)}
    for name, gen in gens.items():
        port = host.source.port if name is None else host.sources[name].port
        n = total if name is None else sides[name]["total"]
        gen.stdin.write(f"go {port} {t0!r} {rate!r} {n}\n")
        gen.stdin.flush()
    setup_s = boot_at(t_open) - cell.proc_start

    cap = None
    if cell.trace:
        cap = devtrace.Capture(cell.tmp / "profile.json", cuda)
        framing.on_ack = Profiling(cap, framing, t_open + PROFILE_AFTER * interval)

    errors = []

    def loop():
        try:
            time.sleep(max(0.0, t0 + interval - time.monotonic()))
            host.run()
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    th = threading.Thread(target=loop, name="streambench-loop")
    th.start()
    deadline = t_close + DRAIN_LIMIT_S
    time.sleep(max(0.0, t_close - time.monotonic()))
    while time.monotonic() < deadline and not errors and (
            framing.acked_to() < total
            or any(framing.acked_to(n) < s["total"] for n, s in sides.items())):
        time.sleep(0.01)
    end = time.monotonic()
    host._stop = True  # the loop ends after the batch it is running
    th.join(timeout=120)
    if th.is_alive():
        raise RuntimeError("the host's loop did not stop within 120 s")
    if errors:
        raise errors[0]
    gen_stats = {name or "primary": json.loads(gen.stdout.readline() or "{}")
                 for name, gen in gens.items()}
    peak = int(torch.cuda.max_memory_allocated(host.device)) if cuda else 0
    host.stop()
    got = read_outputs(cell.config, out, host.metric_logger)
    prof_batches = framing.on_ack.batches() if cap is not None else []
    del host, framing.on_ack
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    polls = framing.polls
    lat, lost = latencies(polls, t0, rate, i_open, total, end)
    for name, side in sides.items():
        side["lost"] = unacked(polls, name, side["open"], side["total"])
    # the loop's state at the close: the backlog (events due but not yet
    # polled) at the last poll before it, and the batches that overran
    # the interval (poll to ack)
    before = [r for r in polls if r["poll"] < t_close] or polls[:1]
    backlog = int((before[-1]["poll"] - t0) * rate) - before[-1]["to"]
    busy = [(r["ack"] - r["poll"]) * 1e3 for r in polls if r["ack"] is not None]
    loop_state = {
        "backlog_at_close": backlog,
        "overruns": sum(1 for r in polls if r["poll"] >= t_open and r["ack"] is not None
                        and r["ack"] - r["poll"] > interval),
        "batch_ms_max": max(busy) if busy else None,
        "batches": [[round(r["poll"] - t0, 2), r["to"] - r["frm"],
                     round((r["ack"] - r["poll"]) * 1e3) if r["ack"] else None]
                    for r in polls],
    }
    record = {
        "loop": "stream", "config": cell.config["name"],
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": peak,
        },
        "setup_s": setup_s, "latencies_ms": lat,
        "attempted": total - i_open + sum(s["total"] - s["open"] for s in sides.values()),
        "failed": lost + sum(s["lost"] for s in sides.values()),
        "framing": [{**{k: r[k] for k in ("frm", "to", "bt", "poll", "ack")},
                     "sources": {n: (s["frm"], s["to"]) for n, s in r["sources"].items()}}
                    for r in polls],
        "streams": sides,
        "window_batches": [r for r in polls if r["poll"] >= t_open and r["ack"] is not None],
        "pool_events": POOL_EVENTS, "outputs": got,
        "lines": [json.dumps({"setup_marks_s": marks, "generator": gen_stats,
                              "window_events": total - i_open, "rate": rate,
                              "side_streams": sides, **loop_state})],
    }
    if cell.trace:
        spans = devtrace.read_spans(tracefile)
        span_totals(spans, polls)
        if prof_batches:
            cap.export()
            record["profile"] = profile_summary(cap, prof_batches, spans)
        record["peaks"] = load_json(HERE / "peaks.json").get(record["device"]["kind"])
    return record
