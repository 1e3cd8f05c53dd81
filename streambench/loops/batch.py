"""The batch loop: ``BatchHost.run``, the batch job's pass over
time-partitioned JSON-lines files, passes back to back.

The generator writes the archive once a run, under the run's TMPDIR.
Pass ``k`` reads it through a directory link of its own
(``archive/pass-k``): the conf's path pattern matches every pass's
links, and the processed-files tracker, which the host writes after each
pass, leaves only the new pass's files to read. Pass 0 is set-up (it
warms every shape a pass uses, all of them full chunks); the window
opens as pass 1 starts and takes whole passes, as many as start within
``seconds``: the rate is the events of those passes over the time from
the window's open to the last one's end.

The benchmark records the passes' batch times (around the processor's
``dispatch_batch``) and each chunk's rows (around ``encode_rows``), and
times each ``read_json_file`` call as its own ``parse`` span.
"""

from __future__ import annotations

import collections
import gc
import json
import subprocess
import sys
import time

from streambench import devtrace
from streambench.harness import HERE, boot_at, load_json
from streambench.outputs import read_outputs

GENERATOR = HERE / "traffic" / "generator.py"
# a CPU rehearsal's archive
REHEARSAL_ARCHIVE = {"files": 2, "events_per_file": 3000}


def shrink(cell) -> None:
    """The cell at a CPU rehearsal's size: its archive cut."""
    cell.config["archive"] = dict(REHEARSAL_ARCHIVE)


def start_traffic(cell):
    """Start the generator process, which writes the archive."""
    a = cell.config["archive"]
    out = cell.tmp / "job" / "archive" / "data"
    out.mkdir(parents=True)
    return subprocess.Popen(
        [sys.executable, str(GENERATOR), "--mix", str(cell.mix_path),
         "--seed", str(cell.seed), "--mode", "files", "--out", str(out),
         "--files", str(a["files"]), "--events-per-file", str(a["events_per_file"])],
        stdout=subprocess.PIPE, text=True,
    )


def stop_traffic(gen) -> None:
    if gen.poll() is None:
        gen.kill()
    gen.wait(timeout=30)
    gen.stdout.close()


class Recorder:
    """Wraps the host's processor and its module's ``read_json_file``."""

    def __init__(self, host, batchhost_mod):
        self.passes = []
        self.parse = []  # (wall start, wall end) of each read_json_file
        proc = host.processor
        encode, dispatch = proc.encode_rows, proc.dispatch_batch
        read = batchhost_mod.read_json_file

        def rec_encode(rows, base_ms, source=None):
            self.passes[-1]["chunks"].append({"rows": len(rows)})
            return encode(rows, base_ms, source=source)

        def rec_dispatch(raw, batch_time_ms=None):
            self.passes[-1]["bt"] = batch_time_ms
            return dispatch(raw, batch_time_ms)

        def rec_read(path):
            w0 = time.time()
            try:
                return read(path)
            finally:
                self.parse.append((w0, time.time()))

        proc.encode_rows, proc.dispatch_batch = rec_encode, rec_dispatch
        batchhost_mod.read_json_file = rec_read
        self._restore = lambda: setattr(batchhost_mod, "read_json_file", read)

    def restore(self) -> None:
        self._restore()


def run_pass(host, rec: Recorder, archive, k: int) -> dict:
    (archive / f"pass-{k}").symlink_to("data", target_is_directory=True)
    p = {"k": k, "bt": None, "chunks": [], "start": time.monotonic(),
         "start_wall": time.time()}
    rec.passes.append(p)
    host.run()
    p["end"], p["end_wall"] = time.monotonic(), time.time()
    return p


def span_totals(spans, passes, parse) -> None:
    """Each pass's chunk spans, summed by name, onto its record, with
    the benchmark's own ``parse`` spans."""
    by_bt = {p["bt"]: p for p in passes}
    for p in passes:
        p["spans"] = collections.Counter()
    for s in spans:
        p = by_bt.get(s["props"].get("batchTime")) if s["name"] == "batch/chunk" else None
        if p is not None:
            p.setdefault("traces", set()).add(s["trace"])
    by_trace = {t: p for p in passes for t in p.get("traces", ())}
    for s in spans:
        p = by_trace.get(s["trace"])
        if p is not None:
            p["spans"][s["name"]] += s["ms"]
    for w0, w1 in parse:
        for p in passes:
            if p["start_wall"] <= w0 < p["end_wall"]:
                p["spans"]["parse"] += (w1 - w0) * 1e3


def run(cell, gen, device) -> dict:
    import torch

    from data_accelerator_tpu_torch.core.confmanager import ConfigManager
    from data_accelerator_tpu_torch.runtime import batchhost as batchhost_mod

    marks = {"imported": boot_at(time.monotonic()) - cell.proc_start}

    job, out = cell.tmp / "job", cell.tmp / "out"
    out.mkdir(parents=True)
    tracefile = cell.tmp / "trace.jsonl"
    extra = {"datax.job.process.telemetry.tracefile": str(tracefile)} if cell.trace else {}
    conf = cell.materialize_conf(job, out, extra)
    ConfigManager.reset()
    ConfigManager.get_configuration_from_arguments([f"conf={conf}"])
    host = batchhost_mod.BatchHost(ConfigManager.load_config(), device=device)
    marks["host_ready"] = boot_at(time.monotonic()) - cell.proc_start
    cuda = host.processor.device.type == "cuda"
    rec = Recorder(host, batchhost_mod)
    if gen.stdout.readline().strip() != "done":
        raise RuntimeError("the traffic generator did not write the archive")
    marks["traffic_ready"] = boot_at(time.monotonic()) - cell.proc_start
    archive = job / "archive"
    cap = devtrace.Capture(cell.tmp / "profile.json", cuda) if cell.trace else None
    try:
        run_pass(host, rec, archive, 0)
        if cap is not None:
            cap.start()  # before the window opens: starting takes seconds
        t_open = time.monotonic()
        setup_s = boot_at(t_open) - cell.proc_start
        k = 1
        while k == 1 or time.monotonic() - t_open < cell.seconds:
            run_pass(host, rec, archive, k)
            if cap is not None and k == 1:
                cap.stop()
            k += 1
    finally:
        rec.restore()
    peak = int(torch.cuda.max_memory_allocated(host.processor.device)) if cuda else 0
    got = read_outputs(cell.config, out)
    del host
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    window = rec.passes[1:]
    events = sum(c["rows"] for p in window for c in p["chunks"])
    elapsed = window[-1]["end"] - t_open
    record = {
        "loop": "batch", "config": cell.config["name"],
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": peak,
        },
        "setup_s": setup_s, "events_per_s": events / elapsed,
        "attempted": events, "failed": 0,
        "passes": rec.passes, "window_passes": window, "outputs": got,
        "lines": [json.dumps({
            "setup_marks_s": marks, "passes": len(rec.passes), "window_passes": len(window),
            "window_s": elapsed, "window_events": events,
            "pass_s": [round(p["end"] - p["start"], 4) for p in rec.passes]})],
    }
    if cell.trace:
        spans = devtrace.read_spans(tracefile)
        span_totals(spans, rec.passes, rec.parse)
        cap.export()
        data = cap.read()
        merged = devtrace.union(data["device"])
        p1 = rec.passes[1]
        lo, hi = p1["start_wall"], p1["end_wall"]
        parse_spans = [{"name": "parse (read_json_file)", "start": a, "end": b}
                       for a, b in rec.parse]
        record["profile"] = {
            "busy_s": devtrace.busy_within(merged, data["wall0"], data["wall1"]),
            "window_s": data["wall1"] - data["wall0"],
            "pass": {"bt": p1["bt"], "host_s": hi - lo,
                     "busy_s": devtrace.busy_within(merged, lo, hi),
                     "chunks": len(p1["chunks"]),
                     "rows": sum(c["rows"] for c in p1["chunks"]),
                     "score_kernel_s": sum(b - a for a, b, n in data["device"]
                                           if "anomaly_score" in n)},
            "breakdown": {
                "device_ops": devtrace.top_ops(data["device"]),
                "idle_gaps": devtrace.idle_gaps(merged, lo, hi, spans + parse_spans),
            },
        }
        record["peaks"] = load_json(HERE / "peaks.json").get(record["device"]["kind"])
    return record
