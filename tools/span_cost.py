"""What a span costs the host: microseconds a span through the port's
tracer, the way a host emits it (one span under an active batch trace,
observed by the stage histograms, written to the telemetry writers).

    python3 tools/span_cost.py [--root DIR] [--spans N] [--repeats R]

Three ways: the process log alone with INFO off (a job without a
tracefile, as the benchmark's untraced runs), the process log and a
JSONL flight recorder (``telemetry.tracefile``, a traced run), and no
active trace (the no-op path). ``--root`` imports the port from another
checkout, such as an unpacked earlier commit, to compare the two in one
call. Prints one JSON line: the median of ``--repeats`` timings of
``--spans`` spans each, in microseconds a span.
"""

import argparse
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "no card"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--spans", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=7)
    a = ap.parse_args(argv)
    sys.path.insert(0, a.root)
    from data_accelerator_tpu_torch.obs import telemetry, tracing
    from data_accelerator_tpu_torch.obs.histogram import HistogramRegistry

    logging.getLogger().setLevel(logging.WARNING)

    def per_span_us(writers) -> float:
        tracer = tracing.Tracer(
            telemetry.TelemetryLogger("DATAX-SpanCost", writers),
            histograms=HistogramRegistry(), flow="SpanCost",
        )
        timings = []
        for _ in range(a.repeats):
            ctx = tracer.begin("streaming/batch", batchTime=1)
            with ctx.activate():
                t0 = time.perf_counter()
                for _ in range(a.spans):
                    with tracing.span("sink/file/encode", rows=1):
                        pass
                timings.append((time.perf_counter() - t0) / a.spans * 1e6)
            ctx.end()
        return statistics.median(timings)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        log_only = per_span_us([telemetry.LogWriter()])
        recorder = per_span_us([telemetry.LogWriter(), telemetry.JsonlWriter(path)])
    t0 = time.perf_counter()
    for _ in range(a.spans):
        with tracing.span("sink/file/encode", rows=1):
            pass
    no_trace = (time.perf_counter() - t0) / a.spans * 1e6
    print(json.dumps({
        "root": a.root, "spans": a.spans, "repeats": a.repeats,
        "us_a_span_log_only": log_only, "us_a_span_with_tracefile": recorder,
        "us_a_span_no_trace": no_trace, "card": _card(),
    }), flush=True)


if __name__ == "__main__":
    main()
