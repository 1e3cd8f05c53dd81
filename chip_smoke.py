"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every hand-written kernel compiled with ``nvcc``, all at once,
   with each kernel's registers, shared memory and spill bytes as
   ``ptxas -v`` reported them, and the JSON decoder with ``g++`` beside
   them;
3. kernel_check: each kernel held against its plain PyTorch version on
   the card at ragged sizes, at views that start 0-3 rows past a 16-byte
   boundary (for ``anomaly_score`` every pair of offsets of x and mu), for
   float32 and int32 rows (and ``dx305_double`` at user grids of 1 and 3
   blocks), then timed with CUDA events at the main
   path's shape and, for device time alone, at ``N_LARGE`` rows, beyond
   the L2 cache; host_split: the host's time for the parts of one call;
4. ingest: the main path from JSON bytes (``bench.py::make_json_payload``'s
   distribution, from the seed): the single-source alerting flow plus
   the anomaly-score query (BASELINE configs 1 and 4) through the port's
   native decoder into one pinned matrix a batch, one host-to-device
   copy, and results streamed back on a side stream, in a depth-2
   pipelined loop whose tables land on a background thread; against the
   CPU run of the same bytes, with host syncs, pool reuse, the anomaly
   kernel's launches and one profiled step's host-to-device copies
   checked;
   flow: the same flow through ``FlowProcessor`` at full batch
   capacity on the card, batch for batch against the same flow on the
   CPU, with every kernel's launch count read from that run. A step is
   timed from the host columns (pinned and copied to the card by
   ``encode_columns``) to the counts vector on the host;
5. udf_flow: a user UDF whose body is its own CUDA kernel, declared in
   the flow's conf (``tests/data/udfs_torch/dx305_cuda.py:clean``,
   kernel ``dx305_double.cu``), through its own ``FlowProcessor`` on the
   same batches, timed and checked the same way;
6. host: the main path as users run it, through the port's
   ``StreamingHost``: the same flow from socket bytes (a feeder thread
   writes ``BATCHES`` seeded payloads), its UDF declared in the conf,
   ``run_pipelined`` at depth 2 with background landing, sinks, acks,
   metrics and window/offset checkpoints every second; each batch's rows
   held against a CPU replay of the bytes, base and batch time the host
   used, 0 host syncs in poll, encode and dispatch, the anomaly kernel's
   launches read from the host's UDF, and a successor host on the same
   checkpoint directory restoring the last saved window and matching the
   CPU replay continued from it;
   host_cli: ``runtime.host.main`` on a conf file it writes, local
   simulated input at full capacity, the default pilot, 3 batches;
   observe: the observability plane. The card's machine profile with
   the process cache emptied (every ``Calib_*``; HBM read and write at
   or under the published 3,350 GB/s, D2H positive, a decode rate, the
   probe's memory gone from the allocator's peak); then the host phase's
   flow and bytes plus a passthrough output through ``run_pipelined``
   at depth 2 with fleet frames every second to an in-process object
   store, the protocol monitor and an observability port, a
   ``torch.profiler`` capture of 2 s armed over ``POST /profile`` once the
   first batch is dispatched; a restart successor on the same checkpoint
   directory publishing as ``r2``. Rows against the CPU replay,
   ``Calib_*`` on every batch, protocol events and no violation, one
   ``profiler/capture`` span and a capture holding ``anomaly_score``
   and the dispatch and landing threads' CPU ops, 0 host syncs; the
   ``FleetView`` over the store (counters equal to the hosts' sums, the
   merged batch histogram, both replicas completed, lineage ``r1`` ->
   ``r2``, the DX54x audit conserved) and the ``obs`` CLI's ``spans
   --aggregate`` and ``trace --stitch`` over the flight recorder;
7. gen_conf: ``runtime.host.main`` on the conf the reference's control
   plane generates for the config-1 queries (committed under
   ``tests/data/generated_torch/`` at 262,144 rows a batch, with its alert
   rules, conformance model and compile manifest), from its local
   source for two batches past the conformance monitor's warm-up; the
   firing set from ``GET /alerts``, the DX5xx events and
   ``Conformance_*`` ratios (DX501-503 silent, DX522 fired exactly when
   a judged ratio is past its band), the ``Conf_*`` gauges, the
   manifest warm's ``Compile_ColdStart_Ms`` (no warm misses) and the
   first batch's dispatch time against the same conf without the
   manifest, run first and freed before the peak memory restarts; the
   manifest run's host calibrates the card at its init (the process
   cache emptied): ``Calib_*`` on every batch, each stage's calibrated
   prediction and whether it is judged, its ``Conformance_StageTime_*``
   ratio on every batch, DX520/521 fired exactly when a judged ratio is
   past its band, and DX522 silent;
   storm: the two-stream window join (``__graft_entry__``'s StormDoors
   flow, the port's copy, plus a reference-data query) through
   ``StreamingHost.run_pipelined`` at depth 2 from two sockets: 262,144
   IoT rows a batch and a weather stream whose three stations report
   once every fifth batch; each batch's rows held against a CPU replay
   of what each source's poll returned, per-source input counts, 0 join
   rows dropped, 0 host syncs, a restart restoring both rings, and the
   join's device time against one profiled step;
   join_ops: the join ops alone, exact against the CPU, 0 host syncs,
   timed with CUDA events;
   state: BASELINE config 3's accumulator (``seen``, the largest value a
   key) and a 10 s window count, with 16 state partitions mirrored
   through an in-process ``ObjectStoreServer``: two predecessor replicas
   (``filteringest``) each fed the same 4 socket batches, one after the
   other under a pinned clock, stopped and freed without the cyclic
   collector; then a successor on fresh directories pulls every
   partition, merges the window rings, reloads ``seen`` and runs a
   fifth batch. Each row owned once, ``seen`` equal to numpy's, the
   window from ``partitions`` and its counts equal to one CPU replica's
   over the same five batches, 0 host syncs, with the landing thread's
   overwrite + persist ms, snapshot and state-copy bytes, pushes and the
   handoff's times;
8. livequery: the designer's kernels and the multi-tenant ``lq/``
   serving plane, every service and kernel on the card. ``lq_serve``:
   ``bench.py::bench_livequery``'s shape (60 rows, one ``GROUP BY``
   query, the ticker at 4 ms) under an open load of 8 tenants x 4
   sessions at 500/s, then 32 x 8 at 2,000/s, 1.5 s each, through 64
   workers: every result equal to the CPU's, one compiled entry and one
   step-cache entry across both, no execute timed out; ``lq_quota``: 5
   executes over ``tenant.maxqps`` 1 refused with 0 dispatches;
   ``lq_designer``: schema inference polls 1,000 events of
   ``make_json_payload``'s distribution and writes the sample blob, a
   ``KernelService`` kernel built from it runs DoorEvents, OpenDoors,
   HeatAvg over the 5 s window and the anomaly query, each cold and 20
   times warm, against a CPU kernel, the anomaly kernel launched by
   every execute of its query, two threads on one kernel equal to a
   serial run; ``lq_cache``: three row buckets of a windowed query under
   a 9 MiB budget, each entry's modelled bytes beside the allocator's
   growth, the third evicting the first; then the card's allocation back
   to its value at the phase's start, every service stopped, with the
   cyclic collector off from the start (one collection before it sets
   the baseline and reports what earlier phases left as cyclic
   garbage);
9. debug: the host phase's main path with ``process.debug.nans``,
   ``tracerleaks`` and ``buffersanitizer`` armed, from a socket at
   depth 2 with checkpoints every second: rows against a CPU replay, 0
   poison hits, guarded views counted, events/s beside the host
   phase's and the host syncs the guards add per batch; then three
   seeded faults on the card: NaN temperatures raise
   ``FloatingPointError`` at ``anomaly_score``'s output in ``Scored``, a
   view of a pooled pinned matrix kept past its release is DX805, and
   batches decoded into poisoned, reused matrices at depth 2 land the
   CPU's rows;
   plan: ``analyze_processor`` over the main flow's card processor, its
   totals against ``device_bytes()``, the allocator's growth and its
   peak over the first step, each within a stated band; the latency
   model under the card's calibrated profile beside the measured step;
   the analysis CLI ``--device --udfs --json`` on the main flow's gui
   JSON, clean; ``lq_cache`` again, priced by the plan, now from a
   64-row bucket up (the plan rounds a card's tensors to 512-byte
   blocks); ``launchesPerStep`` (the step counted on ``meta``) beside
   one profiled step's device activities, and the launch-priced
   ``deviceStepMs`` (at or over the 1 ms floor) beside the measured
   step; the race, protocol and conf gates over the port's own source
   (no finding); ``--compile`` on the main flow at ``CAPACITY`` rows,
   its manifest's transfer entries equal to the slots a processor booted
   from it warms, and a host booted from it with no
   ``Compile_WarmMiss_Count``; the fleet tier over the main, storm and
   state flows' card plans on a one-card spec with the card's memory;
   gen_conf also says whether DX520 judges ``device-step`` now;
   chaos: the five drills of the JAX package's ``serve/scenarios.py``
   (preemption mid-window, sink outage, hot-key skew, malformed flood,
   rescale with state), pilot off and on, at depth 2 with the buffer
   sanitizer and the protocol monitor armed, on card hosts: the main
   flow plus an event-id witness at ``CAPACITY`` events a poll, the
   accumulator flow at ``CAPACITY`` rows a batch. Each drill's events/s,
   every event once, the per-event outputs against a CPU run of its
   events, 0 poison hits and violations, the pilot's actuation and
   ``anomaly_score``'s launches;
   control: the control plane's one-box stack in process (the REST API
   with roles, a gateway, the website) with a job client that spawns
   the port's host as a child process on the card. Through the website,
   in the SPA's order: save the main flow from a socket, validate with
   the device tier, generate configs, start the job for 4 batches, feed
   it 4 x ``CAPACITY`` seeded events, sync until it succeeds, stop.
   The child's log names a CUDA device and counts every event, each
   output's count per batch equals the port's host on the CPU over the
   same conf and bytes, the conf's conformance model is the port's
   plan; then a designer kernel and a LiveQuery session of the flow run
   the anomaly query, each equal to a CPU service on the same sample;
10. ground_truth: under ``torch.cuda.set_sync_debug_mode("error")`` the
   bad twins of the DX300, DX301 and DX305 analyzer fixtures raise on
   CUDA tensors and their clean twins run.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it. Without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import importlib.machinery
import importlib.util
import io
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import types
import warnings
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet) for the least-time bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

IOT_SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "deviceDetails", "type": {"type": "struct", "fields": [
            {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
            {"name": "deviceType", "type": "string", "nullable": False, "metadata": {}},
            {"name": "homeId", "type": "long", "nullable": False, "metadata": {}},
            {"name": "status", "type": "long", "nullable": False, "metadata": {}},
            {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
        ]}, "nullable": False, "metadata": {}},
    ],
})
TRANSFORM = (
    "--DataXQuery--\n"
    "DoorEvents = SELECT deviceDetails.deviceId AS deviceId, "
    "deviceDetails.deviceType AS deviceType, deviceDetails.status AS status, "
    "deviceDetails.homeId AS homeId, "
    "deviceDetails.temperature AS temperature, eventTimeStamp "
    "FROM DataXProcessedInput\n"
    "--DataXQuery--\n"
    "OpenDoors = SELECT deviceId, eventTimeStamp FROM DoorEvents "
    "WHERE deviceType = 'DoorLock' AND status = 0\n"
    "--DataXQuery--\n"
    "HeatAvg = SELECT deviceId, COUNT(*) AS Cnt, AVG(temperature) AS AvgT "
    "FROM DataXProcessedInput_5seconds GROUP BY deviceId\n"
    "--DataXQuery--\n"
    "Scored = SELECT deviceId, temperature, "
    "anomalyscore(temperature, deviceId) AS score FROM DoorEvents\n"
    "--DataXQuery--\n"
    "AnomalyAlerts = SELECT deviceId, score FROM Scored WHERE score > 0.9\n"
)
OUTPUTS = ["OpenDoors", "HeatAvg", "AnomalyAlerts"]
DEVICE_TYPES = ["Heating", "WindSpeed", "DoorLock"]
BASE_MS = 1_700_000_000_000
# the user-UDF flow: the query of tests/data/flows/dx305_udf_pallas.json
# over the IoT stream, its UDF declared in conf
UDF_TRANSFORM = (
    "--DataXQuery--\n"
    "S = SELECT deviceId, pdouble(temperature) AS p FROM DataXProcessedInput\n"
)
UDF_CLASS = "tests.data.udfs_torch.dx305_cuda:clean"
# the per-chip batch of bench.py; 8 batches 1 s apart evict the 5 s window
CAPACITY = 262_144
BATCHES = 8
# 64 x the batch: each kernel's bytes are beyond the 50 MB L2 at this size
N_LARGE = 16_777_216
# ragged sizes and view offsets (rows past a 16-byte boundary) the checks use
CHECK_SIZES = (1, 3, 5, 1023, 1025, CAPACITY)
OFFSETS = (0, 1, 2, 3)


def bind_repo_tests() -> None:
    """Bind the name ``tests`` to this checkout's ``tests/``, a namespace
    package that a regular ``tests`` package installed on the path would
    shadow: the user-UDF flow's conf names its UDF by the import path
    ``tests.data.udfs_torch.dx305_cuda:clean``."""
    spec = importlib.machinery.ModuleSpec("tests", None, is_package=True)
    spec.submodule_search_locations = [str(ROOT / "tests")]
    sys.modules["tests"] = importlib.util.module_from_spec(spec)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def flow_conf() -> dict:
    return {
        "datax.job.name": "ChipSmoke",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.input.default.inputtype": "local",
        "datax.job.input.default.blobschemafile": IOT_SCHEMA,
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.transform": TRANSFORM,
        "datax.job.process.timewindow.DataXProcessedInput_5seconds"
        ".windowduration": "5 seconds",
        "datax.job.process.projection": (
            "current_timestamp() AS eventTimeStamp\nRaw.*"
        ),
    }


def udf_flow_conf() -> dict:
    return {
        "datax.job.name": "ChipSmokeUdf",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.input.default.inputtype": "local",
        "datax.job.input.default.blobschemafile": IOT_SCHEMA,
        "datax.job.process.transform": UDF_TRANSFORM,
        "datax.job.process.projection": (
            "deviceDetails.deviceId AS deviceId\n"
            "deviceDetails.temperature AS temperature"
        ),
        "datax.job.process.jar.udf.pdouble.class": UDF_CLASS,
    }


def make_columns(rs, type_ids, n, alert_rate=0.01):
    """One batch in the shape of bench.py::make_json_payload: deviceId
    1-8, three device types, ~1% door-lock alerts, temperatures 0-100 at
    the payload's three decimals."""
    is_door = rs.uniform(size=n) < 2 * alert_rate
    type_col = np.where(is_door, 2, rs.randint(0, 2, n))
    status = np.where(is_door & (rs.uniform(size=n) < 0.5), 0, 1)
    return {
        "deviceDetails.deviceId": rs.randint(1, 9, n).astype(np.int32),
        "deviceDetails.deviceType": type_ids[type_col],
        "deviceDetails.homeId": np.full(n, 150, np.int32),
        "deviceDetails.status": status.astype(np.int32),
        "deviceDetails.temperature": np.round(rs.uniform(0, 100, n), 3).astype(np.float32),
    }


def cuda_ms_turns(fns: dict, runs: int = 25, warmup: int = 3) -> dict:
    """Median CUDA-event time of one call of each of ``fns`` (name ->
    function), their calls taken in turns, so that every function sees
    the host in the same state; a shared host's speed drifts between
    runs."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0)})
    return line


def phase_build() -> None:
    from data_accelerator_tpu_torch.kernels import build
    from tests.data.udfs_torch.dx305_cuda import SOURCE as DX305_SOURCE

    sources = ["anomaly_score", DX305_SOURCE]
    t0 = time.perf_counter()
    # the decoder's g++ runs beside the nvcc processes
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(build.build_host, "decoder")
        paths = build.build(sources)
        paths.append(host.result())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc": build.nvcc_path(), "libraries": [p.name for p in paths],
          "ptxas": {p.name: build.ptxas_usage(src)
                    for p, src in zip(paths, sources)}})


def bytes_bound_ms(n_bytes: int, flops: int):
    """The least time for the work, and which peak sets it."""
    bound_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FP32_FLOPS * 1e3
    if bound_bytes >= bound_ops:
        return bound_bytes, "bytes"
    return bound_ops, "operations"


def rows(rs, n, dtype, offset, lo, hi):
    """``n`` random rows as a view that starts ``offset`` rows past the
    start of its (16-byte aligned) allocation on the card."""
    if dtype is np.float32:
        base = rs.uniform(lo, hi, n + offset).astype(np.float32)
    else:
        base = rs.randint(int(lo), int(hi), n + offset, dtype=np.int64)
        base = base.astype(np.int32)
    return torch.from_numpy(base).to("cuda")[offset:]


def check_anomaly_score(rs):
    """Kernel against plain on the card (within 1e-6) at ``CHECK_SIZES``,
    every float32/int32 pair, x and mu each at every view offset, so one
    may be on a 16-byte boundary and the other off it; returns the max abs error and the timings at ``CAPACITY`` and
    ``N_LARGE`` rows."""
    from data_accelerator_tpu_torch.kernels.anomaly_score import (
        AnomalyScoreKernel,
        anomaly_score_plain as plain,
    )
    from data_accelerator_tpu_torch.kernels.timing import graph_ms

    kernel = AnomalyScoreKernel()
    max_err = 0.0
    for n in CHECK_SIZES:
        for x_dtype in (np.float32, np.int32):
            for mu_dtype in (np.int32, np.float32):
                for off, mu_off in ((a, b) for a in OFFSETS for b in OFFSETS):
                    x = rows(rs, n, x_dtype, off, -50, 150)
                    mu = rows(rs, n, mu_dtype, mu_off, -10, 10)
                    if x_dtype is np.float32:
                        x[::5] = mu[::5].to(torch.float32)  # score 0.5 exactly
                    got = kernel(x, mu)
                    torch.cuda.synchronize()
                    err = float((got - plain(x, mu)).abs().max())
                    if not err <= 1e-6:
                        raise AssertionError(
                            f"anomaly_score n={n} x={x_dtype.__name__} "
                            f"mu={mu_dtype.__name__} offsets={off},{mu_off}: "
                            f"max abs error {err} > 1e-6"
                        )
                    max_err = max(max_err, err)
    # main-path shape: float32 temperature, int32 deviceId
    x = rows(rs, CAPACITY, np.float32, 0, 0, 100)
    mu = rows(rs, CAPACITY, np.int32, 0, 1, 9)
    xl = rows(rs, N_LARGE, np.float32, 0, 0, 100)
    mul = rows(rs, N_LARGE, np.int32, 0, 1, 9)
    # x and mu read once, o written once: 12 B a row; sub, 2 abs, add,
    # div, neg, exp, add, div: 9 flops a row
    bound, bound_by = bytes_bound_ms(12 * CAPACITY, 9 * CAPACITY)
    bound_large, _ = bytes_bound_ms(12 * N_LARGE, 9 * N_LARGE)
    device_large = graph_ms(lambda: kernel(xl, mul), reps=10)
    calls = cuda_ms_turns({"kernel": lambda: kernel(x, mu),
                           "plain": lambda: plain(x, mu),
                           "torch_mul": lambda: torch.mul(x, 2.0)})
    return {
        "max_err": max_err,
        "kernel_ms": calls["kernel"],
        "plain_ms": calls["plain"],
        # the yardstick a call of the launch path is held to
        "torch_mul_ms": calls["torch_mul"],
        "device_ms": graph_ms(lambda: kernel(x, mu)),
        "plain_device_ms": graph_ms(lambda: plain(x, mu)),
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "n_large": N_LARGE,
        "device_ms_large": device_large,
        "bound_ms_large": bound_large,
        "bound_share_large": bound_large / device_large,
        "library_device_ms_large": None,
    }


def check_dx305(rs):
    """The user-UDF kernel ``dx305_double`` through ``cuda_call``, held
    against its plain version on the card (exactly: a cast and a
    multiply by 2 round the same everywhere) at ``CHECK_SIZES`` and view
    offsets, for float32 and int32 rows, and at user grids of 1 and 3
    blocks; then kernel, plain and ``torch.mul(x, 2.0)`` timed at
    ``CAPACITY`` float32 rows, and kernel and ``torch.mul`` on the
    device at ``N_LARGE``."""
    from data_accelerator_tpu_torch.kernels.launch import cuda_call
    from data_accelerator_tpu_torch.kernels.timing import graph_ms
    from tests.data.udfs_torch.dx305_cuda import (
        ENTRY, SOURCE, clean, double_plain as plain,
    )

    kernel = clean().kernel
    max_err = 0.0
    cases = [(n, dtype, off, None) for n in CHECK_SIZES
             for dtype in (np.float32, np.int32) for off in OFFSETS]
    cases += [(CAPACITY, dtype, off, grid) for grid in (1, 3)
              for dtype in (np.float32, np.int32) for off in (0, 1)]
    for n, dtype, off, grid in cases:
        x = rows(rs, n, dtype, off, -1e6, 1e6) if dtype is np.float32 else \
            rows(rs, n, dtype, off, -2**31, 2**31)
        if grid is None:
            got = kernel(x)
        else:
            got = cuda_call(SOURCE, ENTRY, x, out_shape=x.shape, grid=grid)
        torch.cuda.synchronize()
        ref = plain(x)
        err = float((got - ref).abs().max())
        if got.dtype != torch.float32 or not torch.equal(got, ref):
            raise AssertionError(
                f"dx305_double n={n} x={dtype.__name__} offset={off} "
                f"grid={grid}: max abs error {err}, not equal to the plain "
                "version"
            )
        max_err = max(max_err, err)
    x = rows(rs, CAPACITY, np.float32, 0, 0, 100)
    xl = rows(rs, N_LARGE, np.float32, 0, 0, 100)
    # x read, o written: 8 B a row; one multiply a row
    bound, bound_by = bytes_bound_ms(8 * CAPACITY, CAPACITY)
    bound_large, _ = bytes_bound_ms(8 * N_LARGE, N_LARGE)
    device_large = graph_ms(lambda: kernel(xl), reps=10)
    calls = cuda_ms_turns({"kernel": lambda: kernel(x),
                           "plain": lambda: plain(x),
                           "library": lambda: torch.mul(x, 2.0)})
    return {
        "max_err": max_err,
        "kernel_ms": calls["kernel"],
        "plain_ms": calls["plain"],
        "library_ms": calls["library"],
        "torch_mul_ms": calls["library"],
        "device_ms": graph_ms(lambda: kernel(x)),
        "plain_device_ms": graph_ms(lambda: plain(x)),
        "library_device_ms": graph_ms(lambda: torch.mul(x, 2.0)),
        "bound_ms": bound,
        "bound_by": bound_by,
        "n_large": N_LARGE,
        "device_ms_large": device_large,
        "bound_ms_large": bound_large,
        "bound_share_large": bound_large / device_large,
        "library_device_ms_large": graph_ms(lambda: torch.mul(xl, 2.0), reps=10),
    }


def host_us_turns(fns: dict, rounds: int = 20, block: int = 100) -> dict:
    """Median host time of one call of each of ``fns`` (name ->
    function) in microseconds: each round times a block of ``block``
    calls of every function in turn with ``time.perf_counter``; the card
    is synchronised between blocks, outside the timer, so its launch
    queue never fills."""
    for fn in fns.values():
        fn()
    per_call = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(block):
                fn()
            per_call[name].append((time.perf_counter() - t0) / block * 1e6)
    torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in per_call.items()}


def phase_host_split() -> None:
    """The host's time for the parts of one kernel call at ``CAPACITY``
    rows, for both kernels, all timed in turns: the whole call, the parts
    the launch path is made of (the output's allocation, the raw stream
    lookup, the current-device check, the ``ctypes`` call with the launch
    inside, and for ``cuda_call`` its two ``ctypes`` arrays and the counted
    launch under its lock), and ``torch.mul(x, 2.0)`` beside them.
    ``checks_us`` is the whole call less the parts timed alone: the
    argument checks and the Python glue."""
    import ctypes
    import threading

    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.kernels.anomaly_score import AnomalyScoreKernel
    from tests.data.udfs_torch.dx305_cuda import ENTRY, SOURCE, clean

    dev = torch.device("cuda")
    index = torch.cuda.current_device()
    x = torch.rand(CAPACITY, device=dev) * 100
    mu = torch.randint(1, 9, (CAPACITY,), dtype=torch.int32, device=dev)
    lock = threading.Lock()
    count = {ENTRY: 0}

    def count_launch():
        with lock:
            count[ENTRY] += 1

    anomaly = AnomalyScoreKernel()
    out = anomaly(x, mu)
    anomaly_entry = anomaly._entry()
    udf_kernel = clean().kernel
    udf_entry = launch._entry(SOURCE, ENTRY)
    ptrs, codes = (ctypes.c_void_p * 1)(x.data_ptr()), (ctypes.c_int * 1)(0)
    stream = launch.current_stream(index)
    fns = {
        "anomaly_call": lambda: anomaly(x, mu),
        "anomaly_ctypes_launch": lambda: anomaly_entry(
            x.data_ptr(), 0, mu.data_ptr(), 1, out.data_ptr(), CAPACITY,
            stream),
        "anomaly_empty": lambda: torch.empty_like(x, dtype=torch.float32),
        "dx305_call": lambda: udf_kernel(x),
        "dx305_ctypes_launch": lambda: udf_entry(
            ptrs, codes, 1, out.data_ptr(), 0, CAPACITY, 0, stream),
        "dx305_empty": lambda: x.new_empty((CAPACITY,), dtype=torch.float32),
        "arrays": lambda: ((ctypes.c_void_p * 1)(*[x.data_ptr()]),
                           (ctypes.c_int * 1)(*[0])),
        "lock_count": count_launch,
        "stream": lambda: launch.current_stream(index),
        "device_check": lambda: torch.cuda.current_device() == index,
        "torch_mul": lambda: torch.mul(x, 2.0),
    }
    us = host_us_turns(fns)
    common = {f"{k}_us": us[k] for k in ("stream", "device_check", "torch_mul")}
    for name, key, extra in (("anomaly_score", "anomaly", ()),
                             ("dx305_double", "dx305", ("arrays", "lock_count"))):
        parts = {"call_us": us[f"{key}_call"],
                 "empty_us": us[f"{key}_empty"],
                 "ctypes_launch_us": us[f"{key}_ctypes_launch"],
                 **{f"{k}_us": us[k] for k in extra}, **common}
        timed = (parts["empty_us"] + parts["stream_us"]
                 + parts["device_check_us"] + parts["ctypes_launch_us"]
                 + parts.get("arrays_us", 0.0) + parts.get("lock_count_us", 0.0))
        parts["checks_us"] = parts["call_us"] - timed
        parts["call_over_torch_mul"] = parts["call_us"] / parts["torch_mul_us"]
        emit({"phase": "host_split", "name": name, "n": CAPACITY, **parts})


def reset_launch_counts(anomaly_udf) -> None:
    """Every kernel's count to 0, just before a path is driven."""
    from data_accelerator_tpu_torch.kernels import launch

    anomaly_udf.kernel.launches = 0
    launch.reset_launches()


def launch_counts(anomaly_udf) -> dict:
    from data_accelerator_tpu_torch.kernels import launch

    return {"anomaly_score": anomaly_udf.launches,
            "dx305_double": launch.launches("dx305_double")}


KERNEL_NAMES = ("anomaly_score", "dx305_double")


def process_launches() -> dict:
    """Each kernel's process-wide count since ``launch.reset_launches()``:
    for a path whose kernel wrappers are made inside it."""
    from data_accelerator_tpu_torch.kernels import launch

    return {name: launch.launches(name) for name in KERNEL_NAMES}


def same_rows(gpu_rows, cpu_rows, what, rtol=1e-4):
    if len(gpu_rows) != len(cpu_rows):
        raise AssertionError(f"{what}: {len(gpu_rows)} rows on the card, "
                             f"{len(cpu_rows)} on the CPU")
    for g, c in zip(gpu_rows, cpu_rows):
        if g.keys() != c.keys():
            raise AssertionError(f"{what}: columns {sorted(g)} vs {sorted(c)}")
        for k, gv in g.items():
            cv = c[k]
            if isinstance(gv, float):
                if not (np.isfinite(gv) and abs(gv - cv) <= rtol * abs(cv)):
                    raise AssertionError(f"{what}.{k}: {gv} vs {cv}")
            elif gv != cv:
                raise AssertionError(f"{what}.{k}: {gv!r} vs {cv!r}")


def make_processors(conf: dict, outputs, gpu_udfs=None, cpu_udfs=None):
    """The same flow on the card and on the CPU; their dictionaries must
    give the device types the same ids."""
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    t0 = time.perf_counter()
    gpu = FlowProcessor(
        SettingDictionary(conf), batch_capacity=CAPACITY,
        output_datasets=outputs, udfs=gpu_udfs, device="cuda",
    )
    cpu = FlowProcessor(
        SettingDictionary(conf), batch_capacity=CAPACITY,
        output_datasets=outputs, udfs=cpu_udfs, device="cpu",
    )
    init_s = time.perf_counter() - t0
    type_ids = np.array([gpu.dictionary.encode(t) for t in DEVICE_TYPES], np.int32)
    cpu_ids = np.array([cpu.dictionary.encode(t) for t in DEVICE_TYPES], np.int32)
    if not np.array_equal(type_ids, cpu_ids):
        raise AssertionError("card and CPU dictionaries disagree")
    return gpu, cpu, type_ids, init_s


def drive_on_card(gpu, batches) -> dict:
    """Each batch through the card, timed from the host columns to the
    counts vector on the host, host syncs counted by sync debug mode."""
    step_ms, encode_ms, collect_ms, syncs, results = [], [], [], [], []
    sync_sites = set()
    for b, cols in enumerate(batches):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            raw = gpu.encode_columns(cols, CAPACITY)
            t_enc = time.perf_counter()
            handle = gpu.dispatch_batch(raw, BASE_MS + 1000 * b)
        torch.cuda.set_sync_debug_mode(0)
        synced = [str(w.message) for w in caught
                  if "synchroniz" in str(w.message)]
        counts = handle.collect_counts().counts
        t1 = time.perf_counter()
        datasets, metrics = handle.collect()
        t2 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        encode_ms.append((t_enc - t0) * 1e3)
        collect_ms.append((t2 - t1) * 1e3)
        syncs.append(len(synced))
        sync_sites.update(m[:160] for m in synced)
        results.append((counts, datasets, metrics))
    return {"step_ms": step_ms, "encode_ms": encode_ms,
            "collect_ms": collect_ms, "syncs": syncs,
            "sync_sites": sorted(sync_sites), "results": results}


def match_cpu(cpu, batches, gpu_results, outputs, rtol=1e-4) -> dict:
    """The same batches through the port on the CPU: counts, metrics and
    rows must equal the card's; returns the rows out per output."""
    rows_out = {n: 0 for n in outputs}
    for b, cols in enumerate(batches):
        handle = cpu.dispatch_batch(
            cpu.encode_columns(cols, CAPACITY), BASE_MS + 1000 * b
        )
        counts = handle.collect_counts().counts
        datasets, metrics = handle.collect()
        g_counts, g_datasets, g_metrics = gpu_results[b]
        if not np.array_equal(g_counts, counts):
            raise AssertionError(f"batch {b}: counts {g_counts} vs {counts}")
        for k, v in metrics.items():
            if k != "Latency-Process" and g_metrics.get(k) != v:
                raise AssertionError(f"batch {b}: metric {k} {g_metrics.get(k)} vs {v}")
        for name in outputs:
            same_rows(g_datasets[name], datasets[name], f"batch {b} {name}", rtol)
            rows_out[name] += len(datasets[name])
    return rows_out


def flow_line(phase, seed, init_s, run, rows_out, launches) -> dict:
    # batch 0 includes first-use costs (kernel load, allocator growth)
    med = statistics.median(run["step_ms"][1:])
    return {
        "phase": phase, "capacity": CAPACITY, "batches": BATCHES,
        "seed": seed, "init_s": init_s,
        "step_ms": run["step_ms"], "step_ms_median": med,
        "events_per_s": CAPACITY / (med / 1e3),
        "encode_ms": run["encode_ms"],
        "encode_ms_median": statistics.median(run["encode_ms"][1:]),
        "collect_ms": run["collect_ms"],
        "host_syncs_per_step": run["syncs"],
        "host_sync_messages": run["sync_sites"],
        "rows_out": rows_out,
        "launches": launches,
        "match_cpu": True,
    }


def phase_flow(seed: int, udf) -> int:
    """Runs the main path on the card and the same batches on the CPU;
    returns the anomaly kernel's launches in the card's run."""
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    gpu, cpu, type_ids, init_s = make_processors(
        flow_conf(), OUTPUTS, gpu_udfs={"anomalyscore": udf},
        cpu_udfs={"anomalyscore": anomalyscore()},
    )
    rs = np.random.RandomState(seed)
    batches = [make_columns(rs, type_ids, CAPACITY) for _ in range(BATCHES)]

    # the main path's run: the counts at 0 just before, read just after
    reset_launch_counts(udf)
    run = drive_on_card(gpu, batches)
    counts = launch_counts(udf)
    launches = counts["anomaly_score"]
    if launches != BATCHES:
        raise AssertionError(
            f"anomaly_score launched {launches} times in {BATCHES} batches "
            "on the card, not once per batch"
        )

    rows_out = match_cpu(cpu, batches, run["results"], OUTPUTS)
    if not rows_out["HeatAvg"] or not rows_out["AnomalyAlerts"]:
        raise AssertionError(f"flow produced no alerts: {rows_out}")
    emit(flow_line("flow", seed, init_s, run, rows_out,
                   {"anomaly_score": launches}))
    phase_profile(gpu, batches[-1], BASE_MS + 1000 * BATCHES)
    return launches


def make_json_payload(rs, n_rows, alert_rate=0.01) -> bytes:
    """bench.py::make_json_payload, drawing from ``rs``: newline JSON
    with ~1% of events tripping the DoorLock rule, mixed device types,
    temperatures 0-100 at three decimals."""
    types = np.array(DEVICE_TYPES)
    is_door = rs.uniform(size=n_rows) < 2 * alert_rate
    dtype_col = np.where(is_door, 2, rs.randint(0, 2, n_rows))
    status = np.where(is_door & (rs.uniform(size=n_rows) < 0.5), 0, 1)
    device_id = rs.randint(1, 9, n_rows)
    temp = rs.uniform(0, 100, n_rows)
    lines = [
        '{"deviceDetails":{"deviceId":%d,"deviceType":"%s","homeId":150,'
        '"status":%d,"temperature":%.3f},"eventTimeStamp":%d}'
        % (device_id[i], types[dtype_col[i]], status[i], temp[i], BASE_MS + i)
        for i in range(n_rows)
    ]
    return ("\n".join(lines) + "\n").encode()


# -- the StormDoors flow: the port's copy of
# __graft_entry__._flow_conf(multi=True), plus a reference-data query --
WEATHER_SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "stationId", "type": "long", "nullable": False,
         "metadata": {"allowedValues": [150, 32, 88]}},
        {"name": "windSpeed", "type": "double", "nullable": False,
         "metadata": {"minValue": 0, "maxValue": 120}},
    ],
})
GRAFT_IOT_SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "deviceDetails", "type": {"type": "struct", "fields": [
            {"name": "deviceId", "type": "long", "nullable": False,
             "metadata": {"allowedValues": [1, 2, 3, 4, 5, 6, 7, 8]}},
            {"name": "deviceType", "type": "string", "nullable": False,
             "metadata": {"allowedValues": ["DoorLock", "Heating", "WindSpeed"]}},
            {"name": "homeId", "type": "long", "nullable": False,
             "metadata": {"allowedValues": [150, 32, 88]}},
            {"name": "status", "type": "long", "nullable": False,
             "metadata": {"allowedValues": [0, 1]}},
            {"name": "temperature", "type": "double", "nullable": False,
             "metadata": {"minValue": 0, "maxValue": 100}},
        ]}, "nullable": False, "metadata": {}},
    ],
})
STORM_TRANSFORM = TRANSFORM.split("--DataXQuery--\nScored")[0] + (
    "--DataXQuery--\n"
    "StormDoors = SELECT a.deviceId, a.homeId, b.windSpeed "
    "FROM DoorEvents a INNER JOIN Weather_10seconds b "
    "ON a.homeId = b.stationId WHERE b.windSpeed > 50\n"
)
DOOR_HOMES_QUERY = (
    "--DataXQuery--\n"
    "DoorHomes = SELECT a.deviceId, h.city FROM DoorEvents a "
    "INNER JOIN homes h ON a.homeId = h.homeId "
    "WHERE a.deviceType = 'DoorLock' AND a.status = 0\n"
)
STORM_OUTPUTS = ["OpenDoors", "HeatAvg", "StormDoors", "DoorHomes"]
HOMES = ((150, "Seattle"), (32, "Redmond"), (88, "Bellevue"))
# the weather stream's batch capacity, and the window's join bound: at
# most 2 readings of station 150 in the 10 s window, each joined by
# every IoT row of a batch (all at homeId 150)
WEATHER_CAPACITY = 1024
STORM_JOIN_CAPACITY = 2 * CAPACITY


def storm_conf(tmp_dir: str, capacity: int = CAPACITY,
               weather_capacity: int = WEATHER_CAPACITY,
               homes_csv: str = "homes.csv",
               join_capacity: int = STORM_JOIN_CAPACITY) -> dict:
    """The two-source StormDoors flow (IoT + weather, the current IoT
    batch joined against a 10 s window of the weather stream) with the
    DoorHomes reference-data query, its transform written under
    ``tmp_dir``."""
    Path(tmp_dir).mkdir(parents=True, exist_ok=True)
    tpath = Path(tmp_dir) / "flow.transform"
    tpath.write_text(STORM_TRANSFORM + DOOR_HOMES_QUERY, encoding="utf-8")
    return {
        "datax.job.name": "GraftIoT",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.transform": str(tpath),
        "datax.job.process.timewindow.DataXProcessedInput_5seconds"
        ".windowduration": "5 seconds",
        "datax.job.process.projection": (
            "current_timestamp() AS eventTimeStamp\nRaw.*"
        ),
        "datax.job.input.sources.default.inputtype": "local",
        "datax.job.input.sources.default.blobschemafile": GRAFT_IOT_SCHEMA,
        "datax.job.input.sources.weather.inputtype": "local",
        "datax.job.input.sources.weather.blobschemafile": WEATHER_SCHEMA,
        "datax.job.input.sources.weather.target": "Weather",
        "datax.job.process.timewindow.Weather_10seconds"
        ".windowduration": "10 seconds",
        "datax.job.input.sources.weather.projection": (
            "current_timestamp() AS eventTimeStamp\nRaw.*"
        ),
        "datax.job.process.batchcapacity": str(capacity),
        "datax.job.input.sources.weather.streaming.maxbatchsize":
            str(weather_capacity),
        "datax.job.process.joincapacity": str(join_capacity),
        "datax.job.input.default.referencedata.homes.path": homes_csv,
    }


def write_homes_csv(path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("homeId,city\n")
        f.writelines(f"{h},{c}\n" for h, c in HOMES)


def iot_lines(rs, n_rows: int) -> bytes:
    """One IoT batch: ``make_json_payload`` (every row at homeId 150)."""
    return make_json_payload(rs, n_rows)


def weather_lines(rs, batch: int) -> bytes:
    """The weather stream's batch ``batch``: the three stations report
    once every fifth batch, staggered (150 at batches 0 and 5, 32 at 1
    and 6, 88 at 2 and 7); wind speed uniform 0-120, drawn every batch."""
    wind = rs.uniform(0, 120)
    k = batch % 5
    if k >= len(HOMES):
        return b""
    return b'{"stationId":%d,"windSpeed":%.3f}\n' % (HOMES[k][0], wind)


# -- the generated conf: the reference control plane's output for a
# designer flow of the config-1 queries, committed with its files --
GEN_FLOW = "GenConfig1"
GEN_PLACEHOLDER = "@GENDIR@"
GEN_FIXTURE = ROOT / "tests" / "data" / "generated_torch"


def materialize_generated_conf(dest, src=GEN_FIXTURE) -> Path:
    """Copy the generated job directory ``src`` to ``dest``, its
    placeholder replaced by ``dest``; returns the conf file's path."""
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    conf = None
    for p in sorted(Path(src).iterdir()):
        out = dest / p.name
        out.write_text(p.read_text(encoding="utf-8").replace(GEN_PLACEHOLDER, str(dest)),
                       encoding="utf-8")
        if p.suffix == ".conf":
            conf = out
    return conf


class SyncCount:
    """Host syncs that sync debug mode reports on this thread while the
    context is entered; a landing thread's warnings are not counted."""

    def __init__(self):
        self.count = 0
        self.sites = set()
        self._thread = threading.get_ident()

    def __enter__(self):
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if (threading.get_ident() == self._thread
                    and "synchronizing CUDA operation" in str(message)):
                self.count += 1
                self.sites.add(str(message)[:160])
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._ctx.__exit__(*exc)


# metrics the CPU run cannot repeat: wall clock, and what depends on when
# the landing thread finished a batch relative to later dispatches (the
# sized capacities it fed, the pool and slot reuse it allowed)
INGEST_UNCOMPARED = ("Latency-Process", "Decode_RowsPerSec",
                     "Decode_BufferReuse_Count", "Transfer_D2HBytes",
                     "Transfer_Efficiency", "Transfer_SlotContended_Count",
                     "Transfer_Overflow_Count")


def drive_ingest(gpu, payloads) -> dict:
    """The depth-2 pipelined loop of a streaming host from bytes:
    ``encode_json_bytes(..., to_device=False)`` of batch N+1 runs while
    up to two batches are in flight, retiring the oldest blocks only on
    its counts, and its tables land on one background thread (at most
    ``depth`` landings outstanding)."""
    depth = gpu.pipeline_depth
    n = len(payloads)
    decode_ms, dispatch_ms, counts_ms = [0.0] * n, [0.0] * n, [0.0] * n
    results = [None] * n
    sync = SyncCount()
    pending, landings = deque(), deque()

    def land(item):
        b, counts, fut = item
        results[b] = (counts, *fut.result())

    def decode(b):
        t0 = time.perf_counter()
        with sync:
            raw = gpu.encode_json_bytes(payloads[b], BASE_MS + 1000 * b,
                                        to_device=False)
        decode_ms[b] = (time.perf_counter() - t0) * 1e3
        return raw, t0

    def retire(pool):
        b, h, t0 = pending.popleft()
        counts = h.collect_counts().counts
        counts_ms[b] = (time.perf_counter() - t0) * 1e3
        landings.append((b, counts, pool.submit(h.collect_tables)))
        while len(landings) > depth:
            land(landings.popleft())

    torch.cuda.synchronize()
    with ThreadPoolExecutor(1, thread_name_prefix="landing") as pool:
        t_start = time.perf_counter()
        raw, t0 = decode(0)
        for b in range(n):
            t1 = time.perf_counter()
            with sync:
                h = gpu.dispatch_batch(raw, BASE_MS + 1000 * b)
            dispatch_ms[b] = (time.perf_counter() - t1) * 1e3
            pending.append((b, h, t0))
            if len(pending) > depth:
                retire(pool)
            if b + 1 < n:
                raw, t0 = decode(b + 1)
        while pending:
            retire(pool)
        while landings:
            land(landings.popleft())
        total_s = time.perf_counter() - t_start
    return {"decode_ms": decode_ms, "dispatch_ms": dispatch_ms,
            "bytes_to_counts_ms": counts_ms, "total_s": total_s,
            "syncs": sync.count, "sync_sites": sorted(sync.sites),
            "results": results}


def h2d_ms(gpu, payload, reps=10) -> float:
    """Median CUDA-event time of one host-to-device copy of a pooled,
    pinned ingest matrix at this flow's shape."""
    raw = gpu.encode_json_bytes(payload, BASE_MS, to_device=False)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        raw.data.to("cuda", non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    pool, mat = raw.ingest_slot
    pool.release(mat)
    return statistics.median(times)


def profile_h2d(gpu, payload, batch_time_ms) -> dict:
    """One step from bytes under ``torch.profiler``: its host-to-device
    copies (name, bytes) from the exported trace, and whether the string
    dictionary grew, which adds the copy of the string-op tables."""
    from torch.profiler import ProfilerActivity, profile

    dict_size = len(gpu.dictionary)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        raw = gpu.encode_json_bytes(payload, batch_time_ms, to_device=False)
        gpu.dispatch_batch(raw, batch_time_ms).collect_counts()
        torch.cuda.synchronize()  # the result copies too, inside the trace
    trace = ROOT / "data_accelerator_tpu_torch" / "_build" / "ingest_trace.json"
    prof.export_chrome_trace(str(trace))
    try:
        events = json.loads(trace.read_text())["traceEvents"]
    finally:
        trace.unlink()
    copies = [[e["name"], e.get("args", {}).get("bytes")] for e in events
              if "HtoD" in e.get("name", "")]
    return {"copies": copies, "matrix_bytes": raw.data.numel() * 4,
            "dictionary_grew": len(gpu.dictionary) != dict_size,
            # what the trace held, for a run that finds no copy in it
            "trace_categories": dict(collections.Counter(
                e.get("cat") for e in events)),
            "key_averages_copies": [[e.key, e.count] for e in prof.key_averages()
                                    if "Memcpy" in e.key]}


def phase_ingest(seed: int, udf, nvidia_smi: str) -> int:
    """The main path from bytes; returns the anomaly kernel's launches
    in the pipelined run."""
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    gpu, cpu, _type_ids, init_s = make_processors(
        flow_conf(), OUTPUTS, gpu_udfs={"anomalyscore": udf},
        cpu_udfs={"anomalyscore": anomalyscore()},
    )
    rs = np.random.RandomState(seed)
    payloads = [make_json_payload(rs, CAPACITY) for _ in range(BATCHES)]

    reset_launch_counts(udf)
    run = drive_ingest(gpu, payloads)
    launches = launch_counts(udf)["anomaly_score"]
    pool = gpu._ingest_pools["default"]
    allocs, reuses = pool.alloc_count, pool.reuse_count
    if launches != BATCHES:
        raise AssertionError(f"ingest: anomaly_score launched {launches} "
                             f"times in {BATCHES} batches")
    if run["syncs"]:
        raise AssertionError(f"ingest: {run['syncs']} host syncs in "
                             f"encode_json_bytes + dispatch_batch: "
                             f"{run['sync_sites']}")
    if allocs > gpu.pipeline_depth + 1 or reuses != BATCHES - allocs:
        raise AssertionError(f"ingest pool: {allocs} matrices allocated, "
                             f"{reuses} reuses in {BATCHES} batches")
    reuse_metric = sum(m.get("Decode_BufferReuse_Count", 0.0)
                       for _c, _d, m in run["results"])
    if reuse_metric != reuses:
        raise AssertionError(f"Decode_BufferReuse_Count {reuse_metric} vs "
                             f"{reuses} reuses")

    # the same bytes through the port on the CPU, one batch at a time
    rows_out = {n: 0 for n in OUTPUTS}
    for b, payload in enumerate(payloads):
        t_ms = BASE_MS + 1000 * b
        h = cpu.dispatch_batch(cpu.encode_json_bytes(payload, t_ms), t_ms)
        counts = h.collect_counts().counts
        datasets, metrics = h.collect_tables()
        g_counts, g_datasets, g_metrics = run["results"][b]
        if not np.array_equal(g_counts, counts):
            raise AssertionError(f"ingest batch {b}: counts {g_counts} vs {counts}")
        for k in set(metrics) | set(g_metrics):
            if k not in INGEST_UNCOMPARED and g_metrics.get(k) != metrics.get(k):
                raise AssertionError(f"ingest batch {b}: metric {k} "
                                     f"{g_metrics.get(k)} vs {metrics.get(k)}")
        for name in OUTPUTS:
            same_rows(g_datasets[name], datasets[name], f"ingest batch {b} {name}")
            rows_out[name] += len(datasets[name])
    if not rows_out["HeatAvg"] or not rows_out["AnomalyAlerts"]:
        raise AssertionError(f"ingest produced no alerts: {rows_out}")

    # step time from bytes, one batch at a time and nothing landing
    # meanwhile: decode, dispatch (copy and step enqueued), counts
    step_ms, step_parts = [], []
    for b in range(BATCHES, BATCHES + 3):
        t_ms = BASE_MS + 1000 * b
        t0 = time.perf_counter()
        raw = gpu.encode_json_bytes(payloads[b % BATCHES], t_ms, to_device=False)
        t1 = time.perf_counter()
        h = gpu.dispatch_batch(raw, t_ms)
        t2 = time.perf_counter()
        h.collect_counts()
        t3 = time.perf_counter()
        step_ms.append((t3 - t0) * 1e3)
        step_parts.append({"decode_ms": (t1 - t0) * 1e3,
                           "dispatch_ms": (t2 - t1) * 1e3,
                           "counts_ms": (t3 - t2) * 1e3})
        h.collect_tables()
    copy_ms = h2d_ms(gpu, payloads[0])
    prof = profile_h2d(gpu, payloads[1], BASE_MS + 1000 * (BATCHES + 3))
    matrix_copies = [c for c in prof["copies"] if c[1] == prof["matrix_bytes"]]
    if len(matrix_copies) != 1 or (
            len(prof["copies"]) != 1 and not prof["dictionary_grew"]):
        raise AssertionError(f"ingest: host-to-device copies of one step "
                             f"{prof['copies']}, not one of "
                             f"{prof['matrix_bytes']} bytes; {prof}")

    metrics = [m for _c, _d, m in run["results"]]
    emit({
        "phase": "ingest", "capacity": CAPACITY, "batches": BATCHES,
        "depth": gpu.pipeline_depth, "seed": seed, "init_s": init_s,
        "payload_bytes": [len(p) for p in payloads],
        "decode_ms": run["decode_ms"],
        "decode_ms_median": statistics.median(run["decode_ms"][1:]),
        "decode_shards": metrics[-1].get("Decode_Shards"),
        "dispatch_ms": run["dispatch_ms"],
        "h2d_ms": copy_ms, "h2d_bytes": prof["matrix_bytes"],
        "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
        "step_parts": step_parts,
        "pipelined_bytes_to_counts_ms": run["bytes_to_counts_ms"],
        "events_per_s": CAPACITY * BATCHES / run["total_s"],
        "d2h_bytes": [m.get("Transfer_D2HBytes") for m in metrics],
        "transfer_efficiency": [m.get("Transfer_Efficiency") for m in metrics],
        "slot_contended": sum(m.get("Transfer_SlotContended_Count", 0.0)
                              for m in metrics),
        "sync_counts_bytes": metrics[-1]["Sync_CountsBytes"],
        "host_syncs_encode_dispatch": run["syncs"],
        "pool_allocs": allocs, "pool_reuses": reuses,
        "h2d_copies_profiled_step": prof["copies"],
        "rows_out": rows_out, "launches": {"anomaly_score": launches},
        "match_cpu": True, "card": nvidia_smi,
    })
    return launches


def phase_udf_flow(seed: int, anomaly_udf) -> int:
    """The user-UDF path: ``pdouble``, declared in the flow's conf, runs
    its own CUDA kernel through ``cuda_call`` on every batch. Card rows
    must equal the CPU run's exactly; returns ``dx305_double``'s
    launches in the card's run."""
    gpu, cpu, type_ids, init_s = make_processors(udf_flow_conf(), ["S"])
    rs = np.random.RandomState(seed)
    batches = [make_columns(rs, type_ids, CAPACITY) for _ in range(BATCHES)]

    reset_launch_counts(anomaly_udf)
    run = drive_on_card(gpu, batches)
    counts = launch_counts(anomaly_udf)
    launches = counts["dx305_double"]
    if launches != BATCHES or counts["anomaly_score"] != 0:
        raise AssertionError(
            f"user-UDF flow launched {counts} in {BATCHES} batches on the "
            "card, not dx305_double once per batch"
        )
    if any(run["syncs"]):
        raise AssertionError(
            f"user-UDF flow: host syncs per step {run['syncs']}: "
            f"{run['sync_sites']}"
        )
    rows_out = match_cpu(cpu, batches, run["results"], ["S"], rtol=0.0)
    if rows_out["S"] != BATCHES * CAPACITY:
        raise AssertionError(f"user-UDF flow: {rows_out} rows out")
    emit(flow_line("udf_flow", seed, init_s, run, rows_out,
                   {"dx305_double": launches}))
    return launches


# the host phase's stream: one more batch than the run, for the restart
HOST_FLOW = "ChipSmokeHost"
CLI_FLOW = "ChipSmokeCli"
CLI_BATCHES = 3
# the host's own adaptive backpressure halves a poll (down to 1/8 of
# maxrate x interval) after an iteration longer than the interval; at 8 x
# the capacity every poll still asks for a whole batch
HOST_MAXRATE = 8 * CAPACITY


def host_conf(ckpt_dir: str) -> dict:
    """The main path as a user runs it: the alerting flow plus the
    anomaly query from socket bytes, its UDF declared in the conf,
    depth 2 with background landing, checkpoints every second, the
    pilot off so that every batch is a whole capacity.

    The checkpoint cadence counts from each batch's poll time, and the
    decode-ahead polls run ahead of the landings: the 8 polls span
    about three landings (3-4 s on an H100 host), so a 2 s interval can
    leave a single checkpoint after the first; at 1 s the run writes
    several, and the restart restores a later one."""
    conf = flow_conf()
    conf.update({
        "datax.job.name": HOST_FLOW,
        "datax.job.input.default.inputtype": "socket",
        "datax.job.input.default.socket.port": "0",
        "datax.job.input.default.eventhub.maxrate": str(HOST_MAXRATE),
        "datax.job.input.default.eventhub.checkpointdir": ckpt_dir,
        "datax.job.input.default.eventhub.checkpointinterval": "1 second",
        "datax.job.process.batchcapacity": str(CAPACITY),
        "datax.job.process.pipeline.depth": "2",
        "datax.job.process.pilot.enabled": "false",
        "datax.job.process.jar.udf.anomalyscore.class":
            "data_accelerator_tpu_torch.udf.samples:anomalyscore",
    })
    for out in OUTPUTS:
        conf[f"datax.job.output.{out}.console.maxrows"] = "0"
    return conf


class LineCount(io.TextIOBase):
    """Stands in for stdout while a host runs: its console sinks print
    rows; the phase counts the lines and keeps its own output clean."""

    def __init__(self):
        self.lines = 0

    def write(self, text):
        self.lines += text.count("\n")
        return len(text)


class ThreadSyncCount:
    """Host syncs that sync debug mode reports while a thread is inside
    one of the wrapped calls (the host's poll and encode on its
    decode-ahead worker, ``dispatch_batch`` on the dispatch thread); the
    landing thread's reads are not counted."""

    def __init__(self):
        self.count, self.sites = 0, set()
        self._inside = threading.local()

    def wrap(self, fn):
        def counted(*a, **k):
            self._inside.on = True
            try:
                return fn(*a, **k)
            finally:
                self._inside.on = False
        return counted

    def __enter__(self):
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchronizing CUDA operation" not in str(message):
                shown(message, category, filename, lineno, file, line)
            elif getattr(self._inside, "on", False):
                self.count += 1
                self.sites.add(str(message)[:160])

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._ctx.__exit__(*exc)


def feed_socket(port: int, payloads, n_lines: int, src, deadline_s=120.0) -> float:
    """Write ``payloads`` to the host's socket from a feeder thread and
    wait, with a deadline, until the source has buffered ``n_lines``
    lines; returns the seconds it took."""
    import socket

    t0 = time.perf_counter()

    def feed():
        with socket.create_connection(("127.0.0.1", port), timeout=60) as conn:
            for p in payloads:
                conn.sendall(p)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    deadline = time.monotonic() + deadline_s
    while len(src._buf) < n_lines:
        if time.monotonic() > deadline:
            raise AssertionError(f"socket source buffered {len(src._buf)} of "
                                 f"{n_lines} lines in {deadline_s} s")
        time.sleep(0.05)
    feeder.join(timeout=10)
    return time.perf_counter() - t0


def weakly(bound):
    """Bound method ``bound`` called on its object through a weak
    reference: a wrapper stored on that object then holds it in no
    reference cycle, and a stopped host's tensors go when it does, not
    at the next run of the cyclic collector."""
    ref, fn = weakref.ref(bound.__self__), bound.__func__
    return lambda *a, **k: fn(ref(), *a, **k)


def record_host(host, sync: "ThreadSyncCount") -> dict:
    """Wrap a host's processor and sinks: record each batch's bytes,
    base and batch time as the host passed them, the rows its sinks
    got, its metrics, dispatch and checkpoint times, and the last window
    snapshot it saved; count host syncs in poll, encode and dispatch.
    Each wrapper reaches the object it wraps weakly (``weakly``)."""
    proc = host.processor
    rec = {"encoded": [], "times": [], "dispatch_ms": [], "rows": {},
           "metrics": [], "snapshot_ms": [], "save_ms": [], "last_snap": None}
    encode, dispatch = weakly(proc.encode_json_bytes), weakly(proc.dispatch_batch)

    def encode_rec(data, base_ms, **kw):
        rec["encoded"].append((data, base_ms, kw.get("source")))
        return encode(data, base_ms, **kw)

    def dispatch_rec(raw, batch_time_ms):
        t0 = time.perf_counter()
        h = dispatch(raw, batch_time_ms)
        rec["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["times"].append(batch_time_ms)
        return h

    proc.encode_json_bytes = encode_rec
    proc.dispatch_batch = sync.wrap(dispatch_rec)
    host._poll_and_encode = sync.wrap(weakly(host._poll_and_encode))

    snapshot = weakly(proc.snapshot_window_state)

    def snapshot_timed():
        t0 = time.perf_counter()
        snap = snapshot()
        rec["snapshot_ms"].append((time.perf_counter() - t0) * 1e3)
        return snap

    proc.snapshot_window_state = snapshot_timed
    rec["sources"] = len(host.sources)
    save = weakly(host.window_checkpointer.save)

    def save_timed(snap):
        t0 = time.perf_counter()
        save(snap)
        rec["save_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["last_snap"] = snap

    host.window_checkpointer.save = save_timed

    class Recording:
        kind = "recording"

        def write(self, dataset, rows, batch_time_ms):
            rec["rows"][(batch_time_ms, dataset)] = rows
            return len(rows)

    for op in host.dispatcher.operators.values():
        op.sinks.append(Recording())
    send = weakly(host.metric_logger.send_batch_metrics)

    def send_rec(metrics, ts):
        rec["metrics"].append(dict(metrics))
        return send(metrics, ts)

    host.metric_logger.send_batch_metrics = send_rec
    return rec


def replay_on_cpu(cpu, rec, outputs, what, start=0) -> dict:
    """The recorded batches through a CPU processor, one at a time, each
    source's bytes as its poll returned them: every sink's rows must
    equal the card's (ints exact, floats rtol 1e-4); returns the rows
    per output."""
    rows_out = {n: 0 for n in outputs}
    k = rec["sources"]
    for b, t_ms in enumerate(rec["times"]):
        raws = {
            source or cpu.primary: cpu.encode_json_bytes(data, base_ms, source=source)
            for data, base_ms, source in rec["encoded"][k * b:k * (b + 1)]
        }
        datasets, _m = cpu.dispatch_batch(raws, t_ms).collect_tables()
        for name in outputs:
            same_rows(rec["rows"][(t_ms, name)], datasets[name],
                      f"{what} batch {start + b} {name}")
            rows_out[name] += len(datasets[name])
    return rows_out


def same_snapshot(a, b, what) -> None:
    if (a["slot_counter"], a["base_ms"]) != (b["slot_counter"], b["base_ms"]):
        raise AssertionError(f"{what}: counter/base {a['slot_counter']}, "
                             f"{a['base_ms']} vs {b['slot_counter']}, {b['base_ms']}")
    for table, ring in a["rings"].items():
        other = b["rings"][table]
        if not np.array_equal(ring["valid"], other["valid"]) or any(
                not np.array_equal(v, other["cols"][c]) for c, v in ring["cols"].items()):
            raise AssertionError(f"{what}: ring {table} differs")


def phase_host(seed: int, nvidia_smi: str) -> tuple:
    """The main path through the port's ``StreamingHost`` from socket
    bytes; returns ``anomaly_score``'s launches in the run and the run's
    events/s."""
    import tempfile

    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime.host import StreamingHost
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    rs = np.random.RandomState(seed + 1)
    payloads = [make_json_payload(rs, CAPACITY) for _ in range(BATCHES + 1)]
    with tempfile.TemporaryDirectory() as ckpt, contextlib.redirect_stdout(LineCount()) as out:
        conf = SettingDictionary(host_conf(ckpt))
        t0 = time.perf_counter()
        host = StreamingHost(conf)
        init_s = time.perf_counter() - t0
        sync = ThreadSyncCount()
        rec = record_host(host, sync)
        udf = host.processor.udfs["anomalyscore"]
        try:
            feed_s = feed_socket(host.source.port, payloads[:BATCHES],
                                 BATCHES * CAPACITY, host.source)
            udf.kernel.launches = 0
            torch.cuda.synchronize()
            with sync:
                t_run = time.perf_counter()
                host.run_pipelined(max_batches=BATCHES)
                run_s = time.perf_counter() - t_run
            launches = udf.launches
        finally:
            host.stop()
        pool = host.processor._ingest_pools["default"]
        # a successor on the same checkpoint directory, one more batch
        host2 = StreamingHost(conf)
        restored = host2.processor.snapshot_window_state()
        rec2 = record_host(host2, ThreadSyncCount())
        try:
            feed_socket(host2.source.port, payloads[BATCHES:], CAPACITY, host2.source)
            host2.run_pipelined(max_batches=1)
        finally:
            host2.stop()
        console_lines = out.lines

    sizes = [m["Input_DataXProcessedInput_Events_Count"] for m in rec["metrics"]]
    if host.batches_processed != BATCHES or sizes != [float(CAPACITY)] * BATCHES:
        raise AssertionError(f"host: {host.batches_processed} batches of {sizes} rows")
    if launches != BATCHES:
        raise AssertionError(f"host: anomaly_score launched {launches} times "
                             f"in {BATCHES} batches")
    if sync.count:
        raise AssertionError(f"host: {sync.count} host syncs in poll, encode and "
                             f"dispatch: {sorted(sync.sites)}")
    if len(rec["save_ms"]) < 2:
        raise AssertionError(f"host: {len(rec['save_ms'])} checkpoints written")
    if host2.window_restored_from != "local":
        raise AssertionError(f"host restart: window restored from "
                             f"{host2.window_restored_from!r}")
    same_snapshot(rec["last_snap"], restored, "host restart: restored window")

    # the recorded batches on the CPU, then the successor's first batch
    # continued from the last saved snapshot
    cpu = FlowProcessor(conf, device="cpu")
    rows_out = replay_on_cpu(cpu, rec, OUTPUTS, "host")
    if not rows_out["HeatAvg"] or not rows_out["AnomalyAlerts"]:
        raise AssertionError(f"host produced no alerts: {rows_out}")
    cpu2 = FlowProcessor(conf, device="cpu")
    if not cpu2.restore_window_state(rec["last_snap"]):
        raise AssertionError("host restart: the CPU replay refused the snapshot")
    replay_on_cpu(cpu2, rec2, ["HeatAvg"], "host restart", start=BATCHES)
    heat_cnt = sum(r["Cnt"] for r in rec2["rows"][(rec2["times"][0], "HeatAvg")])

    def stats(key):
        vals = [m[key] for m in rec["metrics"] if key in m]
        return {"median": statistics.median(vals), "max": max(vals), "all": vals}

    checkpoint_ms = [a + b for a, b in zip(rec["snapshot_ms"], rec["save_ms"])]
    emit({
        "phase": "host", "capacity": CAPACITY, "batches": BATCHES, "depth": 2,
        "seed": seed, "init_s": init_s, "feed_s": feed_s, "run_s": run_s,
        "events_per_s": BATCHES * CAPACITY / run_s,
        "latency_batch_ms": stats("Latency-Batch"),
        "pipeline_stall_ms": stats("Pipeline_Stall_Ms"),
        "background_land_ms": stats("Transfer_Background_LandMs"),
        "background_pending": stats("Transfer_Background_Pending"),
        "ingest_rate_scale": [m["IngestRateScale"] for m in rec["metrics"]],
        "dispatch_ms": rec["dispatch_ms"],
        "dispatch_ms_median": statistics.median(rec["dispatch_ms"]),
        "checkpoints": len(rec["save_ms"]),
        "checkpoint_ms": checkpoint_ms,
        "checkpoint_snapshot_ms": rec["snapshot_ms"][:len(checkpoint_ms)],
        "checkpoint_save_ms": rec["save_ms"],
        "window_bytes": sum(a.nbytes for ring in rec["last_snap"]["rings"].values()
                            for a in [*ring["cols"].values(), ring["valid"]]),
        "hbm_peak_bytes": rec["metrics"][-1].get("Hbm_PeakBytes"),
        "pool_allocs": pool.alloc_count, "pool_reuses": pool.reuse_count,
        "host_syncs_poll_encode_dispatch": sync.count,
        "rows_out": rows_out, "console_lines": console_lines,
        "restart": {"restored_from": host2.window_restored_from,
                    "restored_slot_counter": restored["slot_counter"],
                    "first_batch_heatavg_cnt": heat_cnt},
        "launches": {"anomaly_score": launches},
        "match_cpu": True, "card": nvidia_smi,
    })
    return launches, BATCHES * CAPACITY / run_s


# -- the observability plane (slice 6) ---------------------------------------
OBSERVE_FLOW = "ChipSmokeObserve"
# a passthrough output: the fleet audit judges the output that emits the
# most rows, and only one that emits every ingested row conserves
OBSERVE_QUERY = (
    "--DataXQuery--\n"
    "Delivered = SELECT deviceDetails.deviceId AS deviceId "
    "FROM DataXProcessedInput\n"
)
OBSERVE_OUTPUTS = OUTPUTS + ["Delivered"]
CAPTURE_SECONDS = 2
# the host's loop threads whose CPU ops a capture must hold
CAPTURE_THREADS = ("dispatch", "landing")


def observe_conf(ckpt_dir: str, fleet_url: str, tracefile: str, profiler_dir: str,
                 replica: str) -> dict:
    """The host phase's conf with the observability plane armed: fleet
    frames every second to ``fleet_url`` as ``replica``, the protocol
    monitor, an observability port, a flight recorder and calibration
    (on by default)."""
    conf = host_conf(ckpt_dir)
    conf.update({
        "datax.job.name": OBSERVE_FLOW,
        "datax.job.process.transform": TRANSFORM + OBSERVE_QUERY,
        "datax.job.output.Delivered.console.maxrows": "0",
        "datax.job.process.fleet.publishurl": fleet_url,
        "datax.job.process.fleet.windowseconds": "1",
        "datax.job.process.fleet.replica": replica,
        "datax.job.process.debug.protocolmonitor": "true",
        "datax.job.process.observability.port": "0",
        "datax.job.process.observability.profilerdir": profiler_dir,
        "datax.job.process.telemetry.tracefile": tracefile,
    })
    return conf


def observe_calib(nvidia_smi: str):
    """The machine profile of the card, measured with the process cache
    emptied: every reading within the card's published peak, and the
    probe's memory absent from the allocator's peak afterwards."""
    from data_accelerator_tpu_torch.obs import calibrate

    calibrate.clear_cache()
    torch.cuda.synchronize()
    peak_before = torch.cuda.max_memory_allocated()
    allocated_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    profile = calibrate.get_profile()
    seconds = time.perf_counter() - t0
    peak_after = torch.cuda.max_memory_allocated()
    allocated_after = torch.cuda.memory_allocated()
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    peak_gbps = PEAK_BYTES_PER_S / 1e9
    emit({"phase": "observe_calib", **profile.metrics(), "probe_ms": profile.probe_ms,
          "seconds": seconds, "backend": profile.backend,
          "device_kind": profile.device_kind, "l2_bytes": l2,
          "probe_bytes": 4 * max(calibrate.PROBE_ELEMS,
                                 calibrate.CARD_L2_MULTIPLE * l2 // 4),
          "matmul_n": calibrate.CARD_MATMUL_N, "published_hbm_gbps": peak_gbps,
          "peak_bytes_before": peak_before, "peak_bytes_after": peak_after,
          "allocated_bytes_before": allocated_before,
          "allocated_bytes_after": allocated_after, "card": nvidia_smi})
    for name in ("hbm_read_gbps", "hbm_write_gbps"):
        if not 0 < getattr(profile, name) <= peak_gbps:
            raise AssertionError(f"observe calib: {name} {getattr(profile, name)} "
                                 f"outside (0, {peak_gbps}]: the probe read the L2")
    if not profile.d2h_gbps > 0 or profile.decode_rows_per_sec is None:
        raise AssertionError(f"observe calib: {profile}")
    if profile.backend != "torch-cuda" or calibrate.get_profile() is not profile:
        raise AssertionError("observe calib: the card's profile is not cached as the card's")
    if peak_after > peak_before or allocated_after != allocated_before:
        raise AssertionError(f"observe calib: the probe left memory behind: peak "
                             f"{peak_before} -> {peak_after} B, allocated "
                             f"{allocated_before} -> {allocated_after} B")
    return profile


def watch_threads(host) -> dict:
    """The native ids of the host loop's threads, recorded as each one
    first runs its part of a batch."""
    ids = {}

    def recording(name, fn):
        def run(*a, **k):
            ids.setdefault(name, threading.get_native_id())
            return fn(*a, **k)
        return run

    host._dispatch_traced = recording("dispatch", host._dispatch_traced)
    host._poll_and_encode = recording("decode", host._poll_and_encode)
    host._finish_tail = recording("landing", host._finish_tail)
    return ids


def read_capture(path: str, thread_ids: dict) -> dict:
    """What a capture's Chrome trace holds: its kernels by name, the
    host's stages, and which of the host loop's threads ran CPU ops or
    stage ranges in it."""
    from data_accelerator_tpu_torch.obs.profiler import TRACE_FILE

    trace_path = Path(path) / TRACE_FILE
    events = json.loads(trace_path.read_text())["traceEvents"]
    kernels = collections.Counter(e.get("name", "") for e in events
                                  if e.get("cat") == "kernel")
    # torch ops, and the ranges the host's spans open during a capture
    op_tids = {e.get("tid") for e in events
               if e.get("cat") in ("cpu_op", "user_annotation")}
    return {
        "trace_bytes": trace_path.stat().st_size, "events": len(events),
        "kernel_launches": sum(kernels.values()), "kernel_names": len(kernels),
        "anomaly_score": sum(n for k, n in kernels.items() if "anomaly_score" in k),
        "top_kernels": kernels.most_common(5),
        "cpu_op_threads": len(op_tids),
        "stage_ranges": sorted({e.get("name") for e in events
                                if e.get("cat") == "user_annotation"}),
        "loop_threads_with_ops": sorted(n for n, t in thread_ids.items() if t in op_tids),
    }


def run_obs_cli(argv) -> tuple:
    """``python -m data_accelerator_tpu_torch.obs <argv>``, in process:
    (exit code, stdout)."""
    from data_accelerator_tpu_torch.obs.__main__ import main as obs_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = obs_main(list(argv))
    return rc, out.getvalue()


def phase_observe(seed: int, nvidia_smi: str, host_events_per_s: float) -> int:
    """The observability plane on the main path: the card's machine
    profile (``observe_calib``), then the host phase's flow and bytes
    (plus a passthrough output) through ``StreamingHost.run_pipelined``
    at depth 2 with fleet frames, the protocol monitor and an
    observability port, a ``torch.profiler`` capture armed over ``POST
    /profile`` once the first batch is dispatched; a restart successor
    on the same checkpoint directory publishes as ``r2``; then
    ``FleetView`` over the store and the ``obs`` CLI over the flight
    recorder. Returns ``anomaly_score``'s launches over both hosts."""
    import tempfile
    import urllib.request

    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.obs.__main__ import load_spans
    from data_accelerator_tpu_torch.obs.fleetview import FleetView
    from data_accelerator_tpu_torch.obs.histogram import HISTOGRAMS
    from data_accelerator_tpu_torch.runtime.host import StreamingHost
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
    from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreServer

    profile = observe_calib(nvidia_smi)
    rs = np.random.RandomState(seed + 1)  # the host phase's bytes
    payloads = [make_json_payload(rs, CAPACITY) for _ in range(BATCHES + 1)]
    store = ObjectStoreServer().start()
    fleet_url = f"objstore://127.0.0.1:{store.port}/fleet"
    armed = {}
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(LineCount()):
            tracefile = str(Path(tmp) / "telemetry.jsonl")
            ckpt, prof_dir = str(Path(tmp) / "ckpt"), str(Path(tmp) / "profiler")
            conf1 = SettingDictionary(observe_conf(ckpt, fleet_url, tracefile,
                                                   prof_dir, "r1"))
            # each replica is a process of its own in a deployment: its
            # frames carry its own latency histograms
            HISTOGRAMS.clear()
            host = StreamingHost(conf1)
            sync = ThreadSyncCount()
            rec = record_host(host, sync)
            thread_ids = watch_threads(host)
            udf = host.processor.udfs["anomalyscore"]
            # the capture is armed while batches flow: on the dispatch
            # thread, once the first batch is dispatched and before the
            # loop goes on, so that the profiler runs before the first
            # tail starts on the landing thread; a later tail drains it
            dispatch = host.processor.dispatch_batch

            def dispatch_and_arm(raw, batch_time_ms):
                h = dispatch(raw, batch_time_ms)
                if not armed:
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{host.obs_server.port}/profile"
                        f"?seconds={CAPTURE_SECONDS}", data=b"", method="POST")
                    with urllib.request.urlopen(req, timeout=120) as r:
                        armed.update(json.loads(r.read()), status=r.status)
                return h

            host.processor.dispatch_batch = dispatch_and_arm
            try:
                feed_socket(host.source.port, payloads[:BATCHES],
                            BATCHES * CAPACITY, host.source)
                udf.kernel.launches = 0
                torch.cuda.synchronize()
                with sync:
                    t_run = time.perf_counter()
                    host.run_pipelined(max_batches=BATCHES)
                    run_s = time.perf_counter() - t_run
                launches = udf.launches
            finally:
                host.stop()
            HISTOGRAMS.clear()
            host2 = StreamingHost(SettingDictionary(
                observe_conf(ckpt, fleet_url, tracefile, prof_dir, "r2")))
            restored = host2.processor.snapshot_window_state()
            rec2 = record_host(host2, ThreadSyncCount())
            udf2 = host2.processor.udfs["anomalyscore"]
            try:
                feed_socket(host2.source.port, payloads[BATCHES:], CAPACITY,
                            host2.source)
                udf2.kernel.launches = 0
                host2.run_pipelined(max_batches=1)
                launches += udf2.launches
            finally:
                host2.stop()
            capture = read_capture(armed["path"], thread_ids) if "path" in armed else {}
            spans = load_spans(tracefile)
            violations = [r for r in map(json.loads, Path(tracefile).read_text().splitlines())
                          if r.get("name") == "protocol/violation"]
            cli = {name: run_obs_cli(argv + ["--file", tracefile]) for name, argv in (
                ("spans", ["spans", "--aggregate"]),
                ("trace", ["trace", str(rec["times"][0]), "--stitch"]),
                ("stitch", ["trace", "all", "--stitch"]),
            )}
        t0 = time.perf_counter()
        view = FleetView(url=fleet_url)
        frames = view.refresh()
        refresh_ms = (time.perf_counter() - t0) * 1e3
        fm = view.fleet_metrics(OBSERVE_FLOW)
    finally:
        store.stop()
    mstore = host.metric_logger.store
    publish_ms = [p["val"] for p in mstore.points(
        f"DATAX-{OBSERVE_FLOW}:Fleet_FramePublish_Ms")]
    frame_bytes = [p["val"] for p in mstore.points(
        f"DATAX-{OBSERVE_FLOW}:Fleet_Frame_Bytes")]

    # the rows: the CPU replay of r1's bytes, then r2's continued from
    # the last window r1 saved
    if host.batches_processed != BATCHES or host2.batches_processed != 1:
        raise AssertionError(f"observe: {host.batches_processed} + "
                             f"{host2.batches_processed} batches")
    if launches != BATCHES + 1:
        raise AssertionError(f"observe: anomaly_score launched {launches} times")
    if sync.count:
        raise AssertionError(f"observe: {sync.count} host syncs in poll, encode and "
                             f"dispatch: {sorted(sync.sites)}")
    same_snapshot(rec["last_snap"], restored, "observe restart: restored window")
    cpu = FlowProcessor(conf1, device="cpu")
    rows_out = replay_on_cpu(cpu, rec, OBSERVE_OUTPUTS, "observe")
    cpu2 = FlowProcessor(conf1, device="cpu")
    if not cpu2.restore_window_state(rec["last_snap"]):
        raise AssertionError("observe restart: the CPU replay refused the snapshot")
    replay_on_cpu(cpu2, rec2, OBSERVE_OUTPUTS, "observe restart", start=BATCHES)

    # calibration rides every batch; the protocol holds
    metrics = rec["metrics"] + rec2["metrics"]
    calib = profile.metrics()
    if any({k: m.get(k) for k in calib} != calib for m in metrics):
        raise AssertionError("observe: a batch without the card's Calib_* gauges")
    protocol_events = sum(m.get("Protocol_Events_Count", 0.0) for m in metrics)
    monitors = (host.protocol_monitor, host2.protocol_monitor)
    if protocol_events <= 0 or any(pm.violations for pm in monitors) or violations \
            or any("Protocol_Violation_Count" in m for m in metrics):
        raise AssertionError(f"observe: {protocol_events} protocol events, "
                             f"{[pm.violations for pm in monitors]} violations")

    # exactly one capture, drained into one batch trace, holding the
    # anomaly kernel and the loop threads' CPU ops
    captures = [s for s in spans if s.get("name") == "profiler/capture"]
    counted = [m["Profiler_Captures_Count"] for m in rec["metrics"]
               if "Profiler_Captures_Count" in m]
    if armed.get("status") != 200 or len(captures) != 1 or not counted \
            or max(counted) != 1.0 or captures[0]["properties"]["path"] != armed["path"]:
        raise AssertionError(f"observe: capture {armed}, spans {captures}, "
                             f"Profiler_Captures_Count {counted}")
    if not capture.get("anomaly_score") \
            or not set(CAPTURE_THREADS) <= set(capture["loop_threads_with_ops"]):
        raise AssertionError(f"observe: the capture holds {capture}")

    # the fleet view: sums, histograms, statuses, lineage, the audit
    summed = {n: v for n, v in fm["counters"].items() if n.endswith("_Count")}
    wrong = {n: (v, sum(m.get(n, 0.0) for m in metrics)) for n, v in summed.items()
             if v != sum(m.get(n, 0.0) for m in metrics)}
    batch_hist = fm["histograms"].get("batch", {}).get("count")
    statuses = {r: v["status"] for r, v in fm["replicas"].items()}
    lineage = [seg["replica"] for seg in fm["lineage"]]
    audit = fm["audit"]
    if not summed or wrong or batch_hist != BATCHES + 1 \
            or statuses != {"r1": "completed", "r2": "completed"} \
            or lineage != ["r1", "r2"] or not audit["conserved"] \
            or audit["output"] != "Delivered" or any(audit["counts"].values()):
        raise AssertionError(f"observe fleet: counters off {wrong}, batch histogram "
                             f"{batch_hist}, {statuses}, lineage {lineage}, {audit}")

    # the CLI over the flight recorder: stages, and both replicas
    stages = {ln.split()[0] for ln in cli["spans"][1].splitlines()[1:] if ln.strip()}
    stitched = cli["stitch"][1]
    if any(rc for rc, _out in cli.values()) \
            or not {"decode", "dispatch", "device-step", "sync", "collect",
                    "sinks", "streaming/batch"} <= stages \
            or "replica r1" not in stitched or "replica r2" not in stitched \
            or "replica r1" not in cli["trace"][1]:
        raise AssertionError(f"observe cli: {cli}")

    def stats(key):
        vals = [m[key] for m in rec["metrics"] if key in m]
        return {"median": statistics.median(vals), "max": max(vals), "all": vals}

    emit({
        "phase": "observe", "capacity": CAPACITY, "batches": BATCHES, "depth": 2,
        "seed": seed, "run_s": run_s, "events_per_s": BATCHES * CAPACITY / run_s,
        "host_phase_events_per_s": host_events_per_s,
        "latency_batch_ms": stats("Latency-Batch"),
        "background_land_ms": stats("Transfer_Background_LandMs"),
        "fleet_frame_publish_ms": publish_ms, "fleet_frame_bytes": frame_bytes,
        "fleet": {"frames": frames, "refresh_ms": refresh_ms,
                  "counters_checked": len(summed), "batch_histogram_count": batch_hist,
                  "replicas": statuses, "lineage": lineage,
                  "audit": {k: audit[k] for k in ("output", "ingested", "emitted",
                                                   "conserved", "counts")}},
        "protocol_events": protocol_events,
        "protocol_violations": sum(pm.violations for pm in monitors),
        "capture": {"seconds": CAPTURE_SECONDS, "armed_status": armed["status"],
                    "duration_ms": captures[0]["durationMs"], **capture,
                    "thread_ids": thread_ids},
        "calib_on_every_batch": True, "host_syncs_poll_encode_dispatch": sync.count,
        "cli_stages": sorted(stages), "rows_out": rows_out,
        "launches": {"anomaly_score": launches}, "match_cpu": True, "card": nvidia_smi,
    })
    return launches


def write_conf_file(path: Path, conf: dict) -> None:
    """A flat ``.conf`` file, multi-line values escaped as the flattener
    writes them."""
    lines = [f"{k}={v}".replace("\\", "\\\\").replace("\n", "\\n") for k, v in conf.items()]
    path.write_text("\n".join(lines) + "\n")


def phase_host_cli(nvidia_smi: str) -> int:
    """The entry point a user starts: ``runtime.host.main`` on a conf
    file, local simulated input at full capacity, the conf-declared
    anomaly UDF and the default pilot; returns ``anomaly_score``'s
    launches (the UDF, and its count, are made by ``main``)."""
    import tempfile

    from data_accelerator_tpu_torch.runtime import host as host_mod

    conf = flow_conf()
    conf.update({
        "datax.job.name": CLI_FLOW,
        "datax.job.input.default.eventhub.maxrate": str(CAPACITY),
        "datax.job.process.batchcapacity": str(CAPACITY),
        "datax.job.process.jar.udf.anomalyscore.class":
            "data_accelerator_tpu_torch.udf.samples:anomalyscore",
    })
    for out in OUTPUTS:
        conf[f"datax.job.output.{out}.console.maxrows"] = "0"
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(LineCount()):
        path = Path(tmp) / "flow.conf"
        write_conf_file(path, conf)
        t0 = time.perf_counter()
        host = host_mod.main([f"conf={path}", f"batches={CLI_BATCHES}"])
        seconds = time.perf_counter() - t0
    launches = host.processor.udfs["anomalyscore"].launches
    keys = host.metric_logger.store.keys(f"DATAX-{CLI_FLOW}:")
    if host.batches_processed != CLI_BATCHES or launches != CLI_BATCHES:
        raise AssertionError(f"host_cli: {host.batches_processed} batches, "
                             f"{launches} anomaly_score launches")
    if f"DATAX-{CLI_FLOW}:Output_HeatAvg_Events_Count" not in keys:
        raise AssertionError(f"host_cli: metric keys {sorted(keys)}")
    if host.pilot is None or host.device.type != "cuda":
        raise AssertionError("host_cli: not piloted on the card")
    emit({"phase": "host_cli", "batches": host.batches_processed,
          "seconds": seconds, "metric_keys": len(keys),
          "launches": {"anomaly_score": launches}, "card": nvidia_smi})
    return launches


class DispatchTimes:
    """Records each processor's ``dispatch_batch`` times while entered,
    less a manifest warm's (batch time 0)."""

    def __init__(self):
        self.ms = collections.defaultdict(list)

    def __enter__(self):
        # the processor class the host builds
        from data_accelerator_tpu_torch.runtime.host import FlowProcessor

        self._cls, self._orig = FlowProcessor, FlowProcessor.dispatch_batch
        times = self.ms

        def timed(proc, raw, batch_time_ms=None):
            t0 = time.perf_counter()
            h = self._orig(proc, raw, batch_time_ms)
            if batch_time_ms != 0:
                times[id(proc)].append((time.perf_counter() - t0) * 1e3)
            return h

        FlowProcessor.dispatch_batch = timed
        return self

    def __exit__(self, *exc):
        self._cls.dispatch_batch = self._orig


def http_get_json(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read())


def phase_gen_conf(nvidia_smi: str) -> dict:
    """The conf the reference's control plane generates for the config-1
    queries (``tests/data/generated_torch/``: alert rules, conformance
    model, compile manifest) through ``runtime.host.main`` at full
    capacity from the conf's local source, for two batches past the
    conformance monitor's warm-up, so that its ratios are judged; before
    it, the same conf without its manifest for the first batch's
    dispatch time, freed before the peak memory restarts. Returns each
    kernel's launches over both runs (the conf declares no kernel)."""
    import tempfile

    from data_accelerator_tpu_torch.core.config import parse_conf_lines
    from data_accelerator_tpu_torch.constants import MetricName
    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.obs import calibrate
    from data_accelerator_tpu_torch.obs import conformance as conf_mod
    from data_accelerator_tpu_torch.obs.exposition import ObservabilityServer
    from data_accelerator_tpu_torch.obs.histogram import HISTOGRAMS
    from data_accelerator_tpu_torch.runtime import host as host_mod

    allocated_at_start = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        conf_path = materialize_generated_conf(Path(tmp) / "job")
        conf = parse_conf_lines(conf_path.read_text().splitlines())
        warmup = int(conf.get("datax.job.process.conformance.warmup",
                              conf_mod.DEFAULT_WARMUP_BATCHES))
        batches = warmup + 2
        cold_path = Path(tmp) / "cold.conf"
        cold_path.write_text("".join(
            line for line in conf_path.read_text().splitlines(keepends=True)
            if not line.startswith("datax.job.process.compile.manifest=")))
        runs = {}
        launch.reset_launches()
        with DispatchTimes() as dt:
            t0 = time.perf_counter()
            host = host_mod.main([f"conf={cold_path}", f"batches={CLI_BATCHES}"])
            runs["no_manifest"] = (dt.ms[id(host.processor)], time.perf_counter() - t0)
        # Hbm_PeakBytes (DX522's observation) is the allocator's peak since
        # its last reset: the first host and its device tensors go first,
        # so that the peak is the manifest run's own. Both runs write one
        # flow's series into the process's metric store, read after the
        # second
        host.metric_logger.store.clear()
        first = weakref.ref(host.processor)
        del host
        gc.collect()
        torch.cuda.synchronize()
        if first() is not None:
            raise AssertionError("gen_conf: the first run's processor outlived its host")
        allocated_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        # the manifest run's host calibrates the card at its init, after
        # its processor is built: its probe must not show in the peak
        calibrate.clear_cache()
        with DispatchTimes() as dt:
            t0 = time.perf_counter()
            host = host_mod.main([f"conf={conf_path}", f"batches={batches}"])
            runs["manifest"] = (dt.ms[id(host.processor)], time.perf_counter() - t0)
        launches = process_launches()
        dispatch_ms, seconds = runs["manifest"]
        # the firing set as GET /alerts serves it, over the run's engine
        srv = ObservabilityServer(host.health, histograms=HISTOGRAMS,
                                  store=host.metric_logger.store, port=0,
                                  alerts=host.alerts)
        srv.start()
        try:
            alerts = http_get_json(srv.port, "/alerts")
        finally:
            srv.stop()
    store = host.metric_logger.store
    prefix = f"DATAX-{GEN_FLOW}:"

    def series(metric):
        return [p["val"] for p in store.points(prefix + metric)]

    names = {k[len(prefix):] for k in store.keys(prefix)}
    drift = store.points(prefix + "Conformance_Drift")
    inputs = series("Input_DataXProcessedInput_Events_Count")
    model = json.loads(conf["datax.job.process.conformance.model"])
    warm_miss = series("Compile_WarmMiss_Count")
    monitor = host.conformance
    # the conf's maxrate is one batch a second: the host's backpressure
    # may shrink a poll after a slow batch
    if host.batches_processed != batches or inputs[0] != float(CAPACITY) \
            or not all(inputs):
        raise AssertionError(f"gen_conf: {host.batches_processed} batches of {inputs} rows")
    if not host.processor._aot_warmed or len(series("Compile_ColdStart_Ms")) != 1:
        raise AssertionError("gen_conf: the manifest warm did not run once")
    if any(warm_miss):
        raise AssertionError(f"gen_conf: Compile_WarmMiss_Count {warm_miss}")
    if host.alerts is None or monitor is None or host.conf_audit is None:
        raise AssertionError("gen_conf: alerts, conformance or the conf audit is off")
    if series("Output_HeatAvg_Events_Count") != [8.0] * batches \
            or not all(series("Output_OpenDoors_Events_Count")):
        raise AssertionError("gen_conf: unexpected output counts")
    # the monitor judged batches past its warm-up: D2H (DX501), occupancy
    # (DX502) and retraces (DX503) hold on this flow; DX522 fires exactly
    # when a judged HBM ratio is past its band
    d2h_ratio = series("Conformance_D2HBytes_Ratio")
    hbm_ratio = series("Conformance_Hbm_Ratio")
    codes = [e["code"] for e in drift]
    if monitor.batches != batches or len(d2h_ratio) != batches \
            or len(hbm_ratio) != batches:
        raise AssertionError(f"gen_conf: the monitor saw {monitor.batches} batches, "
                             f"{len(d2h_ratio)} D2H and {len(hbm_ratio)} HBM ratios")
    if any(c in ("DX501", "DX502", "DX503") for c in codes) \
            or max(d2h_ratio[warmup:]) > monitor.d2h_ratio_high:
        raise AssertionError(f"gen_conf: DX5xx {codes}, D2H ratios {d2h_ratio}")
    judged_past = any(r > monitor.hbm_ratio_high for r in hbm_ratio[warmup:])
    if judged_past != ("DX522" in codes):
        raise AssertionError(f"gen_conf: DX522 events {codes} against HBM ratios "
                             f"{hbm_ratio} (band {monitor.hbm_ratio_high})")
    # the calibration ran in this host's init: the flow's own peak stays
    # beside the model, and DX522 silent
    if "DX522" in codes or judged_past:
        raise AssertionError(f"gen_conf: HBM ratios {hbm_ratio} past "
                             f"{monitor.hbm_ratio_high} (DX522 {codes})")
    # the card's profile rides every batch and prices the model's
    # stages; a stage at or over the floor is judged: its ratio appears
    # every batch, and DX520/521 fire exactly when a judged ratio past
    # the warm-up is over its band
    calib = {n: series(n) for n in sorted(names) if n.startswith("Calib_")}
    if not calib or any(len(v) != batches for v in calib.values()):
        raise AssertionError(f"gen_conf: Calib_* series {calib}")
    predictions = {}
    for stage, ms in sorted(monitor.latency.items()):
        camel = MetricName.stage_metric(stage)[len("Latency-"):]
        ratios = series(f"Conformance_StageTime_{camel}_Ratio")
        judged = ms >= monitor.stage_time_floor_ms
        predictions[stage] = {"predicted_ms": ms, "judged": judged, "ratios": ratios}
        if judged and len(ratios) != batches:
            raise AssertionError(f"gen_conf: stage {stage} judged, ratios {ratios}")
    if not predictions:
        raise AssertionError("gen_conf: no calibrated stage predictions")
    stage_past = any(r > monitor.stage_time_ratio_high
                     for p in predictions.values() if p["judged"]
                     for r in p["ratios"][warmup:])
    if stage_past != any(c in ("DX520", "DX521") for c in codes):
        raise AssertionError(f"gen_conf: DX520/521 events {codes} against stage "
                             f"predictions {predictions}")
    emit({
        "phase": "gen_conf", "conf": str(GEN_FIXTURE.relative_to(ROOT)),
        "batches": host.batches_processed, "conformance_warmup": warmup,
        "capacity": CAPACITY, "input_rows": inputs,
        "seconds": seconds, "engine_exception": None,
        "alerts_firing": [a["name"] for a in alerts["firing"]],
        "alert_rules": [(r["name"], r["state"]) for r in alerts["rules"]],
        "dx5xx_events": [{k: e.get(k) for k in ("code", "metric", "ratio", "observed",
                                               "predicted")} for e in drift],
        "conformance_gauges": {n: series(n) for n in sorted(names)
                               if n.startswith("Conformance_")
                               and n != "Conformance_Drift"},
        "hbm_peak_bytes": series("Hbm_PeakBytes"),
        "calib": {n: v[-1] for n, v in calib.items()},
        "stage_predictions": predictions,
        "launches_per_step": host.launches_per_step(),
        "device_step_judged": predictions.get("device-step", {}).get("judged", False),
        "stage_time_floor_ms": monitor.stage_time_floor_ms,
        "stage_time_band": monitor.stage_time_ratio_high,
        "allocated_at_phase_start_bytes": allocated_at_start,
        "allocated_before_manifest_run_bytes": allocated_before,
        "model_hbm_bytes": model["totals"]["hbmBytes"],
        "model_d2h_bytes_per_batch": model["totals"]["d2hBytesPerBatch"],
        "transfer_d2h_bytes": series("Transfer_D2HBytes"),
        "conf_gauges": {n: series(n)[-1] for n in sorted(names)
                        if n.startswith("Conf_") and n.endswith("_Count")},
        "compile_cold_start_ms": series("Compile_ColdStart_Ms")[0],
        "compile_warm_miss_count": sum(warm_miss),
        "dispatch_ms": dispatch_ms,
        "first_dispatch_ms": {k: v[0][0] for k, v in runs.items()},
        "init_plus_run_s": {k: v[1] for k, v in runs.items()},
        "launches": launches, "card": nvidia_smi,
    })
    return launches


STORM_FLOW = "ChipSmokeStorm"


def storm_host_conf(tmp: str, ckpt_dir: str, homes_csv: str) -> dict:
    """The StormDoors flow from two sockets through the host: depth 2,
    background landing, checkpoints every second, the pilot off."""
    conf = storm_conf(tmp, capacity=CAPACITY, weather_capacity=WEATHER_CAPACITY,
                      homes_csv=homes_csv, join_capacity=STORM_JOIN_CAPACITY)
    conf.update({
        "datax.job.name": STORM_FLOW,
        "datax.job.input.sources.default.inputtype": "socket",
        "datax.job.input.sources.default.socket.port": "0",
        "datax.job.input.sources.weather.inputtype": "socket",
        "datax.job.input.sources.weather.socket.port": "0",
        "datax.job.input.default.eventhub.maxrate": str(HOST_MAXRATE),
        "datax.job.input.default.eventhub.checkpointdir": ckpt_dir,
        "datax.job.input.default.eventhub.checkpointinterval": "1 second",
        "datax.job.process.pipeline.depth": "2",
        "datax.job.process.pilot.enabled": "false",
    })
    for out in STORM_OUTPUTS:
        conf[f"datax.job.output.{out}.console.maxrows"] = "0"
    return conf


class WeatherFeed:
    """Sends the weather stream's line for batch b to its socket as the
    host polls batch b (waiting up to 0.2 s for it to arrive), so the
    stations report staggered; a line may still land one poll late."""

    def __init__(self, host, lines):
        import socket

        self.src = host.sources["weather"]
        self.lines = list(lines)
        self.conn = socket.create_connection(("127.0.0.1", self.src.port), timeout=60)
        poll = self.src.poll_raw

        def poll_fed(max_events):
            if self.lines:
                line = self.lines.pop(0)
                if line:
                    before = self.src._seq + len(self.src._buf)
                    self.conn.sendall(line)
                    deadline = time.monotonic() + 0.2
                    while (self.src._seq + len(self.src._buf) == before
                           and time.monotonic() < deadline):
                        time.sleep(0.002)
            return poll(max_events)

        self.src.poll_raw = poll_fed

    def close(self):
        self.conn.close()


def profile_step(proc, raws, batch_time_ms) -> dict:
    """One step under ``torch.profiler``: device busy time (kernels and
    copies on the one stream) against its wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proc.dispatch_batch(raws, batch_time_ms).collect_counts()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    rows = [e for e in prof.key_averages()
            if not e.key.startswith("aten::") and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_activities": sum(e.count for e in rows)}


def phase_storm(seed: int, nvidia_smi: str) -> dict:
    """The two-stream window join through ``StreamingHost`` from two
    sockets; returns each kernel's launches in the run (the conf declares
    no kernel)."""
    import tempfile

    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.ops.join import sort_join_indices
    from data_accelerator_tpu_torch.runtime.host import StreamingHost
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    rs = np.random.RandomState(seed + 2)
    payloads = [iot_lines(rs, CAPACITY) for _ in range(BATCHES + 1)]
    # this flow's peak; what was allocated before it is printed beside it
    allocated_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    weather = [weather_lines(rs, b) for b in range(BATCHES + 1)]
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(LineCount()):
        homes = str(Path(tmp) / "homes.csv")
        write_homes_csv(homes)
        conf = SettingDictionary(storm_host_conf(tmp, str(Path(tmp) / "ckpt"), homes))
        launch.reset_launches()
        t0 = time.perf_counter()
        host = StreamingHost(conf)
        init_s = time.perf_counter() - t0
        sync = ThreadSyncCount()
        rec = record_host(host, sync)
        feed = WeatherFeed(host, weather[:BATCHES])
        try:
            feed_s = feed_socket(host.source.port, payloads[:BATCHES],
                                 BATCHES * CAPACITY, host.source)
            torch.cuda.synchronize()
            with sync:
                t_run = time.perf_counter()
                host.run_pipelined(max_batches=BATCHES)
                run_s = time.perf_counter() - t_run
            launches = process_launches()
        finally:
            feed.close()
            host.stop()
        host2 = StreamingHost(conf)
        restored = host2.processor.snapshot_window_state()
        rec2 = record_host(host2, ThreadSyncCount())
        feed2 = WeatherFeed(host2, weather[BATCHES:])
        try:
            feed_socket(host2.source.port, payloads[BATCHES:], CAPACITY, host2.source)
            host2.run_pipelined(max_batches=1)
        finally:
            feed2.close()
            host2.stop()

        m = rec["metrics"]
        iot_in = [x["Input_DataXProcessedInput_Events_Count"] for x in m]
        wx_in = [x["Input_Weather_Events_Count"] for x in m]
        dropped = [x["Output_StormDoors_JoinRowsDropped"] for x in m]
        fed = sum(1 for w in weather[:BATCHES] if w)
        if host.batches_processed != BATCHES or iot_in != [float(CAPACITY)] * BATCHES:
            raise AssertionError(f"storm: {host.batches_processed} batches of {iot_in}")
        polled = sum(1 for data, _b, src in rec["encoded"] if src == "weather"
                     for ln in data.splitlines() if ln)
        if sum(wx_in) != polled or not fed - 1 <= polled <= fed:
            raise AssertionError(f"storm: weather {wx_in}, polled {polled} of {fed}")
        if any(dropped):
            raise AssertionError(f"storm: join rows dropped {dropped}")
        if sync.count:
            raise AssertionError(f"storm: {sync.count} host syncs in poll, encode "
                                 f"and dispatch: {sorted(sync.sites)}")
        if host2.window_restored_from != "local" or set(restored["rings"]) != {
                "DataXProcessedInput", "Weather"}:
            raise AssertionError(f"storm restart: {host2.window_restored_from}, "
                                 f"rings {sorted(restored['rings'])}")
        same_snapshot(rec["last_snap"], restored, "storm restart: restored window")
        cpu = FlowProcessor(conf, device="cpu")
        rows_out = replay_on_cpu(cpu, rec, STORM_OUTPUTS, "storm")
        if not rows_out["StormDoors"] or not rows_out["DoorHomes"]:
            raise AssertionError(f"storm produced no joined rows: {rows_out}")
        cpu2 = FlowProcessor(conf, device="cpu")
        if not cpu2.restore_window_state(rec["last_snap"]):
            raise AssertionError("storm restart: the CPU replay refused the snapshot")
        replay_on_cpu(cpu2, rec2, STORM_OUTPUTS, "storm restart", start=BATCHES)

        # the join's share of one profiled step: the step on the card
        # from the restored window, and its join alone at the same inputs
        gpu = FlowProcessor(conf)
        gpu.restore_window_state(rec["last_snap"])
        t_ms = rec["times"][-1] + 1000
        raws = {src or gpu.primary: gpu.encode_json_bytes(data, base, source=src)
                for data, base, src in rec["encoded"][-2:]}
        step = profile_step(gpu, raws, t_ms)
        ring = gpu.window_buffers["Weather"]
        right_keys = ring.cols["stationId"].reshape(-1)
        right_valid = ring.valid.reshape(-1)
        left = raws["default"].unpack() if hasattr(raws["default"], "unpack") else raws["default"]
        left_keys = left.cols["deviceDetails.homeId"]

        def join():
            return sort_join_indices([left_keys], [right_keys], left.valid, right_valid,
                                     STORM_JOIN_CAPACITY)

        join_ms = cuda_ms_turns({"join": join})["join"]

    def stats(key):
        vals = [x[key] for x in m if key in x]
        return {"median": statistics.median(vals), "max": max(vals), "all": vals}

    emit({
        "phase": "storm", "capacity": CAPACITY, "weather_capacity": WEATHER_CAPACITY,
        "join_capacity": STORM_JOIN_CAPACITY, "batches": BATCHES, "depth": 2,
        "seed": seed, "init_s": init_s, "feed_s": feed_s, "run_s": run_s,
        "events_per_s": BATCHES * CAPACITY / run_s,
        "input_events": {"DataXProcessedInput": iot_in, "Weather": wx_in},
        "join_rows_dropped": dropped,
        "storm_rows": [x["Output_StormDoors_Events_Count"] for x in m],
        "door_homes_rows": [x["Output_DoorHomes_Events_Count"] for x in m],
        "dispatch_ms": rec["dispatch_ms"],
        "dispatch_ms_median": statistics.median(rec["dispatch_ms"]),
        "latency_batch_ms": stats("Latency-Batch"),
        "background_land_ms": stats("Transfer_Background_LandMs"),
        "hbm_peak_bytes": m[-1].get("Hbm_PeakBytes"),
        "allocated_at_phase_start_bytes": allocated_at_start,
        "checkpoints": len(rec["save_ms"]),
        "host_syncs_poll_encode_dispatch": sync.count,
        "rows_out": rows_out,
        "restart": {"restored_from": host2.window_restored_from,
                    "rings": sorted(restored["rings"]),
                    "restored_slot_counter": restored["slot_counter"]},
        "profiled_step": step, "join_device_ms": join_ms,
        "join_right_rows": int(right_keys.shape[0]),
        "join_share_of_step": join_ms / step["device_busy_ms"],
        "launches": launches, "match_cpu": True, "card": nvidia_smi,
    })
    return launches


JOIN_BIG = (CAPACITY, 10_240)
JOIN_RESIDUAL = (4096, 4096)


def phase_join_ops(seed: int, nvidia_smi: str) -> dict:
    """The join ops alone on the card against the CPU: indices,
    validity, ``is_null`` and ``dropped`` exact, 0 host syncs, and each
    op's device time (CUDA events). Returns each kernel's launches in
    the checked calls (the ops call none)."""
    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.ops import join as J

    rs = np.random.RandomState(seed + 3)

    def side(n, key_range):
        return (torch.from_numpy(rs.randint(0, key_range, n).astype(np.int32)),
                torch.from_numpy(rs.uniform(size=n) < 0.9),
                torch.from_numpy(rs.randint(0, 1000, n).astype(np.int32)))

    n, m = JOIN_BIG
    # keys over m values: about 0.8 n pairs, inside 2 n, past n / 64
    big = (side(n, m), side(m, m))
    n2, m2 = JOIN_RESIDUAL
    small = (side(n2, 64), side(m2, 64))

    def cases(dev):
        (lk, lv, _), (rk, rv, _) = [[t.to(dev) for t in s] for s in big]
        (slk, slv, sla), (srk, srv, sra) = [[t.to(dev) for t in s] for s in small]

        def residual(i, j):
            return sla[i] > sra[j]

        return {
            "sort_join_inner": lambda: J.sort_join_indices([lk], [rk], lv, rv, 2 * n),
            "sort_join_left_outer": lambda: J.sort_join_indices(
                [lk], [rk], lv, rv, 2 * n, left_outer=True),
            "sort_join_overflow": lambda: J.sort_join_indices([lk], [rk], lv, rv, n // 64),
            "inner_join_residual": lambda: J.inner_join_indices(
                [slk], [srk], slv, srv, n2 * 64, residual),
            "left_join_residual": lambda: J.left_join_indices(
                [slk], [srk], slv, srv, n2 * 64, residual),
        }

    cpu, gpu = cases("cpu"), cases("cuda")
    results = {}
    launch.reset_launches()
    for name, fn in gpu.items():
        want = cpu[name]()
        with SyncCount() as sync:
            got = fn()
        for a, b in zip(want, got):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"join_ops {name}: the card differs from the CPU")
        if sync.count:
            raise AssertionError(f"join_ops {name}: {sync.count} host syncs "
                                 f"{sorted(sync.sites)}")
        results[name] = {"pairs_valid": int(want[2].sum()), "dropped": int(want[-1]),
                         "out_capacity": int(want[2].shape[0])}
    launches = process_launches()
    if results["sort_join_overflow"]["dropped"] <= 0:
        raise AssertionError("join_ops: the overflow case dropped nothing")
    ms = cuda_ms_turns(gpu, runs=10, warmup=2)
    emit({"phase": "join_ops", "sizes": {"sort": JOIN_BIG, "residual": JOIN_RESIDUAL},
          "ops": {k: {**v, "device_ms": ms[k]} for k, v in results.items()},
          "host_syncs": 0, "match_cpu": True, "launches": launches,
          "card": nvidia_smi})
    return launches


# -- state tables: the accumulator and the partition handoff --
STATE_FLOW = "ChipSmokeState"
STATE_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
]})
# bench.py::bench_state_handoff's transform: the accumulator keeps each
# key's largest value across batches, the window counts rows a key
STATE_TRANSFORM = (
    "--DataXQuery--\n"
    "merged = SELECT k, v FROM DataXProcessedInput "
    "UNION ALL SELECT k, v FROM seen\n"
    "--DataXQuery--\n"
    "seen = SELECT k, MAX(v) AS v FROM merged GROUP BY k\n"
    "--DataXQuery--\n"
    "Win = SELECT k, COUNT(*) AS c "
    "FROM DataXProcessedInput_10seconds GROUP BY k\n"
)
STATE_PARTITIONS = 16
STATE_BATCHES = 4


def state_conf(hostdir: str, snapshot_url: str = None, capacity: int = CAPACITY,
               replica_index: int = 1, replica_count: int = 1,
               partitions: int = STATE_PARTITIONS) -> dict:
    """The accumulator flow of one replica, its transform, checkpoints
    and state under ``hostdir``: socket input at 8 x capacity, window
    checkpoints every second, the state table's capacity (4 x the batch)
    as the GROUP BY bound, ``partitions`` state partitions keyed on
    ``k``, the objstore mirror at ``snapshot_url`` (none when None), the
    key-routed ingest filter on when there are several replicas, the
    pilot off and the console sink quiet."""
    Path(hostdir).mkdir(parents=True, exist_ok=True)
    tpath = Path(hostdir) / "state.transform"
    tpath.write_text(STATE_TRANSFORM, encoding="utf-8")
    conf = {
        "datax.job.name": STATE_FLOW,
        "datax.job.input.default.inputtype": "socket",
        "datax.job.input.default.socket.port": "0",
        "datax.job.input.default.blobschemafile": STATE_SCHEMA,
        "datax.job.input.default.eventhub.maxrate": str(8 * capacity),
        "datax.job.input.default.eventhub.checkpointdir": str(Path(hostdir) / "ckpt"),
        "datax.job.input.default.eventhub.checkpointinterval": "1 second",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.timestampcolumn": "ts",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.transform": str(tpath),
        "datax.job.process.batchcapacity": str(capacity),
        "datax.job.process.maxgroups": str(4 * capacity),
        "datax.job.process.pipeline.depth": "2",
        "datax.job.process.timewindow.DataXProcessedInput_10seconds"
        ".windowduration": "10 seconds",
        "datax.job.process.statetable.seen.schema": "k long, v double",
        "datax.job.process.statetable.seen.location": str(Path(hostdir) / "state" / "seen"),
        "datax.job.process.state.partitions": str(partitions),
        "datax.job.process.state.partitionkey": "k",
        "datax.job.process.state.replicaindex": str(replica_index),
        "datax.job.process.state.replicacount": str(replica_count),
        "datax.job.process.pilot.enabled": "false",
        "datax.job.output.Win.console.maxrows": "0",
    }
    if snapshot_url:
        conf["datax.job.process.state.snapshoturl"] = snapshot_url
    if replica_count > 1:
        conf["datax.job.process.state.filteringest"] = "true"
    return conf


def state_batch(rs, n_rows: int, n_keys: int):
    """One batch of the accumulator flow: keys uniform over
    ``0..n_keys-1``, values uniform float32 in [0, 1); returns (JSON
    lines, keys, values), every value written so it parses back to the
    same float32."""
    k = rs.randint(0, n_keys, n_rows).astype(np.int32)
    v = rs.uniform(0, 1, n_rows).astype(np.float32)
    lines = "".join(f'{{"k":{a},"v":{b:.9g}}}\n' for a, b in zip(k.tolist(), v.tolist()))
    return lines.encode(), k, v


def max_per_key(keys, values) -> dict:
    """{key: the largest value} over every row, in numpy."""
    k, v = np.concatenate(keys), np.concatenate(values)
    order = np.lexsort((v, k))
    last = np.r_[k[order][1:] != k[order][:-1], True]
    return dict(zip(k[order][last].tolist(), v[order][last].tolist()))


def table_map(t, key="k", value="v") -> dict:
    """{key: value} over a state table's valid rows, on the host."""
    valid = t.valid.cpu().numpy()
    return dict(zip(t.cols[key].cpu().numpy()[valid].tolist(),
                    t.cols[value].cpu().numpy()[valid].tolist()))


class PinnedClock:
    """The host module's ``time`` in the state phase: ``time()`` reads a
    clock that the wrapped poll sets to its batch's time, so replicas
    that would run side by side see the same batch times one after the
    other, and every batch sits inside the 10 s window of the last."""

    def __init__(self):
        self.now = BASE_MS / 1000.0

    def __call__(self):
        return self.now

    def module(self):
        import types

        return types.SimpleNamespace(time=self, sleep=time.sleep)


class Instrumented:
    """A state host's probes: poll (sets the pinned clock to the batch's
    time) and dispatch (counted for host syncs, the handle's state copy
    bytes kept), each state table's overwrite and persist timed on the
    landing thread with the snapshot bytes they write, the window
    partition pushes, and the batch metrics. ``remove`` takes every
    probe off again, so that the host holds no reference to itself
    through them."""

    def __init__(self, host, sync, clock, times):
        self.host, self.wrapped = host, []
        self.rec = {"metrics": [], "state_d2h_bytes": [], "overwrite_ms": [],
                    "persist_ms": [], "snapshot_bytes": [], "window_pushes": []}
        proc, rec = host.processor, self.rec
        times = list(times)
        poll, dispatch = host._poll_and_encode, proc.dispatch_batch

        def poll_at():
            clock.now = times.pop(0)
            return poll()

        def dispatch_rec(raw, batch_time_ms):
            h = dispatch(raw, batch_time_ms)
            rec["state_d2h_bytes"].append(h.state_d2h_bytes)
            return h

        self._set(host, "_poll_and_encode", sync.wrap(poll_at))
        self._set(proc, "dispatch_batch", sync.wrap(dispatch_rec))
        for st in proc.state_tables.values():
            written = [0]
            put = st._local.put_files

            def put_counted(prefix, side, files, put=put, written=written):
                written[0] += sum(len(b) for b in files.values())
                return put(prefix, side, files)

            def timed(fn, key, written=written):
                def call(*a, **k):
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    rec[key].append((time.perf_counter() - t0) * 1e3)
                    if key == "persist_ms":
                        rec["snapshot_bytes"].append(written[0])
                        written[0] = 0
                    return out
                return call

            self._set(st._local, "put_files", put_counted)
            self._set(st, "overwrite", timed(st.overwrite, "overwrite_ms"))
            self._set(st, "persist", timed(st.persist, "persist_ms"))
        push = proc.push_window_partitions

        def push_counted(snap):
            n = push(snap)
            rec["window_pushes"].append(n)
            return n

        self._set(proc, "push_window_partitions", push_counted)
        send = host.metric_logger.send_batch_metrics

        def send_rec(metrics, ts):
            rec["metrics"].append(dict(metrics))
            return send(metrics, ts)

        self._set(host.metric_logger, "send_batch_metrics", send_rec)

    def _set(self, obj, name, fn):
        setattr(obj, name, fn)
        self.wrapped.append((obj, name))

    def remove(self):
        for obj, name in self.wrapped:
            obj.__dict__.pop(name, None)
        self.wrapped, self.host = [], None


def phase_state(seed: int, nvidia_smi: str) -> dict:
    """BASELINE config 3's accumulator with partitioned state and the
    ``objstore://`` handoff at full width: two predecessor replicas
    (``filteringest``, 16 partitions between them) on the card, each fed
    the same ``STATE_BATCHES`` batches from its socket and stopped; a
    successor on fresh directories pulls every partition through the
    in-process object store, merges the window rings, reloads the
    accumulator and runs one batch. Checks each row owned once, the
    reloaded accumulator against numpy, the window's source, the
    successor's window counts against a single CPU replica fed the same
    batches, 0 host syncs on the dispatch thread, and that a stopped
    predecessor frees its memory by reference counting. Returns each
    kernel's launches on the path (the conf declares none)."""
    import tempfile

    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.runtime import host as host_mod
    from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreServer

    rs = np.random.RandomState(seed + 4)
    batches = [state_batch(rs, CAPACITY, CAPACITY) for _ in range(STATE_BATCHES + 1)]
    payloads = [b[0] for b in batches]
    want_seen = max_per_key([b[1] for b in batches[:STATE_BATCHES]],
                            [b[2] for b in batches[:STATE_BATCHES]])
    t0_s = BASE_MS / 1000.0
    clock = PinnedClock()
    real_time = host_mod.time
    store = ObjectStoreServer(port=0).start()
    url = f"objstore://127.0.0.1:{store.port}/smoke/state"
    preds, memory, sync = [], [], ThreadSyncCount()
    host_mod.time = clock.module()
    try:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(LineCount()):
            launch.reset_launches()
            for idx in (1, 2):
                conf = SettingDictionary(state_conf(
                    str(Path(tmp) / f"pred{idx}"), url, capacity=CAPACITY,
                    replica_index=idx, replica_count=2))
                # replica 2 starts a second later: its own time base
                times = [t0_s + idx - 1 + b for b in range(STATE_BATCHES)]
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                host = host_mod.StreamingHost(conf)
                probes = Instrumented(host, sync, clock, times)
                feed_s = feed_socket(host.source.port, payloads[:STATE_BATCHES],
                                     STATE_BATCHES * CAPACITY, host.source)
                torch.cuda.synchronize()
                with sync:
                    t_run = time.perf_counter()
                    host.run_pipelined(max_batches=STATE_BATCHES)
                    run_s = time.perf_counter() - t_run
                torch.cuda.synchronize()
                alive = torch.cuda.memory_allocated()
                peak = torch.cuda.max_memory_allocated()
                t_stop = time.perf_counter()
                host.stop()
                stop_ms = (time.perf_counter() - t_stop) * 1e3
                probes.remove()
                done = host.batches_processed
                proc_ref = weakref.ref(host.processor)
                gc.disable()
                try:
                    del host
                    freed = proc_ref() is None
                    after = torch.cuda.memory_allocated()
                finally:
                    gc.enable()
                if done != STATE_BATCHES or not freed:
                    raise AssertionError(f"state replica {idx}: {done} batches, "
                                         f"processor freed without the collector: {freed}")
                memory.append({"allocated_before_bytes": before, "peak_bytes": peak,
                               "allocated_before_stop_bytes": alive,
                               "allocated_after_stop_bytes": after})
                if after - before > 0.05 * (alive - before):
                    raise AssertionError(f"state replica {idx}: {after - before} of "
                                         f"{alive - before} bytes still allocated after "
                                         "the stopped host went")
                preds.append({"rec": probes.rec, "run_s": run_s, "feed_s": feed_s,
                              "stop_ms": stop_ms})

            # the successor: one replica, fresh directories, the mirror
            # its only route to state
            clock.now = t0_s + STATE_BATCHES
            t_init = time.perf_counter()
            succ = host_mod.StreamingHost(SettingDictionary(state_conf(
                str(Path(tmp) / "succ"), url, capacity=CAPACITY)))
            init_ms = (time.perf_counter() - t_init) * 1e3
            handoff_ms = succ.processor.state_stats.get("Handoff_Ms")
            seen = table_map(succ.processor.state_data["seen"])
            restored_from = succ.window_restored_from
            probes = Instrumented(succ, sync, clock, [t0_s + STATE_BATCHES + 1])
            feed_socket(succ.source.port, payloads[STATE_BATCHES:], CAPACITY, succ.source)
            win_rows = {}

            class Recording:
                kind = "recording"

                def write(self, dataset, rows, batch_time_ms):
                    win_rows[dataset] = rows
                    return len(rows)

            succ.dispatcher.operators["Win"].sinks.append(Recording())
            with sync:
                t_first = time.perf_counter()
                succ.run_pipelined(max_batches=1)
                first_ms = (time.perf_counter() - t_first) * 1e3
            stop_to_first_ms = (time.perf_counter() - t_stop) * 1e3
            succ.stop()
            probes.remove()
            succ_rec = probes.rec
            launches = process_launches()

            # one replica on the CPU, fed the same five batches
            cpu = host_mod.StreamingHost(SettingDictionary(state_conf(
                str(Path(tmp) / "cpu"), capacity=CAPACITY)), device="cpu")
            cpu_rows = {}

            class CpuRecording:
                kind = "recording"

                def write(self, dataset, rows, batch_time_ms):
                    cpu_rows[batch_time_ms] = rows
                    return len(rows)

            cpu.dispatcher.operators["Win"].sinks.append(CpuRecording())
            cpu_probes = Instrumented(cpu, ThreadSyncCount(), clock,
                                      [t0_s + b for b in range(STATE_BATCHES + 1)])
            feed_socket(cpu.source.port, payloads, (STATE_BATCHES + 1) * CAPACITY,
                        cpu.source)
            cpu.run_pipelined(max_batches=STATE_BATCHES + 1)
            cpu.stop()
            cpu_probes.remove()
    finally:
        host_mod.time = real_time
        store.stop()

    filtered = [p["rec"]["metrics"] for p in preds]
    filtered = [sum(m.get("State_IngestFiltered_Count", 0.0) for m in ms) for ms in filtered]
    if sum(filtered) != STATE_BATCHES * CAPACITY:
        raise AssertionError(f"state: the replicas filtered {filtered} rows, not "
                             f"{STATE_BATCHES * CAPACITY} between them")
    if seen != want_seen:
        bad = sorted(set(seen.items()) ^ set(want_seen.items()))[:5]
        raise AssertionError(f"state: the successor's seen ({len(seen)} keys) differs "
                             f"from numpy's ({len(want_seen)} keys): {bad}")
    if restored_from != "partitions":
        raise AssertionError(f"state: the successor's window came from {restored_from!r}")
    got = sorted(win_rows["Win"], key=lambda r: r["k"])
    want = sorted(cpu_rows[max(cpu_rows)], key=lambda r: r["k"])
    same_rows(got, want, "state successor Win")
    if sum(r["c"] for r in got) != (STATE_BATCHES + 1) * CAPACITY:
        raise AssertionError(f"state: the successor's window counts "
                             f"{sum(r['c'] for r in got)} rows")
    if sync.count:
        raise AssertionError(f"state: {sync.count} host syncs in poll, encode and "
                             f"dispatch: {sorted(sync.sites)}")
    if any(launches.values()):
        raise AssertionError(f"state: kernel launches {launches}")
    succ_metrics = succ_rec["metrics"][0]
    emit({
        "phase": "state", "capacity": CAPACITY, "batches": STATE_BATCHES,
        "partitions": STATE_PARTITIONS, "state_capacity": 4 * CAPACITY, "seed": seed,
        "predecessors": [{
            "replica": i + 1, "events_per_s": STATE_BATCHES * CAPACITY / p["run_s"],
            "run_s": p["run_s"], "feed_s": p["feed_s"], "stop_ms": p["stop_ms"],
            "ingest_filtered": filtered[i],
            "overwrite_ms": p["rec"]["overwrite_ms"], "persist_ms": p["rec"]["persist_ms"],
            "overwrite_persist_ms": [a + b for a, b in zip(p["rec"]["overwrite_ms"],
                                                           p["rec"]["persist_ms"])],
            "snapshot_bytes": p["rec"]["snapshot_bytes"],
            "state_d2h_bytes": p["rec"]["state_d2h_bytes"],
            "window_pushes": p["rec"]["window_pushes"],
            "state_push_counts": [m.get("State_Snapshot_Push_Count") for m in p["rec"]["metrics"]],
            **memory[i],
        } for i, p in enumerate(preds)],
        "successor": {
            "state_handoff_ms": handoff_ms, "init_ms": init_ms, "first_batch_ms": first_ms,
            "stop_to_first_batch_ms": stop_to_first_ms, "window_restored_from": restored_from,
            "seen_keys": len(seen), "win_rows": len(got),
            "state_pull_count": succ_metrics.get("State_Snapshot_Pull_Count"),
            "state_d2h_bytes": succ_rec["state_d2h_bytes"],
            "overwrite_ms": succ_rec["overwrite_ms"], "persist_ms": succ_rec["persist_ms"],
        },
        "host_syncs_poll_encode_dispatch": sync.count, "launches": launches,
        "match_cpu": True, "card": nvidia_smi,
    })
    return launches


# -- LiveQuery: the designer's kernels and the lq/ serving plane ----------
LQ_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
    {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
     "metadata": {}},
]})
# bench.py::bench_livequery's query and rows (60 rows: the 64-row bucket)
LQ_QUERY = (
    "Agg = SELECT deviceId, COUNT(*) AS Cnt, MAX(temperature) AS MaxTemp "
    "FROM DataXProcessedInput GROUP BY deviceId"
)
LQ_ROWS = 60
# (tenants, sessions a tenant, arrivals a second) of the two open loads
LQ_LOADS = ((8, 4, 500.0), (32, 8, 2000.0))
LQ_LOAD_SECONDS = 1.5
LQ_POOL = 64
LQ_SERVE_CONF = {
    "datax.job.process.lq.ticker": "true",
    "datax.job.process.lq.maxbatchwaitms": "4",
    "datax.job.process.lq.tenant.maxsessions": "8",
    "datax.job.process.lq.tenant.maxqps": "1000000",
    "datax.job.process.lq.maxsessions": "4096",
}
# the designer's sample: SchemaInferenceManager.sample_events' default
LQ_SAMPLE_EVENTS = 1000
LQ_WARM_EXECUTES = 20
# the cache part: a windowed query at three row buckets (32,768, 65,536
# and 131,072 rows) under a 9 MiB budget, which holds the first two
# entries and not all three
LQ_CACHE_QUERY = (
    "W = SELECT deviceId, COUNT(*) AS Cnt, MAX(temperature) AS MaxTemp "
    "FROM DataXProcessedInput_5seconds GROUP BY deviceId"
)
LQ_CACHE_ROWS = (16_385, 32_769, 65_537)
# the smallest bucket (64 rows), where the allocator's 512-byte blocks
# hold more than the bytes
LQ_SMALL_ROWS = 60
LQ_CACHE_BUDGET_MB = 9
# the byte model against the allocator's growth across a build and first
# execute: model / growth must fall in this band
LQ_MODEL_BAND = (0.8, 1.25)


def lq_rows(n: int, base_ms: int = BASE_MS):
    return [{"deviceId": i % 7, "temperature": 20.0 + (i % 13),
             "eventTimeStamp": base_ms + i} for i in range(n)]


def same_lq_result(got: dict, want: dict, what: str, rtol=1e-4) -> None:
    if got.get("headers") != want.get("headers") or got.get("table") != want.get("table"):
        raise AssertionError(f"{what}: headers {got.get('headers')} vs {want.get('headers')}")
    same_rows(got["result"], want["result"], what, rtol)


def cuda_tensors_alive(top: int = 6) -> dict:
    """The CUDA tensors the cyclic collector can see (distinct storages,
    their bytes, the largest by shape and dtype) beside
    ``torch.cuda.memory_allocated()``: bytes no such tensor holds are
    held from C++ or by a tensor outside Python's containers."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects() if torch.is_tensor(o) and o.is_cuda]
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr():
            storages[st.data_ptr()] = (st.nbytes(), list(t.shape), str(t.dtype))
    return {
        "allocated": torch.cuda.memory_allocated(),
        "gc_visible_bytes": sum(e[0] for e in storages.values()),
        "gc_visible_storages": len(storages),
        "largest": sorted(storages.values(), key=lambda e: -e[0])[:top],
    }


def collect_garbage(top: int = 12) -> dict:
    """One collection, with what it found unreachable counted by type
    (the types of this program and of the port first), and the card's
    bytes it gave back."""
    before = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        kinds = collections.Counter(
            f"{type(o).__module__}.{type(o).__qualname__}" for o in gc.garbage)
        n = len(gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    gc.collect()
    ours = {k: c for k, c in kinds.items()
            if k.startswith(("data_accelerator_tpu_torch", "chip_smoke", "__main__"))}
    torch.cuda.synchronize()
    return {"objects": n, "freed_bytes": before - torch.cuda.memory_allocated(),
            "port_and_smoke_types": dict(sorted(ours.items(), key=lambda kv: -kv[1])[:top]),
            "types": dict(kinds.most_common(top))}


def open_loop(svc, sids, query, rate: float, seconds: float) -> dict:
    """``bench.py::bench_livequery``'s open loop: an execute is submitted
    every 1/``rate`` s for ``seconds``, whatever has completed, through a
    pool of ``LQ_POOL`` workers; each result is kept."""
    results, errors = [], []
    lock = threading.Lock()

    def one(sid):
        try:
            r = svc.execute(sid, query)
        except Exception as e:  # noqa: BLE001 — counted, and the phase fails on it
            with lock:
                errors.append(repr(e)[:200])
            return
        with lock:
            results.append(r)

    interval = 1.0 / rate
    submitted = 0
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=LQ_POOL) as pool:
        while time.monotonic() - t0 < seconds:
            pool.submit(one, sids[submitted % len(sids)])
            submitted += 1
            delay = t0 + submitted * interval - time.monotonic()
            if delay > 0:
                time.sleep(delay)
    elapsed = time.monotonic() - t0
    return {"submitted": submitted, "results": results, "errors": errors,
            "elapsed_s": elapsed}


def lq_serve(golden: dict) -> dict:
    """The serving plane on the card under the two open loads, one
    service throughout: every result equal to the CPU's, 1 compiled
    entry and 1 step-cache entry across both, no execute timed out."""
    from data_accelerator_tpu_torch.lq.service import (
        LQ_EXEC_STAGE,
        LQ_FLOW,
        LiveQueryService,
    )

    rows = lq_rows(LQ_ROWS)
    svc = LiveQueryService(conf=dict(LQ_SERVE_CONF), device="cuda")
    try:
        first = svc.create_session("warm", "ChipSmokeLQ", LQ_SCHEMA, sample_rows=rows)["id"]
        t0 = time.perf_counter()
        same_lq_result(svc.execute(first, LQ_QUERY), golden, "lq_serve cold")
        cold_ms = (time.perf_counter() - t0) * 1e3
        loads = []
        for k, (tenants, per_tenant, rate) in enumerate(LQ_LOADS):
            sids = [svc.create_session(f"l{k}-t{t}", "ChipSmokeLQ", LQ_SCHEMA,
                                       sample_rows=rows)["id"]
                    for t in range(tenants) for _ in range(per_tenant)]
            svc.histograms.clear()
            svc.coalescer.max_fanin_seen = 0
            before = svc.coalescer.stats()
            run = open_loop(svc, sids, LQ_QUERY, rate, LQ_LOAD_SECONDS)
            after = svc.coalescer.stats()
            checked = set()
            for r in run["results"]:
                if id(r) not in checked:  # coalesced calls share one result
                    same_lq_result(r, golden, f"lq_serve load {k}")
                    checked.add(id(r))
            completed = len(run["results"])
            if run["errors"] or completed != run["submitted"]:
                raise AssertionError(
                    f"lq_serve load {k}: {completed} of {run['submitted']} "
                    f"completed, errors {run['errors'][:3]}")
            cache = svc.cache.stats()
            if (cache["compiles"], cache["entries"], cache["stepCacheEntries"]) != (1, 1, 1):
                raise AssertionError(f"lq_serve load {k}: compile surface grew: {cache}")
            ticks = after["ticks"] - before["ticks"]
            calls = after["calls"] - before["calls"]
            dispatches = after["dispatches"] - before["dispatches"]
            loads.append({
                "tenants": tenants, "sessions": tenants * per_tenant,
                "arrival_rate": rate, "seconds": LQ_LOAD_SECONDS,
                "submitted": run["submitted"], "completed": completed,
                "kernel_qps": completed / run["elapsed_s"],
                "p50_ms": svc.histograms.percentile(LQ_FLOW, LQ_EXEC_STAGE, 50),
                "p99_ms": svc.histograms.percentile(LQ_FLOW, LQ_EXEC_STAGE, 99),
                "avg_fanin": calls / ticks if ticks else 0.0,
                "max_fanin": after["maxFaninSeen"],
                "dispatches": dispatches, "coalesced": calls - dispatches,
                "distinct_results": len(checked),
                "compiles": cache["compiles"], "entries": cache["entries"],
                "step_cache_entries": cache["stepCacheEntries"],
                "resident_bytes": cache["residentBytes"],
            })
        return {"cold_execute_ms": cold_ms, "loads": loads,
                "budget_bytes": svc.cache.budget_bytes}
    finally:
        svc.stop()


def lq_quota() -> dict:
    """A twin service with ``tenant.maxqps`` 1: after the burst token,
    5 executes are refused at admission and dispatch nothing."""
    from data_accelerator_tpu_torch.lq.service import LiveQueryService
    from data_accelerator_tpu_torch.lq.session import AdmissionRejected

    tight = LiveQueryService(conf={"datax.job.process.lq.tenant.maxqps": "1"},
                             device="cuda")
    try:
        sid = tight.create_session("freeloader", "ChipSmokeLQ", LQ_SCHEMA,
                                   sample_rows=lq_rows(LQ_ROWS))["id"]
        tight.execute(sid, LQ_QUERY)
        before = tight.coalescer.stats()["dispatches"]
        rejected = 0
        for _ in range(5):
            try:
                tight.execute(sid, LQ_QUERY)
            except AdmissionRejected:
                rejected += 1
        delta = tight.coalescer.stats()["dispatches"] - before
        if rejected != 5 or delta != 0:
            raise AssertionError(f"lq_quota: {rejected} rejected, {delta} dispatches")
        return {"rejected": rejected, "dispatch_delta": delta,
                "rejected_count": tight.lq_metrics()["LQ_Admission_Rejected_Count"]}
    finally:
        tight.stop()


def designer_queries() -> dict:
    """The config-1 queries as a designer types them into a kernel:
    ``TRANSFORM``'s statements, each with the statements it reads."""
    parts = {p.split(" =", 1)[0]: p.strip()
             for p in TRANSFORM.split("--DataXQuery--\n")[1:]}
    sep = "--DataXQuery--\n"

    def script(*names):
        return "".join(sep + parts[n] + "\n" for n in names)

    return {
        "DoorEvents": parts["DoorEvents"],
        "OpenDoors": script("DoorEvents", "OpenDoors"),
        "HeatAvg": parts["HeatAvg"],
        "Scored": script("DoorEvents", "Scored"),
    }


def lq_designer(seed: int) -> dict:
    """The designer path at the reference's sample size: schema
    inference polls 1,000 events from a file source and writes the
    sample blob; a card kernel and a CPU kernel are built from it with
    the config-1 flow's schema and normalization and the anomaly UDF;
    each query's cold execute, then 20 warm ones, against the CPU's
    rows; the anomaly kernel's launches over the UDF query's executes;
    two threads on one kernel against a serial run."""
    import tempfile

    from data_accelerator_tpu_torch.runtime.sources import FileSource
    from data_accelerator_tpu_torch.serve import livequery
    from data_accelerator_tpu_torch.serve.schemainference import SchemaInferenceManager
    from data_accelerator_tpu_torch.serve.storage import LocalRuntimeStorage
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    conf = flow_conf()
    rs = np.random.RandomState(seed + 6)
    queries = designer_queries()
    # the sample has no timestamp column: both kernels' current_timestamp()
    # reads this clock, so their rows agree
    real_time = livequery.time
    livequery.time = types.SimpleNamespace(time=lambda: BASE_MS / 1000.0 + 0.25)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "events.json"
            path.write_bytes(make_json_payload(rs, LQ_SAMPLE_EVENTS + 24))
            runtime = LocalRuntimeStorage(str(Path(tmp) / "runtime"))
            t0 = time.perf_counter()
            inferred = SchemaInferenceManager(runtime).get_input_schema(
                source=FileSource([str(path)]), flow_name="ChipSmokeDesigner")
            infer_ms = (time.perf_counter() - t0) * 1e3
            fields = {f["name"] for f in json.loads(inferred["Schema"])["fields"]}
            if inferred["EventsSampled"] != LQ_SAMPLE_EVENTS or "deviceDetails" not in fields:
                raise AssertionError(f"lq_designer inference: {inferred['EventsSampled']}, {fields}")
            udf = anomalyscore()
            kernels = {}
            for dev, u in (("cuda", udf), ("cpu", anomalyscore())):
                svc = livequery.KernelService(runtime_storage=runtime, device=dev)
                kid = svc.create_kernel(
                    "ChipSmokeDesigner", conf["datax.job.input.default.blobschemafile"],
                    normalization=conf["datax.job.process.projection"],
                    udfs={"anomalyscore": u})
                kernels[dev] = (svc, kid)
            gsvc, gkid = kernels["cuda"]
            csvc, ckid = kernels["cpu"]
            if len(gsvc.get(gkid).sample_rows) != LQ_SAMPLE_EVENTS:
                raise AssertionError("lq_designer: the kernel did not load the sample blob")
            out = {"infer_ms": infer_ms, "sample_rows": LQ_SAMPLE_EVENTS,
                   "bucket": livequery._capacity_for(LQ_SAMPLE_EVENTS), "queries": {}}
            for name, q in queries.items():
                launches0 = udf.launches
                t0 = time.perf_counter()
                got = gsvc.execute(gkid, q, max_rows=LQ_SAMPLE_EVENTS)
                cold_ms = (time.perf_counter() - t0) * 1e3
                want = csvc.execute(ckid, q, max_rows=LQ_SAMPLE_EVENTS)
                same_lq_result(got, want, f"lq_designer {name}")
                warm = []
                for _ in range(LQ_WARM_EXECUTES):
                    t0 = time.perf_counter()
                    got = gsvc.execute(gkid, q, max_rows=LQ_SAMPLE_EVENTS)
                    warm.append((time.perf_counter() - t0) * 1e3)
                same_lq_result(got, want, f"lq_designer {name} warm")
                executes = 1 + LQ_WARM_EXECUTES
                launches = udf.launches - launches0
                if name == "Scored" and launches < executes:
                    raise AssertionError(
                        f"lq_designer: anomaly_score launched {launches} times "
                        f"in {executes} executes")
                out["queries"][name] = {
                    "rows": len(want["result"]), "cold_ms": cold_ms,
                    "warm_p50_ms": statistics.median(warm),
                    "warm_max_ms": max(warm), "executes": executes,
                    "anomaly_launches": launches}
            # two threads on one kernel at once, against a serial run
            serial = gsvc.execute(gkid, queries["HeatAvg"])
            barrier = threading.Barrier(2)

            def runs():
                barrier.wait(timeout=30)
                return [gsvc.execute(gkid, queries["HeatAvg"]) for _ in range(10)]

            with ThreadPoolExecutor(2) as pool:
                futs = [pool.submit(runs) for _ in range(2)]
                threaded = [r for f in futs for r in f.result(timeout=120)]
            for r in threaded:
                same_lq_result(r, serial, "lq_designer threads", rtol=0)
            out["threads"] = {"threads": 2, "executes": len(threaded), "equal_serial": True}
            gsvc.delete_kernels()
            csvc.delete_kernels()
        return out
    finally:
        livequery.time = real_time


def lq_cache(rows=LQ_CACHE_ROWS) -> dict:
    """The byte model and eviction: three signatures (row buckets) of a
    windowed query under ``LQ_CACHE_BUDGET_MB``, each acquired and run
    once as the coalescer's tick does, then settled. Each entry's price
    beside the allocator's growth across its build and first execute
    (and the requested bytes' growth); the third evicts the LRU entry,
    and the eviction gives back what the model priced."""
    from data_accelerator_tpu_torch.lq.service import LiveQueryService
    from data_accelerator_tpu_torch.lq.warmcache import signature_for

    def requested():
        return torch.cuda.memory_stats().get("requested_bytes.all.current", 0)

    svc = LiveQueryService(
        conf={"datax.job.process.lq.hbmbudgetmb": str(LQ_CACHE_BUDGET_MB)},
        device="cuda")
    try:
        entries, keys = [], []
        for n in rows:
            sid = svc.create_session(f"c{n}", "ChipSmokeLQCache", LQ_SCHEMA,
                                     sample_rows=lq_rows(n))["id"]
            session = svc.sessions.get(sid)
            sig = signature_for(session, LQ_CACHE_QUERY, svc.cache.compile_conf)
            torch.cuda.synchronize()
            mem0, req0 = torch.cuda.memory_allocated(), requested()
            t0 = time.perf_counter()
            entry = svc.cache.acquire(sig, session)
            entry.execute(session.sample_rows, LQ_CACHE_QUERY, 100)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - t0) * 1e3
            growth, req_growth = torch.cuda.memory_allocated() - mem0, requested() - req0
            evicted0 = svc.cache.evictions
            priced_before = {k: e.hbm_bytes for k, e in svc.cache._entries.items()}
            svc.cache.settle(in_use=entry)
            torch.cuda.synchronize()
            gone = [k for k in priced_before if k not in svc.cache._entries]
            freed = torch.cuda.memory_allocated() - (mem0 + growth)
            ratio = entry.hbm_bytes / growth if growth else None
            if entry.sized_by != "model" or ratio is None or not (
                    LQ_MODEL_BAND[0] <= ratio <= LQ_MODEL_BAND[1]):
                raise AssertionError(
                    f"lq_cache: {sig.row_bucket}-row entry priced {entry.hbm_bytes} B "
                    f"({entry.sized_by}) against {growth} B of growth")
            entries.append({
                "row_bucket": sig.row_bucket, "rows": n, "model_bytes": entry.hbm_bytes,
                "sized_by": entry.sized_by,
                "allocated_growth": growth, "requested_growth": req_growth,
                "model_over_growth": ratio, "build_and_first_execute_ms": build_ms,
                "evicted": svc.cache.evictions - evicted0,
                "evicted_model_bytes": sum(priced_before[k] for k in gone),
                "allocated_freed_at_eviction": -freed,
            })
            keys.append(sig.key)
            del entry, session
        metrics = svc.lq_metrics()
        if metrics["LQ_KernelEvict_Count"] < 1 or keys[0] in svc.cache._entries:
            raise AssertionError(f"lq_cache: evictions {metrics['LQ_KernelEvict_Count']}, "
                                 f"resident {list(svc.cache._entries)}")
        return {"budget_bytes": svc.cache.budget_bytes, "entries": entries,
                "evictions": svc.cache.evictions,
                "LQ_KernelEvict_Count": metrics["LQ_KernelEvict_Count"],
                "LQ_KernelBytes": metrics["LQ_KernelBytes"],
                "model_band": list(LQ_MODEL_BAND)}
    finally:
        svc.stop()


def phase_livequery(seed: int, nvidia_smi: str) -> dict:
    """LiveQuery on the card: ``lq_serve``, ``lq_quota``, ``lq_designer``
    and ``lq_cache``, every service and kernel on ``cuda``; then the
    card's allocation back to its value at the phase's start, every
    service stopped and dropped, with the cyclic collector off from the
    start (one collection before it sets the baseline and reports what
    earlier phases left as cyclic garbage). Returns each kernel's
    launches on the path, its counts set to 0 at the start."""
    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.lq.service import LiveQueryService

    torch.cuda.synchronize()
    # what earlier phases left allocated, then what of it was cyclic
    # garbage: the baseline is taken after one collection, and the
    # collector stays off for the phase, so the check at its end sees
    # only what reference counting gave back
    at_start = cuda_tensors_alive()
    at_start["cyclic_garbage"] = collect_garbage()
    mem_start = torch.cuda.memory_allocated()
    at_start["allocated_after_collect"] = mem_start
    launch.reset_launches()
    t0 = time.perf_counter()
    gc.disable()
    try:
        cpu = LiveQueryService(device="cpu")
        try:
            sid = cpu.create_session("cpu", "ChipSmokeLQ", LQ_SCHEMA,
                                     sample_rows=lq_rows(LQ_ROWS))["id"]
            golden = cpu.execute(sid, LQ_QUERY)
        finally:
            cpu.stop()
        serve = lq_serve(golden)
        quota = lq_quota()
        designer = lq_designer(seed)
        cache = lq_cache()
        launches = process_launches()
        torch.cuda.synchronize()
        mem_end = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    line = {
        "phase": "livequery", "seconds": time.perf_counter() - t0,
        "lq_serve": serve, "lq_quota": quota, "lq_designer": designer,
        "lq_cache": cache, "launches": launches,
        "memory": {"at_start": at_start, "allocated_start": mem_start,
                   "allocated_end": mem_end, "collector": "off in the phase"},
        "card": nvidia_smi,
    }
    emit(line)
    if mem_end != mem_start:
        raise AssertionError(
            f"livequery: {mem_end - mem_start} B still allocated after every "
            f"service stopped: {cuda_tensors_alive()}")
    if launches["anomaly_score"] < 1 or launches["dx305_double"]:
        raise AssertionError(f"livequery launches: {launches}")
    return launches


# -- the debug runtime and the device plan (slice 7a) --------------------------
DEBUG_FLOW = "ChipSmokeDebug"
DEBUG_CONF = {
    "datax.job.process.debug.nans": "true",
    "datax.job.process.debug.tracerleaks": "true",
    "datax.job.process.debug.buffersanitizer": "true",
}
# the anomaly query alone: its views carry the temperatures the source
# sent and compute the score, so a NaN temperature trips the guard at
# the UDF's output in Scored
ANOMALY_TRANSFORM = (
    TRANSFORM.split("--DataXQuery--\nOpenDoors")[0]
    + "--DataXQuery--\nScored" + TRANSFORM.split("--DataXQuery--\nScored")[1]
)
# plan: model / reading must fall in these bands (see phase_plan)
PLAN_RESIDENT_BAND = (0.95, 1.05)
PLAN_PEAK_BAND = (0.25, 1.5)


def debug_host_conf(ckpt_dir: str) -> dict:
    """The main path (``host_conf``) with every ``process.debug`` guard
    armed."""
    conf = host_conf(ckpt_dir)
    conf["datax.job.name"] = DEBUG_FLOW
    conf.update(DEBUG_CONF)
    return conf


def debug_faults(seed: int) -> dict:
    """Three seeded faults on the card. A batch of NaN temperatures
    through the armed anomaly query raises ``FloatingPointError`` at
    ``anomaly_score``'s output in ``Scored`` (the kernel launched and
    its output was checked). A view of a pooled pinned matrix kept past
    its release reads the sentinel the pool wrote once the matrix's
    copy had completed: DX805. Then batches at depth 2 decode into
    poisoned, reused matrices while earlier batches are in flight and
    land the CPU's rows: the poison never reached an in-flight copy."""
    import types as _types

    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    rs = np.random.RandomState(seed + 7)
    conf = flow_conf()
    conf.update(DEBUG_CONF)
    conf.update({
        "datax.job.name": DEBUG_FLOW + "Faults",
        "datax.job.process.transform": ANOMALY_TRANSFORM,
        "datax.job.process.batchcapacity": str(CAPACITY),
        "datax.job.process.jar.udf.anomalyscore.class":
            "data_accelerator_tpu_torch.udf.samples:anomalyscore",
    })
    for out in ("AnomalyAlerts",):
        conf[f"datax.job.output.{out}.console.maxrows"] = "0"
    gpu = FlowProcessor(SettingDictionary(conf))
    udf = gpu.udfs["anomalyscore"]
    type_ids = np.array([gpu.dictionary.encode(t) for t in DEVICE_TYPES], np.int32)
    cols = make_columns(rs, type_ids, CAPACITY)
    cols["deviceDetails.temperature"][::97] = np.nan
    before = udf.launches
    try:
        gpu.process_batch(gpu.encode_columns(cols, CAPACITY), BASE_MS)
    except FloatingPointError as e:
        nan_error = str(e)
    else:
        raise AssertionError("debug: a NaN batch passed the armed nans guard")
    nan_launches = udf.launches - before
    if "'Scored'" not in nan_error or "anomalyscore" not in nan_error or nan_launches != 1:
        raise AssertionError(f"debug NaN fault: {nan_error!r}, {nan_launches} launches")
    del gpu

    # a fresh armed processor for the pool faults; the CPU's twin replays
    gpu = FlowProcessor(SettingDictionary(conf))
    cpu = FlowProcessor(SettingDictionary(conf), device="cpu")
    san = gpu.buffer_sanitizer
    payloads = [make_json_payload(rs, CAPACITY) for _ in range(6)]
    base = lambda b: BASE_MS + 1000 * b  # noqa: E731
    raw = gpu.encode_json_bytes(payloads[0], base(0))
    pool, mat = raw.ingest_slot
    row = [c for c, _k in raw.layout].index("deviceDetails.temperature")
    kept = mat[row]  # a view of the pinned matrix, kept past its batch
    if not bool(torch.isfinite(kept.view(torch.float32)).all()):
        raise AssertionError("debug: the decoded temperatures are not finite")
    gpu.process_batch(raw, base(0))
    del raw
    hits = san.scan_table("kept", _types.SimpleNamespace(
        cols={"deviceDetails.temperature": kept.numpy()}, valid=None))
    events = san.drain_events()
    deltas = san.drain_metric_deltas()
    if hits != 1 or [e["code"] for e in events] != ["DX805"] \
            or deltas.get("Sanitizer_PoisonHit_Count") != 1.0:
        raise AssertionError(f"debug kept view: {hits} hits, {events}, {deltas}")
    del kept, mat
    poisoned0, reused0 = san.poison_count, pool.reuse_count
    # depth 2: batch b+1 decodes and ships while batch b is in flight
    cpu.process_batch(cpu.encode_json_bytes(payloads[0], base(0)), base(0))
    handles, landed = [], 0
    for b in range(1, len(payloads)):
        handles.append((b, gpu.dispatch_batch(gpu.encode_json_bytes(payloads[b], base(b)),
                                              base(b))))
        if len(handles) == 2:
            bb, h = handles.pop(0)
            got, metrics = h.collect_tables()
            want, _m = cpu.process_batch(cpu.encode_json_bytes(payloads[bb], base(bb)), base(bb))
            same_rows(got["AnomalyAlerts"], want["AnomalyAlerts"], f"debug reuse batch {bb}")
            if "Sanitizer_PoisonHit_Count" in metrics:
                raise AssertionError(f"debug reuse batch {bb}: {metrics}")
            landed += 1
    for bb, h in handles:
        got, _m = h.collect_tables()
        want, _m = cpu.process_batch(cpu.encode_json_bytes(payloads[bb], base(bb)), base(bb))
        same_rows(got["AnomalyAlerts"], want["AnomalyAlerts"], f"debug reuse batch {bb}")
        landed += 1
    reused = pool.reuse_count - reused0
    if reused < 2 or san.poison_count - poisoned0 < reused or san.poison_hits != 1:
        raise AssertionError(f"debug reuse: {reused} reuses, "
                             f"{san.poison_count - poisoned0} poisons, {san.poison_hits} hits")
    return {"nan_error": nan_error, "nan_fault_launches": nan_launches,
            "kept_view_hits": hits, "kept_view_event": events[0]["message"],
            "reuse_batches": landed, "reused_matrices": reused,
            "poisoned_matrices": san.poison_count - poisoned0,
            "pool_allocs": pool.alloc_count}


def phase_debug(seed: int, nvidia_smi: str, host_events_per_s: float) -> dict:
    """The main path through ``StreamingHost`` with ``process.debug.nans``,
    ``tracerleaks`` and ``buffersanitizer`` armed: the host phase's
    config-1 flow plus the anomaly query from a socket at depth 2,
    checkpoints every second. Rows equal a CPU replay; no poison hit, a
    guarded-view count above 0; events/s beside the host phase's and
    the host syncs the guards add per batch (the unarmed phases have
    none). Then the seeded faults (``debug_faults``). Returns each
    kernel's launches on the armed path."""
    import tempfile

    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.runtime.host import StreamingHost
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    rs = np.random.RandomState(seed + 2)
    payloads = [make_json_payload(rs, CAPACITY) for _ in range(BATCHES)]
    with tempfile.TemporaryDirectory() as ckpt, contextlib.redirect_stdout(LineCount()):
        conf = SettingDictionary(debug_host_conf(ckpt))
        host = StreamingHost(conf)
        proc = host.processor
        guard, san = proc.step_guard, proc.buffer_sanitizer
        if guard is None or not (guard.nans and guard.leaks) or san is None:
            raise AssertionError("debug: the conf did not arm every guard")
        sync = ThreadSyncCount()
        rec = record_host(host, sync)
        try:
            feed_socket(host.source.port, payloads, BATCHES * CAPACITY, host.source)
            torch.cuda.synchronize()
            guard.take_checks()
            launch.reset_launches()
            with sync:
                t_run = time.perf_counter()
                host.run_pipelined(max_batches=BATCHES)
                run_s = time.perf_counter() - t_run
            launches = process_launches()
            checks = guard.take_checks()
        finally:
            host.stop()
        pool = proc._ingest_pools["default"]
    guarded = sum(m.get("Sanitizer_GuardedViews_Count", 0.0) for m in rec["metrics"])
    hit_metrics = [m["Sanitizer_PoisonHit_Count"] for m in rec["metrics"]
                   if "Sanitizer_PoisonHit_Count" in m]
    if host.batches_processed != BATCHES:
        raise AssertionError(f"debug: {host.batches_processed} batches")
    if san.poison_hits or hit_metrics or guarded <= 0:
        raise AssertionError(f"debug: {san.poison_hits} poison hits {hit_metrics}, "
                             f"{guarded} guarded views")
    if launches["anomaly_score"] != BATCHES:
        raise AssertionError(f"debug: anomaly_score launched {launches}")
    if sync.count != checks:
        raise AssertionError(f"debug: {sync.count} host syncs in poll, encode and "
                             f"dispatch, the guards made {checks} checks: "
                             f"{sorted(sync.sites)}")
    cpu = FlowProcessor(conf, device="cpu")
    rows_out = replay_on_cpu(cpu, rec, OUTPUTS, "debug")
    faults = debug_faults(seed)
    emit({
        "phase": "debug", "capacity": CAPACITY, "batches": BATCHES, "depth": 2,
        "seed": seed, "run_s": run_s,
        "events_per_s": BATCHES * CAPACITY / run_s,
        "host_events_per_s": host_events_per_s,
        "events_per_s_over_host": BATCHES * CAPACITY / run_s / host_events_per_s,
        "host_syncs_per_batch": sync.count / BATCHES,
        "guard_checks_per_batch": checks / BATCHES,
        "sanitizer": {"guarded_views": guarded, "poison_hits": san.poison_hits,
                      "poisoned_matrices": san.poison_count,
                      "pool_allocs": pool.alloc_count, "pool_reuses": pool.reuse_count},
        "checkpoints": len(rec["save_ms"]),
        "latency_batch_ms_median": statistics.median(
            m["Latency-Batch"] for m in rec["metrics"]),
        "rows_out": rows_out, "match_cpu": True,
        "faults": faults, "launches": launches, "card": nvidia_smi,
    })
    return launches


def main_flow_gui(capacity: int = CAPACITY) -> dict:
    """The main flow (``host_conf``'s alerting flow plus the anomaly
    query) as the designer's gui JSON the analysis CLI reads."""
    queries = TRANSFORM.replace(
        "FROM DataXProcessedInput_5seconds",
        "FROM DataXProcessedInput TIMEWINDOW('5 seconds')",
    ).replace("\n--DataXQuery--", ";\n--DataXQuery--").rstrip("\n") + ";\n"
    queries += "".join(f"OUTPUT {o} TO Metrics;\n" for o in OUTPUTS)
    return {
        "name": HOST_FLOW,
        "input": {"mode": "streaming", "type": "local", "properties": {
            "inputSchemaFile": IOT_SCHEMA,
            "normalizationSnippet": "current_timestamp() AS eventTimeStamp\nRaw.*",
        }},
        "process": {
            "timestampColumn": "eventTimeStamp",
            "watermark": "0 second",
            "queries": [queries],
            "jobconfig": {"jobBatchCapacity": str(capacity)},
            "functions": [{"id": "anomalyscore", "type": "udf", "properties": {
                "module": "data_accelerator_tpu_torch.udf.samples:anomalyscore"}}],
        },
        "outputs": [{"id": "Metrics", "type": "metric", "properties": {}}],
    }


def plan_conf() -> dict:
    """The main flow (``host_conf``'s) for a processor fed columns."""
    conf = flow_conf()
    conf.update({
        "datax.job.name": HOST_FLOW + "Plan",
        "datax.job.process.batchcapacity": str(CAPACITY),
        "datax.job.process.jar.udf.anomalyscore.class":
            "data_accelerator_tpu_torch.udf.samples:anomalyscore",
    })
    for out in OUTPUTS:
        conf[f"datax.job.output.{out}.console.maxrows"] = "0"
    return conf


def run_analysis_cli(argv) -> tuple:
    """``python -m data_accelerator_tpu_torch.analysis`` in process:
    (exit code, stdout, stderr)."""
    from data_accelerator_tpu_torch.analysis.__main__ import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(list(argv))
    return rc, out.getvalue(), err.getvalue()


# the conformance monitor's defaults for judging a stage's time
# (obs/conformance.py): a prediction under the floor is not judged, a
# judged ratio past the band fires DX520
STAGE_TIME_FLOOR_MS = 1.0
STAGE_TIME_RATIO_HIGH = 10.0


def plan_gates() -> dict:
    """The race, protocol and conf gates over the port's own source: no
    error and no dead conf row."""
    from data_accelerator_tpu_torch.analysis import confcheck, protocheck, racecheck

    race = racecheck.analyze_modules(racecheck.engine_module_paths())
    proto = protocheck.analyze_proto_modules(protocheck.proto_module_paths())
    conf = confcheck.analyze_conf_modules(confcheck.conf_module_paths())
    out = {"race": {**race.race_dict(), "diagnostics": len(race.diagnostics)},
           "protocol": {**proto.protocol_dict(), "diagnostics": len(proto.diagnostics)},
           "conf": {**conf.conf_dict(), "diagnostics": len(conf.diagnostics)}}
    for gate in out.values():
        gate.pop("modules", None)
    if race.diagnostics or proto.diagnostics or conf.diagnostics:
        raise AssertionError(f"plan gates: {[d.render() for d in race.diagnostics]} "
                             f"{[d.render() for d in proto.diagnostics]} "
                             f"{[d.render() for d in conf.diagnostics]}")
    return out


def plan_compile(proc_conf: dict) -> dict:
    """``--compile`` on the main flow's gui JSON at ``CAPACITY`` rows: its
    manifest's transfer entries are the slots a card processor booted
    from it warms, and a host booted from it (``runtime.host.main``,
    local simulated input, ``CLI_BATCHES`` batches) reports no
    ``Compile_WarmMiss_Count``."""
    import tempfile

    from data_accelerator_tpu_torch.analysis.compilecheck import warmed_entries
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime import host as host_mod
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        flow, man = Path(tmp) / "main_flow.json", Path(tmp) / "manifest.json"
        flow.write_text(json.dumps(main_flow_gui()))
        rc, out, err = run_analysis_cli(["--compile", f"--manifest-out={man}", "--json",
                                         str(flow)])
        if rc != 0:
            raise AssertionError(f"plan compile: exit {rc}: {err[-500:]}")
        manifest = json.loads(man.read_text())
        helpers = sorted({(e["entry"].split(":")[1], e["static"]["cap"])
                          for e in manifest["entries"] if e["entry"] != "step"})
        proc = FlowProcessor(SettingDictionary(dict(
            proc_conf, **{"datax.job.process.compile.manifest": str(man)})))
        warmed = warmed_entries(proc)
        cold_ms = proc._drain_compile_stats().get("ColdStart_Ms")
        del proc
        conf = flow_conf()
        conf.update({
            "datax.job.name": CLI_FLOW + "Manifest",
            "datax.job.input.default.eventhub.maxrate": str(CAPACITY),
            "datax.job.process.batchcapacity": str(CAPACITY),
            "datax.job.process.jar.udf.anomalyscore.class":
                "data_accelerator_tpu_torch.udf.samples:anomalyscore",
            "datax.job.process.compile.manifest": str(man),
        })
        for o in OUTPUTS:
            conf[f"datax.job.output.{o}.console.maxrows"] = "0"
        path = Path(tmp) / "flow.conf"
        write_conf_file(path, conf)
        with contextlib.redirect_stdout(LineCount()):
            host = host_mod.main([f"conf={path}", f"batches={CLI_BATCHES}"])
        store = host.metric_logger.store
        key = f"DATAX-{CLI_FLOW}Manifest:"
        miss = [float(p["val"]) for p in store.points(key + "Compile_WarmMiss_Count")] \
            if key + "Compile_WarmMiss_Count" in store.keys(key) else []
        booted = {"batches": host.batches_processed, "warmed": host.processor._aot_warmed,
                  "compile_warm_miss_count": sum(miss)}
        host.stop()
        del host
    out = {"entries": len(manifest["entries"]), "helpers": len(helpers),
           "buckets": sorted({c for _o, c in helpers}),
           "digest_backend": manifest.get("digestBackend"),
           "warmed_slots": len(warmed), "manifest_equals_warm": helpers == warmed,
           "processor_cold_start_ms": cold_ms, "host": booted,
           "seconds": time.perf_counter() - t0}
    if helpers != warmed or booted["compile_warm_miss_count"] or not booted["warmed"] \
            or booted["batches"] != CLI_BATCHES:
        raise AssertionError(f"plan compile: {out} manifest {helpers} warm {warmed}")
    return out


def plan_fleet() -> dict:
    """The fleet tier over the main, storm and state flows' card
    processors (each footprint the port's plan of that processor) on a
    one-card spec with the card's memory: all three place, no error."""
    import tempfile

    from data_accelerator_tpu_torch.analysis.deviceplan import analyze_processor
    from data_accelerator_tpu_torch.analysis.fleetcheck import (
        FleetSpec, FlowFootprint, analyze_fleet)
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    spec = FleetSpec(chips=1, device="cuda")
    footprints = []
    with tempfile.TemporaryDirectory() as tmp:
        homes = str(Path(tmp) / "homes.csv")
        write_homes_csv(homes)
        confs = {"main": plan_conf(), "storm": storm_conf(tmp, homes_csv=homes),
                 "state": state_conf(str(Path(tmp) / "state"))}
        for name, conf in confs.items():
            proc = FlowProcessor(SettingDictionary(conf))
            t = analyze_processor(proc).totals()
            footprints.append(FlowFootprint(
                name=name, hbm_bytes=int(t["hbmBytes"]),
                persistent_bytes=int(t["persistentBytes"]),
                per_batch_bytes=int(t["perBatchBytes"]), flops=float(t["flops"]),
                d2h_bytes_per_batch=int(t["d2hBytesPerBatch"])))
            del proc
            gc.collect()
    report = analyze_fleet(footprints, spec)
    out = {"spec": spec.to_dict(), "placement": report.placement.to_dict(spec),
           "diagnostics": [d.render() for d in report.diagnostics],
           "footprints": {fp.name: fp.hbm_bytes for fp in footprints}}
    if not report.ok or not report.placement.feasible:
        raise AssertionError(f"plan fleet: {out}")
    return out


def phase_plan(seed: int, nvidia_smi: str) -> dict:
    """The device plan of the main flow's card processor
    (``analyze_processor``) against what the card holds.

    - ``persistentBytes`` with one transfer slot per output (what a
      processor holds after its first step: the A/B rotation has
      staged slot A only) prices ``device_bytes()`` and the allocator's
      growth from before the processor to after its first step: both
      within ``PLAN_RESIDENT_BAND``.
    - ``hbmBytes`` (the rings, two slots, the input batch and every
      table the step makes, all at once) prices the allocator's peak
      growth from before the processor to the end of its first step,
      within ``PLAN_PEAK_BAND``: the step's sort, gather and compaction
      intermediates are not in the model, and slot B does not exist
      yet, so the ratio may fall either side of 1.
    - The latency model under the card's calibrated profile, beside the
      measured steady step.
    - The CLI ``--device --udfs --json`` on the main flow's gui JSON
      exits 0 with no diagnostic.
    - ``lq_cache`` again: each entry priced by the plan, within
      ``lq/warmcache.MODEL_BAND`` of the allocator's growth.

    Returns each kernel's launches on the path."""
    import tempfile

    from data_accelerator_tpu_torch.analysis.deviceplan import analyze_processor
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.lq.warmcache import MODEL_BAND
    from data_accelerator_tpu_torch.obs import calibrate
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    rs = np.random.RandomState(seed + 3)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    proc = FlowProcessor(SettingDictionary(plan_conf()))
    report = analyze_processor(proc)
    one_slot = analyze_processor(proc, output_slots=1).totals()
    totals = report.totals()
    if not report.ok or report.diagnostics:
        raise AssertionError(f"plan: {[d.render() for d in report.diagnostics]}")
    type_ids = np.array([proc.dictionary.encode(t) for t in DEVICE_TYPES], np.int32)
    batches = [make_columns(rs, type_ids, CAPACITY) for _ in range(4)]
    # the first step from the processor's build on: its one input batch,
    # the rings and every table the step makes are in the peak
    proc.dispatch_batch(proc.encode_columns(batches[0], CAPACITY), BASE_MS).collect_tables()
    torch.cuda.synchronize()
    peak_growth = torch.cuda.max_memory_allocated() - mem0
    growth = torch.cuda.memory_allocated() - mem0
    held = proc.device_bytes()
    # the step as the latency model prices it: dispatch to the counts on
    # the host (materializing the rows after it is the landing's work)
    step_ms = []
    for b, cols in enumerate(batches[1:], start=1):
        raw = proc.encode_columns(cols, CAPACITY)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handle = proc.dispatch_batch(raw, BASE_MS + 1000 * b)
        handle.collect_counts()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        handle.collect_tables()
        del handle
    launches = process_launches()
    profile = calibrate.get_profile(device="cuda")
    latency = report.latency_model(profile.to_dict(), "calibrated")
    # the step's launches on meta against one profiled step's device
    # activities (kernels and copies)
    prof_step = profile_step(proc, proc.encode_columns(batches[1], CAPACITY),
                             BASE_MS + 1000 * len(batches))
    launch.reset_launches()
    compile_gate = plan_compile(proc_conf=plan_conf())
    ratios = {
        "persistent_1slot_over_device_bytes": one_slot["persistentBytes"] / held,
        "persistent_1slot_over_growth": one_slot["persistentBytes"] / growth,
        "hbm_over_peak_growth": totals["hbmBytes"] / peak_growth,
    }
    del proc, raw
    gates = plan_gates()
    fleet = plan_fleet()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "main_flow.json"
        path.write_text(json.dumps(main_flow_gui()))
        rc, out, err = run_analysis_cli(["--device", "--udfs", "--json", str(path)])
    cli = json.loads(out) if out else {}
    gc.disable()
    try:
        cache = lq_cache(rows=(LQ_SMALL_ROWS,) + LQ_CACHE_ROWS)
    finally:
        gc.enable()
    step_pred = latency["totals"]["deviceStepMs"]
    step_med = statistics.median(step_ms)
    line = {
        "phase": "plan", "seconds": time.perf_counter() - t0,
        "capacity": CAPACITY, "stages": len(report.stages),
        "hbmBytes": totals["hbmBytes"], "persistentBytes": totals["persistentBytes"],
        "perBatchBytes": totals["perBatchBytes"], "flops": totals["flops"],
        "d2hBytesPerBatch": totals["d2hBytesPerBatch"],
        "persistentBytes_one_slot": one_slot["persistentBytes"],
        "device_bytes_after_first_step": held,
        "allocated_growth_after_first_step": growth,
        "allocated_peak_growth_first_step": peak_growth,
        "ratios": ratios,
        "bands": {"resident": list(PLAN_RESIDENT_BAND), "peak": list(PLAN_PEAK_BAND),
                  "lq_cache": list(MODEL_BAND)},
        "latency_model": latency["totals"], "profile_source": latency["profileSource"],
        "measured_step_ms": step_ms,
        "launches_per_step": report.launches_per_step,
        "profiled_step": prof_step,
        "device_step_ms_priced": step_pred,
        "device_step_measured_over_priced": step_med / step_pred,
        "device_step_over_floor": step_pred >= STAGE_TIME_FLOOR_MS,
        "device_step_within_band": step_med / step_pred <= STAGE_TIME_RATIO_HIGH,
        "gates": gates, "compile": compile_gate, "fleet": fleet,
        "cli": {"exit": rc, "diagnostics": cli.get("diagnostics"),
                "stages": len((cli.get("device") or {}).get("stages") or []),
                "stderr": err[-300:]},
        "lq_cache": [{k: e[k] for k in ("row_bucket", "model_bytes", "allocated_growth",
                                        "model_over_growth", "sized_by")}
                     for e in cache["entries"]],
        "launches": launches, "card": nvidia_smi,
    }
    emit(line)
    lo, hi = PLAN_RESIDENT_BAND
    if not (lo <= ratios["persistent_1slot_over_device_bytes"] <= hi
            and lo <= ratios["persistent_1slot_over_growth"] <= hi):
        raise AssertionError(f"plan: resident model outside {PLAN_RESIDENT_BAND}: {ratios}")
    if not PLAN_PEAK_BAND[0] <= ratios["hbm_over_peak_growth"] <= PLAN_PEAK_BAND[1]:
        raise AssertionError(f"plan: hbmBytes / peak outside {PLAN_PEAK_BAND}: {ratios}")
    if rc != 0 or cli.get("diagnostics") != [] or not line["cli"]["stages"]:
        raise AssertionError(f"plan: analysis CLI exit {rc}: {line['cli']}")
    if any(not MODEL_BAND[0] <= e["model_over_growth"] <= MODEL_BAND[1]
           for e in cache["entries"]):
        raise AssertionError(f"plan: lq_cache outside {MODEL_BAND}: {line['lq_cache']}")
    if launches["anomaly_score"] != len(batches) or launches["dx305_double"]:
        raise AssertionError(f"plan launches: {launches}")
    if step_pred < STAGE_TIME_FLOOR_MS:
        raise AssertionError(f"plan: launch-priced deviceStepMs {step_pred} under the "
                             f"{STAGE_TIME_FLOOR_MS} ms floor")
    return launches


def phase_ground_truth() -> None:
    """Each bad twin of the host-sync fixtures (DX300, DX301, DX305)
    raises on CUDA tensors under sync debug mode "error", at the sync
    the analyzer flags; each clean twin runs there and gives its CPU
    result."""
    from tests.data.udfs_torch import dx300_branch, dx301_hostsync, dx305_cuda

    x_cpu = torch.arange(1.0, 9.0)
    x = x_cpu.to("cuda")
    raised = {}
    for code, mod in (("DX300", dx300_branch), ("DX301", dx301_hostsync),
                      ("DX305", dx305_cuda)):
        bad, clean = mod.bad(), mod.clean()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            try:
                bad.fn(x)
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                raised[code] = str(e)[:120]
            out = clean.fn(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if code not in raised:
            raise AssertionError(
                f"{code} bad twin ran under sync debug mode 'error'"
            )
        if not torch.equal(out.cpu(), clean.fn(x_cpu)):
            raise AssertionError(f"{code} clean twin: card and CPU disagree")
    emit({"phase": "ground_truth", "bad_raised": raised, "clean_ran": True})


def phase_profile(proc, cols, batch_time_ms) -> None:
    """One more batch on the card under ``torch.profiler``: device busy
    time (kernels and copies, which run on one stream and do not
    overlap) against the step's wall time, and the kernels that took
    the most device time. Runs after the main path's launches were
    read, so it does not count towards them."""
    from torch.profiler import ProfilerActivity, profile

    raw = proc.encode_columns(cols, CAPACITY)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proc.dispatch_batch(raw, batch_time_ms).collect_counts()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # aten:: rows repeat the device time of the kernels they launched
    device_rows = [
        e for e in prof.key_averages()
        if not e.key.startswith("aten::") and device_us(e) > 0
    ]
    busy_ms = sum(device_us(e) for e in device_rows) / 1e3
    top = sorted(device_rows, key=device_us, reverse=True)[:8]
    emit({
        "phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_activities": sum(e.count for e in device_rows),
        "top": [[e.key[:100], device_us(e) / 1e3, e.count] for e in top],
    })


# -- chaos drills: the JAX package's serve/scenarios.py chaos_* drills,
# run against the port's StreamingHost. A ChaosFlow says what the host
# runs and how a drill's event rows become bytes; the drills are the
# reference's steps with every count a multiple of the flow's poll size.
CHAOS_FAULTS = ("preemption", "sink-outage", "hot-key-skew", "malformed-flood",
                "rescale-state")
CHAOS_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
    {"name": "seq", "type": "long", "nullable": False, "metadata": {}},
]})
CHAOS_TRANSFORM = (
    "--DataXQuery--\n"
    "Out = SELECT k, v, seq FROM DataXProcessedInput\n"
    "--DataXQuery--\n"
    "Hot = SELECT k, COUNT(*) AS c FROM DataXProcessedInput GROUP BY k\n"
)
CHAOS_STATE_TRANSFORM = (
    "--DataXQuery--\n"
    "merged = SELECT k, v FROM DataXProcessedInput "
    "UNION ALL SELECT k, v FROM seen\n"
    "--DataXQuery--\n"
    "seen = SELECT k, MAX(v) AS v FROM merged GROUP BY k\n"
    "--DataXQuery--\n"
    "Out = SELECT k, v, seq FROM DataXProcessedInput\n"
    "--DataXQuery--\n"
    "Win = SELECT k, COUNT(*) AS c "
    "FROM DataXProcessedInput_30seconds GROUP BY k\n"
)
CHAOS_STATE_KEYS = 8
CHAOS_STATE_PARTS = 8
# the card's drill flow: the main path (the alerting flow plus the
# anomaly query) with an event id, and a witness output that carries it
CHAOS_IOT_SCHEMA = json.dumps({
    "type": "struct",
    "fields": json.loads(IOT_SCHEMA)["fields"] + [
        {"name": "seq", "type": "long", "nullable": False, "metadata": {}}],
})
CHAOS_MAIN_TRANSFORM = TRANSFORM + (
    "--DataXQuery--\n"
    "Out = SELECT deviceDetails.deviceId AS k, seq FROM DataXProcessedInput\n"
)
CHAOS_MAIN_OUTPUTS = OUTPUTS + ["Out"]


@dataclass
class ChaosFlow:
    """What a drill's host runs. ``poll``: events a poll takes (the
    reference's drills take 4); ``outputs``: every output, each given a
    recording sink (``Out`` is the exactly-once witness); ``line``: one
    event row ``{"k", "v", "seq"}`` as a JSON line; ``udfs``: the UDF
    objects a host takes; ``device``: where the host runs."""

    poll: int
    capacity: int
    schema: str
    transform: str
    outputs: list
    line: object = None
    udfs: object = None
    device: str = "cuda"
    extra: dict = None
    # polls' worth of events a drill feeds, by fault, where it feeds
    # fewer than the reference's drill
    polls: dict = None

    def events(self, fault: str, polls: int) -> int:
        """The events drill ``fault`` feeds: ``polls`` polls' worth (the
        reference's count) unless the flow cuts it."""
        return (self.polls or {}).get(fault, polls) * self.poll

    def payload(self, rows) -> bytes:
        line = self.line or (lambda r: json.dumps(r))
        return "".join(line(r) + "\n" for r in rows).encode()


def chaos_small_flow(device: str = "cpu") -> ChaosFlow:
    """The reference drills' own flow and sizes."""
    return ChaosFlow(poll=4, capacity=8, schema=CHAOS_SCHEMA,
                     transform=CHAOS_TRANSFORM, outputs=["Out", "Hot"],
                     device=device)


def iot_chaos_line(r) -> str:
    """A drill row as a main-path IoT event: key ``k`` as the device,
    the type, status and temperature from ``seq`` and ``v``."""
    i = int(r["seq"])
    return ('{"deviceDetails":{"deviceId":%d,"deviceType":"%s","homeId":150,'
            '"status":%d,"temperature":%.3f},"seq":%d}'
            % (int(r["k"]) + 1, DEVICE_TYPES[i % 3], (i // 3) % 2,
               float(r["v"]) % 100.0, i))


# the card's drills, cut to fit the smoke's time: preemption still dies at
# its third dispatch, the skew still outlasts the pilot's
# evaluation window
CARD_CHAOS_POLLS = {"preemption": 5, "hot-key-skew": 4,
                    "malformed-flood": 2}


def chaos_main_flow(poll: int = CAPACITY, device: str = "cuda", udf=None,
                    polls: dict = None) -> ChaosFlow:
    """The main path as a drill flow, ``poll`` events a batch."""
    return ChaosFlow(
        poll=poll, capacity=poll, schema=CHAOS_IOT_SCHEMA, polls=polls,
        transform=CHAOS_MAIN_TRANSFORM, outputs=list(CHAOS_MAIN_OUTPUTS),
        line=iot_chaos_line, udfs={"anomalyscore": udf} if udf else None,
        device=device, extra={
            "datax.job.process.timestampcolumn": "eventTimeStamp",
            "datax.job.process.watermark": "0 second",
            "datax.job.process.timewindow.DataXProcessedInput_5seconds"
            ".windowduration": "5 seconds",
            "datax.job.process.projection": (
                "current_timestamp() AS eventTimeStamp\nRaw.*"),
        })


def chaos_state_flow(poll: int = 4, device: str = "cpu") -> ChaosFlow:
    """The rescale drill's stateful flow: a 30 s window ring and the
    ``seen`` MAX accumulator on key-range partitions."""
    return ChaosFlow(poll=poll, capacity=2 * poll, schema=CHAOS_SCHEMA,
                     transform=CHAOS_STATE_TRANSFORM, outputs=["Out", "Win"],
                     device=device)


def chaos_events(lo: int, hi: int, keys: int = 4) -> list:
    return [{"k": i % keys, "v": float(i), "seq": i} for i in range(lo, hi)]


def _chaos_pilot_conf(conf: dict, pilot: bool, pilot_conf) -> None:
    if pilot:
        # tight loop knobs so evaluation windows elapse inside a drill
        conf.update({
            "datax.job.process.pilot.windowseconds": "0.02",
            "datax.job.process.pilot.cooldownseconds": "0.02",
            "datax.job.process.observability.stallewmams": "200",
        })
        for k, v in (pilot_conf or {}).items():
            conf[f"datax.job.process.pilot.{k}"] = str(v)
    else:
        conf["datax.job.process.pilot.enabled"] = "false"


def _chaos_host(ctx, conf: dict, flow: ChaosFlow, src=None):
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.pilot.chaos import RecordingSink
    from data_accelerator_tpu_torch.runtime.host import StreamingHost
    from data_accelerator_tpu_torch.runtime.sources import SocketSource

    src = src if src is not None else SocketSource(port=0)
    host = StreamingHost(SettingDictionary(conf), source=src, udfs=flow.udfs,
                         device=flow.device)
    sinks = {}
    for out in flow.outputs:
        sinks[out] = RecordingSink()
        host.dispatcher.operators[out].sinks = [sinks[out]]
    ctx["host"], ctx["src"], ctx["sink"] = host, src, sinks["Out"]
    ctx.setdefault("sinks", []).append(sinks["Out"])
    ctx.setdefault("all_sinks", []).append(sinks)
    ctx.setdefault("hosts", []).append(host)
    ctx["tracefile"] = conf["datax.job.process.telemetry.tracefile"]
    return host


def build_chaos_host(ctx, name: str, pilot: bool, depth: int, flow: ChaosFlow,
                     pilot_conf=None, reuse_source: bool = False):
    """``serve/scenarios.py::_build_chaos_host`` for the port: one
    socket-fed host with a recording sink on every output, the buffer
    sanitizer and the protocol monitor armed."""
    workdir = ctx["workdir"]
    tpath = os.path.join(workdir, "chaos.transform")
    if not os.path.exists(tpath):
        with open(tpath, "w", encoding="utf-8") as f:
            f.write(flow.transform)
    conf = {
        "datax.job.name": name,
        "datax.job.input.default.blobschemafile": flow.schema,
        "datax.job.input.default.eventhub.maxrate": str(flow.poll),
        "datax.job.input.default.eventhub.checkpointdir": os.path.join(workdir, "ckpt"),
        "datax.job.input.default.eventhub.checkpointinterval": "0 second",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.transform": tpath,
        "datax.job.process.batchcapacity": str(flow.capacity),
        "datax.job.process.pipeline.depth": str(depth),
        "datax.job.process.debug.buffersanitizer": "true",
        "datax.job.process.debug.protocolmonitor": "true",
        "datax.job.process.telemetry.tracefile": os.path.join(workdir, "trace.jsonl"),
        **{f"datax.job.output.{o}.console.maxrows": "0" for o in flow.outputs},
        **(flow.extra or {}),
    }
    _chaos_pilot_conf(conf, pilot, pilot_conf)
    src = ctx["src"] if reuse_source and ctx.get("src") is not None else None
    return _chaos_host(ctx, conf, flow, src)


def build_stateful_host(ctx, name: str, pilot: bool, depth: int, flow: ChaosFlow,
                        replica_index: int = 1, replica_count: int = 1, gen: int = 0,
                        pilot_conf=None):
    """``serve/scenarios.py::_build_stateful_host`` for the port: the
    accumulator flow on ``CHAOS_STATE_PARTS`` partitions mirrored through
    the drill's object store, fleet frames every batch; ``gen`` gives
    each host instance its own directories."""
    workdir = ctx["workdir"]
    tpath = os.path.join(workdir, "state.transform")
    if not os.path.exists(tpath):
        with open(tpath, "w", encoding="utf-8") as f:
            f.write(flow.transform)
    hostdir = os.path.join(workdir, f"g{gen}-r{replica_index}")
    conf = {
        "datax.job.name": name,
        "datax.job.input.default.blobschemafile": flow.schema,
        "datax.job.input.default.eventhub.maxrate": str(flow.poll),
        "datax.job.input.default.eventhub.checkpointdir": os.path.join(hostdir, "ckpt"),
        "datax.job.input.default.eventhub.checkpointinterval": "0 second",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.timestampcolumn": "ts",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.transform": tpath,
        "datax.job.process.batchcapacity": str(flow.capacity),
        "datax.job.process.pipeline.depth": str(depth),
        "datax.job.process.timewindow.DataXProcessedInput_30seconds"
        ".windowduration": "30 seconds",
        "datax.job.process.statetable.seen.schema": "k long, v double",
        "datax.job.process.statetable.seen.location": os.path.join(hostdir, "state", "seen"),
        "datax.job.process.state.partitions": str(CHAOS_STATE_PARTS),
        "datax.job.process.state.partitionkey": "k",
        "datax.job.process.state.replicaindex": str(replica_index),
        "datax.job.process.state.replicacount": str(replica_count),
        "datax.job.process.state.snapshoturl": ctx["store_url"],
        "datax.job.process.state.filteringest": "true",
        "datax.job.process.fleet.publishurl": ctx["store_url"],
        "datax.job.process.fleet.windowseconds": "0",
        "datax.job.process.fleet.replica": f"g{gen}-r{replica_index}",
        "datax.job.process.debug.buffersanitizer": "true",
        "datax.job.process.debug.protocolmonitor": "true",
        "datax.job.process.telemetry.tracefile": os.path.join(workdir, "trace.jsonl"),
        "datax.job.output.Out.console.maxrows": "0",
        "datax.job.output.Win.console.maxrows": "0",
    }
    _chaos_pilot_conf(conf, pilot, pilot_conf)
    return _chaos_host(ctx, conf, flow)


def chaos_delivered(ctx) -> list:
    return [seq for sink in ctx.get("sinks", []) for seq in sink.values("seq")]


def chaos_rows(ctx, output: str = "Out") -> list:
    """Every row the drill's hosts delivered to ``output``, in order."""
    return [r for sinks in ctx.get("all_sinks", []) if output in sinks
            for _t, rows in sinks[output].batches for r in rows]


def _assert_exactly_once(ctx, n: int) -> None:
    seqs = chaos_delivered(ctx)
    if sorted(seqs) != list(range(n)):
        raise AssertionError(
            f"exactly-once violated: {len(seqs)} deliveries of {n} events; "
            f"dupes/losses over {sorted(set(range(n)) ^ set(seqs))[:10]}")


def _assert_pilot_reacted(ctx, action: str, host=None) -> None:
    """The expected actuation fired, ``Pilot_Actuations_Count`` is
    positive and a ``pilot/decide`` span records it."""
    host = host if host is not None else ctx["host"]
    if host.pilot is None:
        raise AssertionError("pilot not armed")
    applied = [d for d in ctx.get("applied_decisions", [])
               if d.applied and d.action == action]
    if not applied:
        raise AssertionError(
            f"no applied {action!r} actuation; decisions="
            f"{[(d.rule, d.action, d.suppressed) for d in ctx.get('applied_decisions', [])]}")
    pts = host.metric_logger.store.points(host.metric_logger.key("Pilot_Actuations_Count"))
    if not pts or float(pts[-1]["val"]) <= 0:
        raise AssertionError("Pilot_Actuations_Count not > 0")
    with open(ctx["tracefile"], encoding="utf-8") as f:
        spans = [json.loads(ln) for ln in f if '"pilot/decide"' in ln]
    if not any(s.get("type") == "span" and s["properties"].get("applied")
               and s["properties"].get("action") == action for s in spans):
        raise AssertionError(f"no applied pilot/decide span for {action!r}")
    ctx.setdefault("actuations", []).append(action)


def _record_decisions(ctx, host):
    collected = ctx.setdefault("applied_decisions", [])
    pilot = host.pilot
    if pilot is None:
        return None
    orig = pilot.evaluate

    def evaluate(*a, **k):
        ds = orig(*a, **k)
        collected.extend(ds)
        return ds

    pilot.evaluate = evaluate
    return orig


def chaos_drain(ctx, host, expect_total: int, chunk: int = 4, timeout_s: float = 60.0):
    """``serve/scenarios.py::_drain``: run the pipelined loop in chunks
    until every expected event has landed, recording every pilot
    decision; evaluate once directly if no window elapsed."""
    orig = _record_decisions(ctx, host)
    try:
        deadline = time.time() + timeout_s
        while len(chaos_delivered(ctx)) < expect_total:
            host.run_pipelined(max_batches=host.batches_processed + chunk)
            if time.time() > deadline:
                raise AssertionError(f"drain timed out: {len(chaos_delivered(ctx))}/"
                                     f"{expect_total} delivered")
        if orig is not None and not any(d.applied for d in ctx["applied_decisions"]):
            host.pilot.evaluate()
    finally:
        if orig is not None:
            host.pilot.evaluate = orig


def _feed(ctx, payload: bytes, n_lines: int, src=None) -> None:
    from data_accelerator_tpu_torch.pilot.chaos import feed_socket

    feed_socket(src if src is not None else ctx["src"], payload,
                expect_events=n_lines, timeout_s=max(5.0, n_lines / 2e5))


def drill_preemption(ctx, pilot, depth, flow):
    from data_accelerator_tpu_torch.pilot.chaos import (
        ChaosFault, PreemptionInjector, RecordingRescaler)
    from data_accelerator_tpu_torch.pilot.controller import ScaleActuator

    n = flow.events("preemption", 8)
    name = "ChaosPreemptP" if pilot else "ChaosPreemptB"
    pconf = {"maxdepth": depth, "saturationhigh": "0.5"}
    build_chaos_host(ctx, name, pilot, depth, flow, pilot_conf=pconf)
    ctx["event_rows"] = chaos_events(0, n)
    _feed(ctx, flow.payload(ctx["event_rows"]), n)
    inj = PreemptionInjector(kill_at_dispatch=3)
    inj.arm(ctx["host"])
    try:
        ctx["host"].run_pipelined(max_batches=n // flow.poll)
    except ChaosFault:
        ctx["preempted"] = True
    finally:
        inj.disarm()
        ctx["host"].stop(close_sources=False)
    if not ctx.get("preempted"):
        raise AssertionError("injector never fired")
    ctx["src"].requeue_unacked()
    host = build_chaos_host(ctx, name, pilot, depth, flow, pilot_conf=pconf,
                            reuse_source=True)
    if pilot and host.pilot is not None:
        scaler = ctx["scaler"] = RecordingRescaler()
        act = ScaleActuator(scaler, "ChaosPreempt", max_replicas=4)
        for kind in act.kinds:
            host.pilot.actuators[kind] = act
    chaos_drain(ctx, host, n)
    host.stop()
    _assert_exactly_once(ctx, n)
    if pilot:
        _assert_pilot_reacted(ctx, "rescale-up")
        if not (ctx["scaler"].calls and ctx["scaler"].calls[0] >= 2):
            raise AssertionError(f"rescaler calls {ctx['scaler'].calls}")
    return n


def drill_sink_outage(ctx, pilot, depth, flow):
    from data_accelerator_tpu_torch.pilot.chaos import ChaosFault, SinkOutageInjector

    n = flow.events("sink-outage", 6)
    build_chaos_host(ctx, "ChaosSinkP" if pilot else "ChaosSinkB", pilot, depth, flow,
                     pilot_conf={"backloghigh": "2"})
    ctx["event_rows"] = chaos_events(0, n)
    _feed(ctx, flow.payload(ctx["event_rows"]), n)
    inj = SinkOutageInjector(fail=True)
    inj.arm(ctx["host"])
    try:
        ctx["host"].run_pipelined(max_batches=n // flow.poll)
    except ChaosFault:
        ctx["outage_hit"] = True
    finally:
        inj.disarm()
    if not ctx.get("outage_hit"):
        raise AssertionError("outage never hit a write")
    ctx["src"].requeue_unacked()
    inj = SinkOutageInjector(delay_s=0.08)
    inj.arm(ctx["host"])
    try:
        chaos_drain(ctx, ctx["host"], n)
    finally:
        inj.disarm()
        ctx["host"].stop()
    _assert_exactly_once(ctx, n)
    if pilot:
        _assert_pilot_reacted(ctx, "backpressure")
    return n


def drill_hot_key_skew(ctx, pilot, depth, flow):
    from data_accelerator_tpu_torch.pilot.chaos import DeviceSlowdownInjector, skewed_events

    n = flow.events("hot-key-skew", 8)
    build_chaos_host(ctx, "ChaosSkewP" if pilot else "ChaosSkewB", pilot, depth, flow,
                     pilot_conf={"stallhighms": "20"})
    ctx["event_rows"] = skewed_events(n, hot_key=0, hot_fraction=0.9)
    _feed(ctx, flow.payload(ctx["event_rows"]), n)
    inj = DeviceSlowdownInjector(extra_s=0.06)
    inj.arm(ctx["host"])
    try:
        chaos_drain(ctx, ctx["host"], n)
    finally:
        inj.disarm()
        ctx["host"].stop()
    _assert_exactly_once(ctx, n)
    if pilot:
        _assert_pilot_reacted(ctx, "depth-down")
        if ctx["host"].live_depth() >= depth:
            raise AssertionError(f"depth still {ctx['host'].live_depth()}")
    return n


def drill_malformed_flood(ctx, pilot, depth, flow):
    from data_accelerator_tpu_torch.pilot.chaos import malformed_payload

    n = flow.events("malformed-flood", 4)
    build_chaos_host(ctx, "ChaosFloodP" if pilot else "ChaosFloodB", pilot, depth, flow,
                     pilot_conf={"malformedhigh": "0.3"})
    ctx["event_rows"] = chaos_events(0, n)
    payload = malformed_payload(ctx["event_rows"], flood_ratio=0.5)
    if flow.line is not None:  # the same garbage lines around the flow's events
        payload = b"\n".join(
            flow.line(json.loads(ln)).encode() if ln.startswith(b'{"k": ') and
            ln.endswith(b"}") else ln for ln in payload.split(b"\n")[:-1]) + b"\n"
    _feed(ctx, payload, payload.count(b"\n"))
    chaos_drain(ctx, ctx["host"], n)
    ctx["host"].stop()
    _assert_exactly_once(ctx, n)
    if pilot:
        _assert_pilot_reacted(ctx, "backpressure")
    return n


def _drain_remaining_payload(src) -> bytes:
    src.requeue_unacked()
    chunks = []
    while True:
        blob, n, _offsets = src.poll_raw(1 << 20)
        if n == 0:
            break
        chunks.append(blob)
    src.close()
    return b"".join(chunks)


def _drain_group(ctx, hosts, expect_total: int, chunk: int = 2, timeout_s: float = 120.0):
    deadline = time.time() + timeout_s
    while len(chaos_delivered(ctx)) < expect_total:
        for h in hosts:
            h.run_pipelined(max_batches=h.batches_processed + chunk)
        if time.time() > deadline:
            raise AssertionError(f"group drain timed out: {len(chaos_delivered(ctx))}/"
                                 f"{expect_total} delivered")


def _loaded_state_map(host) -> dict:
    t = host.processor.state_tables["seen"].load(host.processor.dictionary)
    cols = {c: np.asarray(v.cpu()) for c, v in t.cols.items()}
    return {int(k): float(v) for k, v, ok in zip(cols["k"], cols["v"],
                                                 np.asarray(t.valid.cpu())) if ok}


def _state_max(hi: int) -> dict:
    """Each key's MAX(v) over events 0..hi-1 (``v`` is the event id)."""
    return {k: float(max(i for i in range(hi) if i % CHAOS_STATE_KEYS == k))
            for k in range(CHAOS_STATE_KEYS)}


def drill_rescale_state(ctx, pilot, depth, flow):
    """``serve/scenarios.py::chaos_rescale_with_state``: a stateful host
    rescaled mid-window to two replicas with every active state snapshot
    corrupted in the store, then back to one, then a generation killed
    without a drain; the lineage delivers every event once and the
    fleet view conserves it."""
    from data_accelerator_tpu_torch.obs.fleetview import FleetView
    from data_accelerator_tpu_torch.pilot.chaos import (
        PartitionLossInjector, RecordingRescaler)
    from data_accelerator_tpu_torch.pilot.controller import ScaleActuator
    from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreServer

    b = flow.poll
    n_pre, n_tail, n_kill = 6 * b, 2 * b, b
    name = "RescaleStateP" if pilot else "RescaleStateB"
    store = ObjectStoreServer(port=0).start()
    try:
        ctx["store_url"] = (f"objstore://127.0.0.1:{store.port}/chaos/"
                            f"rescale-{'p' if pilot else 'b'}-d{depth}")
        pre = build_stateful_host(ctx, name, pilot, depth, flow, gen=0,
                                  pilot_conf={"maxdepth": depth, "saturationhigh": "0.5"})
        _feed(ctx, flow.payload(chaos_events(0, n_pre, CHAOS_STATE_KEYS)), n_pre)
        orig = None
        if pilot and pre.pilot is not None:
            scaler = ctx["scaler"] = RecordingRescaler()
            act = ScaleActuator(scaler, "RescaleState", max_replicas=4)
            for kind in act.kinds:
                pre.pilot.actuators[kind] = act
            orig = _record_decisions(ctx, pre)
        pre.run_pipelined(max_batches=pre.batches_processed + 3)
        if orig is not None:
            if not any(d.applied and d.action == "rescale-up"
                       for d in ctx["applied_decisions"]):
                pre.pilot.evaluate()
            pre.pilot.evaluate = orig
        pre_delivered = len(chaos_delivered(ctx))
        if not 0 < pre_delivered < n_pre:
            raise AssertionError(f"predecessor delivered {pre_delivered}")
        pre.stop(close_sources=False)
        inj = PartitionLossInjector(store_url=ctx["store_url"], table="seen",
                                    mode="truncate")
        if not inj.corrupt():
            raise AssertionError("no active state snapshots to corrupt")
        payload = _drain_remaining_payload(ctx["src"])
        b1 = build_stateful_host(ctx, name, False, depth, flow, 1, 2, gen=1)
        src1 = ctx["src"]
        b2 = build_stateful_host(ctx, name, False, depth, flow, 2, 2, gen=1)
        src2 = ctx["src"]
        for h in (b1, b2):
            if h.window_restored_from != "partitions":
                raise AssertionError(f"window from {h.window_restored_from}")
        fallbacks = sum(h.processor.state_stats.get("LoadFallback_Count", 0)
                        for h in (b1, b2))
        if fallbacks < 1:
            raise AssertionError("corruption never hit the loaders")
        n_lines = payload.count(b"\n")
        if n_lines:
            _feed(ctx, payload, n_lines, src1)
            _feed(ctx, payload, n_lines, src2)
        _drain_group(ctx, [b1, b2], n_pre)
        for h in (b1, b2):
            h.stop()
        _assert_exactly_once(ctx, n_pre)
        merged = {}
        for h in (b1, b2):
            merged.update(_loaded_state_map(h))
        if merged != _state_max(n_pre):
            raise AssertionError(f"state diverged: {merged}")
        c = build_stateful_host(ctx, name, False, depth, flow, 1, 1, gen=2)
        if c.window_restored_from != "partitions":
            raise AssertionError(f"scale-down window from {c.window_restored_from}")
        _feed(ctx, flow.payload(chaos_events(n_pre, n_pre + n_tail, CHAOS_STATE_KEYS)),
              n_tail)
        _drain_group(ctx, [c], n_pre + n_tail)
        c.stop()
        _assert_exactly_once(ctx, n_pre + n_tail)
        if _loaded_state_map(c) != _state_max(n_pre + n_tail):
            raise AssertionError(f"final state diverged: {_loaded_state_map(c)}")
        d = build_stateful_host(ctx, name, False, depth, flow, 1, 1, gen=3)
        total = n_pre + n_tail + n_kill
        _feed(ctx, flow.payload(chaos_events(n_pre + n_tail, total, CHAOS_STATE_KEYS)),
              n_kill)
        _drain_group(ctx, [d], total)
        if d.fleet_publisher is None or d.fleet_publisher.frames_published < 1:
            raise AssertionError("killed replica never published a frame")
        d.fleet_publisher.kill()
        d.stop()
        view = FleetView(url=ctx["store_url"], now_fn=lambda: time.time() + 60.0)
        if view.refresh() < 5:
            raise AssertionError("fewer frames than replicas")
        reps = view.fleet_metrics(name)["replicas"]
        if set(reps) != {"g0-r1", "g1-r1", "g1-r2", "g2-r1", "g3-r1"}:
            raise AssertionError(f"lineage not continuous: {sorted(reps)}")
        audit = view.audit(name, output="Out")
        counts = audit["counts"]
        if (counts.get("DX540", 0), counts.get("DX541", 0), counts.get("DX542", 0)) \
                != (0, 0, 1) or not audit["conserved"] or audit["ingested"] != total \
                or audit["emitted"].get("Out") != total:
            raise AssertionError(f"fleet audit: {audit}")
        stale = [r for r, st in reps.items() if st["status"] == "stale"]
        if stale != ["g3-r1"]:
            raise AssertionError(f"stale replicas {stale}")
        if pilot:
            ctx["host"] = pre
            _assert_pilot_reacted(ctx, "rescale-up", host=pre)
            if not (ctx["scaler"].calls and ctx["scaler"].calls[0] >= 2):
                raise AssertionError(f"rescaler calls {ctx['scaler'].calls}")
        return total
    finally:
        store.stop()


def chaos_cpu_replay(flow: ChaosFlow, rows, outputs=None) -> dict:
    """The drill flow's ``outputs`` (default: all) for event ``rows`` on
    a CPU processor, a poll's worth a batch: the plain reference for
    every output whose rows do not depend on where batches break."""
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    conf = {"datax.job.name": "ChaosReplay",
            "datax.job.input.default.blobschemafile": flow.schema,
            "datax.job.process.transform": flow.transform,
            "datax.job.process.batchcapacity": str(flow.capacity),
            **(flow.extra or {})}
    udfs = None
    if flow.udfs:
        from data_accelerator_tpu_torch.udf.samples import anomalyscore

        udfs = {"anomalyscore": anomalyscore()}
    outputs = list(outputs or flow.outputs)
    proc = FlowProcessor(SettingDictionary(conf), output_datasets=outputs,
                         udfs=udfs, device="cpu")
    out = {o: [] for o in outputs}
    for b, lo in enumerate(range(0, len(rows), flow.poll)):
        t_ms = BASE_MS + 1000 * b
        raw = proc.encode_json_bytes(flow.payload(rows[lo:lo + flow.poll]), t_ms)
        datasets, _metrics = proc.dispatch_batch(raw, t_ms).collect()
        for o in outputs:
            out[o].extend(datasets.get(o, []))
    return out


def same_multiset(got, want, what, rtol=1e-5) -> None:
    """Equal row multisets (time columns left out): ints exactly, floats
    within ``rtol``."""
    def key(r):
        return tuple(sorted((c, v) for c, v in r.items() if c != "eventTimeStamp"))

    g, w = sorted(map(key, got)), sorted(map(key, want))
    if len(g) != len(w):
        raise AssertionError(f"{what}: {len(g)} rows against {len(w)}")
    for a, b in zip(g, w):
        for (ca, va), (cb, vb) in zip(a, b):
            if ca != cb or (va != vb and not (
                    isinstance(va, float) and abs(va - vb) <= rtol * max(abs(vb), 1e-30))):
                raise AssertionError(f"{what}: row {a} against {b}")


CHAOS_DRILLS = {
    "preemption": drill_preemption,
    "sink-outage": drill_sink_outage,
    "hot-key-skew": drill_hot_key_skew,
    "malformed-flood": drill_malformed_flood,
    "rescale-state": drill_rescale_state,
}


def run_chaos_drill(fault: str, pilot: bool, workdir: str, flow: ChaosFlow,
                    depth: int = 2) -> dict:
    """One drill on the port's host: ``fault`` at pipeline depth
    ``depth``, the pilot on or off. Raises when an event is lost or
    duplicated, a sanitizer poison hit or a protocol violation shows,
    the monitor sealed no batch, or (pilot on) the expected actuation
    did not fire. Returns the drill's context (``hosts``, ``sinks``,
    ``actuations``) with ``events`` and ``seconds``."""
    ctx = {"workdir": workdir}
    logging.disable(logging.ERROR)
    t0 = time.perf_counter()
    try:
        ctx["events"] = CHAOS_DRILLS[fault](ctx, pilot, depth, flow)
    finally:
        logging.disable(logging.NOTSET)
    ctx["seconds"] = time.perf_counter() - t0
    hits = sum(h.processor.buffer_sanitizer.poison_hits for h in ctx["hosts"])
    violations = sum(h.protocol_monitor.violations for h in ctx["hosts"])
    sealed = sum(h.protocol_monitor.batches_sealed for h in ctx["hosts"])
    if hits or violations or not sealed:
        raise AssertionError(f"{fault}: {hits} poison hits, {violations} protocol "
                             f"violations, {sealed} batches sealed")
    if pilot and not ctx.get("actuations"):
        raise AssertionError(f"{fault}: the pilot did not act")
    if not pilot and any(h.pilot is not None for h in ctx["hosts"]):
        raise AssertionError(f"{fault}: a pilot ran with the pilot off")
    ctx.update(poison_hits=hits, protocol_violations=violations, batches_sealed=sealed)
    return ctx


def phase_chaos(nvidia_smi: str, udf) -> dict:
    """The five drills, pilot off and on, against card hosts at depth 2
    with the buffer sanitizer and the protocol monitor armed: the main
    flow (the alerting flow, the anomaly query, an event-id witness) at
    ``CAPACITY`` events a poll for preemption, sink outage, hot-key skew
    and malformed flood; the accumulator flow at ``CAPACITY`` rows a
    batch for the rescale with state. Each drill prints its events/s,
    its exactly-once witness, the rows of the main flow's per-event
    outputs against a CPU run of the drill's events, poison hits,
    protocol violations, actuations and ``anomaly_score``'s launches.
    Returns each kernel's launches over all drills."""
    import tempfile

    from data_accelerator_tpu_torch.kernels import launch

    main = chaos_main_flow(poll=CAPACITY, device="cuda", udf=udf,
                           polls=CARD_CHAOS_POLLS)
    state = chaos_state_flow(poll=CAPACITY // 2, device="cuda")
    replays: dict = {}
    total = {name: 0 for name in KERNEL_NAMES}
    for fault in CHAOS_FAULTS:
        flow = state if fault == "rescale-state" else main
        for pilot in (False, True):
            reset_launch_counts(udf)
            torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                ctx = run_chaos_drill(fault, pilot, tmp, flow)
            torch.cuda.synchronize()
            launches = process_launches()
            witness = chaos_rows(ctx)
            line = {
                "phase": "chaos", "fault": fault, "pilot": pilot,
                "poll": flow.poll, "capacity": flow.capacity, "events": ctx["events"],
                "seconds": ctx["seconds"], "events_per_s": ctx["events"] / ctx["seconds"],
                "hosts": len(ctx["hosts"]),
                "exactly_once": sorted(r["seq"] for r in witness) == list(range(ctx["events"])),
                "witness_rows": len(witness),
                "poison_hits": ctx["poison_hits"],
                "protocol_violations": ctx["protocol_violations"],
                "batches_sealed": ctx["batches_sealed"],
                "actuations": ctx.get("actuations", []),
                "pilot_actuations_count": sum(h.pilot.actuations_count for h in ctx["hosts"]
                                              if h.pilot is not None),
                "launches_by_path": launches,
            }
            if flow is main:
                key = fault
                if key not in replays:
                    replays[key] = chaos_cpu_replay(main, ctx["event_rows"],
                                                    ("OpenDoors", "AnomalyAlerts"))
                rows = {}
                for out in ("OpenDoors", "AnomalyAlerts"):
                    same_multiset(chaos_rows(ctx, out), replays[key][out], f"chaos {out}")
                    rows[out] = len(replays[key][out])
                line["cpu_replay_rows"] = rows
                if launches["anomaly_score"] < 1:
                    raise AssertionError(f"chaos {fault}: no anomaly_score launch")
            line["card"] = nvidia_smi
            emit(line)
            for name, n in launches.items():
                total[name] += n
            del ctx, witness
            gc.collect()
    return total



# -- the control plane (slice 9a) ---------------------------------------------
CONTROL_FLOW = "ChipSmokeControl"
CONTROL_BATCHES = 4
CONTROL_JOB_TIMEOUT_S = 300.0
CONTROL_SAMPLE_EVENTS = 1000
CONTROL_TOKEN = "designer-token"
# the gateway's services, each forwarded to the one API process
CONTROL_SERVICES = ("flow", "interactivequery", "schemainference", "livedata")
# the host module's log lines; its logger is ``__main__`` in a process
# started with ``python -m``
HOST_BATCH_LINE = re.compile(r"(?:runtime\.host|__main__):batch (\d+): (.*)$")
HOST_START_LINE = re.compile(r"(?:runtime\.host|__main__):starting flow \S+ on (\S+) ")


def control_gui(input_type: str = "socket", capacity: int = CAPACITY) -> dict:
    """The main flow as a designer saves it for the one-box server:
    ``main_flow_gui`` with ``input_type`` in place of the local source,
    a poll a second of up to 8 x the capacity (as ``HOST_MAXRATE``), and
    the pilot off, so that every batch of a fed source is a whole
    capacity."""
    gui = main_flow_gui(capacity)
    gui["name"] = gui["displayName"] = CONTROL_FLOW
    gui["input"]["type"] = input_type
    gui["input"]["properties"].update({"windowDuration": "1",
                                       "maxRate": str(8 * capacity)})
    gui["process"]["jobconfig"]["jobPilot"] = "false"
    return gui


def relocate_job_dir(conf_path, dest) -> Path:
    """The files of a generated job directory copied to ``dest``, every
    path into the old directory pointing into ``dest``; returns the new
    conf's path. A second host on one generated conf needs this: the
    conf's checkpoint directories would let it restore the first's
    window."""
    src, dest = Path(conf_path).parent, Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    for p in sorted(src.iterdir()):
        if p.is_file():
            (dest / p.name).write_text(
                p.read_text(encoding="utf-8").replace(str(src), str(dest)),
                encoding="utf-8")
    return dest / Path(conf_path).name


def host_batch_metrics(log_text: str) -> list:
    """The metrics of each ``batch N: k=v ...`` line a host logged."""
    out = []
    for line in log_text.splitlines():
        m = HOST_BATCH_LINE.search(line)
        if m:
            out.append({k: float(v) for k, v in
                        (kv.split("=", 1) for kv in m.group(2).split())})
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def send_when_listening(port: int, payloads, deadline_s: float = 120.0) -> float:
    """Connect to ``port`` once something listens there (a spawned host's
    socket source) and write ``payloads``; returns the seconds from the
    call to the last byte written."""
    import socket

    t0 = time.perf_counter()
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            conn = socket.create_connection(("127.0.0.1", port), timeout=60)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise AssertionError(f"control: nothing listened on :{port} "
                                     f"in {deadline_s} s")
            time.sleep(0.1)
    with conn:
        for p in payloads:
            conn.sendall(p)
    return time.perf_counter() - t0


def call_json(port: int, method: str, path: str, body=None, timeout: float = 120.0):
    """One HTTP call as the SPA makes it; returns (status, JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def spa(port: int, method: str, path: str, body=None):
    """A call through the website that must succeed; returns its result."""
    status, out = call_json(port, method, path, body)
    if status != 200:
        raise AssertionError(f"control {method} {path}: {status} {out}")
    return out["result"]


def cpu_host_counts(conf_path, payloads, workdir) -> list:
    """The port's host on the CPU over the generated conf (relocated to a
    directory of its own) fed ``payloads`` from a socket, one batch
    each; returns each batch's metrics."""
    from data_accelerator_tpu_torch.core.config import SettingDictionary, parse_conf_lines
    from data_accelerator_tpu_torch.runtime.host import StreamingHost

    path = relocate_job_dir(conf_path, Path(workdir) / "cpu")
    conf = parse_conf_lines(path.read_text(encoding="utf-8").splitlines())
    conf["datax.job.input.default.socket.port"] = "0"
    host = StreamingHost(SettingDictionary(conf), device="cpu")
    per_batch = []
    send = host.metric_logger.send_batch_metrics

    def spy(metrics, ts=None):
        per_batch.append(dict(metrics))
        return send(metrics, ts)

    host.metric_logger.send_batch_metrics = spy
    src = host.sources["default"]
    feed_socket(src.port, payloads, len(payloads) * CAPACITY, src)
    try:
        host.run(max_batches=len(payloads))
    finally:
        host.stop()
    return per_batch


def control_livequery(web_port: int, flow: str, runtime, seed: int) -> dict:
    """The designer's interactive queries through the website, the
    gateway and the API on the card: the flow's sample written by
    ``inputdata/inferschema``, a ``kernel`` and ``kernel/executequery``
    of the anomaly query, an ``lq/session`` and ``lq/execute`` of it;
    each result against a CPU ``KernelService`` and ``LiveQueryService``
    with the flow's UDF on the same sample."""
    from data_accelerator_tpu_torch.lq.service import LiveQueryService
    from data_accelerator_tpu_torch.serve import livequery
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    rs = np.random.RandomState(seed + 12)
    sample = [json.loads(ln) for ln in
              make_json_payload(rs, CONTROL_SAMPLE_EVENTS).decode().splitlines()]
    query = designer_queries()["Scored"]
    out = {}
    # the sample has no timestamp column: every kernel's
    # current_timestamp() reads this clock, so their rows agree
    real_time = livequery.time
    livequery.time = types.SimpleNamespace(time=lambda: BASE_MS / 1000.0 + 0.25)
    cpu_kernels = livequery.KernelService(runtime_storage=runtime, device="cpu")
    cpu_lq = LiveQueryService(device="cpu")
    try:
        inferred = spa(web_port, "POST", "/api/schemainference/inputdata/inferschema",
                       {"name": flow, "events": sample})
        if inferred["EventsSampled"] != CONTROL_SAMPLE_EVENTS:
            raise AssertionError(f"control inferschema: {inferred['EventsSampled']}")
        t0 = time.perf_counter()
        kid = spa(web_port, "POST", "/api/interactivequery/kernel",
                  {"name": flow})["kernelId"]
        out["kernel_create_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = spa(web_port, "POST", "/api/interactivequery/kernel/executequery",
                  {"kernelId": kid, "query": query, "maxRows": CONTROL_SAMPLE_EVENTS})
        out["kernel_execute_ms"] = (time.perf_counter() - t0) * 1e3
        props = control_gui()["input"]["properties"]
        ckid = cpu_kernels.create_kernel(
            flow, props["inputSchemaFile"], normalization=props["normalizationSnippet"],
            udfs={"anomalyscore": anomalyscore()})
        want = cpu_kernels.execute(ckid, query, CONTROL_SAMPLE_EVENTS)
        same_lq_result(got, want, "control kernel/executequery")
        t0 = time.perf_counter()
        # the serving plane has no runtime store: a session takes its rows
        sid = spa(web_port, "POST", "/api/interactivequery/lq/session",
                  {"name": flow, "tenant": "designer", "sampleRows": sample})["id"]
        out["lq_session_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got_lq = spa(web_port, "POST", "/api/interactivequery/lq/execute",
                     {"sessionId": sid, "query": query, "maxRows": CONTROL_SAMPLE_EVENTS})
        out["lq_execute_ms"] = (time.perf_counter() - t0) * 1e3
        csid = cpu_lq.create_session(
            "designer", flow, props["inputSchemaFile"],
            normalization=props["normalizationSnippet"], sample_rows=sample,
            udfs={"anomalyscore": anomalyscore()})["id"]
        same_lq_result(got_lq, cpu_lq.execute(csid, query, CONTROL_SAMPLE_EVENTS),
                       "control lq/execute")
        spa(web_port, "POST", "/api/interactivequery/kernel/delete", {"kernelId": kid})
        spa(web_port, "POST", "/api/interactivequery/lq/session/close", {"sessionId": sid})
        out["rows"] = len(want["result"])
    finally:
        livequery.time = real_time
        cpu_kernels.delete_kernels()
        cpu_lq.stop()
    return out


def phase_control(seed: int, nvidia_smi: str) -> dict:
    """The control plane on the card, the one-box stack in process:
    ``DataXApiService`` (roles on, ``device="cuda"``), a ``Gateway`` and a
    ``WebsiteServer`` bound to it by a writer's token, its job client a
    ``LocalJobClient`` spawning the port's host as a child process on
    the card. Through the website, in the SPA's order: save
    ``control_gui()`` (the main flow from a socket), ``flow/validate``
    with the device tier, ``flow/generateconfigs``, ``flow/startjobs``
    for ``CONTROL_BATCHES`` batches, the seeded payloads written to the
    child's socket, ``job/syncall`` + ``job/get`` until ``success``,
    ``flow/stopjobs``. Checked: the child's log names a CUDA device, its
    batch lines count every event, each output's count per batch equals
    the port's host on the CPU over the same conf and bytes, the conf's
    conformance model is the port's plan, and the plan is what validate
    returned. Then ``control_livequery``. Returns each kernel's launches
    in the server process over the LiveQuery part (the child's are in
    another process: its outputs equal the CPU's, and nothing there
    falls back, so its kernel ran)."""
    import tempfile

    from data_accelerator_tpu_torch.analysis import analyze_flow_device
    from data_accelerator_tpu_torch.core.config import parse_conf_lines
    from data_accelerator_tpu_torch.kernels import launch
    from data_accelerator_tpu_torch.serve.flowservice import FlowOperation
    from data_accelerator_tpu_torch.serve.gateway import (
        ROLE_READER, ROLE_WRITER, AuthTable, Gateway)
    from data_accelerator_tpu_torch.serve.jobs import LocalJobClient
    from data_accelerator_tpu_torch.serve.restapi import DataXApi, DataXApiService
    from data_accelerator_tpu_torch.serve.storage import (
        LocalDesignTimeStorage, LocalRuntimeStorage)
    from data_accelerator_tpu_torch.web import WebsiteServer

    rs = np.random.RandomState(seed + 11)
    payloads = [make_json_payload(rs, CAPACITY) for _ in range(CONTROL_BATCHES)]
    t_phase = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        design = LocalDesignTimeStorage(f"{tmp}/design")
        runtime = LocalRuntimeStorage(f"{tmp}/runtime")
        env = {"PYTHONPATH": os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p)}
        client = LocalJobClient(log_dir=runtime.resolve("logs"), env=env)
        ops = FlowOperation(design, runtime, job_client=client, device="cuda")
        parts, job_name = [], None
        try:
            api = DataXApiService(DataXApi(ops, require_roles=True, device="cuda"),
                                  port=0)
            api.start()
            parts.append(api)
            auth = AuthTable()
            auth.add(CONTROL_TOKEN, "designer@example", [ROLE_READER, ROLE_WRITER])
            gw = Gateway(auth, port=0, backends={
                s: f"http://127.0.0.1:{api.port}" for s in CONTROL_SERVICES})
            gw.start()
            parts.append(gw)
            web = WebsiteServer(gateway_url=f"http://127.0.0.1:{gw.port}",
                                gateway_token=CONTROL_TOKEN, port=0)
            web.start()
            parts.append(web)

            gui = control_gui("socket", CAPACITY)
            t0 = time.perf_counter()
            spa(web.port, "POST", "/api/flow/flow/save", gui)
            times["save_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            report = spa(web.port, "POST", "/api/flow/flow/validate",
                         {"flow": gui, "device": True})
            times["validate_ms"] = (time.perf_counter() - t0) * 1e3
            plan = analyze_flow_device(gui)
            if not report["ok"] or report["device"]["totals"] != plan.plan_dict()["totals"]:
                raise AssertionError(f"control validate: {report.get('diagnostics')}, "
                                     f"{report.get('device', {}).get('totals')}")
            t0 = time.perf_counter()
            gen = spa(web.port, "POST", "/api/flow/flow/generateconfigs",
                      {"flowName": CONTROL_FLOW})
            times["generate_ms"] = (time.perf_counter() - t0) * 1e3
            [job_name], [conf_path] = gen["jobNames"], gen["confPaths"]
            conf = parse_conf_lines(Path(conf_path).read_text(encoding="utf-8").splitlines())
            model = json.dumps(analyze_flow_device(design.get_by_name(CONTROL_FLOW))
                               .runtime_model(), separators=(",", ":"))
            if conf.get("datax.job.process.conformance.model") != model:
                raise AssertionError("control: the conf's conformance model is not "
                                     "the port's plan")
            port = free_port()
            # the socket the child listens on: a per-job conf override,
            # the key=value argument the job client passes the host
            ops.registry.upsert({"name": job_name, "confOverrides": {
                "datax.job.input.default.socket.port": str(port)}})
            t0 = time.perf_counter()
            [started] = spa(web.port, "POST", "/api/flow/flow/startjobs",
                            {"flowName": CONTROL_FLOW, "batches": CONTROL_BATCHES})
            if started["state"] != "starting":
                raise AssertionError(f"control startjobs: {started}")
            times["feed_s"] = send_when_listening(port, payloads)
            log_path = Path(runtime.resolve("logs")) / f"{job_name}.log"
            deadline = time.monotonic() + CONTROL_JOB_TIMEOUT_S
            while True:
                spa(web.port, "POST", "/api/flow/job/syncall", {})
                job = spa(web.port, "GET", f"/api/flow/job/get?jobName={job_name}")
                if "first_batch_s" not in times and HOST_BATCH_LINE.search(
                        log_path.read_text(encoding="utf-8", errors="replace")):
                    # to within one poll of this loop
                    times["first_batch_s"] = time.perf_counter() - t0
                if job["state"] not in ("starting", "running"):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"control: job still {job['state']} after "
                                         f"{CONTROL_JOB_TIMEOUT_S} s")
                time.sleep(0.2)
            times["job_s"] = time.perf_counter() - t0
            spa(web.port, "POST", "/api/flow/flow/stopjobs", {"flowName": CONTROL_FLOW})
            log = log_path.read_text(encoding="utf-8", errors="replace")
            if job["state"] != "success":
                raise AssertionError(f"control: job ended {job['state']}: {log[-3000:]}")
            started_on = HOST_START_LINE.search(log)
            batches = host_batch_metrics(log)
            events = sum(m["Input_DataXProcessedInput_Events_Count"] for m in batches)
            if started_on is None or not started_on.group(1).startswith("cuda"):
                raise AssertionError(f"control: the child ran on "
                                     f"{started_on and started_on.group(1)}")
            if len(batches) != CONTROL_BATCHES or events != CONTROL_BATCHES * CAPACITY:
                raise AssertionError(f"control: {len(batches)} batches, {events} events")
            t0 = time.perf_counter()
            cpu = cpu_host_counts(conf_path, payloads, tmp)
            times["cpu_run_s"] = time.perf_counter() - t0
            counts = {}
            for out in OUTPUTS:
                key = f"Output_{out}_Events_Count"
                counts[out] = [m.get(key) for m in batches]
                if counts[out] != [float(m.get(key)) for m in cpu]:
                    raise AssertionError(f"control {out}: {counts[out]} on the card, "
                                         f"{[m.get(key) for m in cpu]} on the CPU")
            launch.reset_launches()
            lq = control_livequery(web.port, CONTROL_FLOW, runtime, seed)
            torch.cuda.synchronize()
            launches = process_launches()
        finally:
            if job_name is not None:
                client.stop({"name": job_name})
            for part in reversed(parts):
                part.stop()
    line = {"phase": "control", "seconds": time.perf_counter() - t_phase,
            "job": job_name, "child_device": started_on.group(1),
            "batches": len(batches), "events": events, "output_counts": counts,
            "conformance_model": "the port's plan", **times, **lq,
            "launches": launches, "card": nvidia_smi}
    emit(line)
    if launches["anomaly_score"] < 2 or launches["dx305_double"]:
        raise AssertionError(f"control launches: {launches}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    bind_repo_tests()
    from data_accelerator_tpu_torch.kernels.anomaly_score import SOURCE
    from data_accelerator_tpu_torch.udf.samples import anomalyscore
    from tests.data.udfs_torch.dx305_cuda import SOURCE as DX305_SOURCE

    nvidia_smi = phase_device()
    phase_build()
    rs = np.random.RandomState(args.seed)
    checks = {
        "anomaly_score": check_anomaly_score(rs),
        "dx305_double": check_dx305(rs),
    }
    for name, m in checks.items():
        emit({"phase": "kernel_check", "name": name, "n": CAPACITY, **m})
    phase_host_split()
    udf = anomalyscore()
    # ingest first: its profiled step must be the process's first
    # profiler session, since after the flow's profile the profiler
    # recorded no host-to-device copy activity on the card's machine
    ingest_launches = phase_ingest(args.seed, udf, nvidia_smi)
    launches = {
        "anomaly_score": phase_flow(args.seed, udf),
        "dx305_double": phase_udf_flow(args.seed, udf),
    }
    host_launches, host_events_per_s = phase_host(args.seed, nvidia_smi)
    cli_launches = phase_host_cli(nvidia_smi)
    observe_launches = phase_observe(args.seed, nvidia_smi, host_events_per_s)
    # this slice's paths declare no kernel: each kernel's process-wide
    # count, set to 0 just before each path and read just after, stays 0
    slice_launches = {"gen_conf": phase_gen_conf(nvidia_smi),
                      "storm": phase_storm(args.seed, nvidia_smi),
                      "join_ops": phase_join_ops(args.seed, nvidia_smi),
                      "state": phase_state(args.seed, nvidia_smi)}
    if any(n for counts in slice_launches.values() for n in counts.values()):
        raise AssertionError(f"kernel launches on this slice's paths: {slice_launches}")
    # LiveQuery: the designer's UDF query launches anomaly_score
    slice_launches["livequery"] = phase_livequery(args.seed, nvidia_smi)
    # the debug runtime and the device plan: the armed main path and the
    # planned processor launch anomaly_score
    slice_launches["debug"] = phase_debug(args.seed, nvidia_smi, host_events_per_s)
    slice_launches["plan"] = phase_plan(args.seed, nvidia_smi)
    # the chaos drills: the main path's host under five faults
    slice_launches["chaos"] = phase_chaos(nvidia_smi, udf)
    # the control plane: the server process's LiveQuery part launches
    # anomaly_score (the job child's launches are another process's)
    slice_launches["control"] = phase_control(args.seed, nvidia_smi)
    # each path's own launches, its counts set to 0 just before it
    by_path = {
        "anomaly_score": {"flow": launches["anomaly_score"],
                          "ingest": ingest_launches,
                          "host": host_launches,
                          "host_cli": cli_launches,
                          "observe": observe_launches},
        "dx305_double": {"udf_flow": launches["dx305_double"]},
    }
    for path, counts in slice_launches.items():
        for name, n in counts.items():
            by_path[name][path] = n
    phase_ground_truth()

    kernels = [
        ("anomaly_score", "data_accelerator_tpu_torch/" + SOURCE,
         "data_accelerator_tpu/udf/samples.py:88"),
        ("dx305_double", str(DX305_SOURCE.relative_to(ROOT)),
         "tests/data/udfs/dx305_pallas.py:13"),
    ]
    # each value once, under the names the chip check reads
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name],
        "launches_by_path": by_path[name],
        "max_abs_err": checks[name]["max_err"],
        "ms": checks[name]["kernel_ms"],
        "plain_ms": checks[name]["plain_ms"],
        "bound_ms": checks[name]["bound_ms"],
        "bound_by": checks[name]["bound_by"],
        "library_ms": checks[name]["library_ms"],
        "n": CAPACITY,
        "device_ms": checks[name]["device_ms"],
        "plain_device_ms": checks[name]["plain_device_ms"],
        "n_large": N_LARGE,
        "device_ms_large": checks[name]["device_ms_large"],
        "bound_ms_large": checks[name]["bound_ms_large"],
        "library_device_ms_large": checks[name]["library_device_ms_large"],
        "card": nvidia_smi,
    } for name, source, replaces in kernels]})
    print(nvidia_smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
