"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every hand-written kernel compiled with ``nvcc``, all at once,
   with each kernel's registers, shared memory and spill bytes as
   ``ptxas -v`` reported them;
3. kernel_check: each kernel held against its plain PyTorch version on
   the card at ragged sizes, at views that start 0-3 rows past a 16-byte
   boundary (for ``anomaly_score`` every pair of offsets of x and mu), for
   float32 and int32 rows (and ``dx305_double`` at user grids of 1 and 3
   blocks), then timed with CUDA events at the main
   path's shape and, for device time alone, at ``N_LARGE`` rows, beyond
   the L2 cache; host_split: the host's time for the parts of one call;
4. flow: the single-source alerting flow plus the anomaly-score query
   (BASELINE configs 1 and 4) through ``FlowProcessor`` at full batch
   capacity on the card, batch for batch against the same flow on the
   CPU, with every kernel's launch count read from that run. A step is
   timed from the host columns (pinned and copied to the card by
   ``encode_columns``) to the counts vector on the host;
5. udf_flow: a user UDF whose body is its own CUDA kernel, declared in
   the flow's conf (``tests/data/udfs_torch/dx305_cuda.py:clean``,
   kernel ``dx305_double.cu``), through its own ``FlowProcessor`` on the
   same batches, timed and checked the same way;
6. ground_truth: under ``torch.cuda.set_sync_debug_mode("error")`` the
   bad twins of the DX300, DX301 and DX305 analyzer fixtures raise on
   CUDA tensors and their clean twins run.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it. Without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import importlib.machinery
import importlib.util
import json
import statistics
import subprocess
import sys
import time
import warnings
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
    paths = build.build(sources)
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
    launches = {
        "anomaly_score": phase_flow(args.seed, udf),
        "dx305_double": phase_udf_flow(args.seed, udf),
    }
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
