"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every hand-written kernel compiled with ``nvcc``, all at once;
3. kernels: each kernel held against its plain PyTorch version on the
   card, then both timed with CUDA events at the main path's shape;
4. flow: the single-source alerting flow plus the anomaly-score query
   (BASELINE configs 1 and 4) through ``FlowProcessor`` at full batch
   capacity on the card, batch for batch against the same flow on the
   CPU, with every kernel's launch count read from that run. A step is
   timed from the host columns (pinned and copied to the card by
   ``encode_columns``) to the counts vector on the host.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it. Without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

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
# the per-chip batch of bench.py; 8 batches 1 s apart evict the 5 s window
CAPACITY = 262_144
BATCHES = 8


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


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of per-run CUDA-event times, each run one call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed, timed with CUDA events; the median replay over ``reps``.
    Unlike ``cuda_ms`` this leaves out the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture, as graph capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, runs=10, warmup=1) / reps


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

    t0 = time.perf_counter()
    paths = build.build(["anomaly_score"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc": build.nvcc_path(), "libraries": [p.name for p in paths]})


def check_anomaly_score(rs):
    """Kernel against plain on the card at the test sizes and the main
    path's; returns the max abs error and the timings at ``CAPACITY``."""
    from data_accelerator_tpu_torch.kernels.anomaly_score import (
        AnomalyScoreKernel,
        anomaly_score_plain as plain,
    )

    dev = torch.device("cuda")
    kernel = AnomalyScoreKernel()
    max_err = 0.0
    for n in (1, 1023, 1025, CAPACITY):
        for mu_dtype in (np.int32, np.float32):
            x = torch.from_numpy(rs.uniform(-50, 150, n).astype(np.float32)).to(dev)
            if mu_dtype is np.int32:
                mu_np = rs.randint(1, 9, n).astype(np.int32)
            else:
                mu_np = rs.uniform(-10, 10, n).astype(np.float32)
            mu = torch.from_numpy(mu_np).to(dev)
            x[::5] = mu[::5].to(torch.float32)  # score 0.5 exactly
            got = kernel(x, mu)
            torch.cuda.synchronize()
            err = float((got - plain(x, mu)).abs().max())
            if not err <= 1e-6:
                raise AssertionError(
                    f"anomaly_score n={n} mu={mu_dtype.__name__}: "
                    f"max abs error {err} > 1e-6"
                )
            max_err = max(max_err, err)
    # main-path shape: float32 temperature, int32 deviceId
    x = torch.from_numpy(rs.uniform(0, 100, CAPACITY).astype(np.float32)).to(dev)
    mu = torch.from_numpy(rs.randint(1, 9, CAPACITY).astype(np.int32)).to(dev)
    ms = cuda_ms(lambda: kernel(x, mu))
    plain_ms = cuda_ms(lambda: plain(x, mu))
    device_ms = graph_ms(lambda: kernel(x, mu))
    plain_device_ms = graph_ms(lambda: plain(x, mu))
    bytes_moved = 3 * 4 * CAPACITY  # x and mu read once, o written once
    flops = 9 * CAPACITY  # sub, 2 abs, add, div, neg, exp, add, div
    bound_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "device_ms": device_ms,
        "plain_device_ms": plain_device_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }


def same_rows(gpu_rows, cpu_rows, what):
    if len(gpu_rows) != len(cpu_rows):
        raise AssertionError(f"{what}: {len(gpu_rows)} rows on the card, "
                             f"{len(cpu_rows)} on the CPU")
    for g, c in zip(gpu_rows, cpu_rows):
        if g.keys() != c.keys():
            raise AssertionError(f"{what}: columns {sorted(g)} vs {sorted(c)}")
        for k, gv in g.items():
            cv = c[k]
            if isinstance(gv, float):
                if not (np.isfinite(gv) and abs(gv - cv) <= 1e-4 * abs(cv)):
                    raise AssertionError(f"{what}.{k}: {gv} vs {cv}")
            elif gv != cv:
                raise AssertionError(f"{what}.{k}: {gv!r} vs {cv!r}")


def phase_flow(seed: int, udf) -> int:
    """Runs the main path on the card and the same batches on the CPU;
    returns the anomaly kernel's launches in the card's run."""
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    t0 = time.perf_counter()
    gpu = FlowProcessor(
        SettingDictionary(flow_conf()), batch_capacity=CAPACITY,
        output_datasets=OUTPUTS, udfs={"anomalyscore": udf}, device="cuda",
    )
    cpu = FlowProcessor(
        SettingDictionary(flow_conf()), batch_capacity=CAPACITY,
        output_datasets=OUTPUTS, udfs={"anomalyscore": anomalyscore()},
        device="cpu",
    )
    init_s = time.perf_counter() - t0
    type_ids = np.array([gpu.dictionary.encode(t) for t in DEVICE_TYPES], np.int32)
    cpu_ids = np.array([cpu.dictionary.encode(t) for t in DEVICE_TYPES], np.int32)
    if not np.array_equal(type_ids, cpu_ids):
        raise AssertionError("card and CPU dictionaries disagree")
    rs = np.random.RandomState(seed)
    batches = [make_columns(rs, type_ids, CAPACITY) for _ in range(BATCHES)]

    # the main path's run: the count at 0 just before, read just after
    udf.kernel.launches = 0
    step_ms, encode_ms, collect_ms, syncs, gpu_results = [], [], [], [], []
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
        gpu_results.append((counts, datasets, metrics))
    launches = udf.launches
    if launches != BATCHES:
        raise AssertionError(
            f"anomaly_score launched {launches} times in {BATCHES} batches "
            "on the card, not once per batch"
        )

    # the same batches through the port on the CPU
    rows_out = {n: 0 for n in OUTPUTS}
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
        for name in OUTPUTS:
            same_rows(g_datasets[name], datasets[name], f"batch {b} {name}")
            rows_out[name] += len(datasets[name])
    if not rows_out["HeatAvg"] or not rows_out["AnomalyAlerts"]:
        raise AssertionError(f"flow produced no alerts: {rows_out}")

    # batch 0 includes first-use costs (kernel load, allocator growth)
    med = statistics.median(step_ms[1:])
    emit({
        "phase": "flow", "capacity": CAPACITY, "batches": BATCHES,
        "seed": seed, "init_s": init_s,
        "step_ms": step_ms, "step_ms_median": med,
        "events_per_s": CAPACITY / (med / 1e3),
        "encode_ms": encode_ms,
        "encode_ms_median": statistics.median(encode_ms[1:]),
        "collect_ms": collect_ms,
        "host_syncs_per_step": syncs,
        "host_sync_messages": sorted(sync_sites),
        "rows_out": rows_out,
        "launches": {"anomaly_score": launches},
        "match_cpu": True,
    })
    phase_profile(gpu, batches[-1], BASE_MS + 1000 * BATCHES)
    return launches


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

    from data_accelerator_tpu_torch.kernels.anomaly_score import SOURCE
    from data_accelerator_tpu_torch.udf.samples import anomalyscore

    nvidia_smi = phase_device()
    phase_build()
    m = check_anomaly_score(np.random.RandomState(args.seed))
    udf = anomalyscore()
    launches = phase_flow(args.seed, udf)

    # ``max_err`` and ``kernel_ms`` repeat ``max_abs_err`` and ``ms``
    # under the names the port's bring-up plan gives them
    emit({"kernels": [{
        "name": "anomaly_score", "route": "cuda",
        "source": "data_accelerator_tpu_torch/" + SOURCE,
        "replaces": "data_accelerator_tpu/udf/samples.py:88",
        "launches": launches,
        "max_abs_err": m["max_abs_err"], "max_err": m["max_abs_err"],
        "ms": m["ms"], "kernel_ms": m["ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": m["library_ms"], "n": CAPACITY,
        "device_ms": m["device_ms"], "plain_device_ms": m["plain_device_ms"],
        "card": nvidia_smi,
    }]})
    print(nvidia_smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
