"""Latency closed forms of the cost model: roofline milliseconds from the
byte and FLOP terms the generated conf carries and a measured machine
profile (``obs/calibrate.py``).

Copy of the JAX package's ``analysis/costmodel.py``, trimmed to
``runtime_conformance_model`` and the latency forms
(``stage_time_ms``, ``transfer_time_ms``, ``decode_time_ms``,
``model_input_rows``, ``latency_model``, ``stage_latency_predictions``)
and ``warm_kernel_cache_budget_bytes``, which reads the device's memory
(the card's total, or ``constants.CPU_DEVICE_MEMORY_BYTES`` on the CPU)
where the JAX package takes its fleet-spec chip's.
The byte and FLOP closed forms over the planner's ``StagePlan`` wait for
``analysis/deviceplan.py`` (slice 7); the mesh collective forms wait for
multi-GPU (slice 8).

The forms are the reference's, term for term, so one profile prices one
conf-embedded model to the same milliseconds in both packages. One
consequence is deliberate: ``latency_model`` charges one dispatch
overhead a step, which is the JAX package's one jitted call. The port's
eager step launches many kernels, so its ``deviceStepMs`` is a lower
bound that the card's step exceeds by the launches it does not count.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..constants import CPU_DEVICE_MEMORY_BYTES


def runtime_conformance_model(
    totals: Dict[str, object],
    stages: Optional[list] = None,
    outputs: Optional[Dict[str, dict]] = None,
) -> dict:
    """The cost model as a *runtime artifact*: the compact JSON-ready
    slice of a device-plan report that config generation embeds into
    the flow's conf (``datax.job.process.conformance.model``) and the
    host's ``ConformanceMonitor`` judges observations against. Keeps
    only what the monitor (and humans debugging drift) need — modeled
    per-batch D2H bytes, HBM totals, per-output modeled occupancy, and
    the per-stage d2hBytes/hbmBytes/flops breakdown (the byte+FLOP
    terms the host combines with its own calibrated machine profile
    into the DX520/DX521 latency predictions — bytes and FLOPs travel
    in the conf, milliseconds are computed where the hardware is)."""
    return {
        "totals": {
            "d2hBytesPerBatch": totals.get("d2hBytesPerBatch"),
            "hbmBytes": totals.get("hbmBytes"),
            "modelBytes": totals.get("modelBytes"),
            "flops": totals.get("flops"),
        },
        "outputs": dict(outputs or {}),
        "stages": [
            {
                "name": s.get("name"),
                "kind": s.get("kind"),
                # rows ride along so the latency model can derive the
                # per-batch ingest row count (input-kind stages) for
                # the calibrated host-decode term
                "rows": s.get("rows"),
                "hbmBytes": s.get("hbmBytes"),
                "d2hBytes": s.get("d2hBytes"),
                "flops": s.get("flops"),
            }
            for s in (stages or [])
        ],
    }


# ---------------------------------------------------------------------------
# Latency closed forms (the time axis): roofline milliseconds from the
# byte/FLOP closed forms plus a measured machine profile
# (obs/calibrate.py). The per-stage form is the classic roofline —
# a stage is either bandwidth-bound or compute-bound, never both:
#
#     stage_ms = max(bytes / HBM_BW, flops / F) [+ dispatch overhead]
#
# These are LOWER bounds by construction (peak-bandwidth streaming,
# peak dense FLOP/s); achieved efficiency on gather/sort-heavy SQL
# stages runs below peak, so the DX520 runtime band that judges
# observed-vs-predicted is wide (it catches wholesale regressions —
# a bandwidth collapse, dispatch-overhead domination, a memory
# re-layout — not micro-inefficiency).
# ---------------------------------------------------------------------------
def stage_time_ms(
    hbm_bytes: float, flops: float, profile: Dict[str, float],
) -> float:
    """Roofline milliseconds of one stage under ``profile`` (a
    ``MachineProfile.to_dict()``): max of the memory term (stage bytes
    at the slower of the read/write streams) and the compute term.
    Dispatch overhead is NOT included — the whole step pays it once,
    not per stage."""
    bw = min(
        float(profile.get("hbm_read_gbps") or 1.0),
        float(profile.get("hbm_write_gbps") or 1.0),
    )
    flop_rate = float(profile.get("flops_gflops") or 1.0)
    mem_ms = float(hbm_bytes) / max(bw, 1e-9) / 1e6
    compute_ms = float(flops) / max(flop_rate, 1e-9) / 1e6
    return max(mem_ms, compute_ms)


def transfer_time_ms(bytes_: float, gbps: Optional[float]) -> Optional[float]:
    """Milliseconds to move ``bytes_`` over a link of ``gbps`` (D2H or
    ICI); None when the link bandwidth is unknown (e.g. no mesh)."""
    if not gbps:
        return None
    return float(bytes_) / float(gbps) / 1e6


def decode_time_ms(
    input_rows: float, profile: Dict[str, float],
) -> Optional[float]:
    """The calibrated host-decode term: milliseconds to run
    ``input_rows`` through the native ingest decoder at the machine's
    measured rate (``decode_rows_per_sec``, obs/calibrate.py's decoder
    probe over a reference payload). None when the machine has no
    calibrated decode rate (native library unavailable) or the model
    carries no input rows — the missing-prediction posture (silence)
    applies, like every other absent term."""
    rate = profile.get("decode_rows_per_sec")
    if not rate or not input_rows:
        return None
    return float(input_rows) / float(rate) * 1000.0


def model_input_rows(stages: list) -> float:
    """Per-batch ingest row count of a stage list (dict-shaped): the
    summed capacities of the input-kind stages — the rows the host
    decoder must produce each batch."""
    return float(sum(
        float(s.get("rows") or 0.0)
        for s in (stages or [])
        if s.get("kind") == "input"
    ))


def latency_model(
    stages: list,
    totals: Dict[str, object],
    profile: Dict[str, float],
    profile_source: str = "default",
) -> dict:
    """The ``latencyModel`` report block: per-stage roofline ms plus
    the batch-level decomposition the runtime stages map onto —
    ``decodeMs`` (the calibrated host-decode term over the input-stage
    rows), ``deviceStepMs`` (every stage's compute, one dispatch
    overhead), ``d2hMs`` (the full-fetch output transfer), ``iciMs``
    (the wire bytes over the calibrated link).
    ``stages``/``totals`` are dict-shaped (the conf-embedded runtime
    model). Consumed by the host's DX520/DX521 predictions."""
    overhead_ms = float(profile.get("dispatch_overhead_us") or 0.0) / 1000.0
    out_stages = []
    compute_ms = 0.0
    for s in stages or []:
        ms = stage_time_ms(
            float(s.get("hbmBytes") or 0.0), float(s.get("flops") or 0.0),
            profile,
        )
        compute_ms += ms
        out_stages.append({
            "name": s.get("name"),
            "kind": s.get("kind"),
            "computeMs": round(ms, 4),
        })
    d2h_bytes = float(totals.get("d2hBytesPerBatch") or 0.0)
    d2h_ms = transfer_time_ms(d2h_bytes, profile.get("d2h_gbps"))
    ici_bytes = float(
        totals.get("iciWireBytesPerBatch")
        or totals.get("iciBytesPerBatch") or 0.0
    )
    ici_ms = transfer_time_ms(ici_bytes, profile.get("ici_gbps"))
    decode_ms = decode_time_ms(model_input_rows(stages), profile)
    device_step_ms = compute_ms + overhead_ms
    return {
        "profileSource": profile_source,
        "profile": {
            k: profile.get(k)
            for k in (
                "backend", "device_kind", "hbm_read_gbps",
                "hbm_write_gbps", "flops_gflops", "dispatch_overhead_us",
                "d2h_gbps", "ici_gbps", "decode_rows_per_sec",
            )
        },
        "stages": out_stages,
        "totals": {
            "computeMs": round(compute_ms, 4),
            "dispatchOverheadMs": round(overhead_ms, 4),
            "decodeMs": (
                round(decode_ms, 4) if decode_ms is not None else None
            ),
            "deviceStepMs": round(device_step_ms, 4),
            "d2hMs": round(d2h_ms, 4) if d2h_ms is not None else None,
            "iciMs": round(ici_ms, 4) if ici_ms is not None else None,
            "batchMs": round(
                device_step_ms + (decode_ms or 0.0) + (d2h_ms or 0.0)
                + (ici_ms or 0.0), 4
            ),
        },
    }


def stage_latency_predictions(model: dict) -> Dict[str, float]:
    """Map a ``latency_model()`` block onto the runtime histogram
    stages the host measures (constants.MetricName.STAGES): the DX520
    comparison keys. Only stages the model can actually predict appear
    — ``decode`` (the calibrated host-decode rate over the flow's
    input rows), ``device-step`` (compute + one dispatch overhead) and
    ``collect`` (the D2H landing of the output tables).
    Sinks/checkpoint are host-side I/O the model deliberately does not
    cover. Like every roofline term the decode prediction is a LOWER
    bound (a saturated decoder at the calibrated rate; the runtime
    decode span also contains the source poll), judged under the wide
    DX520 band and the sub-floor silence rule."""
    totals = model.get("totals") or {}
    out: Dict[str, float] = {}
    if totals.get("decodeMs"):
        out["decode"] = float(totals["decodeMs"])
    if totals.get("deviceStepMs"):
        out["device-step"] = float(totals["deviceStepMs"])
    if totals.get("d2hMs"):
        out["collect"] = float(totals["d2hMs"])
    return out


# fraction of one device's memory the LiveQuery serving plane may pin in
# resident interactive kernels (lq/warmcache.py WarmKernelCache): the
# production flows on the device own the rest, so the serving plane
# takes a bounded slice instead of competing with them allocation by
# allocation
DEFAULT_LQ_CACHE_HEADROOM = 0.25


def warm_kernel_cache_budget_bytes(
    chip_hbm_bytes: Optional[int] = None,
    headroom: float = DEFAULT_LQ_CACHE_HEADROOM,
    device: "torch.device | str" = "cuda",
) -> int:
    """Device bytes the LiveQuery warm-kernel LRU may keep resident:
    ``headroom`` of ``chip_hbm_bytes``, which defaults to the memory of
    ``device``: on a card its total memory, on the CPU
    ``constants.CPU_DEVICE_MEMORY_BYTES``. Each cache entry is priced by
    ``FlowProcessor.device_bytes``. Raises when ``device`` is a card and
    none is present."""
    if chip_hbm_bytes is None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"warm-kernel budget for {str(dev)!r}: no CUDA device "
                    "is present"
                )
            chip_hbm_bytes = torch.cuda.get_device_properties(dev).total_memory
        else:
            chip_hbm_bytes = CPU_DEVICE_MEMORY_BYTES
    return int(chip_hbm_bytes * float(headroom))
