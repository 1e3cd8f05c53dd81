"""Closed-form static cost model over compiled device plans, and its
latency forms.

Every capacity in a lowered flow is static, so a stage's device bytes
and FLOP count are *closed-form functions* of the shapes the planner
chose: no execution, no sampling. The byte and FLOP forms consume the
``StagePlan``/``JoinSite`` metadata ``compile/planner.py`` records at
lowering time; ``analysis/deviceplan.py`` holds the byte forms equal to
the meta evaluation of the production lowering and to the tensors a
real batch materializes. The latency forms turn those bytes and FLOPs
into roofline milliseconds under a measured machine profile
(``obs/calibrate.py``).

Column widths (core/schema.py device encoding, as the JAX package's
x64-off encoding): long/string/timestamp -> int32 (4 B), double ->
float32 (4 B), boolean -> bool (1 B); the validity mask is one bool per
row.

Copy of the JAX package's ``analysis/costmodel.py``. The ring
collective wire forms (``allgather_wire_bytes``, ``allreduce_wire_bytes``,
``alltoall_wire_bytes``, ``collective_wire_bytes``) are the reference's,
term for term: the mesh's census (``dist/mesh.py::MeshCollectives``)
turns its recorded result bytes into ``Mesh_ICI_Bytes`` with them, and
the DX7xx mesh model (``analysis/meshcheck.py``) prices its reshard
edges with them. The mesh model forms (``ici_bytes_group``,
``ici_bytes_join``, ``stage_ici_bytes``, ``mesh_runtime_model``) are
the reference's too. Every other form is the reference's, term for
term, except where the port materializes other dtypes than the JAX
package:

- ``stage_transient_bytes``: a match-matrix join with a residual
  evaluates the residual over blocks of at most
  ``ops/join.py::RESIDUAL_BLOCK_PAIRS`` pairs, indexing with broadcast
  views of int64 row ranges (no grid is allocated) and gathering its
  operands per block, where the JAX package builds two int32 index
  grids over every pair at once. The form charges the [n, m] mask, the
  residual's [n, m] bool result and one block's two gathered 4-byte
  operands (a comparison of one left and one right column), in place
  of the reference's two grids over every pair.
- ``ops/groupby.py`` sums float aggregates in float64 in a
  ``[groups + 1]`` buffer before casting back to float32: an O(groups)
  intermediate that, like every group-by and sort-merge intermediate in
  the reference's form, folds into no term; the outputs keep the
  reference's float32.

``warm_kernel_cache_budget_bytes`` reads the device's memory (the
card's total, or ``constants.CPU_DEVICE_MEMORY_BYTES`` on the CPU)
where the JAX package takes its fleet-spec chip's.

The latency forms are the reference's, term for term, so one profile
prices one conf-embedded model to the same milliseconds in both
packages. One difference is deliberate: ``latency_model`` takes the
step's launch count and charges a dispatch overhead for each launch.
The JAX package's step is one jitted call, which is ``launches=1``
and the reference's formula; the port's eager step launches every
kernel on its own (``deviceplan.count_step_launches``, a few hundred
for config 1).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..compile.planner import StagePlan
from ..constants import CPU_DEVICE_MEMORY_BYTES

# planner type name -> device bytes per element
COLUMN_WIDTH: Dict[str, int] = {
    "long": 4,
    "double": 4,
    "boolean": 1,
    "string": 4,
    "timestamp": 4,
}

# pairs budget above which a match-matrix join is flagged as the
# O(n*m) cliff (DX203): 2^24 pair evaluations per batch
DEFAULT_MATCH_MATRIX_BUDGET = 1 << 24

# bytes of one equality/sort key element (all key-able types are 4 B)
KEY_BYTES = 4

# bytes of one gathered residual operand (every key-able type is 4 B)
OPERAND_BYTES = 4


def column_width(type_name: str) -> int:
    """Device bytes per element of a planner-typed column (unknown
    types conservatively count as 4: every device dtype except bool is
    32-bit)."""
    return COLUMN_WIDTH.get(type_name, 4)


def table_bytes(types: Dict[str, str], rows: int) -> int:
    """Device bytes of one materialized TableData: every device column
    (hidden ``__defer.``/``.__valid`` included: they are real tensors)
    plus the one-bool-per-row validity mask."""
    return sum(column_width(t) * rows for t in types.values()) + rows


def row_bytes(types: Dict[str, str]) -> int:
    return table_bytes(types, 1)


def view_output_bytes(
    types: Dict[str, str], plan: Optional[StagePlan], rows: int
) -> int:
    """Closed-form bytes of a compiled view's output table.

    Mirrors the planner's run() exactly: grouped views ride an
    ``__overflow.groups`` int32 column, any view whose FROM chain joined
    rides ``__overflow.joins`` (both row-broadcast), and UNION outputs
    carry neither (the concat keeps only schema columns).
    """
    b = table_bytes(types, rows)
    if plan is None or plan.kind == "union":
        return b
    if plan.grouped:
        b += 4 * rows  # __overflow.groups
    if plan.joins:
        b += 4 * rows  # __overflow.joins
    return b


def d2h_transfer_bytes(
    types: Dict[str, str], plan: Optional[StagePlan], rows_transferred: int
) -> int:
    """Closed-form device->host bytes of fetching one OUTPUT table at
    ``rows_transferred`` rows: the per-batch wire cost of the sync stage
    for that output (``view_output_bytes`` at the transfer capacity: the
    full padded capacity, or the sized capacity under
    ``datax.job.process.pipeline.sizedtransfer``)."""
    return view_output_bytes(types, plan, rows_transferred)


# A/B output transfer slots (runtime/processor.py _stage_output): each
# output keeps this many transfer-ready copies of its table resident on
# the device, alternating so batch N+1's step never writes into batch
# N's in-flight device-to-host copy
OUTPUT_SLOT_BUFFERS = 2


def output_slot_bytes(
    types: Dict[str, str], plan: Optional[StagePlan], capacity: int,
    buffers: int = OUTPUT_SLOT_BUFFERS,
) -> int:
    """Closed-form device bytes of one output's transfer slots:
    ``buffers`` resident copies of the view-output layout at the slot
    capacity (``OUTPUT_SLOT_BUFFERS``, the A/B pair, unless the caller
    knows the processor holds fewer). The static model charges the bound
    (the padded output capacity), like every other capacity it
    accounts."""
    return buffers * view_output_bytes(types, plan, capacity)


def _log2(n: int) -> float:
    return math.log2(max(int(n), 2))


def stage_transient_bytes(plan: Optional[StagePlan]) -> int:
    """Peak in-stage intermediates that never persist: the [n, m] bool
    match matrix of non-sort-merge joins and, with a residual, the
    residual's [n, m] bool result plus one block's two gathered
    operands (``ops/join.py`` evaluates the residual over blocks of at
    most ``RESIDUAL_BLOCK_PAIRS`` pairs). Sort-merge and group-by
    intermediates are O(rows) and fold into the output estimate."""
    if plan is None:
        return 0
    from ..ops.join import RESIDUAL_BLOCK_PAIRS

    total = 0
    for s in plan.joins:
        if s.algorithm == "match-matrix":
            pairs = s.left_rows * s.right_rows
            total += pairs  # bool mask
            if s.has_residual:
                block = min(pairs, RESIDUAL_BLOCK_PAIRS)
                total += pairs + 2 * OPERAND_BYTES * block
    return total


def stage_flops(plan: Optional[StagePlan], n_out_cols: int) -> float:
    """Order-of-magnitude FLOP/compare estimate per batch for one stage.

    Sorts count rows*log2(rows) per key column (the planner's group-by,
    distinct, sort-merge join and ORDER BY all lower to lexsorts);
    match-matrix joins count one compare per pair per conjunct;
    projections count one op per output element.
    """
    if plan is None:
        return 0.0
    n = plan.input_rows
    out = plan.output_rows
    flops = float(n) * max(n_out_cols, 1)  # projection/eval of outputs
    for s in plan.joins:
        if s.algorithm == "match-matrix":
            flops += float(s.left_rows) * s.right_rows * (
                s.n_eq_keys + (1 if s.has_residual else 0)
            )
        else:
            nm = s.left_rows + s.right_rows
            flops += nm * _log2(nm) * s.n_eq_keys + s.out_rows
    if plan.grouped:
        flops += n * _log2(n) * max(plan.group_keys, 1)
        flops += float(n) * max(plan.n_aggregates, 1)
    if plan.distinct:
        flops += n * _log2(n)
    if plan.order_keys:
        flops += out * _log2(out) * plan.order_keys
    return flops


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
    launches: int = 1,
) -> dict:
    """The ``latencyModel`` report block: per-stage roofline ms plus
    the batch-level decomposition the runtime stages map onto —
    ``decodeMs`` (the calibrated host-decode term over the input-stage
    rows), ``deviceStepMs`` (every stage's compute, one dispatch
    overhead a launch), ``d2hMs`` (the full-fetch output transfer),
    ``iciMs`` (the wire bytes over the calibrated link).
    ``stages``/``totals`` are dict-shaped (the conf-embedded runtime
    model). ``launches``: the kernels a step launches
    (``deviceplan.count_step_launches``); at 1, the JAX package's one
    jitted call, the formula is the reference's. Consumed by the host's
    DX520/DX521 predictions."""
    overhead_ms = (
        float(profile.get("dispatch_overhead_us") or 0.0) / 1000.0
        * max(1, int(launches))
    )
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
    ``constants.CPU_DEVICE_MEMORY_BYTES``. Each cache entry is priced with
    the byte model (``lq/warmcache.py``). Raises when ``device`` is a
    card and none is present."""
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


# ---------------------------------------------------------------------------
# Mesh collective wire-cost closed forms (the DX7xx tier,
# analysis/meshcheck.py). Two byte conventions, deliberately separate:
#
# - **result bytes**: the full logical size of a collective's result —
#   chip-count-INDEPENDENT, deterministic from static shapes, and the
#   quantity the analyzer asserts exactly equal between the closed-form
#   model and the Mesh-lowered program (the DX2xx `model ==
#   materialized` analog).
# - **wire bytes**: total bytes crossing ICI links across the whole
#   slice for a ring-algorithm collective over `result bytes` — the
#   Megatron-LM closed forms over chip count N. This is the term DX703
#   budgets and the runtime's Mesh_ICI_Bytes series observes.
#
# ring all-gather of S result bytes: each chip forwards (N-1) shard
# messages of S/N bytes -> total S*(N-1). ring all-reduce =
# reduce-scatter + all-gather -> 2*S*(N-1)/N per chip, total 2*S*(N-1).
# all-to-all keeps 1/N local -> total S*(N-1)/N.
# ---------------------------------------------------------------------------
def allgather_wire_bytes(result_bytes: float, chips: int) -> float:
    """Total slice-wide ICI bytes of a ring all-gather producing
    ``result_bytes`` on every chip."""
    if chips <= 1:
        return 0.0
    return float(result_bytes) * (chips - 1)


def allreduce_wire_bytes(result_bytes: float, chips: int) -> float:
    """Total slice-wide ICI bytes of a ring all-reduce (reduce-scatter
    + all-gather) over ``result_bytes``."""
    if chips <= 1:
        return 0.0
    return 2.0 * float(result_bytes) * (chips - 1)


def alltoall_wire_bytes(result_bytes: float, chips: int) -> float:
    """Total slice-wide ICI bytes of an all-to-all over
    ``result_bytes`` (1/N of every shard stays local)."""
    if chips <= 1:
        return 0.0
    return float(result_bytes) * (chips - 1) / chips


# wire factor per compiled-HLO collective op name — the same convention
# dist/mesh.py's runtime collective_summary applies, so the model and
# the observed Mesh_ICI_Bytes series can never disagree about what a
# byte over the ICI means
COLLECTIVE_WIRE_FACTORS = {
    "all-gather": allgather_wire_bytes,
    "all-reduce": allreduce_wire_bytes,
    "reduce-scatter": alltoall_wire_bytes,  # S*(N-1)/N: one shard stays
    "all-to-all": alltoall_wire_bytes,
    "collective-permute": lambda s, n: float(s),  # every byte moves once
}


def collective_wire_bytes(op: str, result_bytes: float, chips: int) -> float:
    """Wire bytes of one collective given its result bytes — shared by
    the DX7xx model and the runtime observation path."""
    fn = COLLECTIVE_WIRE_FACTORS.get(op)
    return fn(result_bytes, chips) if fn else float(result_bytes)


def mesh_runtime_model(
    totals: Dict[str, object], stages: Optional[list] = None,
) -> dict:
    """The sharding plan as a *runtime artifact*: the compact JSON slice
    of a mesh-plan report that config generation embeds into mesh jobs'
    confs (``datax.job.process.mesh.model``, the S660 stage) and the
    host's ``ConformanceMonitor`` judges the observed ``Mesh_ICI_Bytes``
    / ``Mesh_Reshard_Count`` series against (DX510/DX511)."""
    return {
        "totals": {
            "iciResultBytesPerBatch": totals.get("iciResultBytesPerBatch"),
            "iciWireBytesPerBatch": totals.get("iciWireBytesPerBatch"),
            "reshardCount": totals.get("reshardCount"),
            "chips": totals.get("chips"),
        },
        "stages": [
            {
                "name": s.get("name"),
                "axis": s.get("axis"),
                "iciWireBytes": s.get("iciWireBytes"),
                "reshards": s.get("reshards"),
            }
            for s in (stages or [])
        ],
    }


def ici_bytes_group(
    input_rows: int,
    group_keys: int,
    n_aggregates: int,
    groups: int,
    group_row_bytes: int,
    chips: int,
) -> float:
    """Expected ICI bytes/batch of one GROUP BY under the 1-D data-mesh
    layout (dist/mesh.py): rows shard, outputs replicate.

    - distributed sort (group_ids): each of the N rows' key + aggregated
      value elements crosses chips with probability (C-1)/C;
    - all-gather of the replicated [G]-row group output to every chip:
      G * row_bytes * (C-1).

    The second term is the one that scales with group cardinality G —
    the quantity bounded by ``process.maxgroups``.
    """
    if chips <= 1:
        return 0.0
    shuffle = (
        float(input_rows)
        * KEY_BYTES
        * (group_keys + n_aggregates)
        * (chips - 1)
        / chips
    )
    gather = float(groups) * group_row_bytes * (chips - 1)
    return shuffle + gather


def ici_bytes_join(
    left_rows: int,
    right_rows: int,
    n_eq_keys: int,
    out_rows: int,
    out_row_bytes: int,
    chips: int,
    match_matrix: bool = False,
    right_row_bytes: int = 0,
) -> float:
    """Expected ICI bytes/batch of one JOIN site.

    Sort-merge: the union gid sort shuffles (n+m) key elements like the
    group-by sort; match-matrix instead broadcasts the whole right table
    to every chip (the [n, m] compare needs it locally). Both then
    all-gather the capacity-bounded output — the term that scales with
    join fan-out F = out_rows.
    """
    if chips <= 1:
        return 0.0
    if match_matrix:
        shuffle = float(right_rows) * right_row_bytes * (chips - 1)
    else:
        shuffle = (
            float(left_rows + right_rows)
            * KEY_BYTES
            * n_eq_keys
            * (chips - 1)
            / chips
        )
    gather = float(out_rows) * out_row_bytes * (chips - 1)
    return shuffle + gather


def stage_ici_bytes(
    plan: Optional[StagePlan],
    out_row_bytes_: int,
    chips: int,
    right_row_bytes: Dict[str, int],
) -> float:
    """Total expected ICI bytes/batch for one stage at ``chips`` chips.

    ``right_row_bytes``: per right-table row bytes (match-matrix joins
    broadcast the right side). Projections/unions move nothing — rows
    stay sharded and the ops are elementwise.
    """
    if plan is None or chips <= 1:
        return 0.0
    total = 0.0
    for s in plan.joins:
        total += ici_bytes_join(
            s.left_rows,
            s.right_rows,
            s.n_eq_keys,
            s.out_rows,
            out_row_bytes_,
            chips,
            match_matrix=(s.algorithm == "match-matrix"),
            right_row_bytes=right_row_bytes.get(s.right_table, KEY_BYTES),
        )
    if plan.grouped:
        total += ici_bytes_group(
            plan.input_rows,
            plan.group_keys,
            plan.n_aggregates,
            plan.groups_bound,
            out_row_bytes_,
            chips,
        )
    return total
