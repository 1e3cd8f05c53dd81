"""Device mesh + sharding layout for the flow step.

The reference scales by partitioning RDDs across Spark executors and
letting Spark's shuffle service move rows for GROUP BY/JOIN
(CommonProcessorFactory.scala:405-421; shuffle implicit in the
``spark.sql`` calls at :257,271). The JAX package's equivalent is one
``jax.sharding.Mesh`` with a single ``data`` axis, and this module keeps
its layout:

- micro-batch rows shard over ``data`` (the executor-partition analog);
- window ring buffers ``[slots, capacity]`` shard their *capacity* dim
  over ``data`` so each device retains only its shard of window history;
- reference/state tables replicate (they are small and join-broadcast,
  like Spark broadcast joins);
- outputs replicate.

A port of the JAX package's ``dist/mesh.py``. PyTorch has no SPMD
partitioner, so where the JAX package hands one jitted program and
these shardings to GSPMD, the port runs the partitioning itself, in one
process over an ordered tuple of torch devices (``Mesh``; a device may
repeat, so one card or the CPU can hold several virtual shards):

- a tensor sharded over ``data`` is a list of per-device tensors, one
  row range (or, for a ring, one capacity range) each, in mesh order;
  a replicated one is one tensor per distinct device;
- the step (``runtime/processor.py::build_mesh_step_fn``) runs a view
  per shard when its rows can be split, and otherwise — a *collective*
  stage, by the rule the JAX package's mesh analyzer applies
  (``is_collective_view``) — gathers its sharded inputs and runs it
  once per distinct device, where GSPMD would insert the collectives;
- every gather and reduction the step makes adds its op kind and its
  logical result bytes to the step's ``MeshCollectives``. There is no
  HLO to parse, so ``collective_summary`` has no counterpart: the census
  is what the port's own collectives record as they run.

Byte convention (the reference's): a collective's result bytes are the
full logical size of its result, independent of the chip count; wire
bytes apply the ring closed forms (``analysis/costmodel.py
collective_wire_bytes``) per op kind.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[i]`` holds shard ``i`` of every tensor
    sharded over ``axis_name``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device once, in mesh order: where a replicated tensor
        lives and a replicated stage runs."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axis_name: str = DATA_AXIS,
) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default:
    every visible CUDA card). ``devices`` may repeat a device, which
    then holds several virtual shards (``("cpu",) * 8`` is the
    counterpart of the JAX package's 8 virtual CPU devices). Raises
    ``RuntimeError`` when no card is visible and no ``devices`` are
    given, and ``ValueError`` when ``n_devices`` exceeds them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible (pass devices=, e.g. "
                "('cpu',) * n, to build a mesh on the CPU)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), axis_name)


@dataclass(frozen=True)
class Sharding:
    """A ``NamedSharding`` analog: ``spec[d]`` names the mesh axis dim
    ``d`` shards over (None: whole); an empty spec replicates."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    @property
    def dim(self) -> Optional[int]:
        """The dim sharded over the data axis, or None (replicated)."""
        for d, axis in enumerate(self.spec):
            if axis is not None:
                return d
        return None

    def shard(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` laid out under this sharding: per mesh device its range
        of the sharded dim (a view where it already lies there), or,
        replicated, one tensor per distinct device."""
        dim = self.dim
        if dim is None:
            return [_on(t, d) for d in self.mesh.distinct_devices]
        n = self.mesh.size
        if t.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of size {t.shape[dim]} does not divide over "
                f"{n} devices"
            )
        return [_on(p, d) for p, d in zip(t.chunk(n, dim), self.mesh.devices)]


def row_sharding(mesh: Mesh) -> Sharding:
    """Rows of a [capacity] column shard over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def ring_sharding(mesh: Mesh) -> Sharding:
    """Window ring cols are [slots, capacity]: shard capacity."""
    return Sharding(mesh, (None, DATA_AXIS))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def step_shardings(mesh: Mesh):
    """(in_shardings, out_shardings) of ``FlowProcessor``'s step
    signature, as in the JAX package:

    in:  (raw tables per source — rows shard, rings per windowed table —
          capacity dim shards, state, refdata, base_s, now_rel_ms,
          counter, delta_ms, aux string-op dictionary tables —
          replicated)
    out: (datasets, new_rings, new_state, counts_vec)
    """
    row = row_sharding(mesh)
    ring = ring_sharding(mesh)
    rep = replicated(mesh)
    in_shardings = (row, ring, rep, rep, rep, rep, rep, rep, rep)
    out_shardings = (rep, ring, rep, rep)
    return in_shardings, out_shardings


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def is_collective_view(view) -> bool:
    """True when a compiled view's lowering needs its input rows whole:
    grouping/distinct sort, a join, a global ORDER BY / LIMIT, a
    host-side finishing sort, a multi-branch union concat, or a
    kernel-UDF call (a hand-written kernel sees whole columns, as a
    Pallas custom call has no SPMD rule). The rule of the JAX package's
    ``analysis/meshcheck.py::_is_collective_view``."""
    p = view.plan
    if view.host_order:
        return True
    if p is None:
        return False
    return bool(
        p.grouped or p.joins or p.distinct or p.order_keys
        or p.limit is not None or p.union_branches > 1
        or p.unshardable_udfs
    )


# ---------------------------------------------------------------------------
# Observed collective communication: what the mesh step actually moved.
#
# The port's gathers and reductions record themselves as they run, so
# the census is the executed program's, batch by batch. Two consumers,
# one convention (the JAX package's):
#
# - the runtime (`FlowProcessor` under a mesh) exports the census per
#   batch as the `Mesh_ICI_Bytes` / `Mesh_Reshard_Count` series;
# - the DX7xx mesh analyzer (`analysis/meshcheck.py`) models it
#   statically, and its cross-check holds one step's census against
#   the model, gather by gather.
#
# Byte convention: `result_bytes` per collective = the full logical
# size of the op's result (chip-count-independent). Wire bytes apply
# the ring closed forms per op kind.
# ---------------------------------------------------------------------------
# the name the step's all-reduce of the counts vector records
COUNTS_TABLE = "counts"


@dataclass
class MeshCollectives:
    """Census of the collectives one mesh step ran."""

    # (op kind, table, result bytes) per collective, in the order they
    # ran: the table a gather brought whole, or COUNTS_TABLE
    log: List[Tuple[str, str, int]] = field(default_factory=list)

    def record(self, op: str, result_bytes: int, table: str = "") -> None:
        self.log.append((op, table, int(result_bytes)))

    @property
    def ops(self) -> Dict[str, Tuple[int, int]]:
        """Op kind -> (op count, total result bytes)."""
        out: Dict[str, Tuple[int, int]] = {}
        for op, _table, b in self.log:
            c, total = out.get(op, (0, 0))
            out[op] = (c + 1, total + b)
        return out

    @property
    def op_count(self) -> int:
        return len(self.log)

    @property
    def result_bytes(self) -> int:
        return sum(b for _op, _table, b in self.log)

    def wire_bytes(self, chips: int) -> float:
        """Total mesh-wide interconnect bytes per execution under the
        ring closed forms (the Mesh_ICI_Bytes unit)."""
        from ..analysis.costmodel import collective_wire_bytes

        return sum(
            collective_wire_bytes(op, b, chips)
            for op, (_c, b) in self.ops.items()
        )

    def to_dict(self) -> dict:
        return {
            op: {"count": c, "resultBytes": b}
            for op, (c, b) in sorted(self.ops.items())
        }


def logical_nbytes(t: torch.Tensor) -> int:
    """A tensor's logical size: every element, broadcast ones included."""
    return t.numel() * t.element_size()
