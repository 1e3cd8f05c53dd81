"""Multi-host ingest: per-host feeds assembled into one sharded batch.

reference role: EventHub/Kafka partitions are consumed by whichever
executor holds them and rows live where they land; Spark's shuffle
repairs placement later (SURVEY §2.3 P1/C2). Each host process ingests
its own slice of the stream (its SocketSource port / its Kafka
partition set), encodes rows into the row range its devices own, and
the global batch is assembled WITHOUT any cross-host data movement.

Partition assignment mirrors the reference's EventProcessorHost lease
model (partitions balanced across consumers): partition p belongs to
host ``p % process_count``.

A port of the JAX package's ``dist/ingest.py`` over
``torch.distributed``. A host's index and count are the rank and world
size of the initialized default process group (0 and 1 without one);
explicit arguments win, as in the reference. The JAX package stamps the
hosts' local shards as one global ``jax.Array``; the port's mesh is one
process's devices (``dist/mesh.py``), so a host's batch is its own rows
placed on its own mesh devices, one row range each, with the global row
count and this host's range of it beside them (``GlobalBatch``).
Results that need the other hosts' rows come from the group's
collectives (``GlobalBatch.all_reduce``): gloo on the CPU, NCCL on
cards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..compile.planner import TableData
from .mesh import Mesh, row_sharding


def _group_rank_size():
    """(rank, world size) of the initialized default process group, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _index(process_index: Optional[int]) -> int:
    return _group_rank_size()[0] if process_index is None else process_index


def _count(process_count: Optional[int]) -> int:
    return _group_rank_size()[1] if process_count is None else process_count


def assigned_partitions(
    n_partitions: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[int]:
    """Stream partitions this host consumes (lease-balance analog)."""
    pi, pc = _index(process_index), _count(process_count)
    return [p for p in range(n_partitions) if p % pc == pi]


def local_row_range(
    mesh: Mesh, global_rows: int, process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> range:
    """The [start, stop) range of a globally row-sharded batch that this
    host's mesh devices own: every host holds a mesh of the same size,
    so host ``pi`` owns the ``pi``-th of ``process_count`` equal ranges.
    Hosts encode ONLY these rows."""
    pi, pc = _index(process_index), _count(process_count)
    per_device, rem = divmod(global_rows, pc * mesh.size)
    if rem:
        raise ValueError(
            f"{global_rows} rows do not divide over {pc} hosts x "
            f"{mesh.size} devices"
        )
    step = per_device * mesh.size
    return range(pi * step, (pi + 1) * step)


@dataclass
class GlobalBatch:
    """One host's part of a global batch: its rows as one shard per
    mesh device (``row_sharding``), the global row count and this
    host's range of it."""

    mesh: Mesh
    shards: List[TableData]
    global_rows: int
    rows: range

    def local(self) -> TableData:
        """This host's rows whole, on its first mesh device (a local
        concatenation: no cross-host copy)."""
        dev = self.mesh.devices[0]
        cols = {
            c: torch.cat([s.cols[c].to(dev) for s in self.shards])
            for c in self.shards[0].cols
        }
        return TableData(cols, torch.cat([s.valid.to(dev) for s in self.shards]))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` (this host's partial result) reduced over every host of
        the default process group by its backend's all-reduce, in place;
        with no group (one host) ``t`` itself."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(t, op=red)
        return t


def global_batch_from_local(
    mesh: Mesh,
    local_cols: Dict[str, np.ndarray],
    local_valid: np.ndarray,
    global_rows: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> GlobalBatch:
    """This host's part of the globally row-sharded batch from its
    locally ingested rows: each column split into one row range per
    mesh device and placed there (no cross-host transfer: every host
    calls this with its own rows)."""
    sharding = row_sharding(mesh)

    def put(a: np.ndarray) -> List[torch.Tensor]:
        return sharding.shard(torch.as_tensor(np.ascontiguousarray(a)))

    cols = {c: put(v) for c, v in local_cols.items()}
    valid = put(np.asarray(local_valid, dtype=bool))
    shards = [
        TableData({c: parts[i] for c, parts in cols.items()}, valid[i])
        for i in range(mesh.size)
    ]
    return GlobalBatch(
        mesh, shards, global_rows,
        local_row_range(mesh, global_rows, process_index, process_count),
    )


class HostIngestPlan:
    """One host's slice of the ingest work for a flow.

    Carries what the control plane computes per host at job-config
    time: which stream partitions to consume, how many of the global
    batch rows to encode, and the per-host rate share of the flow's
    maxRate (EventHubStreamingFactory.scala:43's rate limiter, split
    across hosts).
    """

    def __init__(
        self,
        mesh: Mesh,
        global_capacity: int,
        n_partitions: int,
        max_rate: float,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.mesh = mesh
        self.global_capacity = global_capacity
        self.process_index = _index(process_index)
        self.process_count = _count(process_count)
        self.partitions = assigned_partitions(
            n_partitions, self.process_index, self.process_count
        )
        self.rows = local_row_range(
            mesh, global_capacity, self.process_index, self.process_count
        )
        self.local_capacity = len(self.rows)
        self.max_rate = max_rate / max(1, self.process_count)

    def make_global(
        self, local_cols: Dict[str, np.ndarray], local_valid: np.ndarray
    ) -> GlobalBatch:
        if len(local_valid) != self.local_capacity:
            raise ValueError(
                f"host shard must be exactly {self.local_capacity} rows, "
                f"got {len(local_valid)}"
            )
        return global_batch_from_local(
            self.mesh, local_cols, local_valid, self.global_capacity,
            self.process_index, self.process_count,
        )
