"""Mesh execution: the device mesh, its sharding layout and the
multi-host ingest plan. Exports what the JAX package's
``dist/__init__.py`` does."""

from .ingest import (
    HostIngestPlan,
    assigned_partitions,
    global_batch_from_local,
    local_row_range,
)
from .mesh import (
    DATA_AXIS,
    make_mesh,
    replicated,
    ring_sharding,
    row_sharding,
    step_shardings,
)

__all__ = [
    "DATA_AXIS",
    "HostIngestPlan",
    "assigned_partitions",
    "global_batch_from_local",
    "local_row_range",
    "make_mesh",
    "replicated",
    "ring_sharding",
    "row_sharding",
    "step_shardings",
]
