"""Time windows as device-resident ring buffers.

The reference implements ``TIMEWINDOW('5 minutes')`` by caching each
batch's filtered RDD in driver memory, evicting stale ones, and
re-unioning per batch (CommonProcessorFactory.scala:156-236,
TimeWindowHandler.scala:23-68). Here, as in the JAX package, a fixed ring
of K batch slots lives on the device as [K, capacity] column tensors;
each batch overwrites one slot, timestamps are kept relative to the
current batch base (shifted by the base delta each step), and a window
table is just the flattened ring masked by ``ts >= now - duration``.

The JAX step donates its rings so XLA updates them in place; here the
rings are updated in place outright, with the slot index and the rebase
delta as host integers, so the update needs no device-to-host read.

Windowed views (``DataXProcessedInput_5minutes``) are exposed to the
pipeline as plain input tables of capacity K*capacity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from ..compile.planner import TableData, ViewSchema


@dataclass
class WindowBuffers:
    """Ring of K batch slots: cols are [K, capacity]."""

    cols: Dict[str, torch.Tensor]
    valid: torch.Tensor  # [K, capacity]

    @property
    def slots(self) -> int:
        return int(self.valid.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[1])


def num_slots(max_window_s: float, watermark_s: float, interval_s: float) -> int:
    """Slots needed to retain max_window + watermark of history
    (the eviction horizon at CommonProcessorFactory.scala:185-194)."""
    return max(1, math.ceil((max_window_s + watermark_s) / max(interval_s, 1e-9))) + 1


def make_buffers(
    schema: ViewSchema, capacity: int, slots: int,
    device: "torch.device | str" = "cpu",
) -> WindowBuffers:
    dtypes = {"double": torch.float32, "boolean": torch.bool}
    cols = {
        c: torch.zeros((slots, capacity), dtype=dtypes.get(t, torch.int32), device=device)
        for c, t in schema.types.items()
    }
    return WindowBuffers(
        cols, torch.zeros((slots, capacity), dtype=torch.bool, device=device)
    )


def update_buffers(
    buf: WindowBuffers,
    batch: TableData,
    slot: int,
    delta_ms: int,
    ts_col: str,
) -> WindowBuffers:
    """Rebase stored timestamps to the new batch base, then overwrite the
    ring slot with the new batch — both in place. ``slot`` and
    ``delta_ms`` (new_base_ms - old_base_ms) are host integers."""
    for c, arr in buf.cols.items():
        if c == ts_col and delta_ms:
            arr.sub_(delta_ms)
        arr[slot] = batch.cols[c]
    buf.valid[slot] = batch.valid
    return buf


def window_table(
    buf: WindowBuffers,
    duration_ms: int,
    now_rel_ms: torch.Tensor,
    ts_col: str,
) -> TableData:
    """Flattened ring masked to the window span [now - duration, now].
    The columns are views of the ring, valid until its next update."""
    k, cap = buf.valid.shape
    ts = buf.cols[ts_col].reshape(k * cap)
    valid = buf.valid.reshape(k * cap)
    in_window = (ts >= (now_rel_ms - duration_ms)) & (ts <= now_rel_ms)
    cols = {c: a.reshape(k * cap) for c, a in buf.cols.items()}
    return TableData(cols, valid & in_window)
