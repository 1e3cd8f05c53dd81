"""Mask compaction: gather valid rows to the front with a static size."""

from __future__ import annotations

from typing import Tuple

import torch


def compact_indices(
    valid: torch.Tensor, out_capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of valid rows packed to the front.

    Returns (idx[out_capacity], out_valid[out_capacity]); gather columns
    with ``col[idx]`` after masking by out_valid. Rows beyond
    out_capacity drop (callers size capacity >= plausible counts).

    A prefix sum gives each valid row its output slot and one scatter
    writes the row numbers there: the shape never depends on the data,
    so nothing waits on the device (``torch.nonzero`` would).
    """
    n = valid.shape[0]
    pos = torch.cumsum(valid.to(torch.int32), 0) - 1
    # rows that are invalid or past the bound all land in one extra slot
    slot = torch.where(valid & (pos < out_capacity), pos, out_capacity)
    idx = torch.full(
        (out_capacity + 1,), -1, dtype=torch.int64, device=valid.device
    )
    idx.scatter_(0, slot, torch.arange(n, device=valid.device))
    idx = idx[:out_capacity]
    out_valid = idx >= 0
    return torch.where(out_valid, idx, 0), out_valid
