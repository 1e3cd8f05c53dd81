"""Sort-based GROUP BY for fixed-capacity masked batches.

The same static-shape pipeline as the JAX package's ``ops/groupby.py``:

  1. sort rows by (invalid-last, key columns), stable
  2. flag segment boundaries, prefix-sum into dense group ids
  3. segmented reductions into a capacity-sized output

All shapes are static; invalid rows sort to the end and land in a dummy
trailing segment that the output mask hides. Group count <= row count, so
output capacity == input capacity is always sufficient.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1


def _as_sortable(col: torch.Tensor) -> torch.Tensor:
    """Make a column usable as a sort key (bool/float -> int bits)."""
    if col.dtype == torch.bool:
        return col.to(torch.int32)
    if col.is_floating_point():
        # total order on floats via the sign-magnitude bit trick
        bits = col.to(torch.float32).view(torch.int32)
        return torch.where(bits < 0, INT32_MIN - bits, bits)
    return col.to(torch.int32)


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: the permutation sorting by every key, the LAST key
    primary, ties kept in input order. Composed from stable sorts, least
    significant key first."""
    keys = list(keys)
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def group_ids(
    keys: Sequence[torch.Tensor], valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute dense group ids for the masked rows.

    Returns (order, gids_sorted, num_groups, first_in_group):
    - order: [n] permutation sorting rows by (valid desc, keys)
    - gids_sorted: [n] int32 dense group id per *sorted* position; invalid
      rows get id ``num_groups`` (a trailing dummy segment)
    - num_groups: int32 scalar tensor, the count of real groups
    - first_in_group: [n] bool, True at the first sorted row of each group
    """
    keys = list(keys)
    n = valid.shape[0]
    sort_keys: List[torch.Tensor] = [_as_sortable(k) for k in reversed(keys)]
    # primary key: invalid rows last (the last key is primary)
    sort_keys.append(torch.where(valid, 0, 1).to(torch.int32))
    order = lexsort(sort_keys)

    valid_s = valid[order]
    boundary = torch.zeros((n,), dtype=torch.bool, device=valid.device)
    head = torch.ones((1,), dtype=torch.bool, device=valid.device)
    for k in keys:
        ks = k[order]
        boundary = boundary | torch.cat([head, ks[1:] != ks[:-1]])
    # only valid rows start groups; the first invalid row starts the dummy
    first_invalid = torch.cat(
        [~valid_s[:1], valid_s[1:] != valid_s[:-1]]
    )
    boundary = (boundary & valid_s) | (first_invalid & ~valid_s)
    # position 0 is always a boundary (group 0 or the dummy); a cat, as
    # assigning a Python scalar into a CUDA tensor is a blocking copy
    boundary = torch.cat([head, boundary[1:]])

    seg = (torch.cumsum(boundary.to(torch.int32), 0) - 1).to(torch.int32)
    first_in_group = boundary & valid_s
    num_groups = first_in_group.sum(dtype=torch.int32)
    return order, seg, num_groups, first_in_group


def segment_aggregate(
    values,
    seg: torch.Tensor,
    capacity: int,
    op: str,
    valid_s: torch.Tensor,
) -> torch.Tensor:
    """Aggregate sorted ``values`` per segment id into [capacity] output.

    op: "sum" | "min" | "max" | "count" | "any" | "all"
    Invalid rows must already carry the op's identity or sit in the dummy
    trailing segment. Segments at or past ``capacity`` drop, as
    ``jax.ops.segment_*`` drops out-of-range ids; an empty segment holds
    the op's identity (0, +inf/INT32_MAX for min, -inf/INT32_MIN for max).
    """
    num_segments = capacity + 1  # one extra dummy slot
    # invalid rows and groups past the bound all fall into the dummy slot
    ids = torch.where(valid_s, seg, capacity).clamp(max=capacity).to(torch.int64)
    dev = seg.device
    if op == "count":
        out = torch.zeros((num_segments,), dtype=torch.int32, device=dev)
        out.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    elif op == "sum" and values.is_floating_point():
        # float sums accumulate in float64: the scatter adds in an order
        # that differs by device and run, and float32 partial sums of a
        # large window would differ in their fifth digit
        out = torch.zeros((num_segments,), dtype=torch.float64, device=dev)
        out.scatter_add_(0, ids, values.to(torch.float64))
        out = out.to(values.dtype)
    elif op == "sum":
        out = torch.zeros((num_segments,), dtype=values.dtype, device=dev)
        out.scatter_add_(0, ids, values)
    elif op in ("min", "max", "any", "all"):
        if op in ("any", "all"):
            values = values.to(torch.int32)
        low = op in ("min", "all")
        if values.is_floating_point():
            ident = float("inf") if low else float("-inf")
        else:
            ident = INT32_MAX if low else INT32_MIN
        out = torch.full((num_segments,), ident, dtype=values.dtype, device=dev)
        out.scatter_reduce_(0, ids, values, "amin" if low else "amax")
        if op in ("any", "all"):
            out = out.to(torch.bool)
    else:
        raise ValueError(f"unknown aggregate op {op!r}")
    return out[:capacity]


def distinct_mask(keys: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """Mask keeping one representative row per distinct key combination.

    Used for SELECT DISTINCT: rows stay in place (no reordering); the
    first occurrence in sort order survives.
    """
    order, _seg, _num, first = group_ids(keys, valid)
    keep = torch.zeros_like(valid)
    keep[order] = first
    return keep & valid
