"""Capacity-bounded inner/left equi-join on torch tensors.

The port of the JAX package's ``ops/join.py``: Spark's shuffle-hash or
broadcast join (implicit in spark.sql for the reference's JOIN queries,
e.g. the refdata joins of HomeAutomationLocal.json) as two static-shape
formulations the planner chooses between per join site:

- **sort-merge** (``sort_join_indices``, the default for pure equi
  joins): dense group ids over the UNION of both sides' key tuples (one
  lexsort), then a searchsorted range lookup per left row and a
  searchsorted over the cumulative pair counts that expands the pairs
  into the fixed output capacity — O((n+m+cap)·log). This keeps the
  current batch x windowed table joins off the O(n·m) cliff.
- **match-matrix** (``inner_join_indices``/``left_join_indices``): the
  [n, m] outer comparison, kept for joins with non-equi residual ON
  terms, which need the full pair mask anyway. The residual is evaluated
  over blocks of left rows, so its gathers never hold more than
  ``RESIDUAL_BLOCK_PAIRS`` pairs at once.

Pair order is identical between the two and to the JAX package's:
left-major, right rows in their original index order (every sort is
stable). Every shape is static and nothing reads a value back to the
host: the pair total and the dropped count stay 0-d device tensors, and
the pairs compact with a prefix sum (``ops/compact.py``), never with
``torch.nonzero``. Index outputs are int64, ready for gathers.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .compact import compact_indices
from .groupby import group_ids

# the most (left row, right row) pairs one residual evaluation gathers
RESIDUAL_BLOCK_PAIRS = 1 << 22

Residual = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _match_matrix(
    left_keys: Sequence[torch.Tensor],
    right_keys: Sequence[torch.Tensor],
    left_valid: torch.Tensor,
    right_valid: torch.Tensor,
    residual: Optional[Residual],
) -> torch.Tensor:
    """The [n, m] pair mask: both rows valid, every key pair equal, and
    the residual true. The residual sees [b, m] index matrices for blocks
    of ``b`` left rows, in order, so the pair order stays left-major."""
    match = left_valid[:, None] & right_valid[None, :]
    for lk, rk in zip(left_keys, right_keys):
        match = match & (lk[:, None] == rk[None, :])
    if residual is None:
        return match
    n, m = match.shape
    dev = match.device
    rows = max(1, RESIDUAL_BLOCK_PAIRS // max(m, 1))
    ri = torch.arange(m, device=dev)
    parts = []
    for start in range(0, n, rows):
        li = torch.arange(start, min(n, start + rows), device=dev)
        b = li.shape[0]
        parts.append(residual(li[:, None].expand(b, m), ri[None, :].expand(b, m)))
    return match & torch.cat(parts)


def _dropped(total: torch.Tensor, out_capacity: int) -> torch.Tensor:
    """Pairs past the capacity bound, as a 0-d int32 tensor."""
    return torch.clamp(total - out_capacity, min=0).to(torch.int32)


def inner_join_indices(
    left_keys: Sequence[torch.Tensor],
    right_keys: Sequence[torch.Tensor],
    left_valid: torch.Tensor,
    right_valid: torch.Tensor,
    out_capacity: int,
    residual: Optional[Residual] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (left_idx[out], right_idx[out], valid[out], dropped) of
    matching pairs.

    left_keys/right_keys: sequences of [n] / [m] tensors (conjunctive
    equality). ``residual``: optional extra predicate evaluated pairwise
    on (left row index matrix, right row index matrix) -> bool of the
    same shape, for non-equi ON terms.

    Pairs beyond ``out_capacity`` are dropped; ``dropped`` (0-d int32)
    counts them, and the planner rides it through to the runtime so the
    flow emits ``Output_<n>_JoinRowsDropped`` rather than failing.
    """
    m = right_valid.shape[0]
    flat = _match_matrix(
        left_keys, right_keys, left_valid, right_valid, residual
    ).reshape(-1)
    dropped = _dropped(flat.sum(dtype=torch.int32), out_capacity)
    pair_idx, valid = compact_indices(flat, out_capacity)
    return pair_idx // m, pair_idx % m, valid, dropped


def left_join_indices(
    left_keys: Sequence[torch.Tensor],
    right_keys: Sequence[torch.Tensor],
    left_valid: torch.Tensor,
    right_valid: torch.Tensor,
    out_capacity: int,
    residual: Optional[Residual] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """LEFT OUTER variant: also emits unmatched left rows once.

    Returns (left_idx, right_idx, valid, right_is_null, dropped): where
    ``right_is_null`` marks rows whose right side carries no match (the
    caller nulls their right columns) and ``dropped`` (0-d int32) counts
    output rows lost to the capacity bound.
    """
    n = left_valid.shape[0]
    m = right_valid.shape[0]
    match = _match_matrix(left_keys, right_keys, left_valid, right_valid, residual)
    unmatched = left_valid & ~match.any(dim=1)
    # matched pairs followed by unmatched-left singles, in one index
    # space: pair space [n*m], then singles space [n]
    flat = torch.cat([match.reshape(-1), unmatched])
    dropped = _dropped(flat.sum(dtype=torch.int32), out_capacity)
    idx, valid = compact_indices(flat, out_capacity)
    is_single = idx >= n * m
    pair_idx = torch.where(is_single, 0, idx)
    left_idx = torch.where(is_single, idx - n * m, pair_idx // m)
    right_idx = torch.where(is_single, 0, pair_idx % m)
    return left_idx, right_idx, valid, is_single, dropped


def _union_gids(left_keys, right_keys, left_valid, right_valid):
    """Dense key-tuple ids across both sides: equal tuples (any mix of
    key columns and types) get equal ids; invalid rows get per-side
    sentinels (-1 left, -2 right) that never match anything."""
    keys = [torch.cat([lk, rk]) for lk, rk in zip(left_keys, right_keys)]
    valid = torch.cat([left_valid, right_valid])
    order, seg, _num, _first = group_ids(keys, valid)
    gid = torch.empty_like(seg).scatter_(0, order, seg)
    n = left_valid.shape[0]
    gl = torch.where(left_valid, gid[:n], -1)
    gr = torch.where(right_valid, gid[n:], -2)
    return gl, gr


def sort_join_indices(
    left_keys: Sequence[torch.Tensor],
    right_keys: Sequence[torch.Tensor],
    left_valid: torch.Tensor,
    right_valid: torch.Tensor,
    out_capacity: int,
    left_outer: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-merge equi-join (no residual: the planner keeps the match
    matrix for those).

    Returns (left_idx, right_idx, valid, right_is_null, dropped), the
    LEFT OUTER surface; for inner joins ``right_is_null`` is all False.
    Per left row, its matching right rows occupy a contiguous range of
    the gid-sorted right side, found with two searchsorteds; output slots
    map back to (left row, offset) through a searchsorted over the
    inclusive cumulative pair counts.
    """
    n = left_valid.shape[0]
    m = right_valid.shape[0]
    dev = left_valid.device
    gl, gr = _union_gids(left_keys, right_keys, left_valid, right_valid)
    r_order = torch.sort(gr, stable=True).indices
    gr_s = gr[r_order]
    lo = torch.searchsorted(gr_s, gl)
    hi = torch.searchsorted(gr_s, gl, right=True)
    matches = torch.where(left_valid, hi - lo, 0)
    if left_outer:
        # an unmatched valid left row emits one null-right row
        cnt = torch.where(left_valid, torch.clamp(matches, min=1), 0)
    else:
        cnt = matches
    cum = torch.cumsum(cnt, 0)
    total = cum[-1]
    starts = cum - cnt
    j = torch.arange(out_capacity, device=dev)
    li = torch.searchsorted(cum, j, right=True)
    valid_out = j < total
    li_c = torch.clamp(li, 0, n - 1)
    offset = j - starts[li_c]
    is_null = valid_out & (matches[li_c] == 0) if left_outer else torch.zeros_like(valid_out)
    rpos = torch.clamp(lo[li_c] + offset, 0, m - 1)
    ri = r_order[rpos]
    left_idx = torch.where(valid_out, li_c, 0)
    right_idx = torch.where(valid_out & ~is_null, ri, 0)
    return left_idx, right_idx, valid_out, is_null, _dropped(total, out_capacity)
