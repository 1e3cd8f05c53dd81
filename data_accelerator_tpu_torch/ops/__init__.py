"""Columnar primitives over fixed-capacity masked batches, on torch
tensors: static-shape, mask-aware, and free of host syncs."""

from .compact import compact_indices
from .groupby import distinct_mask, group_ids, segment_aggregate
from .join import inner_join_indices, left_join_indices, sort_join_indices

__all__ = [
    "group_ids",
    "segment_aggregate",
    "distinct_mask",
    "compact_indices",
    "inner_join_indices",
    "left_join_indices",
    "sort_join_indices",
]
