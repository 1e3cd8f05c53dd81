"""DX302 fixture: impure device function mutating captured state.

The bad twin appends to a module-level list per call. Eager PyTorch runs
the append on every batch (the JAX package runs it once, at trace time):
either way the function's result depends on state outside the batch."""

import torch

from data_accelerator_tpu_torch.udf.api import TorchUdf

CALLS = []  # noqa: the captured state the bad twin mutates


def _bad_fn(x):
    CALLS.append(1)  # a side effect per call
    return x.to(torch.float32) * 2.0


def bad() -> TorchUdf:
    return TorchUdf("doubler", _bad_fn, out_type="double")


def _clean_fn(x):
    return x.to(torch.float32) * 2.0


def clean() -> TorchUdf:
    return TorchUdf("doubler", _clean_fn, out_type="double")
