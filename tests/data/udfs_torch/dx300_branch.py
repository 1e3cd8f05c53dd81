"""DX300 fixture: data-dependent Python control flow on a device tensor."""

import torch

from data_accelerator_tpu_torch.udf.api import TorchUdf


def _bad_fn(x):
    if x.sum() > 0:  # Tensor.__bool__: a host sync every batch
        return x.to(torch.float32)
    return -x.to(torch.float32)


def bad() -> TorchUdf:
    return TorchUdf("branchy", _bad_fn, out_type="double")


def _clean_fn(x):
    y = x.to(torch.float32)
    return torch.where(x.sum() > 0, y, -y)


def clean() -> TorchUdf:
    return TorchUdf("branchy", _clean_fn, out_type="double")
