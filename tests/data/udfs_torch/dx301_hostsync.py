"""DX301 fixture: host sync point on a device tensor."""

import torch

from data_accelerator_tpu_torch.udf.api import TorchUdf


def _bad_fn(x):
    mu = float(x[0])  # reads the tensor back to the host every batch
    return x.to(torch.float32) * mu


def bad() -> TorchUdf:
    return TorchUdf("scalemu", _bad_fn, out_type="double")


def _clean_fn(x):
    mu = x[0].to(torch.float32)  # stays on the device
    return x.to(torch.float32) * mu


def clean() -> TorchUdf:
    return TorchUdf("scalemu", _clean_fn, out_type="double")
