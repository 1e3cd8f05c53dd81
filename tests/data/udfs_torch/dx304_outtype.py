"""DX304 fixture: declared out_type disagrees with the return dtype.

The bad twin declares ``long`` but computes a float — the pipeline
decodes the column through the declared type and silently truncates
(0.5*5 -> 2, not 2.5), which the runtime ground-truth test asserts."""

import torch

from data_accelerator_tpu_torch.udf.api import TorchUdf


def _half(x):
    return x.to(torch.float32) * 0.5


def bad() -> TorchUdf:
    return TorchUdf("halfit", _half, out_type="long")


def clean() -> TorchUdf:
    return TorchUdf("halfit", _half, out_type="double")
