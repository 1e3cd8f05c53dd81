"""DX305 fixture: CUDA launch hazards at a user-written cuda_call.

The UDF's body is its own kernel, ``dx305_double.cu`` beside this
module. The bad twin derives the grid from tensor CONTENTS (a host read
of ``x[0]`` every batch) and omits ``out_shape``, which ``cuda_call``
requires. The clean twin derives everything from static ``.shape`` and
passes the output shape."""

from pathlib import Path

import torch

from data_accelerator_tpu_torch.kernels.launch import cuda_call
from data_accelerator_tpu_torch.udf.api import CudaKernelUdf

SOURCE = Path(__file__).with_name("dx305_double.cu")
ENTRY = "dx305_double"


def double_plain(x):
    """The kernel's plain version, for the CPU path and the checks."""
    return torch.mul(x.to(torch.float32), 2.0)


def _bad_kernel(x):
    g = int(x[0]) + 1  # grid from tensor contents: a host read
    return cuda_call(SOURCE, ENTRY, x, grid=(g,))


def bad() -> CudaKernelUdf:
    return CudaKernelUdf("pdouble", _bad_kernel, double_plain, out_type="double")


def _clean_kernel(x):
    # n = x.numel() rows, from the tensor's metadata: no device read
    return cuda_call(SOURCE, ENTRY, x, out_shape=x.shape, out_dtype=torch.float32)


def clean() -> CudaKernelUdf:
    return CudaKernelUdf(
        "pdouble", _clean_kernel, double_plain, out_type="double"
    )
