"""DX303 fixture: captured mutable state with no on_interval declared.

The bad twin closes over a dict and never declares a refresh hook. Eager
PyTorch reads the dict on every call, so an update lands in whatever
batch is running, with no batch boundary and no pipeline rebuild (the
JAX package would keep serving the traced value: DynamicUDF.onInterval
gap)."""

import torch

from data_accelerator_tpu_torch.udf.api import TorchUdf


def bad() -> TorchUdf:
    state = {"factor": 2.0}
    return TorchUdf(
        "scalest",
        lambda x: x.to(torch.float32) * state["factor"],
        out_type="double",
    )


def clean() -> TorchUdf:
    state = {"factor": 2.0}

    def refresh(batch_time_ms: int) -> bool:
        return False  # flip to True when state changes -> rebuild

    return TorchUdf(
        "scalest",
        lambda x: x.to(torch.float32) * state["factor"],
        out_type="double",
        on_interval=refresh,
    )
