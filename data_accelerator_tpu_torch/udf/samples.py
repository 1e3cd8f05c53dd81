"""Sample UDFs: one per extension tier.

reference: datax-udf-samples/.../{udf/UdfHelloWorld,
udaf/UdafLastThreshold,dynamicudf/DynamicUdfHelloWorld,
normalizer/RemoveInvalidChars}.scala — the reference implementations of
all four extension interfaces, used by its tests and docs. These are the
conf-loadable equivalents
(class = data_accelerator_tpu_torch.udf.samples:<attr>).
"""

from __future__ import annotations

import torch

from ..compile.exprs import HostStr, is_device
from ..core.config import EngineException
from ..kernels.anomaly_score import AnomalyScoreKernel, anomaly_score_plain
from .api import CudaKernelUdf, TorchUdaf, TorchUdf


class HelloWorldUdf:
    """String-tier sample: ``hello(name)`` -> "Hello <name>".

    reference: UdfHelloWorld.scala — returns a device-deferred string
    template (strings materialize at the sink boundary, so arbitrary
    string construction stays off the device hot path).
    """

    name = "hello"
    is_aggregate = False

    def on_interval(self, batch_time_ms: int) -> bool:
        return False

    def compile_call(self, compiler, e):
        if len(e.args) != 1:
            raise EngineException("hello() takes one argument")
        arg = compiler.compile(e.args[0])
        if not is_device(arg):
            raise EngineException("hello() requires a device argument")
        return HostStr(parts=["Hello ", arg], deps=arg.deps)


def _scale_udf() -> TorchUdf:
    """Dynamic-tier sample: ``scaleby(x)`` multiplies by a factor that
    refreshes per interval (DynamicUdfHelloWorld.scala semantics: the
    generator's initialization captures state refreshed by onInterval)."""
    state = {"factor": 2.0, "refreshes": 0}

    def refresh(batch_time_ms: int) -> bool:
        state["refreshes"] += 1
        return False  # factor stable; flip to True when state changes

    return TorchUdf(
        "scaleby",
        lambda x: x.to(torch.float32) * state["factor"],
        out_type="double",
        on_interval=refresh,
    )


scaleby = _scale_udf


def _last_over_threshold(threshold: float = 0.0) -> TorchUdaf:
    """UDAF sample: latest value (by event time) above a threshold within
    each group. reference: UdafLastThreshold.scala:12-58 (stateful
    last-value-by-time aggregate)."""

    def reduce(arg_arrays, seg, capacity, valid_s):
        from ..ops.groupby import INT32_MIN, segment_aggregate

        value, ts = arg_arrays[0], arg_arrays[1]
        ok = valid_s & (value > threshold)
        ts_ok = torch.where(ok, ts.to(torch.int32), INT32_MIN)
        max_ts = segment_aggregate(ts_ok, seg, capacity, "max", valid_s)
        at_max = ok & (
            ts.to(torch.int32) == max_ts[seg.clamp(0, capacity - 1).long()]
        )
        v = torch.where(at_max, value.to(torch.float32), float("-inf"))
        out = segment_aggregate(v, seg, capacity, "max", valid_s)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))

    return TorchUdaf("lastabove", reduce, out_type="double")


lastabove = _last_over_threshold


def anomalyscore() -> CudaKernelUdf:
    """Kernel-tier sample: per-row anomaly score
    ``sigmoid(|x - mu| / (1 + |mu|))``, the hand-written CUDA kernel in
    csrc/anomaly_score.cu (the JAX package's Pallas ``_anomaly_kernel``),
    standing in for the reference's custom-Scala scoring UDFs."""
    return CudaKernelUdf(
        "anomalyscore", AnomalyScoreKernel(), anomaly_score_plain,
        out_type="double",
    )


def remove_invalid_chars(raw: str) -> str:
    """Normalizer-tier sample: strip control chars from raw event text
    before JSON parse. reference: RemoveInvalidChars.scala
    (StringNormalizer trait)."""
    return "".join(ch for ch in raw if ch >= " " or ch in "\t")
