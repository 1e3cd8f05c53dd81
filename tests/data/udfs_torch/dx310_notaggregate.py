"""DX310 fixture: conf declares a udaf whose target is not an
aggregate (no ``reduce``) — the reference's JarUDFHandler would have
rejected the registration; loading it blind gives wrong answers at the
first GROUP BY."""

import torch

from data_accelerator_tpu_torch.udf.api import TorchUdaf, TorchUdf


def bad() -> TorchUdf:
    # a scalar UDF declared under the udaf tier: no reduce
    return TorchUdf("lastval", lambda x: x.to(torch.float32), out_type="double")


def clean() -> TorchUdaf:
    def reduce(arg_arrays, seg, capacity, valid_s):
        from data_accelerator_tpu_torch.ops.groupby import segment_aggregate

        vals = arg_arrays[0].to(torch.float32)
        return segment_aggregate(vals, seg, capacity, "max", valid_s)

    return TorchUdaf("lastval", reduce, out_type="double")
