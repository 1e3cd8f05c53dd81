"""User-defined function tiers.

reference: the extension API surface —
- ``DynamicUDF.Generator0..3`` + per-batch refresh
  (datax-core/.../extension/DynamicUDF.scala:32-45,
  ExtendedUDFHandler.scala:23-112) -> ``TorchUdf`` with ``on_interval``.
- plain JAR UDFs / UDAFs loaded by reflection
  (JarUDFHandler.scala:13-100, SparkJarLoader.scala:24-165) ->
  ``load_udfs_from_conf`` importing ``module:attr`` python paths from the
  same ``datax.job.process.jar.udf.<name>.*`` conf namespace.
- custom aggregates (UserDefinedAggregateFunction) -> ``TorchUdaf`` with
  a segment-reduce over sorted groups.
- the Scala-tier escape hatch for custom kernels -> ``CudaKernelUdf``
  (a hand-written CUDA kernel, with its plain PyTorch version on the CPU).
"""

from .api import (
    CudaKernelUdf,
    TorchUdaf,
    TorchUdf,
    UdfRegistry,
    load_udfs_from_conf,
)

__all__ = [
    "TorchUdf",
    "TorchUdaf",
    "CudaKernelUdf",
    "UdfRegistry",
    "load_udfs_from_conf",
]
