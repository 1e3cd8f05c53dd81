"""UDF tier implementations: torch scalar UDFs, custom aggregates,
hand-written CUDA kernels, and conf-driven loading.

Contract with the expression compiler (compile/exprs.py): a UDF is an
object with ``compile_call(compiler, func_ast) -> Value``; aggregate
UDFs additionally set ``is_aggregate`` and provide ``reduce(arg_arrays,
seg, capacity, valid_s)`` (consumed by the group-by planner). Device
functions must be pure functions of their tensors — per-batch refresh
state arrives through ``on_interval``, which rebuilds the step's
pipeline when it reports change (the reference's
``DynamicUDF.onInterval`` refreshed broadcast variables the same way,
ExtendedUDFHandler.scala:39 + CommonProcessorFactory.scala:351-353).
"""

from __future__ import annotations

import importlib
import logging
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..core.config import EngineException, SettingDictionary
from ..kernels.launch import meta_kernel_call

logger = logging.getLogger(__name__)


class TorchUdf:
    """Scalar (row-wise) device UDF: ``fn(*tensors) -> tensor``.

    ``out_type``: result type name, or callable(arg_types)->type.
    ``on_interval``: optional ``fn(batch_time_ms) -> bool`` returning
    True when captured state changed (forces a pipeline rebuild).
    reference: DynamicUDF.Generator0..3 (arity implied by the SQL call).
    """

    is_aggregate = False

    def __init__(
        self,
        name: str,
        fn: Callable,
        out_type: Union[str, Callable[[List[str]], str]] = "double",
        on_interval: Optional[Callable[[int], bool]] = None,
    ):
        self.name = name
        self.fn = fn
        self.out_type = out_type
        self._on_interval = on_interval

    def on_interval(self, batch_time_ms: int) -> bool:
        if self._on_interval is None:
            return False
        return bool(self._on_interval(batch_time_ms))

    def compile_call(self, compiler, e):
        from ..compile.exprs import CompiledExpr, is_device

        args = [compiler.compile(a) for a in e.args]
        bad = [a for a in args if not is_device(a)]
        if bad:
            raise EngineException(
                f"UDF {self.name} requires device-typed arguments"
            )
        arg_types = [a.type for a in args]
        out_t = (
            self.out_type(arg_types) if callable(self.out_type) else self.out_type
        )
        fn = self.fn

        def run(env):
            return fn(*[a.fn(env) for a in args])

        deps = tuple(d for a in args for d in a.deps)
        return CompiledExpr(out_t, run, deps=deps)


class TorchUdaf:
    """Custom aggregate: reduces each sorted group segment to one value.

    ``reduce(vals: [args x n], seg, capacity, valid_s) -> [capacity]``
    where ``vals`` are the compiled argument arrays re-ordered into
    group-sorted order. reference: UserDefinedAggregateFunction tier
    (JarUDFHandler registerJavaUDAF, SparkJarLoader.scala:139-165).
    """

    is_aggregate = True

    def __init__(
        self,
        name: str,
        reduce: Callable,
        out_type: Union[str, Callable[[List[str]], str]] = "double",
    ):
        self.name = name
        self.reduce = reduce
        self.out_type = out_type

    def result_type(self, arg_types: List[str]) -> str:
        return (
            self.out_type(arg_types) if callable(self.out_type) else self.out_type
        )

    def on_interval(self, batch_time_ms: int) -> bool:
        return False

    def compile_call(self, compiler, e):
        # non-grouped use: reduce over the whole (valid) batch is not
        # supported yet — match the reference, where UDAFs appear with
        # GROUP BY
        raise EngineException(
            f"aggregate UDF {self.name} requires a GROUP BY context"
        )


class CudaKernelUdf(TorchUdf):
    """TorchUdf whose body is a hand-written CUDA kernel.

    ``kernel``: the kernel's launcher — called with CUDA tensors, it
    launches the kernel or raises, and counts its launches: a wrapper
    object in ``kernel.launches``, a function through
    ``kernels/launch.py::cuda_call`` (a user's own kernel source), by
    entry symbol. ``plain``: the same function in plain PyTorch,
    used when — and only when — the inputs lie on the CPU, or on the
    ``meta`` device, where the device-plan analysis
    (``analysis/deviceplan.py``) propagates shapes and dtypes and
    nothing computes. The CUDA tier
    of the JAX package's ``PallasUdf`` (a Pallas kernel over 1-D row
    blocks); the kernel sees whole contiguous columns, as the Pallas
    BlockSpecs hand the kernel materialized blocks.
    """

    def __init__(
        self,
        name: str,
        kernel: Callable,
        plain: Callable,
        out_type: str = "double",
        on_interval: Optional[Callable[[int], bool]] = None,
    ):
        self.kernel = kernel
        self.plain = plain

        def fn(*tensors):
            return self._call(*tensors)

        super().__init__(name, fn, out_type, on_interval)

    @property
    def launches(self) -> int:
        """A wrapper object's count (see ``kernel``)."""
        return self.kernel.launches

    def _call(self, *tensors: torch.Tensor) -> torch.Tensor:
        if tensors and all(t.device.type == "meta" for t in tensors):
            return meta_kernel_call(self.plain, *tensors)
        if all(t.device.type in ("cpu", "meta") for t in tensors):
            return self.plain(*tensors)
        return self.kernel(*[t.contiguous() for t in tensors])


class UdfRegistry:
    """name(lowercase) -> UDF object; the dict handed to FlowProcessor."""

    def __init__(self, udfs: Optional[Dict[str, object]] = None):
        self._udfs: Dict[str, object] = dict(udfs or {})
        self.last_errors: List[str] = []

    def register(self, udf) -> None:
        self._udfs[udf.name.lower()] = udf

    def as_dict(self) -> Dict[str, object]:
        return dict(self._udfs)

    def refresh(self, batch_time_ms: int) -> bool:
        """Run every UDF's interval hook; True if any state changed
        (caller rebuilds the step's pipeline). reference: udf.onInterval invocation
        at CommonProcessorFactory.scala:351-353.

        A throwing hook must not kill the batch loop: that refresh is
        skipped (the previous pipeline keeps serving, with its previous
        state) and the UDF's name lands in ``last_errors`` so the host
        can emit the ``UdfRefreshError`` metric."""
        changed = False
        self.last_errors = []
        for name, udf in self._udfs.items():
            hook = getattr(udf, "on_interval", None)
            if hook is None:
                continue
            try:
                if hook(batch_time_ms):
                    changed = True
            except Exception:  # noqa: BLE001 — user refresh hook
                logger.exception(
                    "on_interval failed for UDF %s; skipping refresh and "
                    "keeping the previous pipeline", name,
                )
                self.last_errors.append(name)
        return changed


# JAX and the JAX package: a conf the port runs never loads code from
# them, whatever module path it names
REFERENCE_MODULES = ("jax", "jaxlib", "data_accelerator_tpu")


def _refuse_reference_path(path: str, owner: str) -> None:
    """Raise, before anything is imported, for a class path into JAX or
    the JAX package, naming the port's counterpart when it has one.
    ``owner`` says who names the path. The path is never rewritten: a
    JAX UDF is not the port's UDF."""
    mod_name = path.split(":", 1)[0] if ":" in path else path.rsplit(".", 1)[0]
    top = mod_name.split(".")[0]
    if top not in REFERENCE_MODULES:
        return
    hint = ""
    if top == "data_accelerator_tpu":
        counterpart = "data_accelerator_tpu_torch" + path[len(top):]
        try:
            _import_attr(counterpart)
        except (ImportError, AttributeError):
            pass
        else:
            hint = f"; the port's counterpart is '{counterpart}'"
    raise EngineException(
        f"{owner} names '{path}', a module of {top}: the PyTorch "
        f"port loads no code from JAX or the JAX package{hint}"
    )


def _import_attr(path: str):
    """``package.module:attr`` -> python object (reflection-load analog,
    ClassLoaderHost/SparkJarLoader). Refuses a path into JAX or the JAX
    package."""
    _refuse_reference_path(path, "a class path")
    if ":" in path:
        mod_name, attr = path.split(":", 1)
    else:
        mod_name, attr = path.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    obj = mod
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def load_udfs_from_conf(dict_: SettingDictionary) -> Dict[str, object]:
    """Load UDFs/UDAFs declared in job conf.

    Conf shape (same namespaces the reference's flattener emits):
      datax.job.process.jar.udf.<name>.class  = pkg.mod:attr
      datax.job.process.jar.udaf.<name>.class = pkg.mod:attr
    The attr is either a UDF object or a zero-arg factory returning one.

    Registration is case-insensitive, so a name declared twice (across
    the udf/udaf tiers or differing only in case) would silently
    last-win, and a name matching an engine builtin would never be
    called (the compiler resolves builtins first) — both are rejected
    with a typed ``EngineException`` instead.
    """
    # lazy: analysis owns the builtin-function registry the compiler
    # resolves before UDFs (analysis/typeprop.py BUILTIN_FNS)
    from ..analysis.typeprop import BUILTIN_FNS

    out: Dict[str, object] = {}
    declared_as: Dict[str, str] = {}  # lowercase name -> "tier 'Name'"
    for tier in ("udf", "udaf"):
        ns = f"datax.job.process.jar.{tier}."
        grouped = dict_.get_sub_dictionary(ns).group_by_sub_namespace()
        for name, sub in grouped.items():
            cls_path = sub.get("class")
            if not cls_path:
                continue
            key = name.lower()
            if key in declared_as:
                raise EngineException(
                    f"duplicate UDF name: {tier} '{name}' is already "
                    f"declared as {declared_as[key]} (names are "
                    "case-insensitive; last-wins would silently shadow "
                    "the first)"
                )
            if name.upper() in BUILTIN_FNS:
                raise EngineException(
                    f"{tier} '{name}' shadows the engine builtin "
                    f"{name.upper()}: the compiler resolves builtins "
                    "first, so this UDF would never be called — rename it"
                )
            declared_as[key] = f"{tier} '{name}'"
            _refuse_reference_path(cls_path, f"{tier} '{name}'")
            try:
                obj = _import_attr(cls_path)
                if isinstance(obj, type) or not hasattr(obj, "compile_call"):
                    obj = obj()  # class or factory -> instance
            except Exception as e:  # noqa: BLE001 — conf-driven load
                raise EngineException(
                    f"cannot load {tier} '{name}' from '{cls_path}': {e}"
                ) from e
            if not hasattr(obj, "compile_call"):
                raise EngineException(
                    f"{tier} '{name}' ({cls_path}) is not a UDF object"
                )
            obj.name = name
            out[key] = obj
            logger.info("registered %s %s from %s", tier, name, cls_path)
    return out
