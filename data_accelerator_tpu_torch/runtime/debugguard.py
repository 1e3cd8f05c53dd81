"""The step's debug guards: ``process.debug.nans`` and
``process.debug.tracerleaks``.

The counterpart of the JAX package's ``FlowProcessor._debug_guard``
(``runtime/processor.py``), which arms ``jax.debug_nans`` and
``jax.checking_leaks`` around the jitted step. Eager PyTorch has neither
a NaN-checking mode nor tracers, so the port checks what the two JAX
modes catch at the points where a flow's own code runs:

* **nans**: after each UDF call, every float output is checked for NaN
  (all its rows, as ``jax.debug_nans`` checks every row a primitive
  computes); after each view, every float column the view computed is
  checked over its valid rows. A column that shares its storage with a
  table the view read is carried, not computed, and is left to the view
  that made it. A NaN raises ``FloatingPointError`` naming the view and
  the UDF or column that produced it. Each check is one host sync, so a
  view costs one and a UDF call one; ``checks`` counts them. Unarmed,
  none of this runs and the step keeps its zero host syncs.
* **tracerleaks**: the hazard is a step tensor that user code keeps
  past the call, a closure or a global that still holds it (the JAX
  package's leaked tracer). Each UDF call gets fresh views of its input
  tensors, held here only by ``weakref``; once the call has returned and
  its locals are gone, a view still alive, other than the very tensor
  the UDF returned, was kept by the UDF, and ``TensorLeakError`` says
  so.
"""

from __future__ import annotations

import copy
import weakref
from dataclasses import replace
from typing import Dict, List, Optional

import torch

from ..compile.planner import CompiledView, TableData


class TensorLeakError(RuntimeError):
    """A UDF kept a step tensor past its call (``process.debug.tracerleaks``)."""


def _storages(env: Dict[str, object]) -> set:
    """The storage addresses of every column of every table in ``env``."""
    out = set()
    for t in env.values():
        if isinstance(t, TableData):
            for v in t.cols.values():
                out.add(v.untyped_storage().data_ptr())
    return out


class StepGuard:
    """The armed guards of one processor. Its step runs one batch at a
    time (under the processor's dispatch lock), so the view being run is
    plain state here."""

    def __init__(self, nans: bool, leaks: bool):
        self.nans = nans
        self.leaks = leaks
        self.view: Optional[str] = None
        # host syncs the NaN checks made (one per checked view or call)
        self.checks = 0

    # -- the UDF calls ------------------------------------------------------
    def udf(self, udf):
        """A copy of ``udf`` whose calls run under the guards; aggregates
        (which have no per-call function) come back as they are."""
        fn = getattr(udf, "fn", None)
        if fn is None or getattr(udf, "is_aggregate", False):
            return udf
        guarded = copy.copy(udf)
        name = udf.name

        def call(*tensors):
            return self._call(name, fn, tensors)

        guarded.fn = call
        return guarded

    def _call(self, name: str, fn, tensors):
        refs: List[weakref.ref] = []
        if self.leaks:
            views = [t.view_as(t) for t in tensors]
            refs = [weakref.ref(v) for v in views]
            out = fn(*views)
            del views
        else:
            out = fn(*tensors)
        if out.device.type == "meta":
            return out  # a shape-only evaluation (analysis/deviceplan.py)
        kept = [r() for r in refs]
        kept = [v for v in kept if v is not None and v is not out]
        if kept:
            raise TensorLeakError(
                f"UDF {name!r} in view {self.view!r} leaked {len(kept)} step "
                "tensor(s): an input outlived the call (held by a global, "
                "a closure or an attribute), so it would read a later "
                "batch's memory"
            )
        if self.nans and out.is_floating_point():
            self.checks += 1
            if bool(torch.isnan(out).any()):
                raise FloatingPointError(
                    f"NaN in the output of UDF {name!r} in view {self.view!r}"
                )
        return out

    # -- the views ----------------------------------------------------------
    def view_fn(self, view: CompiledView) -> CompiledView:
        """A copy of ``view`` whose function runs under the guards."""
        fn, name = view.fn, view.name

        def run(env, base_s, now_rel_ms):
            return self._run_view(name, fn, env, base_s, now_rel_ms)

        return replace(view, fn=run)

    def _run_view(self, name, fn, env, base_s, now_rel_ms):
        self.view = name
        try:
            out = fn(env, base_s, now_rel_ms)
        finally:
            self.view = None
        if self.nans and out.valid.device.type != "meta":
            carried = _storages(env)
            computed = [
                (c, v) for c, v in out.cols.items()
                if v.is_floating_point()
                and v.shape[:1] == out.valid.shape
                and v.untyped_storage().data_ptr() not in carried
            ]
            if computed:
                self.checks += 1
                flags = torch.stack([
                    (torch.isnan(v) & out.valid).any() for _c, v in computed
                ]).tolist()
                bad = [c for (c, _v), f in zip(computed, flags) if f]
                if bad:
                    raise FloatingPointError(
                        f"NaN in view {name!r}, column(s) {bad}"
                    )
        return out

    def take_checks(self) -> int:
        n, self.checks = self.checks, 0
        return n


def from_conf(dbg_conf) -> Optional[StepGuard]:
    """``process.debug.nans`` / ``process.debug.tracerleaks`` (``dbg_conf``
    is the ``debug.`` sub-dictionary); None when neither is armed."""
    # dx-conf: read debug.nans default=false
    # dx-conf: read debug.tracerleaks default=false
    nans = (dbg_conf.get_or_else("nans", "false") or "").lower() == "true"
    leaks = (
        dbg_conf.get_or_else("tracerleaks", "false") or ""
    ).lower() == "true"
    return StepGuard(nans, leaks) if nans or leaks else None
