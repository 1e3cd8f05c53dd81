"""LiveQuery serving plane: multi-tenant sessions, micro-batched
device dispatch, warm-kernel residency.

The reference platform's signature experience is interactive LiveQuery
from the designer (SURVEY §1, the L5/L3 zero-code tier); this package
scales that experience to the ROADMAP's "millions of users" axis by
multiplexing thousands of concurrent tenant sessions onto a few chips:

- ``session``   — per-tenant registry, TTL reaping, quota admission
                  (typed rejections → REST 429 + Retry-After);
- ``warmcache`` — compile-signature-keyed resident kernels (flow-hash x
                  pow2 row bucket x query shape) under a device-byte
                  budget (``FlowProcessor.device_bytes``);
- ``coalescer`` — per-signature micro-batching: one dispatch group per
                  signature per deadline tick, identical payloads share
                  one device dispatch, the compile surface stays
                  bounded by the bucket lattice while QPS scales;
- ``service``   — the facade the REST surface (``serve/restapi.py``'s
                  ``lq/*`` routes) talks to, with the ``LQ_*`` /
                  ``Latency-LQExec-pNN`` observability surface.

Imports are lazy (PEP 562): ``serve/livequery.py`` imports the session
registry from here while ``warmcache`` imports the ``Kernel`` machinery
from there — laziness keeps the cycle inert.

The port's copy of the JAX package's ``lq/``; each module's docstring
names its changes.
"""

_EXPORTS = {
    "AdmissionRejected": ".session",
    "Session": ".session",
    "SessionManager": ".session",
    "LEGACY_TENANT": ".session",
    "CompileSignature": ".warmcache",
    "WarmKernelCache": ".warmcache",
    "signature_for": ".warmcache",
    "DispatchCoalescer": ".coalescer",
    "PendingExec": ".coalescer",
    "LiveQueryService": ".service",
    "LQ_EXEC_STAGE": ".service",
    "LQ_FLOW": ".service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod, __name__), name)
