"""Static analysis of flows: the UDF tier (``udfcheck.py``, DX300-DX305
and DX310) and the builtin-function registry (``typeprop.py``).

The JAX package's other tiers (semantic, device plan, compile surface,
mesh, fleet, race, protocol, conf) are not ported yet.
"""

from .diagnostics import CODES, Diagnostic, Span
from .udfcheck import (
    UdfCheckReport,
    UdfSummary,
    analyze_flow_udfs,
    check_udf_object,
)

__all__ = [
    "CODES",
    "Diagnostic",
    "Span",
    "UdfCheckReport",
    "UdfSummary",
    "analyze_flow_udfs",
    "check_udf_object",
]
