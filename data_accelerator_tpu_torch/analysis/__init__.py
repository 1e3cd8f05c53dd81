"""Flow static analyzer: typed diagnostics over the whole flow graph.

Design-time counterpart to the runtime compiler: reuses the production
codegen and parsers, so a bad flow config fails in milliseconds with a
``DXnnn``-coded diagnostic instead of minutes into a deployed job.

The ported tiers:

- the semantic tier (``analyze_flow``): reference resolution, type
  propagation, legality, dead flow, device-compilation risk
  (``analyzer.py``, ``typeprop.py``);
- the device tier (``analyze_flow_device``, ``analyze_processor``): the
  compiled plan evaluated on ``meta`` tensors, a per-stage byte/FLOP
  cost report plus the DX2xx capacity and rebuild lints
  (``deviceplan.py``, ``costmodel.py``);
- the UDF tier (``analyze_flow_udfs``): taint-lattice abstract
  interpretation of the flow's UDF device functions, the DX3xx lints
  (``udfcheck.py``).

The JAX package's fleet, compile, race, protocol and conf tiers (slice
7b) and its mesh tier (slice 8) are not ported yet; their runtime halves
are: the buffer sanitizer (``runtime/sanitizer.py``, DX805), the
protocol monitor (``runtime/protocolmonitor.py``, DX906) and the conf
audit (``runtime/confaudit.py``, DX1006).

CLI: ``python -m data_accelerator_tpu_torch.analysis flow.json [--json]
[--device] [--udfs] [--all]`` (non-zero exit on error-severity
diagnostics).
"""

from .analyzer import (
    DEFAULT_MAX_STATE_ROWS,
    FlowAnalyzer,
    FlowContext,
    analyze_flow,
    analyze_script,
)
from .chipcount import ChipCountError, parse_chip_count
from .deviceplan import (
    DEFAULT_CHIPS,
    DevicePlanReport,
    StageCost,
    analyze_flow_device,
    analyze_processor,
    combined_report_dict,
)
from .diagnostics import (
    CODES,
    PASS_NAMES,
    REPORT_SCHEMA_VERSION,
    SEV_ERROR,
    SEV_WARNING,
    AnalysisReport,
    Diagnostic,
    Span,
)
from .typeprop import TableScope, schema_to_types
from .udfcheck import (
    UdfCheckReport,
    UdfSummary,
    analyze_flow_udfs,
    check_udf_object,
)

__all__ = [
    "CODES",
    "DEFAULT_CHIPS",
    "DEFAULT_MAX_STATE_ROWS",
    "FlowAnalyzer",
    "analyze_script",
    "PASS_NAMES",
    "REPORT_SCHEMA_VERSION",
    "SEV_ERROR",
    "SEV_WARNING",
    "AnalysisReport",
    "ChipCountError",
    "DevicePlanReport",
    "Diagnostic",
    "FlowContext",
    "Span",
    "StageCost",
    "TableScope",
    "UdfCheckReport",
    "UdfSummary",
    "analyze_flow",
    "analyze_flow_device",
    "analyze_flow_udfs",
    "analyze_processor",
    "check_udf_object",
    "combined_report_dict",
    "parse_chip_count",
    "schema_to_types",
]
