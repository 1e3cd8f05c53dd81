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
  (``udfcheck.py``);
- the fleet tier (``analyze_fleet``, ``analyze_fleet_flows``):
  placement of a set of flows, DX400-DX413 (``fleetcheck.py``);
- the compile tier (``analyze_flow_compile``,
  ``analyze_processor_compile``): the dispatch surface and its
  manifest, DX6xx (``compilecheck.py``);
- the engine gates over the port's own source: buffer lifetime and
  locksets (``analyze_modules``, ``analyze_flow_race``, DX80x,
  ``racecheck.py``), the delivery protocol (``analyze_proto_modules``,
  ``analyze_flow_protocol``, DX90x, ``protocheck.py``) and the conf
  lattice (``analyze_conf_modules``, ``analyze_flow_conf``, DX10xx,
  ``confcheck.py``); their runtime halves are the buffer sanitizer
  (``runtime/sanitizer.py``, DX805), the protocol monitor
  (``runtime/protocolmonitor.py``, DX906) and the conf audit
  (``runtime/confaudit.py``, DX1006).

The JAX package's mesh tier waits for multi-GPU slice 8.

CLI: ``python -m data_accelerator_tpu_torch.analysis flow.json [--json]
[--device] [--udfs] [--fleet] [--compile] [--race] [--protocol]
[--conf] [--all]`` (non-zero exit on error-severity diagnostics).
"""

from .analyzer import (
    DEFAULT_MAX_STATE_ROWS,
    FlowAnalyzer,
    FlowContext,
    analyze_flow,
    analyze_script,
)
from .chipcount import ChipCountError, parse_chip_count
from .compilecheck import (
    CompileSurfaceReport,
    analyze_flow_compile,
    analyze_processor_compile,
)
from .confcheck import analyze_conf_modules, analyze_flow_conf, conf_module_paths
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
from .fleetcheck import (
    FleetSpec,
    analyze_fleet,
    analyze_fleet_flows,
    flow_footprint,
    load_fleet_spec,
)
from .protocheck import analyze_flow_protocol, analyze_proto_modules, proto_module_paths
from .racecheck import (
    ENGINE_PACKAGES,
    analyze_flow_race,
    analyze_modules,
    engine_module_paths,
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
    "CompileSurfaceReport",
    "ENGINE_PACKAGES",
    "FleetSpec",
    "analyze_conf_modules",
    "analyze_fleet",
    "analyze_fleet_flows",
    "flow_footprint",
    "load_fleet_spec",
    "analyze_flow_compile",
    "analyze_flow_conf",
    "analyze_flow_protocol",
    "analyze_flow_race",
    "analyze_modules",
    "analyze_processor_compile",
    "analyze_proto_modules",
    "conf_module_paths",
    "engine_module_paths",
    "proto_module_paths",
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
