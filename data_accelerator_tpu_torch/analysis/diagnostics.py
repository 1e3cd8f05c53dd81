"""Typed diagnostics for the port's UDF analyzer tier.

A trimmed copy of the JAX package's ``analysis/diagnostics.py``: the
``Span``/``Diagnostic`` types, ``make`` and the registry entries of the
UDF tier (DX300-DX305, DX310), with the JAX package's code numbers and
severities. Tests assert codes, not messages, so wording can change
without breaking callers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass(frozen=True)
class Span:
    """1-based location in the analyzed source.

    ``line`` is the first line of the finding; ``col`` is the 1-based
    character offset; ``end_line`` closes multi-line findings.
    """

    line: int = 0
    col: int = 1
    end_line: Optional[int] = None

    def to_dict(self) -> dict:
        d = {"line": self.line, "col": self.col}
        if self.end_line is not None:
            d["endLine"] = self.end_line
        return d


@dataclass(frozen=True)
class Diagnostic:
    code: str  # "DX300"
    severity: str  # SEV_ERROR | SEV_WARNING
    table: str  # the UDF the finding concerns ("" = flow-level)
    message: str
    span: Span = Span()

    @property
    def is_error(self) -> bool:
        return self.severity == SEV_ERROR

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "table": self.table,
            "message": self.message,
            "span": self.span.to_dict(),
        }

    def render(self) -> str:
        loc = f" (line {self.span.line})" if self.span.line else ""
        tbl = f" [{self.table}]" if self.table else ""
        return f"{self.severity.upper()} {self.code}{tbl} {self.message}{loc}"


# ---------------------------------------------------------------------------
# Code registry: code -> (default severity, one-line cause, one-line fix).
# Pass 7: UDF host-sync safety, purity and determinism (analysis/
# udfcheck.py, the --udfs tier: taint-lattice abstract interpretation of
# the UDFs' device-function ASTs).
# ---------------------------------------------------------------------------
CODES: Dict[str, tuple] = {
    "DX300": (SEV_ERROR, "data-dependent Python control flow on a device tensor: if/while/and/or/not bool-convert it, a blocking device-to-host sync every batch that also rules out CUDA-graph capture",
              "replace the branch with torch.where so control flow stays on the device"),
    "DX301": (SEV_ERROR, "host sync point on a device tensor: .item()/.tolist()/.cpu()/.numpy()/float()/int()/bool() or torch.cuda.synchronize() block the host every batch and rule out CUDA-graph capture",
              "keep the computation in torch ops on the device; read values back only outside the step"),
    "DX302": (SEV_WARNING, "impure device function: mutates global/closure state, does I/O, or draws host randomness or torch's global generator — eager PyTorch repeats the effect every batch, so results depend on state outside the batch",
              "make the function pure; pass an explicit torch.Generator, and move state behind on_interval"),
    "DX303": (SEV_WARNING, "captured mutable state with no on_interval declared: eager PyTorch reads the state on every call, so an update lands mid-stream with no batch boundary and no refresh",
              "declare on_interval so state changes take effect at a batch boundary (DynamicUDF.onInterval semantics), or capture immutable values"),
    "DX304": (SEV_WARNING, "declared out_type disagrees with the return dtype inferred under the type lattice: results decode through the wrong column type",
              "fix out_type (or the return expression) so the declared SQL type matches what the function computes"),
    "DX305": (SEV_ERROR, "CUDA launch hazard: cuda_call without out_shape, or its grid/out_shape derived from device tensor values (a host read every batch)",
              "derive grid and out_shape from static shapes (.shape/.numel()) only and always pass out_shape"),
    "DX310": (SEV_ERROR, "UDF conf entry does not load: bad package.module:attr, non-callable target, or aggregate without reduce",
              "point class/module at an importable UDF object or zero-arg factory; aggregates must provide reduce"),
}

# version of the ``--json`` report shape, the JAX package's number
REPORT_SCHEMA_VERSION = 5


def make(code: str, table: str, message: str, span: Optional[Span] = None,
         severity: Optional[str] = None) -> Diagnostic:
    """Build a diagnostic, defaulting severity from the registry."""
    default_sev = CODES[code][0]
    return Diagnostic(
        code=code,
        severity=severity or default_sev,
        table=table,
        message=message,
        span=span or Span(),
    )
