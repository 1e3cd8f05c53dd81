"""Runtime conf audit: the dynamic half of the DX10xx configuration
lattice (analysis/confspec.py).

The static ``--conf`` tier proves properties of the SOURCE — every
engine read site has a registry row, every generated key has a reader.
This module closes the loop at process boundary: the CONCRETE flat conf
a host (or LQ service) actually booted with is replayed through the
same ``check_conf_mapping`` validator the analyzer uses, so a conf that
was hand-edited, generated by an older designer, or corrupted in
transit is flight-recorded the moment the process starts instead of
surfacing as silently-ignored keys. One validator, two enforcement
points — the audit can never drift from the static gate.

Findings become DX1006 events (``conf/violation`` telemetry +
``Conf_Violation`` metric detail rows, mirroring the DX805/DX906 drain
idiom in host.py) and three gauges: ``Conf_Audited_Count`` /
``Conf_Unknown_Count`` / ``Conf_OutOfBounds_Count``. The audit is
strictly fail-open and advisory — a finding never blocks boot; the
reference engine's behavior for a bad key (ignore it) is preserved,
just no longer invisible.

Copy of the JAX package's ``runtime/confaudit.py``, unchanged but for
this note: the port's ``StreamingHost`` runs it at init, as the JAX
host does, over the port's copy of ``analysis/confspec.py``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional

from ..constants import MetricName

logger = logging.getLogger(__name__)

#: telemetry event name for DX1006 flight records (the conf analog of
#: ``protocol/violation``)
CONF_VIOLATION_EVENT = "conf/violation"

#: metric key the detail events are zadd'ed under
CONF_VIOLATION_METRIC = "Conf_Violation"


class ConfAudit:
    """Result of auditing one concrete conf mapping.

    ``events`` holds one DX1006 dict per finding; ``metric_deltas``
    gives the three ``Conf_*`` counts for the metric plane.
    """

    def __init__(
        self,
        subject: str,
        audited: int,
        findings: List[tuple],
    ):
        self.subject = subject
        self.audited = audited
        self.findings = list(findings)

    @property
    def unknown(self) -> int:
        return sum(1 for kind, _, _ in self.findings if kind == "unknown")

    @property
    def out_of_bounds(self) -> int:
        # value (type/bounds/choices) and constraint (incompatible-knob)
        # violations both count as out-of-lattice confs
        return sum(1 for kind, _, _ in self.findings if kind != "unknown")

    @property
    def ok(self) -> bool:
        return not self.findings

    def events(self) -> List[Dict[str, object]]:
        """One DX1006 flight-record dict per finding."""
        return [
            {
                "code": "DX1006",
                "subject": self.subject,
                "kind": kind,
                "key": key,
                "reason": reason,
                "message": (
                    f"DX1006: conf audit ({self.subject}): "
                    f"{kind} '{key}': {reason}"
                ),
            }
            for kind, key, reason in self.findings
        ]

    def metric_deltas(self) -> Dict[str, float]:
        return {
            MetricName.CONF_AUDITED: float(self.audited),
            MetricName.CONF_UNKNOWN: float(self.unknown),
            MetricName.CONF_OUT_OF_BOUNDS: float(self.out_of_bounds),
        }

    def emit(self, telemetry=None, metric_logger=None) -> None:
        """Flight-record the audit: DX1006 events to telemetry + metric
        detail rows, and the three ``Conf_*`` gauges. Mirrors the
        DX906 drain in host.py; strictly fail-open."""
        events = self.events()
        for ev in events:
            logger.warning("%s", ev["message"])
        if telemetry is not None:
            try:
                for ev in events:
                    telemetry.track_event(CONF_VIOLATION_EVENT, ev)
            except Exception:  # noqa: BLE001 — audit must not block boot
                logger.warning("conf audit telemetry emit failed", exc_info=True)
        if metric_logger is not None:
            try:
                if events:
                    metric_logger.send_metric_events(
                        CONF_VIOLATION_METRIC, events
                    )
                metric_logger.send_batch_metrics(self.metric_deltas())
            except Exception:  # noqa: BLE001 — audit must not block boot
                logger.warning("conf audit metric emit failed", exc_info=True)


def _flat_items(conf) -> Mapping[str, str]:
    """Best-effort flat ``{key: value}`` view of a SettingDictionary, a
    plain mapping, or anything with an ``elems``/``dict`` attribute."""
    if conf is None:
        return {}
    elems = getattr(conf, "elems", None)
    if isinstance(elems, dict):
        return elems
    if isinstance(conf, Mapping):
        return conf
    d = getattr(conf, "dict", None)
    if isinstance(d, dict):
        return d
    return {}


def audit_conf(conf, subject: str = "host") -> ConfAudit:
    """Audit a concrete conf against the DX10xx lattice. Fail-open: any
    analyzer error yields an empty (clean) audit."""
    try:
        from ..analysis.confspec import PROCESS_PREFIX, check_conf_mapping

        flat = dict(_flat_items(conf))
        audited = sum(1 for k in flat if k.startswith(PROCESS_PREFIX))
        findings = check_conf_mapping(flat)
        return ConfAudit(subject, audited, findings)
    except Exception:  # noqa: BLE001 — audit must not block boot
        logger.warning("conf audit failed (skipping)", exc_info=True)
        return ConfAudit(subject, 0, [])


def from_conf(
    conf, subject: str = "host", telemetry=None, metric_logger=None
) -> Optional[ConfAudit]:
    """Run the boot-time audit and flight-record it. Always returns the
    audit (never raises); callers keep it for introspection/tests."""
    audit = audit_conf(conf, subject=subject)
    audit.emit(telemetry=telemetry, metric_logger=metric_logger)
    return audit
