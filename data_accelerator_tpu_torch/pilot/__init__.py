"""Autopilot: closed-loop runtime control (ROADMAP item 5).

The control plane used to deploy and *watch*; this package makes the
runtime *act*: ``controller`` maps the observability surface to bounded
actuations (pipeline depth, batch admission, replicas) once per
evaluation window, ``backpressure`` is the token bucket the ingestor
consults.

Copy of the JAX package's ``pilot/__init__.py``. Not ported yet: the
fault injectors (``pilot/chaos.py``) and the replay CLI
(``pilot/__main__.py``).
"""

from .backpressure import TokenBucket
from .controller import (
    ACTION_KINDS,
    Actuator,
    BackpressureActuator,
    Decision,
    DepthActuator,
    PilotConfig,
    PilotController,
    ScaleActuator,
    SignalSnapshot,
    decide,
)

__all__ = [
    "ACTION_KINDS",
    "Actuator",
    "BackpressureActuator",
    "Decision",
    "DepthActuator",
    "PilotConfig",
    "PilotController",
    "ScaleActuator",
    "SignalSnapshot",
    "TokenBucket",
    "decide",
]
