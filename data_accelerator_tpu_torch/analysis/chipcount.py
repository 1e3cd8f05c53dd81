"""One chip-count parser for every surface that accepts N chips.

Copy of the JAX package's ``analysis/chipcount.py``, untrimmed.

``--device --chips=N``, ``--mesh --chips=N``, the fleet spec's
``chips`` key and the REST ``"chips"`` body field used to parse and
validate their chip counts separately — a ``--chips=0`` typo was an
unhandled int() somewhere and a silent model-of-nothing somewhere else.
All of them now funnel through :func:`parse_chip_count`, which raises
one typed error (:class:`ChipCountError`, a ``ValueError``) naming the
offending surface, so the CLI exits 2 and the REST layer 400s with the
same message for the same mistake.
"""

from __future__ import annotations

from typing import Optional, Union


class ChipCountError(ValueError):
    """A chip count that is not a positive integer."""


def parse_chip_count(
    value: Union[str, int, float, None], source: str = "--chips"
) -> Optional[int]:
    """Parse a chip count from any surface (CLI flag text, fleet-spec
    JSON number, REST body field). ``None``/empty means "not given" and
    passes through as ``None`` so callers keep their defaults;
    everything else must be a positive integer or :class:`ChipCountError`
    is raised with the ``source`` label in the message."""
    if value is None or value == "":
        return None
    if isinstance(value, bool):  # bool is an int subclass; reject it
        raise ChipCountError(f"{source}: chip count must be an integer")
    try:
        n = int(value)
    except (TypeError, ValueError):
        raise ChipCountError(
            f"{source}: invalid chip count {value!r} (expected a positive "
            f"integer)"
        ) from None
    if isinstance(value, float) and value != n:
        raise ChipCountError(
            f"{source}: invalid chip count {value!r} (expected a positive "
            f"integer)"
        )
    if n < 1:
        raise ChipCountError(
            f"{source}: chip count must be >= 1, got {n}"
        )
    return n
