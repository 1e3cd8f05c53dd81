"""Token templating for flow documents.

Two placeholder forms, matching the reference's semantics
(DataX.Config/Templating/{Token,TokenDictionary,TokenReplacement}.cs):

- ``${token}``   — plain token, replaced wherever it appears.
- ``_S_{token}`` — late-bound ("secret") token: resolved only during
  runtime-config generation, so saved flow documents keep the
  placeholder and never embed environment-specific values.

Replacement runs to a fixed point so tokens may expand to strings that
themselves contain tokens (the reference iterates its token list the
same way). A token whose value is a non-string JSON value replaces the
*entire* string when the string is exactly one placeholder — this is how
``"_S_{processTimeWindows}"`` becomes a JSON array in the job config.

Copy of the JAX package's ``serve/templating.py``, unchanged.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

_PLAIN = "${%s}"
_SECRET = "_S_{%s}"
_TOKEN_RE = re.compile(r"(_S_\{(\w+)\})|(\$\{(\w+)\})")

_MAX_PASSES = 10


class TokenDictionary:
    """Ordered token set with nested-JSON replacement."""

    def __init__(self, tokens: Optional[Dict[str, Any]] = None):
        self._tokens: Dict[str, Any] = dict(tokens or {})

    def set(self, name: str, value: Any) -> None:
        self._tokens[name] = value

    def get(self, name: str, default: Any = None) -> Any:
        return self._tokens.get(name, default)

    def update(self, other: Dict[str, Any]) -> None:
        self._tokens.update(other)

    def names(self):
        return list(self._tokens)

    # -- replacement -----------------------------------------------------
    def _replace_str(self, s: str) -> Any:
        # whole-string single placeholder: may return a non-string value
        m = _TOKEN_RE.fullmatch(s)
        if m:
            name = m.group(2) or m.group(4)
            if name in self._tokens:
                return self._tokens[name]
            return s

        def sub(mm: re.Match) -> str:
            name = mm.group(2) or mm.group(4)
            if name in self._tokens:
                return str(self._tokens[name])
            return mm.group(0)

        return _TOKEN_RE.sub(sub, s)

    def replace(self, value: Any) -> Any:
        """Deep-replace tokens in a nested JSON value, to fixed point."""
        for _ in range(_MAX_PASSES):
            new = self._replace_once(value)
            if new == value:
                return new
            value = new
        return value

    def _replace_once(self, value: Any) -> Any:
        if isinstance(value, str):
            return self._replace_str(value)
        if isinstance(value, dict):
            return {k: self._replace_once(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self._replace_once(v) for v in value]
        return value


def unresolved_tokens(value: Any) -> list:
    """Names of placeholders still present (generation-time validation)."""
    out = []

    def walk(v):
        if isinstance(v, str):
            for m in _TOKEN_RE.finditer(v):
                out.append(m.group(2) or m.group(4))
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, list):
            for x in v:
                walk(x)

    walk(value)
    return out
