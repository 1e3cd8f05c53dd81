"""Flow compiler: DataXQuery parsing and SQL planning onto torch tensors."""

from .transform_parser import (
    COMMAND_TYPE_COMMAND,
    COMMAND_TYPE_QUERY,
    ParsedResult,
    SqlCommand,
    TransformParser,
)

__all__ = [
    "SqlCommand",
    "ParsedResult",
    "TransformParser",
    "COMMAND_TYPE_QUERY",
    "COMMAND_TYPE_COMMAND",
]
