"""Static analysis: only the builtin-function registry is ported yet."""
