"""The engine's builtin function names, grouped by result type.

A trimmed copy of the JAX package's ``analysis/typeprop.py``: the port
needs only ``BUILTIN_FNS``, which ``udf/api.py`` reads to refuse a UDF
that a builtin would shadow. The type propagation itself is not ported.
"""

from ..compile.exprs import AGGREGATE_FNS  # {"AVG","MIN","MAX","SUM","COUNT"}

_STRING_RESULT_FNS = {
    "UPPER", "UCASE", "LOWER", "LCASE", "TRIM", "LTRIM", "RTRIM", "REVERSE",
    "INITCAP", "SUBSTRING", "SUBSTR", "REPLACE", "TRANSLATE", "REPEAT",
    "LPAD", "RPAD", "SPLIT_PART", "REGEXP_EXTRACT", "REGEXP_REPLACE",
    "ELEMENT_AT", "FROM_UNIXTIME", "TO_DATE",
}
_NUMERIC_RESULT_FNS = {
    "LENGTH", "CHAR_LENGTH", "CHARACTER_LENGTH", "LEN", "INSTR", "LOCATE",
    "ASCII", "UNIX_TIMESTAMP", "TO_UNIX_TIMESTAMP", "HOUR", "MINUTE",
    "SECOND", "YEAR", "MONTH", "DAY", "DAYOFMONTH", "DAYOFWEEK", "DATEDIFF",
    "POW", "POWER", "MOD", "SIGN", "ABS", "FLOOR", "CEIL", "ROUND", "SQRT",
    "EXP", "LOG", "LOG2", "LOG10",
}
_BOOL_RESULT_FNS = {"CONTAINS", "STARTSWITH", "STARTS_WITH", "ENDSWITH",
                    "ENDS_WITH"}
_TIMESTAMP_RESULT_FNS = {"CURRENT_TIMESTAMP", "DATE_TRUNC", "TO_TIMESTAMP",
                         "STRINGTOTIMESTAMP"}
_COMPOSITE_FNS = {"MAP", "STRUCT", "ARRAY", "FILTERNULL", "SPLIT",
                  "COALESCE", "IF", "GREATEST", "LEAST", "APPLYTEMPLATE"}

BUILTIN_FNS = (
    AGGREGATE_FNS | _STRING_RESULT_FNS | _NUMERIC_RESULT_FNS
    | _BOOL_RESULT_FNS | _TIMESTAMP_RESULT_FNS | _COMPOSITE_FNS
    | {"CONCAT", "CONCAT_WS", "CAST"}
)
