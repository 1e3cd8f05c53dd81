"""Expressions and the SQL planner of the PyTorch port against the JAX
package's, on the same TableData.

Each query compiles in both packages (same dictionary history, so the
same string ids) and runs on the same numpy columns. Ints, bools and
dictionary ids must match exactly, row for row in the order the
reference defines; floats within rtol 1e-6 (a segmented sum may add in
another order), NaN matching NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_accelerator_tpu.compile.pipeline import PipelineCompiler as JPipelineCompiler
from data_accelerator_tpu.compile.planner import TableData as JTableData
from data_accelerator_tpu.compile.planner import ViewSchema as JViewSchema
from data_accelerator_tpu.compile.stringops import AuxTableBuilder as JAuxTableBuilder
from data_accelerator_tpu.compile.stringops import poly_hash, pow_len
from data_accelerator_tpu.core.schema import StringDictionary as JStringDictionary
from data_accelerator_tpu_torch.compile.exprs import _int_str_hash, _trunc_mod
from data_accelerator_tpu_torch.compile.pipeline import PipelineCompiler
from data_accelerator_tpu_torch.compile.planner import TableData, ViewSchema
from data_accelerator_tpu_torch.compile.stringops import AuxTableBuilder
from data_accelerator_tpu_torch.core.config import EngineException
from data_accelerator_tpu_torch.core.schema import StringDictionary

torch.set_num_threads(2)

TYPES = {
    "k": "long", "a": "long", "b": "long", "x": "double",
    "s": "string", "ts": "timestamp",
}
WORDS = ["u", "v", "Wx", "abc", None]
CAP = 48
BASE_S = 1_700_000_000


def _columns(seed, dictionary):
    rs = np.random.RandomState(seed)
    ids = np.array([dictionary.encode(w) for w in WORDS], np.int32)
    cols = {
        "k": rs.randint(0, 5, CAP).astype(np.int32),
        "a": rs.randint(-20, 20, CAP).astype(np.int32),
        "b": rs.randint(-3, 4, CAP).astype(np.int32),  # zeros included
        "x": rs.choice(np.array([-1.5, -0.0, 0.0, 2.25, 7.0, -9.5], np.float32), CAP),
        "s": ids[rs.randint(0, len(WORDS), CAP)],
        "ts": rs.randint(-5_000_000, 5_000_000, CAP).astype(np.int32),
    }
    valid = rs.uniform(size=CAP) < 0.8
    return cols, valid


def _run_both(transform, seed=0):
    """Compile and run ``transform`` over table T in both packages;
    returns {view: (jax TableData, torch TableData, schema)}."""
    jd, td = JStringDictionary(), StringDictionary()
    jcols, valid = _columns(seed, jd)
    tcols, tvalid = _columns(seed, td)
    assert jd.entries() == td.entries()
    jpc = JPipelineCompiler(jd)
    tpc = PipelineCompiler(td)
    jpipe = jpc.compile_transform(transform, {"T": (JViewSchema(dict(TYPES)), CAP)})
    tpipe = tpc.compile_transform(transform, {"T": (ViewSchema(dict(TYPES)), CAP)})
    jaux = JAuxTableBuilder(jpc.aux, jd).tables()
    taux = AuxTableBuilder(tpc.aux, td).tables()
    assert jd.entries() == td.entries()
    jout = jpipe.run(
        {"T": JTableData({c: jnp.asarray(v) for c, v in jcols.items()}, jnp.asarray(valid))},
        jnp.asarray(BASE_S, jnp.int32), jnp.asarray(250, jnp.int32), aux=jaux,
    )
    tout = tpipe.run(
        {"T": TableData({c: torch.from_numpy(v) for c, v in tcols.items()}, torch.from_numpy(tvalid))},
        torch.full((), BASE_S, dtype=torch.int32), torch.full((), 250, dtype=torch.int32),
        aux=taux,
    )
    return {
        v.name: (jout[v.name], tout[v.name], jpipe.schema_of(v.name))
        for v in jpipe.views
    }


def _assert_same_table(jt, tt, schema):
    jvalid = np.asarray(jt.valid)
    tvalid = tt.valid.numpy()
    assert np.array_equal(jvalid, tvalid)
    assert set(jt.cols) == set(tt.cols)
    for c in jt.cols:
        ja = np.asarray(jt.cols[c])
        ta = tt.cols[c].numpy()
        assert ja.shape == ta.shape, c
        if ja.shape[:1] == jvalid.shape:
            ja, ta = ja[jvalid], ta[jvalid]
        if ja.dtype.kind == "f":
            assert ta.dtype == np.float32, c
            np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6, err_msg=c)
        else:
            assert ja.dtype == ta.dtype, (c, ja.dtype, ta.dtype)
            assert np.array_equal(ja, ta), (c, ja, ta)


QUERIES = {
    "arithmetic": (
        "P = SELECT a + b AS s1, a - b AS d1, a * b AS m1, a % b AS r1, "
        "a % 0 AS rz, MOD(a, b) AS r2, x % 0.0 AS fz, x / b AS q1, a / b AS q2, "
        "-a AS na, x * 2.5 AS xs, ABS(a) AS aa, ROUND(x) AS rx, SIGN(a) AS sg "
        "FROM T"
    ),
    "where": (
        "W = SELECT a, s FROM T WHERE a > 0 AND s IN ('u', 'v') AND NOT (b = 2)"
    ),
    "where_or_case": (
        "W2 = SELECT a, CASE WHEN a > 5 THEN 1 WHEN a < -5 THEN -1 ELSE 0 END AS sgn, "
        "IF(x > 0, x, 0.0) AS px, GREATEST(a, b) AS g, LEAST(x, a) AS l "
        "FROM T WHERE k = 1 OR x <= -1.5 OR s IS NULL"
    ),
    "group": (
        "G = SELECT k, COUNT(*) AS c, SUM(a) AS sa, SUM(x) AS sx, MIN(a) AS mina, "
        "MAX(a) AS maxa, MIN(x) AS minx, MAX(x) AS maxx, AVG(x) AS ax, "
        "AVG(a) AS aa, COUNT(DISTINCT a) AS da, MIN(s) AS mins, MAX(s) AS maxs "
        "FROM T WHERE b != 0 GROUP BY k"
    ),
    "group_having": (
        "H = SELECT s, k, COUNT(*) AS c FROM T GROUP BY s, k HAVING COUNT(*) > 1"
    ),
    "distinct": "D = SELECT DISTINCT k, s FROM T",
    "order_limit": "O = SELECT a, x, s FROM T ORDER BY x DESC, a LIMIT 7",
    "order_string": "O2 = SELECT s, a FROM T ORDER BY s, a DESC",
    "limit_only": "L = SELECT a FROM T WHERE a > 0 LIMIT 5",
    "strings": (
        "S = SELECT UPPER(s) AS us, LENGTH(s) AS ls, s LIKE 'a%' AS lk, "
        "SUBSTRING(s, 1, 2) AS sub FROM T"
    ),
    "time": (
        "TM = SELECT hour(ts) AS h, minute(ts) AS mi, year(ts) AS y, month(ts) AS mo, "
        "day(ts) AS d, dayofweek(ts) AS dw, date_trunc('hour', ts) AS tr, "
        "unix_timestamp() AS now_s, current_timestamp() AS now_ms FROM T"
    ),
    "computed_string": (
        "C = SELECT a, s FROM T WHERE CONCAT(s, CAST(a AS STRING)) = 'u-3' "
        "OR CONCAT('v', CAST(b AS STRING)) = CONCAT(s, '2')"
    ),
    "chained_union": (
        "A1 = SELECT k, a FROM T WHERE a > 0\n--DataXQuery--\n"
        "A2 = SELECT k, a FROM T WHERE a < -10\n--DataXQuery--\n"
        "U = SELECT k, a FROM A1 UNION ALL SELECT k, a FROM A2"
    ),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_jax(name):
    outs = _run_both("--DataXQuery--\n" + QUERIES[name], seed=len(name))
    assert outs
    for view, (jt, tt, schema) in outs.items():
        _assert_same_table(jt, tt, schema)


def test_modulo_by_zero_is_zero_like_jax():
    a = torch.tensor([5, -5, 7, 0], dtype=torch.int32)
    b = torch.tensor([0, 0, -3, 0], dtype=torch.int32)
    got = _trunc_mod(a, b)
    ref = jnp.fmod(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    assert got.tolist() == np.asarray(ref).tolist() == [0, 0, 1, 0]
    assert got.dtype == torch.int32


def test_int_string_hash_is_bit_equal_to_host_hash():
    vals = np.array(
        [0, 7, -7, 10, 99, -100, 123456789, 2**31 - 1, -(2**31), -1000000000],
        np.int32,
    )
    for p in (1000003, 92821):
        h, pl = _int_str_hash(torch.from_numpy(vals), p)
        assert h.dtype == torch.int32 and pl.dtype == torch.int32
        assert h.tolist() == [poly_hash(str(int(v)), p) for v in vals]
        assert pl.tolist() == [pow_len(str(int(v)), p) for v in vals]


def test_join_raises_until_ported():
    with pytest.raises(EngineException, match="JOIN is not ported yet"):
        PipelineCompiler(StringDictionary()).compile_transform(
            "--DataXQuery--\nJ = SELECT a.k FROM T a JOIN T b ON a.k = b.k",
            {"T": (ViewSchema(dict(TYPES)), CAP)},
        )
