"""The join ops of the PyTorch port (``ops/join.py``) against the JAX
package's: ``tests/test_ops.py``'s join tests on both packages, then the
same random inputs through ``sort_join_indices`` (inner and
``left_outer``), ``inner_join_indices`` and ``left_join_indices`` (with
and without a residual), where the left and right indices, validity,
``is_null`` and ``dropped`` must be exact, pair for pair in the
reference's order (left-major, right rows in index order). The
sort-merge and match-matrix formulations agree with each other too, and
the residual's block evaluation keeps the pair order at any block size.
On the card, the same ops against the CPU (``cuda``-marked)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_accelerator_tpu.ops import join as jjoin
from data_accelerator_tpu_torch.ops import join as tjoin

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- tests/test_ops.py, on the port ------------------------------------------
def test_inner_join_basic():
    lk = _t(np.int32([1, 2, 3, 4]))
    rk = _t(np.int32([2, 3, 2]))
    lv = torch.ones(4, dtype=torch.bool)
    rv = torch.ones(3, dtype=torch.bool)
    li, ri, valid, dropped = tjoin.inner_join_indices([lk], [rk], lv, rv, out_capacity=8)
    pairs = {(int(lk[li[i]]), int(rk[ri[i]])) for i in range(8) if bool(valid[i])}
    assert pairs == {(2, 2), (3, 3)}
    assert int(valid.sum()) == 3 and int(dropped) == 0


def test_inner_join_residual_condition():
    lk = _t(np.int32([1, 1]))
    rk = _t(np.int32([1, 1]))
    lval, rval = _t(np.int32([10, 20])), _t(np.int32([15, 25]))
    ones = torch.ones(2, dtype=torch.bool)
    li, ri, valid, _d = tjoin.inner_join_indices(
        [lk], [rk], ones, ones, 8, residual=lambda i, j: lval[i] > rval[j])
    assert {(int(li[i]), int(ri[i])) for i in range(8) if bool(valid[i])} == {(1, 0)}


def test_join_overflow_drops():
    z = torch.zeros(4, dtype=torch.int32)
    ones = torch.ones(4, dtype=torch.bool)
    _, _, valid, dropped = tjoin.inner_join_indices([z], [z], ones, ones, out_capacity=5)
    assert int(valid.sum()) == 5  # 16 matches capped at 5
    assert int(dropped) == 11 and dropped.dtype == torch.int32


def test_left_join_unmatched():
    lk, rk = _t(np.int32([1, 2])), _t(np.int32([2]))
    li, ri, valid, is_null, dropped = tjoin.left_join_indices(
        [lk], [rk], torch.ones(2, dtype=torch.bool), torch.ones(1, dtype=torch.bool), 4)
    rows = [(int(lk[li[i]]), bool(is_null[i])) for i in range(4) if bool(valid[i])]
    assert sorted(rows) == [(1, True), (2, False)]


def test_sort_join_overflow_and_left_outer():
    lk, rk = _t(np.int32([1, 1, 2, 3])), _t(np.int32([1, 1, 1, 9]))
    ones = torch.ones(4, dtype=torch.bool)
    # inner with overflow: 2 left rows x 3 matches = 6 pairs, cap 4
    _, _, valid, _nul, dropped = tjoin.sort_join_indices([lk], [rk], ones, ones, 4)
    assert int(valid.sum()) == 4 and int(dropped) == 2
    # left outer: unmatched lefts (2, 3) emit one null row each
    li, ri, valid, is_null, dropped = tjoin.sort_join_indices(
        [lk], [rk], ones, ones, 16, left_outer=True)
    rows = [(int(li[i]), bool(is_null[i])) for i in range(16) if bool(valid[i])]
    assert rows == [(0, False)] * 3 + [(1, False)] * 3 + [(2, True), (3, True)]
    assert int(dropped) == 0


# -- against the JAX package, exact --------------------------------------------
def _inputs(seed, n, m, n_keys=1, key_range=6, float_key=False):
    rs = np.random.RandomState(seed)
    lks, rks = [], []
    for k in range(n_keys):
        if float_key and k == 0:
            vals = np.array([-0.0, 0.0, 1.5, -2.25, np.inf], np.float32)
            lks.append(vals[rs.randint(0, 5, n)])
            rks.append(vals[rs.randint(0, 5, m)])
        else:
            lks.append(rs.randint(0, key_range, n).astype(np.int32))
            rks.append(rs.randint(0, key_range, m).astype(np.int32))
    lv = rs.uniform(size=n) < 0.8
    rv = rs.uniform(size=m) < 0.8
    lval = rs.randint(0, 100, n).astype(np.int32)
    rval = rs.randint(0, 100, m).astype(np.int32)
    return lks, rks, lv, rv, lval, rval


def _both(fn_name, inputs, cap, residual=False, **kw):
    lks, rks, lv, rv, lval, rval = inputs
    jargs = ([jnp.asarray(a) for a in lks], [jnp.asarray(a) for a in rks],
             jnp.asarray(lv), jnp.asarray(rv), cap)
    targs = ([_t(a) for a in lks], [_t(a) for a in rks], _t(lv), _t(rv), cap)
    if residual:
        jl, jr, tl, tr = jnp.asarray(lval), jnp.asarray(rval), _t(lval), _t(rval)
        kw_j = dict(kw, residual=lambda i, j: jl[i] > jr[j] + 20)
        kw_t = dict(kw, residual=lambda i, j: tl[i] > tr[j] + 20)
    else:
        kw_j = kw_t = kw
    return (getattr(jjoin, fn_name)(*jargs, **kw_j),
            getattr(tjoin, fn_name)(*targs, **kw_t))


def _assert_exact(jout, tout):
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert np.array_equal(np.asarray(j), _np(t)), (np.asarray(j), _np(t))


CASES = [
    # (seed, n, m, cap, n_keys, float_key)
    (0, 50, 40, 400, 1, False),
    (1, 64, 64, 20, 1, False),    # overflow
    (2, 33, 17, 200, 2, False),   # two key columns
    (3, 40, 40, 300, 1, True),    # float keys, -0.0 == 0.0
    (4, 1, 9, 16, 1, False),
    (5, 9, 1, 16, 1, False),
]


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("seed,n,m,cap,n_keys,float_key", CASES)
def test_sort_join_matches_jax(seed, n, m, cap, n_keys, float_key, left_outer):
    jout, tout = _both("sort_join_indices", _inputs(seed, n, m, n_keys, float_key=float_key),
                       cap, left_outer=left_outer)
    _assert_exact(jout, tout)
    assert tout[0].dtype == torch.int64 and tout[4].dtype == torch.int32


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("fn", ["inner_join_indices", "left_join_indices"])
@pytest.mark.parametrize("seed,n,m,cap,n_keys,float_key", CASES)
def test_match_matrix_matches_jax(seed, n, m, cap, n_keys, float_key, fn, residual):
    jout, tout = _both(fn, _inputs(seed, n, m, n_keys, float_key=float_key), cap,
                       residual=residual)
    _assert_exact(jout, tout)


@pytest.mark.parametrize("left_outer", [False, True])
def test_sort_merge_equals_match_matrix_in_pair_order(left_outer):
    """The planner may pick either formulation: for INNER joins the same
    pairs in the same order; for LEFT joins the same rows, the match
    matrix listing unmatched left rows after every pair and the
    sort-merge in left-row order."""
    lks, rks, lv, rv, _a, _b = _inputs(7, 60, 45, 2)
    args = ([_t(a) for a in lks], [_t(a) for a in rks], _t(lv), _t(rv), 500)
    s = tjoin.sort_join_indices(*args, left_outer=left_outer)
    if left_outer:
        mm = tjoin.left_join_indices(*args)
        assert torch.equal(s[2], mm[2]) and torch.equal(s[4], mm[4])

        def rows(out):
            li, ri, valid, is_null, _d = out
            return sorted(zip(li[valid].tolist(), ri[valid].tolist(),
                              is_null[valid].tolist()))

        assert rows(s) == rows(mm)
    else:
        li, ri, valid, dropped = tjoin.inner_join_indices(*args)
        for a, b in zip((s[0], s[1], s[2], s[4]), (li, ri, valid, dropped)):
            assert torch.equal(a, b)
        assert not s[3].any()


@pytest.mark.parametrize("block_pairs", [1, 7, 64, 1 << 22])
def test_residual_blocks_keep_pair_order(monkeypatch, block_pairs):
    inputs = _inputs(8, 37, 23)
    monkeypatch.setattr(tjoin, "RESIDUAL_BLOCK_PAIRS", block_pairs)
    for fn in ("inner_join_indices", "left_join_indices"):
        jout, tout = _both(fn, inputs, 300, residual=True)
        _assert_exact(jout, tout)


# -- on the card -------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("left_outer", [False, True])
def test_join_ops_on_the_card_match_the_cpu(left_outer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed, n, m, cap, n_keys, float_key in CASES:
        lks, rks, lv, rv, lval, rval = _inputs(seed, n, m, n_keys, float_key=float_key)
        outs = {}
        for dev in ("cpu", "cuda"):
            args = ([_t(a).to(dev) for a in lks], [_t(a).to(dev) for a in rks],
                    _t(lv).to(dev), _t(rv).to(dev), cap)
            tl, tr = _t(lval).to(dev), _t(rval).to(dev)
            outs[dev] = (
                tjoin.sort_join_indices(*args, left_outer=left_outer),
                tjoin.left_join_indices(*args, residual=lambda i, j: tl[i] > tr[j] + 20)
                if left_outer else
                tjoin.inner_join_indices(*args, residual=lambda i, j: tl[i] > tr[j] + 20),
            )
        for c, g in zip(outs["cpu"], outs["cuda"]):
            for a, b in zip(c, g):
                assert torch.equal(a, b.cpu())
