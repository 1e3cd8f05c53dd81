"""The PyTorch port's ``ops/`` against the JAX package's, on the same
numpy inputs.

Ints and bools must match exactly; float sums within rtol 1e-6, because
a segmented sum may add in another order (min/max/count are exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_accelerator_tpu.ops import compact as jcompact
from data_accelerator_tpu.ops import groupby as jgroupby
from data_accelerator_tpu_torch.ops import compact as tcompact
from data_accelerator_tpu_torch.ops import groupby as tgroupby

torch.set_num_threads(2)

_FLOAT_KEYS = np.array([-2.5, -0.0, 0.0, 1.5, -7.0, 3.0], np.float32)


def _case(seed, n, valid_rate):
    rs = np.random.RandomState(seed)
    ikey = rs.randint(-3, 4, n).astype(np.int32)
    fkey = rs.choice(_FLOAT_KEYS, n)
    bkey = rs.uniform(size=n) < 0.5
    valid = rs.uniform(size=n) < valid_rate
    return rs, [ikey, fkey, bkey], valid


# (seed, rows, share of valid rows): the 0.0 case is all-invalid input
CASES = [(0, 1, 1.0), (1, 17, 0.7), (2, 64, 0.5), (3, 40, 0.0), (4, 200, 0.9)]


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape
    assert np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("seed,n,rate", CASES)
@pytest.mark.parametrize("key_set", [(0,), (1,), (0, 1, 2), ()])
def test_group_ids_match(seed, n, rate, key_set):
    _rs, keys, valid = _case(seed, n, rate)
    keys = [keys[i] for i in key_set]
    ref = jgroupby.group_ids([jnp.asarray(k) for k in keys], jnp.asarray(valid))
    got = tgroupby.group_ids([torch.from_numpy(k) for k in keys], torch.from_numpy(valid))
    for a, b in zip(ref, got):
        _same(a, b)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32


def test_negative_zero_and_negative_float_keys_group_like_jax():
    keys = np.array([-0.0, 0.0, -1.0, -2.0, -1.0, 2.0, 0.0], np.float32)
    valid = np.ones(7, bool)
    ref = jgroupby.group_ids([jnp.asarray(keys)], jnp.asarray(valid))
    got = tgroupby.group_ids([torch.from_numpy(keys)], torch.from_numpy(valid))
    for a, b in zip(ref, got):
        _same(a, b)
    assert int(got[2]) == 4  # -2, -1, 0 (both zeros), 2


@pytest.mark.parametrize("seed,n,rate", CASES)
@pytest.mark.parametrize("op", ["count", "sum", "min", "max", "any", "all"])
@pytest.mark.parametrize("vtype", ["f32", "i32"])
def test_segment_aggregate_matches(seed, n, rate, op, vtype):
    rs, keys, valid = _case(seed, n, rate)
    order, seg, _num, _first = tgroupby.group_ids(
        [torch.from_numpy(keys[0])], torch.from_numpy(valid)
    )
    valid_s = torch.from_numpy(valid)[order]
    if vtype == "f32":
        vals = rs.uniform(-50, 50, n).astype(np.float32)
    else:
        vals = rs.randint(-1000, 1000, n).astype(np.int32)
    if op in ("any", "all"):
        vals = vals > 0
    tv = None if op == "count" else torch.from_numpy(vals)
    jv = None if op == "count" else jnp.asarray(vals)
    # capacities above the group count leave empty segments (identity
    # fill); capacity 2 drops groups past the bound
    for cap in (n + 3, 2):
        ref = np.asarray(jgroupby.segment_aggregate(
            jv, jnp.asarray(seg.numpy()), cap, op, jnp.asarray(valid_s.numpy())
        ))
        got = tgroupby.segment_aggregate(tv, seg, cap, op, valid_s).numpy()
        assert ref.dtype == got.dtype
        if op == "sum" and vtype == "f32":
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
        else:
            assert np.array_equal(got, ref), (got, ref)


def test_empty_segment_identities():
    seg = np.array([0, 0], np.int32)
    valid_s = np.ones(2, bool)
    for vals in (np.array([1, 2], np.int32), np.array([1.5, 2.5], np.float32)):
        for op in ("min", "max"):
            ref = np.asarray(jgroupby.segment_aggregate(
                jnp.asarray(vals), jnp.asarray(seg), 3, op, jnp.asarray(valid_s)
            ))
            got = tgroupby.segment_aggregate(
                torch.from_numpy(vals), torch.from_numpy(seg), 3, op,
                torch.from_numpy(valid_s),
            ).numpy()
            assert np.array_equal(got, ref)
    got = tgroupby.segment_aggregate(
        torch.tensor([1, 2], dtype=torch.int32), torch.from_numpy(seg), 3,
        "min", torch.from_numpy(valid_s),
    )
    assert got.tolist() == [1, 2147483647, 2147483647]


@pytest.mark.parametrize("seed,n,rate", CASES)
def test_distinct_mask_matches(seed, n, rate):
    _rs, keys, valid = _case(seed, n, rate)
    ref = jgroupby.distinct_mask(
        [jnp.asarray(keys[0]), jnp.asarray(keys[2])], jnp.asarray(valid)
    )
    got = tgroupby.distinct_mask(
        [torch.from_numpy(keys[0]), torch.from_numpy(keys[2])],
        torch.from_numpy(valid),
    )
    _same(ref, got)


@pytest.mark.parametrize("seed,n,rate", CASES)
def test_compact_indices_match(seed, n, rate):
    _rs, _keys, valid = _case(seed, n, rate)
    for cap in (n, max(1, n // 3)):
        ref = jcompact.compact_indices(jnp.asarray(valid), cap)
        got = tcompact.compact_indices(torch.from_numpy(valid), cap)
        for a, b in zip(ref, got):
            _same(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_lexsort_matches_jax(seed):
    rs = np.random.RandomState(seed)
    keys = [
        rs.randint(0, 3, 50).astype(np.int32),
        rs.choice(_FLOAT_KEYS, 50),
        rs.randint(-2, 2, 50).astype(np.int32),
    ]
    ref = jnp.lexsort([jnp.asarray(k) for k in keys])
    got = tgroupby.lexsort([torch.from_numpy(k) for k in keys])
    _same(ref, got)
