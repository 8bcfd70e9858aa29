"""The XLA paths behind GROUP BY, compaction, join expansion, filtered global
aggregates and the shuffle histogram, checked against NumPy at the edge
cases that matter for each: run boundaries, all-distinct and all-equal keys,
padded tails, capacity overflow and int64 sums past the int32 range."""

import numpy as np

import jax
import jax.numpy as jnp

from conftest import make_engine
from gpu_olap_tpu.ops import aggregate as agg_ops
from gpu_olap_tpu.ops import filter as filter_ops
from gpu_olap_tpu.ops import join as join_ops

I32MAX = np.iinfo(np.int32).max


def _spec(func, values=None):
    return {"func": func, "values": values, "valid": None, "distinct": False,
            "acc_dtype": np.int64, "np_kind": "i", "arg_id": "v",
            "int32_ok": True}


def _groupby(keys, vals, max_groups, prefix_rows=None):
    """GROUP BY k -> COUNT(*), SUM(v), MIN(v), MAX(v) over int32 columns."""
    k = jnp.asarray(keys.astype(np.int32))
    v = jnp.asarray(vals.astype(np.int32))
    specs = [_spec("count"), _spec("sum", v), _spec("min", v), _spec("max", v)]
    codes, res, n_groups, overflow = jax.jit(
        lambda k, v: agg_ops.groupby_aggregate(
            [(k, None)], None,
            [dict(s, values=None if s["values"] is None else v) for s in specs],
            max_groups, n_rows=k.shape[0], prefix_rows=prefix_rows))(k, v)
    ng = int(n_groups)
    m = min(ng, max_groups)
    out = [np.asarray(codes[0][0])[:m]] + [np.asarray(r[0])[:m] for r in res]
    return out, ng, bool(overflow)


def _oracle(keys, vals):
    uk, inv = np.unique(keys, return_inverse=True)
    v64 = vals.astype(np.int64)
    cnt = np.bincount(inv, minlength=len(uk))
    sums = np.zeros(len(uk), np.int64)
    np.add.at(sums, inv, v64)
    mins = np.full(len(uk), np.iinfo(np.int64).max)
    np.minimum.at(mins, inv, v64)
    maxs = np.full(len(uk), np.iinfo(np.int64).min)
    np.maximum.at(maxs, inv, v64)
    return [uk, cnt, sums, mins, maxs]


def _check_groupby(keys, vals, max_groups=None):
    exp = _oracle(keys, vals)
    got, ng, overflow = _groupby(keys, vals, max_groups or len(exp[0]) + 8)
    assert ng == len(exp[0]) and not overflow
    for g, e, name in zip(got, exp, ("key", "count", "sum", "min", "max")):
        np.testing.assert_array_equal(g, e, err_msg=name)


def test_groupby_basic_runs():
    rng = np.random.default_rng(10)
    n = 4096
    _check_groupby(rng.integers(0, n // 16, n),
                   rng.integers(-1_000_000, 1_000_000, n))


def test_groupby_giant_group_across_boundary():
    """One group covering the first half and more, then many tiny groups."""
    n = 8192
    keys = np.empty(n, dtype=np.int64)
    half = n // 2 + 2048
    keys[:half] = 7
    keys[half:] = 100 + np.arange(n - half) // 3
    _check_groupby(keys, np.arange(n) % 4096)


def test_groupby_every_row_new_group():
    n = 4096
    _check_groupby(np.arange(n) * 3 - n, np.full(n, -5))


def test_groupby_padded_tail_ignored():
    """Rows past ``prefix_rows`` (scan padding) never form or feed a group,
    whatever they hold."""
    rng = np.random.default_rng(11)
    n, n_valid = 8 * 4096, 8 * 4096 - 12345
    keys = rng.integers(0, 500, n)
    vals = rng.integers(0, 1000, n)
    keys[n_valid:] = rng.integers(-5, 5, n - n_valid)   # garbage in the pad
    vals[n_valid:] = 10 ** 6
    exp = _oracle(keys[:n_valid], vals[:n_valid])
    got, ng, _ = _groupby(keys, vals, len(exp[0]) + 8, prefix_rows=n_valid)
    assert ng == len(exp[0])
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)


def test_groupby_overflow_keeps_exact_count():
    """Capacity overflow raises the flag and reports the exact group count,
    so the host can grow the buffer and retry; the leading groups (all but
    the last slot, which absorbs the rest) stay correct."""
    n = 4096
    got, ng, overflow = _groupby(np.arange(n), np.ones(n), 64)
    assert overflow and ng == n
    np.testing.assert_array_equal(got[0], np.arange(64))
    np.testing.assert_array_equal(got[1][:63], np.ones(63))


def test_groupby_many_groups_random_sizes():
    rng = np.random.default_rng(12)
    sizes = rng.integers(1, 9, 9000)
    keys = np.repeat(np.arange(len(sizes)) * 7 - 100, sizes)
    keys = keys[rng.permutation(len(keys))]
    _check_groupby(keys, rng.integers(-(1 << 30), 1 << 30, len(keys)))


def test_groupby_int64_sum_of_int32_extremes():
    """A giant group of int32 extremes: its SUM leaves the int32 range and
    must stay exact in int64."""
    n = 8 * 4096
    keys = np.full(n, 2047)
    keys[:2047] = np.arange(2047)
    keys[6 * 4096:] = 2048 + np.arange(n - 6 * 4096) // 5
    vals = np.full(n, I32MAX)
    vals[::3] = -(1 << 31)
    _check_groupby(keys, vals)


def test_groupby_fuzz_vs_oracle():
    rng = np.random.default_rng(13)
    for _ in range(4):
        n = int(rng.integers(1, 7)) * 4096 + int(rng.integers(0, 100))
        ng = int(rng.integers(1, n + 1))
        pool = rng.integers(-(1 << 28), 1 << 28, ng)
        _check_groupby(pool[rng.integers(0, ng, n)],
                       rng.integers(-(1 << 31), 1 << 31, n))


def test_compaction_indices_basic():
    rng = np.random.default_rng(20)
    n = 6 * 4096
    mask = rng.random(n) < 0.3
    a = rng.integers(-(1 << 31), 1 << 31, n)
    idx, cnt = filter_ops.compaction_indices(jnp.asarray(mask))
    cnt = int(cnt)
    assert cnt == mask.sum()
    np.testing.assert_array_equal(a[np.asarray(idx)[:cnt]], a[mask])


def test_compaction_indices_extreme_masks():
    n = 4 * 4096
    a = np.arange(n)
    for mask in (np.ones(n, bool), np.zeros(n, bool), a % 2 == 0,
                 a == n - 1):
        idx, cnt = filter_ops.compaction_indices(jnp.asarray(mask))
        cnt = int(cnt)
        assert cnt == mask.sum()
        np.testing.assert_array_equal(a[np.asarray(idx)[:cnt]], a[mask])


def _join_pairs(lk, rk, capacity):
    li, ri, out_valid, total, overflow, _cnt = join_ops.inner_join(
        [(jnp.asarray(lk), jnp.zeros(len(lk), bool))], None,
        [(jnp.asarray(rk), jnp.zeros(len(rk), bool))], None, capacity)
    total = int(total)
    assert not bool(overflow)
    assert int(np.asarray(out_valid).sum()) == total
    pairs = np.stack([np.asarray(li)[:total], np.asarray(ri)[:total]], 1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def _expected_pairs(lk, rk):
    pairs = [(i, j) for i, a in enumerate(lk) for j in np.flatnonzero(rk == a)]
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def test_join_expansion_basic():
    rng = np.random.default_rng(21)
    lk = rng.integers(0, 300, 3000)
    rk = rng.integers(0, 300, 1500)
    exp = _expected_pairs(lk, rk)
    np.testing.assert_array_equal(_join_pairs(lk, rk, len(exp) + 64), exp)


def test_join_expansion_long_runs():
    """Match runs far longer than any block: one probe row matching
    thousands of build rows, next to single matches."""
    rk = np.repeat(np.array([3, 5, 8, 9, 11]), [5000, 1, 7000, 2048, 2])
    lk = np.array([3, 8, 5, 11, 4, 9, 3])
    exp = _expected_pairs(lk, rk)
    np.testing.assert_array_equal(_join_pairs(lk, rk, len(exp) + 64), exp)


def _filter_sum_parity(values, threshold, bucket):
    eng = make_engine("device", min_shape_bucket=bucket)
    eng.register("t", {"v": values})
    r = eng.query(f"SELECT COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, "
                  f"MAX(v) AS mx FROM t WHERE v > {threshold}")
    assert r.meta["backend"] == "device"
    got = r.to_pydict()
    m = values > threshold
    assert int(got["n"][0]) == int(m.sum())
    assert int(got["s"][0]) == int(values[m].astype(np.int64).sum())
    assert int(got["mn"][0]) == int(values[m].min())
    assert int(got["mx"][0]) == int(values[m].max())


def test_filtered_sum_exact_past_int32():
    rng = np.random.default_rng(1)
    values = rng.integers(0, 1 << 30, 70_000)
    assert values[values > (1 << 29)].sum() > I32MAX   # leaves int32
    _filter_sum_parity(values, 1 << 29, 1 << 14)


def test_filtered_sum_ignores_padded_tail():
    rng = np.random.default_rng(0)
    # 95,000 rows padded up to the next 2^14 bucket: pads must not count
    _filter_sum_parity(rng.integers(0, 1000, 95_000), 500, 1 << 14)


def test_partition_histogram_matches_bincount():
    from gpu_olap_tpu.ops.hashing import partition_of
    from gpu_olap_tpu.parallel import skew

    rng = np.random.default_rng(5)
    keys = jnp.asarray(rng.integers(0, 1 << 30, 50_000).astype(np.int32))
    hist = np.asarray(skew.partition_histogram(keys, 8))
    dest = np.asarray(partition_of(keys, 8))
    np.testing.assert_array_equal(hist, np.bincount(dest, minlength=8))


def test_partition_histogram_many_partitions_and_skew():
    from gpu_olap_tpu.ops.hashing import partition_of
    from gpu_olap_tpu.parallel import skew

    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 20, 40_000)
    keys[:20_000] = 7                                   # one hot key
    keys = jnp.asarray(keys)
    hist = np.asarray(skew.partition_histogram(keys, 256))
    dest = np.asarray(partition_of(keys, 256))
    np.testing.assert_array_equal(hist, np.bincount(dest, minlength=256))
    assert hist.sum() == 40_000 and hist.max() >= 20_000
