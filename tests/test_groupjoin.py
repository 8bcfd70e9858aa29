"""Eager aggregation through joins (group-join rewrite).

Global aggregates over an inner join must compute from probe-side match
counts without materializing the match buffer — and must agree exactly with
the CPU oracle (which always materializes).  Reference context: the CUDA probe
kernel caps matches with ``max_matches`` (join_kernels.cuh:127,157); the
rewrite sidesteps that capacity entirely for COUNT/SUM/AVG/MIN/MAX shapes.
"""

import numpy as np
import pytest

from gpu_olap_tpu import EngineConfig, OlapEngine


@pytest.fixture()
def engines():
    rng = np.random.default_rng(7)
    nk = 40
    lv = rng.integers(0, 100, 1500).astype(np.int64)
    tables = {
        "l": {"k": rng.integers(0, nk, 1500).astype(np.int64), "v": lv},
        "r": {"k": rng.integers(0, nk, 900).astype(np.int64),
              "w": rng.integers(0, 100, 900).astype(np.int64)},
    }
    dev = OlapEngine(EngineConfig(backend="device", min_shape_bucket=64,
                                  join_expansion=1.0))
    cpu = OlapEngine(EngineConfig(backend="cpu"))
    for n, t in tables.items():
        dev.register(n, t)
        cpu.register(n, t)
    return dev, cpu


QUERIES = [
    # duplicate-heavy count: the sortmerge headline shape
    "SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k",
    # grouped over probe-side keys: multiplicity-weighted per group,
    # unmatched probe rows must not form groups
    "SELECT l.v % 7 AS g, COUNT(*) AS n, SUM(l.v) AS s, AVG(l.v) AS a "
    "FROM l JOIN r ON l.k = r.k GROUP BY g ORDER BY g",
    "SELECT l.v % 5 AS g, MIN(l.v) AS mn, MAX(l.v) AS mx, COUNT(l.v) AS c "
    "FROM l JOIN r ON l.k = r.k GROUP BY g ORDER BY g",
    # multiplicity-weighted sum/avg + multiplicity-free min/max
    "SELECT COUNT(*) AS n, SUM(l.v) AS s, AVG(l.v) AS a, "
    "MIN(l.v) AS mn, MAX(l.v) AS mx FROM l JOIN r ON l.k = r.k",
    # probe-side expression + filter pushed below the join
    "SELECT SUM(l.v * 2 + 1) AS s FROM l JOIN r ON l.k = r.k WHERE l.v > 50",
    "SELECT COUNT(l.v) AS c FROM l JOIN r ON l.k = r.k",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_groupjoin_matches_oracle(engines, sql):
    dev, cpu = engines
    d = dev.query(sql).to_pydict()
    c = cpu.query(sql).to_pydict()
    assert set(d) == set(c)
    for k in d:
        np.testing.assert_allclose(
            np.asarray(d[k], dtype=np.float64),
            np.asarray(c[k], dtype=np.float64), rtol=1e-12, err_msg=sql)


def test_groupjoin_avoids_match_buffer(engines):
    """The rewrite must not allocate join match capacity (no overflow flags,
    no growth recompiles) even when matches vastly exceed any buffer guess."""
    dev, _ = engines
    dev.query("SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k")
    ex = dev._get_device_executor()
    assert not ex._cap_override, f"unexpected capacity growth: {ex._cap_override}"


def test_sorted_space_global_join_agg(engines):
    """Key-derived global aggregates reduce in merge-sorted key space
    (round 5): the path must engage (counter) and match the oracle,
    including the equi-key substituted SUM(l.k + r.k)."""
    from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS

    dev, cpu = engines
    for sql in (
        "SELECT COUNT(*) AS n, SUM(l.k + r.k) AS s FROM l JOIN r ON l.k = r.k",
        "SELECT MIN(l.k) AS mn, MAX(r.k) AS mx, AVG(l.k) AS a "
        "FROM l JOIN r ON l.k = r.k",
    ):
        before = GLOBAL_METRICS.counters.get("sorted_global_join_agg", 0)
        d = dev.query(sql).to_pydict()
        assert GLOBAL_METRICS.counters.get(
            "sorted_global_join_agg", 0) > before, f"path not taken: {sql}"
        c = cpu.query(sql).to_pydict()
        for k in d:
            np.testing.assert_allclose(
                np.asarray(d[k], dtype=np.float64),
                np.asarray(c[k], dtype=np.float64), rtol=1e-12, err_msg=sql)


def test_decomposable_pair_aggregates(engines):
    """Round 5: SUM/AVG over top-level sums of side-pure terms reduce in
    sorted space (sum over pairs of f(probe)+g(build) = weighted side sums);
    MIN/MAX take single-side arguments.  Exact parity, path engaged."""
    from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS

    dev, cpu = engines
    for sql in (
        "SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s FROM l JOIN r ON l.k = r.k",
        "SELECT SUM(r.w) AS sw, AVG(l.v + r.w) AS a, MIN(r.w) AS mn, "
        "MAX(l.v) AS mx, COUNT(r.w) AS c FROM l JOIN r ON l.k = r.k",
        "SELECT SUM(l.v * 2 + r.w) AS s FROM l JOIN r ON l.k = r.k",
    ):
        before = GLOBAL_METRICS.counters.get("sorted_global_join_agg", 0)
        d = dev.query(sql).to_pydict()
        assert GLOBAL_METRICS.counters.get(
            "sorted_global_join_agg", 0) > before, f"path not taken: {sql}"
        c = cpu.query(sql).to_pydict()
        for k in d:
            np.testing.assert_allclose(
                np.asarray(d[k], dtype=np.float64),
                np.asarray(c[k], dtype=np.float64), rtol=1e-12, err_msg=sql)


def test_sorted_grouped_join_agg_opt_in(engines):
    """The grouped sorted-space variant is OPT-IN (an A/B on the previous
    accelerator found it slower than the probe-order path) — correctness
    still holds when enabled."""
    from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS

    _, cpu = engines
    dev = OlapEngine(EngineConfig(backend="device", min_shape_bucket=64,
                                  join_expansion=1.0,
                                  use_sorted_join_agg=True))
    dev.catalog = cpu.catalog
    # plain-column group key: computed keys whose eval carries a validity
    # lane (e.g. % with its div-by-zero guard) fall back by design
    sql = ("SELECT l.v AS g, COUNT(*) AS n, SUM(l.v) AS s, "
           "AVG(l.v) AS a, MIN(l.v) AS mn FROM l JOIN r ON l.k = r.k "
           "GROUP BY l.v ORDER BY g")
    before = GLOBAL_METRICS.counters.get("sorted_grouped_join_agg", 0)
    d = dev.query(sql).to_pydict()
    assert GLOBAL_METRICS.counters.get(
        "sorted_grouped_join_agg", 0) > before, "opt-in path not taken"
    c = cpu.query(sql).to_pydict()
    for k in d:
        np.testing.assert_allclose(
            np.asarray(d[k], dtype=np.float64),
            np.asarray(c[k], dtype=np.float64), rtol=1e-12)


def test_groupjoin_ineligible_falls_back(engines):
    """Non-decomposable mixed-side arguments need the real pair expansion."""
    dev, cpu = engines
    sql = "SELECT SUM(l.v * r.w) AS s FROM l JOIN r ON l.k = r.k"
    d = dev.query(sql).to_pydict()
    c = cpu.query(sql).to_pydict()
    np.testing.assert_allclose(np.asarray(d["s"], dtype=np.float64),
                               np.asarray(c["s"], dtype=np.float64))
