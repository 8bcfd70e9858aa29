"""Oracle parity for the aggregate shapes the engine serves hottest: GROUP BY
over one integer key (ride, payload, count-only and DISTINCT shapes), filtered
global aggregates over a scan, and packed multi-key GROUP BY.  Each query runs
on the device path and must match the NumPy oracle, and must not fall back.
"""

import numpy as np
import pandas as pd
import pytest

from conftest import make_engine


@pytest.fixture(scope="module")
def engines():
    # bucket 32768+: the table carries a padded tail
    rng = np.random.default_rng(7)
    n = 40_000
    data = {
        "k": rng.integers(0, 500, n).astype(np.int64),
        "v": rng.integers(0, 100_000, n).astype(np.int64),
    }
    dev = make_engine("device")
    dev.register("t", data)
    cpu = make_engine("cpu")
    cpu.catalog = dev.catalog
    return dev, cpu


def _parity(dev, cpu, sql):
    got = dev.query(sql)
    assert got.metrics["backend"] == "device"
    exp = cpu.query(sql)
    gdf = got.to_pandas().sort_values(got.to_pandas().columns.tolist()).reset_index(drop=True)
    edf = exp.to_pandas().sort_values(exp.to_pandas().columns.tolist()).reset_index(drop=True)
    pd.testing.assert_frame_equal(gdf, edf, check_dtype=False, rtol=1e-12)


def test_groupby_ride_shape(engines):
    dev, cpu = engines
    _parity(dev, cpu,
            "SELECT k, COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, "
            "MAX(v) AS mx, AVG(v) AS a FROM t GROUP BY k")


def test_groupby_sum_only_payload_shape(engines):
    dev, cpu = engines
    _parity(dev, cpu, "SELECT k, SUM(v) AS s FROM t GROUP BY k")


def test_groupby_count_only(engines):
    dev, cpu = engines
    _parity(dev, cpu, "SELECT k, COUNT(*) AS n FROM t GROUP BY k")


def test_distinct_single_key(engines):
    dev, cpu = engines
    _parity(dev, cpu, "SELECT DISTINCT k FROM t")


@pytest.fixture(scope="module")
def engines_big():
    """Filtered global aggregates over a 70K-row scan."""
    rng = np.random.default_rng(8)
    n = 70_000
    data = {
        "k": rng.integers(0, 500, n).astype(np.int64),
        "v": rng.integers(-50_000, 100_000, n).astype(np.int64),
        "w": rng.integers(0, 1_000, n).astype(np.int64),
        "f": rng.normal(size=n),
    }
    dev = make_engine("device")
    dev.register("t", data)
    cpu = make_engine("cpu")
    cpu.catalog = dev.catalog
    return dev, cpu


def _parity_fa(dev, cpu, sql):
    got = dev.query(sql)
    assert got.metrics["backend"] == "device"
    exp = cpu.query(sql)
    gdf = got.to_pandas().reset_index(drop=True)
    edf = exp.to_pandas().reset_index(drop=True)
    pd.testing.assert_frame_equal(gdf, edf, check_dtype=False, rtol=1e-12)


def test_filtered_global_all_funcs(engines_big):
    dev, cpu = engines_big
    _parity_fa(dev, cpu,
               "SELECT COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, "
               "MAX(v) AS mx, AVG(v) AS a FROM t WHERE v > 500")


def test_filtered_global_distinct_filter_column(engines_big):
    dev, cpu = engines_big
    _parity_fa(dev, cpu,
               "SELECT COUNT(*) AS n, SUM(v) AS s, MAX(w) AS mw "
               "FROM t WHERE w <= 350")


def test_filtered_global_flipped_literal(engines_big):
    dev, cpu = engines_big
    _parity_fa(dev, cpu, "SELECT SUM(v) AS s FROM t WHERE 500 < v")
    _parity_fa(dev, cpu, "SELECT COUNT(w) AS c FROM t WHERE v != 0")


def test_filtered_global_empty_match(engines_big):
    dev, cpu = engines_big
    # no row matches: COUNT = 0, SUM/MIN/MAX NULL — parity with the oracle
    _parity_fa(dev, cpu,
               "SELECT COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn "
               "FROM t WHERE v > 2000000")


def test_filtered_float_and_grouped_shapes(engines_big):
    dev, cpu = engines_big
    # float predicate column (not int32-narrowable)
    _parity_fa(dev, cpu, "SELECT COUNT(*) AS n FROM t WHERE f > 0.5")
    # filtered grouped aggregate
    _parity_fa(dev, cpu,
               "SELECT k, COUNT(*) AS n FROM t WHERE v > 500 GROUP BY k "
               "ORDER BY k")


def test_filtered_global_wide_aggregate(engines_big):
    """A filter column plus six or four distinct value columns."""
    rng = np.random.default_rng(21)
    n = 70_000
    data = {c: rng.integers(0, 1000, n).astype(np.int64)
            for c in ("a", "b", "c", "d", "e", "g", "h")}
    dev = make_engine("device")
    dev.register("w", data)
    cpu = make_engine("cpu")
    cpu.catalog = dev.catalog
    sql = ("SELECT SUM(a) AS sa, SUM(b) AS sb, SUM(c) AS sc, SUM(d) AS sd, "
           "SUM(e) AS se, SUM(g) AS sg FROM w WHERE h > 500")
    _parity_fa(dev, cpu, sql)
    sql5 = ("SELECT SUM(a) AS sa, SUM(b) AS sb, SUM(c) AS sc, SUM(d) AS sd "
            "FROM w WHERE h > 500")
    _parity_fa(dev, cpu, sql5)


def test_groupby_filtered_minmax_second_argument(engines_big):
    """MIN/MAX over two different arguments (the permutation path) under a
    filter, with AVG over a float column."""
    dev, cpu = engines_big
    _parity(dev, cpu,
            "SELECT k, MIN(v) AS mn, MAX(w) AS mw, AVG(f) AS af FROM t "
            "WHERE w < 900 GROUP BY k")


def test_multikey_packed_groupby_matches_oracle():
    """Multi-key GROUP BY with zone-map-packable keys folds into one int32
    code (device.py packing); results must decode exactly — including
    negative ranges and dictionary keys."""
    import numpy as np
    import pandas as pd

    from gpu_olap_tpu import EngineConfig, OlapEngine

    rng = np.random.default_rng(77)
    n = 1 << 15
    k1 = rng.integers(-8, 40, n).astype(np.int64)
    s = np.array(["x", "y", "zz"])[rng.integers(0, 3, n)]
    v = rng.integers(-50, 50, n).astype(np.int64)

    def run(backend):
        eng = OlapEngine(EngineConfig(backend=backend,
                                      min_shape_bucket=1 << 14))
        eng.register("t", {"k1": k1, "s": s, "v": v})
        return (eng.query("SELECT k1, s, SUM(v) sv, MIN(v) mn, COUNT(*) c "
                          "FROM t GROUP BY k1, s")
                .to_pandas().sort_values(["k1", "s"]).reset_index(drop=True))

    dev = run("device")
    cpu = run("cpu")
    pd.testing.assert_frame_equal(cpu, dev, check_dtype=False)
