"""Device-executor parity: every query runs on both the NumPy oracle and the
JAX device path (8-device CPU platform) and must produce the same multiset of
rows — the BASELINE exact-parity requirement, with the oracle as the reference
semantics (SURVEY.md §4: "make the CPU path a correct oracle").
"""

import numpy as np
import pandas as pd
import pytest

from conftest import make_engine
from parity_corpus import QUERIES, populate


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(123)
    dev = make_engine("device")
    populate(dev, np.random.default_rng(123))
    cpu = make_engine("cpu")
    cpu.catalog = dev.catalog
    return dev, cpu


def _canon(result) -> pd.DataFrame:
    df = result.to_pandas()
    # canonical multiset ordering over all columns
    if len(df.columns):
        df = df.sort_values(list(df.columns)).reset_index(drop=True)
    return df


@pytest.mark.parametrize("sql", QUERIES, ids=range(len(QUERIES)))
def test_device_matches_oracle(engines, sql):
    dev, cpu = engines
    got = dev.query(sql)
    assert got.metrics["backend"] == "device", f"fell back: {sql}"
    exp = cpu.query(sql)
    gdf, edf = _canon(got), _canon(exp)
    assert list(gdf.columns) == list(edf.columns)
    assert len(gdf) == len(edf), f"{sql}: {len(gdf)} vs {len(edf)} rows"
    for col in gdf.columns:
        g, e = gdf[col].to_numpy(), edf[col].to_numpy()
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), e.astype(np.float64),
                rtol=1e-9, atol=1e-9, err_msg=f"{sql} :: {col}", equal_nan=True,
            )
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{sql} :: {col}")


def test_ordered_query_preserves_order(engines):
    dev, cpu = engines
    sql = "SELECT region, amount FROM sales ORDER BY amount DESC LIMIT 20"
    g = dev.query(sql).to_pandas()
    e = cpu.query(sql).to_pandas()
    np.testing.assert_allclose(g.amount.to_numpy(), e.amount.to_numpy())
    assert list(g.region) == list(e.region)


def test_join_capacity_overflow_recovery():
    """Many-to-many join whose output greatly exceeds the default capacity
    exercises the overflow -> grow -> recompile path (max_matches analogue)."""
    eng = make_engine("device", join_expansion=1.0, min_shape_bucket=64)
    rng = np.random.default_rng(5)
    eng.register("l", {"k": rng.integers(0, 3, 200)})
    eng.register("r", {"k": rng.integers(0, 3, 200)})
    got = eng.query("SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k")
    cpu = make_engine("cpu")
    cpu.catalog = eng.catalog
    exp = cpu.query("SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k")
    assert got.to_pydict()["n"][0] == exp.to_pydict()["n"][0]


def test_group_capacity_overflow_recovery():
    eng = make_engine("device", max_groups=16, min_shape_bucket=64)
    eng.register("t", {"k": np.arange(1000) % 300, "v": np.arange(1000)})
    got = eng.query("SELECT k, SUM(v) AS s FROM t GROUP BY k")
    assert got.num_rows == 300
    cpu = make_engine("cpu")
    cpu.catalog = eng.catalog
    exp = cpu.query("SELECT k, SUM(v) AS s FROM t GROUP BY k")
    g = got.to_pandas().sort_values("k").reset_index(drop=True)
    e = exp.to_pandas().sort_values("k").reset_index(drop=True)
    assert g.equals(e)


def test_int64_exact_sums_on_device():
    eng = make_engine("device")
    big = np.array([2**53 + 1, 2**53 + 3, 5, -7], dtype=np.int64)
    eng.register("t", {"g": np.array([1, 1, 2, 2]), "a": big})
    r = eng.query("SELECT g, SUM(a) AS s FROM t GROUP BY g")
    d = r.to_pandas().sort_values("g")
    assert list(d.s) == [2**54 + 4, -2]


def test_compile_cache_reuse(engines):
    dev, _ = engines
    sql = "SELECT region, COUNT(*) AS n FROM sales GROUP BY region"
    dev.query(sql)
    n_compiled = len(dev._device_executor._compiled)
    dev.query(sql)
    assert len(dev._device_executor._compiled) == n_compiled
