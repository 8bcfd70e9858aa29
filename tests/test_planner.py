"""Physical planner tests — schema derivation (done for real, unlike
``physical_plan.rs:250-265``), join key extraction, and strategy selection
(``join_kernel.rs:71-77`` thresholds)."""

import numpy as np
import pytest

from gpu_olap_tpu.catalog import CatalogError
from gpu_olap_tpu.interop.columnar import DType
from gpu_olap_tpu.plan import physical as P

from conftest import make_engine


@pytest.fixture
def engine(sales_data, customers_data):
    eng = make_engine("cpu")
    eng.register("sales", sales_data)
    eng.register("customers", customers_data)
    return eng


def test_unknown_table_errors(engine):
    # reference behavior: planning a scan of an unknown table fails
    # (integration_tests.rs:122-137)
    with pytest.raises(CatalogError):
        engine.plan_query("SELECT a FROM nonexistent")


def test_scan_projection_indices(engine):
    plan = engine.plan_query("SELECT amount FROM sales WHERE year = 2024")
    scans = _find(plan, P.PhysTableScan)
    assert len(scans) == 1
    # projection pruned to {amount, year}
    assert scans[0].projection is not None
    assert set(scans[0].schema.names) == {"sales.amount", "sales.year"}


def test_projection_schema_types(engine):
    plan = engine.plan_query(
        "SELECT amount * quantity AS v, product_id + 1 AS p, amount > 0 AS b FROM sales"
    )
    assert [f.dtype for f in plan.schema] == [DType.FLOAT64, DType.INT64, DType.BOOL]
    assert plan.schema.names == ["v", "p", "b"]


def test_join_schema_merges_sides(engine):
    plan = engine.plan_query(
        "SELECT s.amount, c.customer_name FROM sales s "
        "JOIN customers c ON s.customer_id = c.customer_id"
    )
    joins = _find(plan, P.PhysHashJoin)
    assert len(joins) == 1
    j = joins[0]
    assert len(j.left_keys) == 1 and len(j.right_keys) == 1
    # join output schema = left fields ++ right fields (not the empty stub)
    assert len(j.schema) == len(j.left.schema) + len(j.right.schema)


def test_join_strategy_broadcast_small_build(engine):
    plan = engine.plan_query(
        "SELECT s.amount FROM sales s JOIN customers c ON s.customer_id = c.customer_id"
    )
    j = _find(plan, P.PhysHashJoin)[0]
    # customers = 200 rows < 1M threshold -> broadcast
    assert j.strategy == "broadcast_hash"


def test_join_residual_filter(engine):
    plan = engine.plan_query(
        "SELECT s.amount FROM sales s JOIN customers c "
        "ON s.customer_id = c.customer_id AND s.amount > c.credit"
    )
    j = _find(plan, P.PhysHashJoin)[0]
    assert len(j.left_keys) == 1
    assert j.residual is not None


def test_aggregate_schema(engine):
    plan = engine.plan_query(
        "SELECT region, COUNT(*) AS n, SUM(amount) AS s, AVG(amount) AS a, "
        "MIN(quantity) AS mn FROM sales GROUP BY region"
    )
    aggs = _find(plan, P.PhysAggregate)
    assert len(aggs) == 1
    agg = aggs[0]
    assert [f.dtype for f in agg.schema] == [
        DType.STRING, DType.INT64, DType.FLOAT64, DType.FLOAT64, DType.INT64,
    ]
    assert [s.func for s in agg.aggs] == ["count", "sum", "avg", "min"]


def test_sum_int_stays_int(engine):
    plan = engine.plan_query("SELECT SUM(quantity) FROM sales")
    agg = _find(plan, P.PhysAggregate)[0]
    assert agg.aggs[0].out_dtype is DType.INT64


def test_sort_limit_fusion(engine):
    plan = engine.plan_query("SELECT amount FROM sales ORDER BY amount DESC LIMIT 10")
    sorts = _find(plan, P.PhysSort)
    assert sorts and sorts[0].limit == 10


def test_no_equi_keys_errors(engine):
    with pytest.raises(P.PlanError):
        engine.plan_query(
            "SELECT s.amount FROM sales s JOIN customers c ON s.amount > c.credit"
        )


def test_ambiguous_column_errors(engine):
    eng = make_engine("cpu")
    eng.register("a", {"k": np.arange(3), "v": np.arange(3)})
    eng.register("b", {"k": np.arange(3), "v": np.arange(3)})
    with pytest.raises(Exception):
        eng.plan_query("SELECT v FROM a JOIN b ON a.k = b.k")


def _find(plan, cls):
    out = []

    def walk(p):
        if isinstance(p, cls):
            out.append(p)
        for k in p.inputs():
            walk(k)

    walk(plan)
    return out


def test_join_strategy_override(engine):
    from conftest import make_engine

    eng = make_engine("cpu", join_strategy="sort_merge")
    eng.catalog = engine.catalog
    plan = eng.plan_query(
        "SELECT s.amount FROM sales s JOIN customers c ON s.customer_id = c.customer_id"
    )
    j = _find(plan, P.PhysHashJoin)[0]
    assert j.strategy == "sort_merge"
