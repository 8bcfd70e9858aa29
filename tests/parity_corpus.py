"""The device-parity query corpus and its tables.

Shared by ``tests/test_device_parity.py`` (CPU device path against the NumPy
oracle) and ``chip_smoke.py`` (the same corpus on the GPU).  Needs numpy
alone: the tables are registered as dicts of arrays.
"""

import numpy as np

QUERIES = [
    # scans / filters / projection
    "SELECT product_id, amount FROM sales WHERE amount > 150",
    "SELECT amount * quantity AS v, amount + 1 AS a1 FROM sales WHERE product_id < 10",
    "SELECT amount FROM sales WHERE (amount > 100 AND year = 2024) OR quantity < 5",
    "SELECT quantity / 3 AS q, quantity % 7 AS m FROM sales WHERE product_id = 1",
    "SELECT amount FROM sales WHERE region = 'EU' AND year IN (2021, 2023)",
    "SELECT amount FROM sales WHERE region != 'EU' AND quantity BETWEEN 10 AND 20",
    "SELECT CASE WHEN amount > 100 THEN 1 ELSE 0 END AS flag FROM sales WHERE product_id = 3",
    "SELECT CAST(amount AS int) AS ai FROM sales WHERE product_id = 5",
    "SELECT abs(amount - 100.0) AS d FROM sales WHERE product_id = 7",
    # aggregation
    "SELECT COUNT(*) AS n, SUM(quantity) AS s, SUM(amount) AS f FROM sales",
    "SELECT region, COUNT(*) AS n, SUM(amount) AS s, AVG(amount) AS a, "
    "MIN(amount) AS mn, MAX(amount) AS mx FROM sales GROUP BY region",
    "SELECT region, year, SUM(quantity) AS q FROM sales GROUP BY region, year",
    "SELECT product_id, COUNT(DISTINCT customer_id) AS d FROM sales GROUP BY product_id",
    # SUM/AVG DISTINCT dedup on device (round-5 fix: was COUNT-only)
    "SELECT product_id, SUM(DISTINCT quantity) AS sd, AVG(DISTINCT quantity) AS ad "
    "FROM sales GROUP BY product_id",
    "SELECT SUM(DISTINCT quantity) AS sd, AVG(DISTINCT quantity) AS ad, "
    "COUNT(DISTINCT quantity) AS cd FROM sales",
    "SELECT region, SUM(DISTINCT v) AS sd FROM nullt GROUP BY region",
    "SELECT region, SUM(amount) AS s FROM sales GROUP BY region HAVING s > 100000",
    "SELECT region, MAX(amount) - MIN(amount) AS spread FROM sales GROUP BY region",
    "SELECT year, COUNT(*) AS n FROM sales WHERE amount > 120 GROUP BY year",
    "SELECT MIN(region) AS mn, MAX(region) AS mx FROM sales",
    # joins
    "SELECT s.amount, c.customer_name FROM sales s JOIN customers c ON s.customer_id = c.customer_id WHERE s.amount > 180",
    "SELECT c.region, SUM(s.amount) AS t FROM sales s JOIN customers c "
    "ON s.customer_id = c.customer_id GROUP BY c.region",
    "SELECT s.amount FROM sales s JOIN customers c ON s.customer_id = c.customer_id "
    "AND s.region = c.region",
    "SELECT l.v, r.w FROM lt l LEFT JOIN rt r ON l.k = r.k",
    "SELECT l.v, r.w FROM lt l RIGHT JOIN rt r ON l.k = r.k",
    "SELECT l.v, r.w FROM lt l FULL JOIN rt r ON l.k = r.k",
    "SELECT l.v FROM lt l JOIN rt r ON l.k = r.k AND l.v > r.w",
    # sort / limit / distinct
    "SELECT amount FROM sales ORDER BY amount DESC LIMIT 10",
    "SELECT region, year, amount FROM sales ORDER BY region ASC, year DESC, amount ASC LIMIT 25",
    "SELECT a FROM seq ORDER BY a LIMIT 10 OFFSET 20",
    "SELECT DISTINCT region, year FROM sales",
    "SELECT DISTINCT product_id FROM sales WHERE product_id < 5",
    # aggregates over strings / nulls
    "SELECT region, COUNT(v) AS c, SUM(v) AS s FROM nullt GROUP BY region",
    "SELECT COUNT(*) AS n FROM nullt WHERE v IS NULL",
    "SELECT COUNT(*) AS n FROM nullt WHERE v IS NOT NULL AND v > 1",
    # derived tables
    "SELECT t.region, SUM(t.v) AS s FROM "
    "(SELECT region, amount * quantity AS v FROM sales) t GROUP BY t.region",
    # date functions
    "SELECT date_part('year', ts) AS y, date_part('month', ts) AS m, COUNT(*) AS n "
    "FROM events GROUP BY y, m",
    "SELECT date_part('day', ts) AS d, date_part('hour', ts) AS h FROM events WHERE ev = 3",
    # LIKE
    "SELECT COUNT(*) AS n FROM customers WHERE customer_name LIKE 'cust00%'",
    # reference example workloads, verbatim shapes (VERDICT r4 #10:
    # /root/reference/examples/python_usage.py:226-245, 275-284)
    "SELECT c.region, p.category, "
    "COUNT(DISTINCT o.order_id) AS num_orders, "
    "COUNT(DISTINCT c.customer_id) AS num_customers, "
    "SUM(oi.quantity * p.price) AS total_revenue, "
    "AVG(oi.quantity * p.price) AS avg_order_value "
    "FROM orders o "
    "JOIN order_items oi ON o.order_id = oi.order_id "
    "JOIN products p ON oi.product_id = p.product_id "
    "JOIN customers c ON o.customer_id = c.customer_id "
    "WHERE o.order_date >= '2024-01-01' AND o.order_date < '2024-07-01' "
    "AND o.status = 'completed' "
    "GROUP BY c.region, p.category "
    "HAVING total_revenue > 9000 "
    "ORDER BY total_revenue DESC",
    "SELECT date_part('year', ts) AS year, date_part('month', ts) AS month, "
    "COUNT(*) AS num_events, SUM(ev) AS total_value "
    "FROM events GROUP BY year, month ORDER BY year, month",
    # empty results
    "SELECT amount FROM sales WHERE amount > 1e18",
    "SELECT region, SUM(amount) AS s FROM sales WHERE amount > 1e18 GROUP BY region",
    "SELECT COUNT(*) AS n, SUM(amount) AS s FROM sales WHERE amount > 1e18",
]


def populate(eng, rng):
    n = 5000
    eng.register("sales", {
        "product_id": rng.integers(0, 50, n),
        "amount": rng.normal(100.0, 50.0, n),
        "quantity": rng.integers(1, 100, n),
        "customer_id": rng.integers(0, 300, n),
        "region": rng.choice(["EU", "US", "APAC", "LATAM"], n),
        "year": rng.integers(2020, 2026, n),
    })
    eng.register("customers", {
        "customer_id": np.arange(200),  # some sales customer_ids unmatched
        "customer_name": np.array([f"cust{i:03d}" for i in range(200)]),
        "region": rng.choice(["EU", "US", "APAC", "LATAM"], 200),
    })
    eng.register("lt", {"k": rng.integers(0, 30, 100), "v": rng.integers(0, 1000, 100)})
    eng.register("rt", {"k": rng.integers(10, 40, 80), "w": rng.integers(0, 1000, 80)})
    eng.register("seq", {"a": np.arange(100)})
    vals = rng.normal(0, 2, 400)
    vals[rng.random(400) < 0.3] = np.nan
    eng.register("nullt", {"region": rng.choice(["a", "b", "c"], 400), "v": vals})
    # reference example-workload tables (orders/order_items/products shapes,
    # python_usage.py:220-245 there)
    n_ord = 800
    months = rng.integers(1, 13, n_ord)
    eng.register("orders", {
        "order_id": np.arange(n_ord),
        "customer_id": rng.integers(0, 300, n_ord),
        "order_date": np.array([f"2024-{m:02d}-{d:02d}" for m, d in
                                zip(months, rng.integers(1, 29, n_ord))]),
        "status": rng.choice(["completed", "pending", "cancelled"], n_ord,
                             p=[0.7, 0.2, 0.1]),
    })
    n_items = 2500
    eng.register("order_items", {
        "order_id": rng.integers(0, n_ord, n_items),
        "product_id": rng.integers(0, 50, n_items),
        "quantity": rng.integers(1, 10, n_items),
    })
    eng.register("products", {
        "product_id": np.arange(50),
        "category": rng.choice(["tools", "toys", "food", "books"], 50),
        "price": np.round(rng.uniform(1, 100, 50), 2),
    })
    base = np.datetime64("2023-06-01T00:00:00", "ms").astype(np.int64)
    ts = base + rng.integers(0, 400 * 24 * 3600 * 1000, 500, dtype=np.int64)
    eng.register("events", {"ts": ts.astype("datetime64[ms]"),
                            "ev": rng.integers(0, 10, 500)})
