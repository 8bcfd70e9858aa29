

def test_presorted_build_auto_sort_merge():
    """Catalog sortedness statistic auto-selects the sort-merge strategy and
    the executor's build sort collapses to a sentinel mask — results must
    still match the oracle exactly (reference join_kernel.rs:10-14)."""
    import numpy as np

    from gpu_olap_tpu import EngineConfig, OlapEngine

    rng = np.random.default_rng(31)
    nb = 5000
    # sorted build key WITH duplicates (defeats the unique-key lookup path)
    bk = np.sort(rng.integers(0, nb // 2, nb)).astype(np.int64)
    pk = rng.integers(0, nb // 2, 8000).astype(np.int64)

    def mk(backend):
        eng = OlapEngine(EngineConfig(backend=backend, min_shape_bucket=256))
        eng.register("b", {"k": bk, "w": np.arange(nb, dtype=np.int64)})
        eng.register("p", {"k": pk})
        return eng

    dev = mk("device")
    got = dev.query("SELECT COUNT(*) AS n, SUM(b.w) AS s "
                    "FROM p JOIN b ON p.k = b.k").to_pydict()
    exp = mk("cpu").query("SELECT COUNT(*) AS n, SUM(b.w) AS s "
                          "FROM p JOIN b ON p.k = b.k").to_pydict()
    assert got == exp
    # the statistic engaged (build side is small -> broadcast threshold may
    # win; force the check on the planner-level stat instead)
    assert dev.catalog.ensure_sorted_stat("b", "k") is True
    assert dev.catalog.ensure_sorted_stat("p", "k") is False


def test_presorted_stat_respects_nulls_and_order():
    import numpy as np

    from gpu_olap_tpu import EngineConfig, OlapEngine

    eng = OlapEngine(EngineConfig(backend="cpu"))
    eng.register("t", {"a": np.array([3, 1, 2], dtype=np.int64),
                       "b": np.array([1, 2, 3], dtype=np.int64)})
    assert eng.catalog.ensure_sorted_stat("t", "a") is False
    assert eng.catalog.ensure_sorted_stat("t", "b") is True


def test_stream_join_engages_and_matches_oracle():
    """>=32K-row int32-foldable inner join with pair arguments from both
    sides: exact parity with the oracle."""
    import numpy as np

    from gpu_olap_tpu import EngineConfig, OlapEngine

    rng = np.random.default_rng(33)
    nl = nr = 40_000
    nkeys = nr // 2
    lk = rng.integers(0, nkeys, nl).astype(np.int64)
    rk = rng.integers(0, nkeys, nr).astype(np.int64)
    lv = rng.integers(0, 1000, nl).astype(np.int64)
    rw = rng.integers(0, 1000, nr).astype(np.int64)

    def mk(backend):
        eng = OlapEngine(EngineConfig(backend=backend, join_expansion=2.5,
                                      min_shape_bucket=1 << 14))
        eng.register("l", {"k": lk, "v": lv})
        eng.register("r", {"k": rk, "w": rw})
        return eng

    sql = ("SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s, MIN(l.v - r.w) AS mn "
           "FROM l JOIN r ON l.k = r.k")
    got = mk("device").query(sql).to_pydict()
    exp = mk("cpu").query(sql).to_pydict()
    assert got == exp


def test_stream_join_grouped_parity():
    import numpy as np

    from gpu_olap_tpu import EngineConfig, OlapEngine

    rng = np.random.default_rng(34)
    # ~6x match expansion bounds the capacity the CPU run must carry
    nl, nr = 25_000, 10_000
    nkeys = 1_750  # heavy duplication both sides
    lk = rng.integers(0, nkeys, nl).astype(np.int64)
    rk = rng.integers(0, nkeys, nr).astype(np.int64)
    rg = rng.integers(0, 7, nr).astype(np.int64)

    def mk(backend):
        eng = OlapEngine(EngineConfig(backend=backend, join_expansion=60.0,
                                      min_shape_bucket=1 << 14))
        eng.register("l", {"k": lk})
        eng.register("r", {"k": rk, "g": rg})
        return eng

    sql = ("SELECT r.g AS g, COUNT(*) AS n FROM l JOIN r ON l.k = r.k "
           "GROUP BY r.g")
    got = mk("device").query(sql).to_pandas().sort_values("g").reset_index(drop=True)
    exp = mk("cpu").query(sql).to_pandas().sort_values("g").reset_index(drop=True)
    assert got.g.tolist() == exp.g.tolist()
    assert got.n.tolist() == exp.n.tolist()
