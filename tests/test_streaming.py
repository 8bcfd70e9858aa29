"""Out-of-core streamed aggregation tests: parquet tables above the cache
threshold stream through the partial-aggregate pipeline and must match the
in-memory oracle exactly."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from gpu_olap_tpu import EngineConfig, OlapEngine


@pytest.fixture(scope="module")
def big_parquet(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream") / "big.parquet")
    rng = np.random.default_rng(7)
    n = 50_000
    table = pa.table({
        "k": rng.integers(0, 100, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
        "f": rng.normal(10.0, 3.0, n),
    })
    pq.write_table(table, path)
    return path, table


def _streaming_engine(path):
    eng = OlapEngine(EngineConfig(
        backend="device",
        table_cache_threshold_rows=1000,  # force out-of-core path
        batch_size=8192,
        min_shape_bucket=1024,
    ))
    eng.load_table("big", path)
    assert not eng.catalog.is_cached("big")
    return eng


def _oracle_engine(path):
    eng = OlapEngine(EngineConfig(backend="cpu"))
    eng.load_table("big", path)
    return eng


def test_streamed_groupby_matches_oracle(big_parquet):
    path, _ = big_parquet
    sql = ("SELECT k, COUNT(*) AS n, SUM(v) AS s, AVG(f) AS a, "
           "MIN(v) AS mn, MAX(f) AS mx FROM big GROUP BY k")
    res = _streaming_engine(path).query(sql)
    assert res.meta["backend"] == "streaming"
    got = res.to_pandas().sort_values("k").reset_index(drop=True)
    exp = _oracle_engine(path).query(sql).to_pandas().sort_values("k").reset_index(drop=True)
    assert got.k.tolist() == exp.k.tolist()
    assert got.n.tolist() == exp.n.tolist()
    assert got.s.tolist() == exp.s.tolist()
    np.testing.assert_allclose(got.a.to_numpy(), exp.a.to_numpy(), rtol=1e-9)
    assert got.mn.tolist() == exp.mn.tolist()
    np.testing.assert_allclose(got.mx.to_numpy(), exp.mx.to_numpy(), rtol=1e-12)


def test_streamed_filter_agg(big_parquet):
    path, table = big_parquet
    sql = "SELECT COUNT(*) AS n, SUM(v) AS s FROM big WHERE v > 500"
    res = _streaming_engine(path).query(sql)
    assert res.meta["backend"] == "streaming"
    got = res.to_pydict()
    v = table.column("v").to_numpy()
    mask = v > 500
    assert got["n"][0] == mask.sum()
    assert got["s"][0] == v[mask].sum()


def test_streamed_projection_expr(big_parquet):
    path, table = big_parquet
    sql = "SELECT k, SUM(v * 2 + 1) AS s FROM big GROUP BY k"
    res = _streaming_engine(path).query(sql)
    assert res.meta["backend"] == "streaming"
    got = res.to_pandas().sort_values("k").reset_index(drop=True)
    import pandas as pd

    df = pd.DataFrame({"k": table.column("k").to_numpy(),
                       "v": table.column("v").to_numpy()})
    df["e"] = df.v * 2 + 1
    exp = df.groupby("k").e.sum().reset_index(name="s")
    assert got.s.tolist() == exp.s.tolist()


def test_non_streamable_falls_back(big_parquet):
    path, table = big_parquet
    # ORDER BY over raw rows is not an aggregation pipeline -> full-load fallback
    eng = _streaming_engine(path)
    res = eng.query("SELECT v FROM big ORDER BY v DESC LIMIT 5")
    assert res.meta["backend"] == "device"  # full-load fallback, not streamed
    got = res.to_pydict()
    v = np.sort(table.column("v").to_numpy())[::-1][:5]
    assert list(got["v"]) == list(v)


def test_streamed_global_agg_empty_filter(big_parquet):
    path, _ = big_parquet
    sql = "SELECT COUNT(*) AS n, SUM(v) AS s FROM big WHERE v > 100000"
    got = _streaming_engine(path).query(sql)
    assert got.meta["backend"] == "streaming"
    d = got.to_pydict()
    assert d["n"][0] == 0


def test_streamed_join_aggregate(big_parquet):
    """Streamed probe join: uncached big table joins a cached dimension table,
    fused into the partial-aggregate pipeline."""
    path, table = big_parquet
    eng = _streaming_engine(path)
    dim_k = np.arange(100, dtype=np.int64)
    dim_w = (dim_k * 7 + 1).astype(np.int64)
    eng.register("dim", {"k": dim_k, "w": dim_w})
    sql = ("SELECT d.w, COUNT(*) AS n, SUM(b.v) AS s FROM big b "
           "JOIN dim d ON b.k = d.k WHERE b.v > 100 GROUP BY d.w")
    res = eng.query(sql)
    assert res.meta["backend"] == "streaming"
    got = res.to_pandas().sort_values("w").reset_index(drop=True)

    import pandas as pd

    df = pd.DataFrame({"k": table.column("k").to_numpy(),
                       "v": table.column("v").to_numpy()})
    df = df[df.v > 100].merge(pd.DataFrame({"k": dim_k, "w": dim_w}), on="k")
    exp = df.groupby("w").agg(n=("v", "count"), s=("v", "sum")).reset_index()
    assert got.w.tolist() == exp.w.tolist()
    assert got.n.tolist() == exp.n.tolist()
    assert got.s.tolist() == exp.s.tolist()


def test_streamed_join_duplicate_build_keys(big_parquet):
    path, table = big_parquet
    eng = _streaming_engine(path)
    # duplicate build keys force match expansion beyond chunk size
    dim_k = np.repeat(np.arange(50, dtype=np.int64), 3)
    dim_w = np.arange(150, dtype=np.int64)
    eng.register("dim", {"k": dim_k, "w": dim_w})
    sql = ("SELECT COUNT(*) AS n, SUM(d.w) AS s FROM big b "
           "JOIN dim d ON b.k = d.k")
    res = eng.query(sql)
    assert res.meta["backend"] == "streaming"
    got = res.to_pydict()

    import pandas as pd

    df = pd.DataFrame({"k": table.column("k").to_numpy()})
    j = df.merge(pd.DataFrame({"k": dim_k, "w": dim_w}), on="k")
    assert got["n"][0] == len(j)
    assert got["s"][0] == j.w.sum()


def test_streamed_post_aggregate_ops(big_parquet):
    """HAVING / ORDER BY / LIMIT above the aggregate must not defeat
    streaming: the aggregate subtree streams, post-ops run on the host over
    the small group results."""
    path, table = big_parquet
    sql = ("SELECT k, SUM(v) AS s FROM big GROUP BY k "
           "HAVING SUM(v) > 1000 ORDER BY s DESC LIMIT 10")
    res = _streaming_engine(path).query(sql)
    assert res.meta["backend"] == "streaming"
    got = res.to_pandas()

    import pandas as pd

    df = pd.DataFrame({"k": table.column("k").to_numpy(),
                       "v": table.column("v").to_numpy()})
    exp = df.groupby("k").v.sum().reset_index(name="s")
    exp = exp[exp.s > 1000].sort_values("s", ascending=False).head(10)
    assert got.s.tolist() == exp.s.tolist()
    assert got.k.tolist() == exp.k.tolist()


def test_arena_staging_reuse(big_parquet):
    """Chunk staging goes through the BufferArena: buffers are recycled
    across chunks (bounded allocation, not one fresh buffer per chunk)."""
    path, _ = big_parquet
    eng = _streaming_engine(path)
    res = eng.query("SELECT k, SUM(v) AS s FROM big GROUP BY k")
    assert res.meta["backend"] == "streaming"
    arena = eng._get_device_executor()._streaming_arena_stats()
    # 50k rows / 8192-row chunks = 7 chunks x 2 columns staged, but the pool
    # holds only as many buffers as were ever simultaneously in flight
    assert arena["allocated_bytes"] > 0
    total_allocated = sum(c["allocated"] for c in arena["classes"].values())
    assert total_allocated <= 2 * (eng.config.num_feed_buffers + 2)
    # after the stream completes every buffer is back in the pool
    for cls in arena["classes"].values():
        assert cls["free"] == cls["allocated"]


# ---------------------------------------------------------------------------
# hash-partitioned streamed group state (the 1B-row GROUP BY: big states
# split across P hash partitions of small per-part states)
# ---------------------------------------------------------------------------

def _hash_state_engine(path, sspg, max_groups):
    eng = OlapEngine(EngineConfig(
        backend="device",
        table_cache_threshold_rows=1000,
        batch_size=8192,
        min_shape_bucket=1024,
        max_groups=max_groups,
        stream_state_partition_groups=sspg,
    ))
    eng.load_table("big", path)
    return eng


def test_hash_state_groupby_matches_oracle(big_parquet):
    path, _ = big_parquet
    sql = ("SELECT k, COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, "
           "MAX(v) AS mx, AVG(f) AS a FROM big GROUP BY k")
    eng = _hash_state_engine(path, sspg=256, max_groups=4096)
    res = eng.query(sql)
    assert res.meta["backend"] == "streaming"
    # the partitioned-state path actually engaged
    sa = eng._get_device_executor()._streaming
    assert sa.last_hash_parts > 1
    got = res.to_pandas().sort_values("k").reset_index(drop=True)
    exp = _oracle_engine(path).query(sql).to_pandas() \
        .sort_values("k").reset_index(drop=True)
    assert got.k.tolist() == exp.k.tolist()
    assert got.n.tolist() == exp.n.tolist()
    assert got.s.tolist() == exp.s.tolist()
    assert got.mn.tolist() == exp.mn.tolist()
    assert got.mx.tolist() == exp.mx.tolist()
    np.testing.assert_allclose(got.a.to_numpy(), exp.a.to_numpy(), rtol=1e-9)


def test_hash_state_overflow_retries(big_parquet):
    """Per-partition caps sized below the actual group count must grow and
    retry, not fail or drop groups."""
    path, _ = big_parquet
    sql = "SELECT k, SUM(v) AS s FROM big GROUP BY k"
    eng = _hash_state_engine(path, sspg=32, max_groups=64)
    res = eng.query(sql)
    assert res.meta["backend"] == "streaming"
    got = res.to_pandas().sort_values("k").reset_index(drop=True)
    exp = _oracle_engine(path).query(sql).to_pandas() \
        .sort_values("k").reset_index(drop=True)
    assert got.k.tolist() == exp.k.tolist()
    assert got.s.tolist() == exp.s.tolist()


def test_hash_state_multikey_groupby(tmp_path):
    """Multi-column group keys hash-combine across the state partitions."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(23)
    n = 40_000
    path = str(tmp_path / "mk.parquet")
    pq.write_table(pa.table({
        "g1": rng.integers(0, 40, n).astype(np.int64),
        "g2": rng.integers(0, 7, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    }), path)
    sql = ("SELECT g1, g2, COUNT(*) AS n, SUM(v) AS s, MAX(v) AS mx "
           "FROM big GROUP BY g1, g2")
    eng = _hash_state_engine(path, sspg=128, max_groups=2048)
    res = eng.query(sql)
    assert res.meta["backend"] == "streaming"
    assert eng._get_device_executor()._streaming.last_hash_parts > 1
    exp = _oracle_engine(path).query(sql)
    got = res.to_pandas().sort_values(["g1", "g2"]).reset_index(drop=True)
    e = exp.to_pandas().sort_values(["g1", "g2"]).reset_index(drop=True)
    assert got.n.tolist() == e.n.tolist()
    assert got.s.tolist() == e.s.tolist()
    assert got.mx.tolist() == e.mx.tolist()


def test_streamed_nulls_fall_back_exact(tmp_path):
    """Parquet columns with metadata-recorded nulls must NOT stream (staged
    chunks carry no validity lanes — round-5 guard for a latent round-2
    gap): the full-load device path runs instead and aggregates skip nulls
    exactly like the oracle."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(13)
    n = 20_000
    v = rng.normal(10.0, 3.0, n)
    v[rng.random(n) < 0.25] = np.nan
    path = str(tmp_path / "nulls.parquet")
    pq.write_table(pa.table({
        "k": rng.integers(0, 50, n).astype(np.int64),
        "v": pa.array(v, mask=np.isnan(v)),
    }), path)
    sql = "SELECT k, COUNT(v) AS c, AVG(v) AS a FROM big GROUP BY k"
    eng = _streaming_engine(path)
    res = eng.query(sql)
    assert res.meta["backend"] == "device"  # fell back, not streamed
    exp = _oracle_engine(path).query(sql)
    got = res.to_pandas().sort_values("k").reset_index(drop=True)
    e = exp.to_pandas().sort_values("k").reset_index(drop=True)
    assert got.c.tolist() == e.c.tolist()
    np.testing.assert_allclose(got.a.to_numpy(), e.a.to_numpy(), rtol=1e-9)


def test_hash_state_with_filter(big_parquet):
    """Filters between scan and aggregate are row-local: the hash split on
    unfiltered rows stays correct."""
    path, table = big_parquet
    sql = "SELECT k, COUNT(*) AS n FROM big WHERE v > 500 GROUP BY k"
    eng = _hash_state_engine(path, sspg=128, max_groups=2048)
    res = eng.query(sql)
    assert res.meta["backend"] == "streaming"
    import pandas as pd

    df = pd.DataFrame({"k": table.column("k").to_numpy(),
                       "v": table.column("v").to_numpy()})
    exp = df[df.v > 500].groupby("k").size().reset_index(name="n")
    got = res.to_pandas().sort_values("k").reset_index(drop=True)
    assert got.k.tolist() == exp.k.tolist()
    assert got.n.tolist() == exp.n.tolist()


# ---------------------------------------------------------------------------
# grace-join partitioned path: BOTH sides above the cache threshold
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_big_parquets(tmp_path_factory):
    d = tmp_path_factory.mktemp("grace")
    rng = np.random.default_rng(17)
    # the grace path is exercised identically at 1/4 the rows (same chunking
    # structure at batch_size 2048 below) — the old 60Kx40K shape cost 300 s
    # of CPU-mesh wall time for no extra coverage
    nl, nr = 15_000, 10_000
    lpath, rpath = str(d / "l.parquet"), str(d / "r.parquet")
    pq.write_table(pa.table({
        "k": rng.integers(0, 1250, nl).astype(np.int64),
        "v": rng.integers(0, 1000, nl).astype(np.int64),
    }), lpath)
    pq.write_table(pa.table({
        "k": rng.integers(0, 1250, nr).astype(np.int64),
        "w": rng.integers(0, 1000, nr).astype(np.int64),
    }), rpath)
    return lpath, rpath


def _grace_engine(lpath, rpath, **kw):
    eng = OlapEngine(EngineConfig(
        backend="device",
        table_cache_threshold_rows=1000,  # NEITHER side fits
        batch_size=2048,
        min_shape_bucket=1024,
        **kw,
    ))
    eng.load_table("l", lpath)
    eng.load_table("r", rpath)
    assert not eng.catalog.is_cached("l")
    assert not eng.catalog.is_cached("r")
    return eng


def _grace_oracle(lpath, rpath):
    eng = OlapEngine(EngineConfig(backend="cpu"))
    eng.load_table("l", lpath)
    eng.load_table("r", rpath)
    return eng


def test_partitioned_join_aggregate_matches_oracle(two_big_parquets):
    lpath, rpath = two_big_parquets
    sql = ("SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s, MIN(r.w) AS mn "
           "FROM l JOIN r ON l.k = r.k")
    res = _grace_engine(lpath, rpath).query(sql)
    assert res.meta["backend"] == "streaming-partitioned"
    exp = _grace_oracle(lpath, rpath).query(sql)
    assert res.to_pydict() == exp.to_pydict()


def test_partitioned_join_groupby_matches_oracle(two_big_parquets):
    lpath, rpath = two_big_parquets
    sql = ("SELECT l.k AS k, COUNT(*) AS n, SUM(r.w) AS s "
           "FROM l JOIN r ON l.k = r.k GROUP BY l.k")
    eng = _grace_engine(lpath, rpath, spill_partitions=4)
    res = eng.query(sql)
    assert res.meta["backend"] == "streaming-partitioned"
    got = res.to_pandas().sort_values("k").reset_index(drop=True)
    exp = (_grace_oracle(lpath, rpath).query(sql)
           .to_pandas().sort_values("k").reset_index(drop=True))
    assert got.k.tolist() == exp.k.tolist()
    assert got.n.tolist() == exp.n.tolist()
    assert got.s.tolist() == exp.s.tolist()
    # spill partitions are cached per table version: re-query repartitions
    # nothing and still answers correctly
    res2 = eng.query(sql)
    got2 = res2.to_pandas().sort_values("k").reset_index(drop=True)
    assert got2.s.tolist() == exp.s.tolist()
