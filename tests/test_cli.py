"""CLI surface tests (python -m gpu_olap_tpu)."""

import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest


@pytest.fixture(scope="module")
def parquet(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "t.parquet")
    pq.write_table(pa.table({"k": np.arange(100) % 5,
                             "v": np.arange(100, dtype=np.float64)}), path)
    return path


def _run(*args):
    return subprocess.run(
        [sys.executable, "-m", "gpu_olap_tpu", "--backend", "cpu", *args],
        capture_output=True, text=True, timeout=120,
    )


def test_cli_one_shot(parquet):
    r = _run("--table", f"t={parquet}",
             "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    assert r.returncode == 0, r.stderr
    assert "950" in r.stdout  # k=0 sum: 0+5+...+95
    assert "rows in" in r.stderr


def test_cli_explain(parquet):
    r = _run("--table", f"t={parquet}", "--explain",
             "SELECT v FROM t WHERE v > 10")
    assert r.returncode == 0
    assert "PhysTableScan" in r.stdout and "Filter" in r.stdout


def test_cli_sql_error(parquet):
    r = _run("--table", f"t={parquet}", "SELEC v FROM t")
    assert "error:" in r.stderr


def test_cli_bad_table_spec():
    r = _run("--table", "nopath", "SELECT 1 FROM t")
    assert r.returncode == 2


def test_cli_missing_file():
    r = _run("--table", "t=/nonexistent/file.parquet", "SELECT 1 FROM t")
    assert r.returncode == 2
    assert "error loading" in r.stderr
