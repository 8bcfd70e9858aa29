"""Engine entry point.

Analogue of ``OlapEngine`` (``gpu-olap-core/src/lib.rs:45-79``): owns
the catalog + config and drives parse -> optimize -> physical plan -> execute.
The Python-facing class also provides the documented binding API
(``GpuOlapEngine`` ctor kwargs, ``query_pandas``, ``query_polars`` —
``examples/python_usage.py:20-38,96,164`` / README.md:260-312), which the
reference documents but never implemented.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from .catalog import Catalog
from .config import EngineConfig
from .executor.result import QueryResult
from .plan.optimizer import optimize
from .plan.physical import create_physical_plan
from .sql.parser import parse_sql
from .utils.metrics import GLOBAL_METRICS, Timer
from .utils.tracing import get_logger

logger = get_logger(__name__)


class OlapEngine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.catalog = Catalog(self.config.table_cache_threshold_rows)
        self.metrics = GLOBAL_METRICS
        self._device_executor = None
        # query result cache keyed by (sql, referenced table versions) —
        # the reference documents this but never uses enable_cache
        # (PROJECT_SUMMARY.md:200, lib.rs:29-30)
        self._result_cache: dict = {}
        self._result_cache_max = 128
        # concurrent execution (reference: tokio async engine + DashMap
        # catalog, lib.rs:52 / catalog.rs:12).  Parse/optimize/plan are pure
        # and run concurrently; the single-accelerator device executor is
        # serialized by _device_lock; the CPU oracle runs fully concurrent.
        self._cache_lock = threading.Lock()
        self._exec_init_lock = threading.Lock()
        self._device_lock = threading.Lock()
        self._df_lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- table management (lib.rs:71-78) -----------------------------------
    def load_table(self, name: str, path: str) -> None:
        self.catalog.load_table(name, path)

    def register(self, name: str, data) -> None:
        """Register in-memory data: pandas DataFrame, Arrow Table, dict of arrays."""
        import numpy as np

        from .interop.columnar import ColumnBatch

        if isinstance(data, ColumnBatch):
            self.catalog.register_batch(name, data)
        elif isinstance(data, dict):
            self.catalog.register_batch(name, ColumnBatch.from_dict(data))
        elif type(data).__module__.startswith("pandas"):
            self.catalog.register_pandas(name, data)
        elif type(data).__module__.startswith("pyarrow"):
            self.catalog.register_arrow(name, data)
        else:
            raise TypeError(f"Cannot register {type(data)}")

    def get_table_schema(self, name: str):
        return self.catalog.get_schema(name)

    def drop_table(self, name: str) -> None:
        self.catalog.drop_table(name)

    # -- planning ----------------------------------------------------------
    def plan_query(self, sql: str):
        """SQL -> optimized physical plan (lib.rs:52-60 pipeline, minus execute)."""
        logical = parse_sql(sql)
        optimized = optimize(logical)
        return create_physical_plan(optimized, self.catalog, self.config)

    def explain(self, sql: str) -> str:
        logical = parse_sql(sql)
        optimized = optimize(logical)
        physical = create_physical_plan(optimized, self.catalog, self.config)
        return (
            "== Logical ==\n" + str(logical)
            + "\n== Optimized ==\n" + str(optimized)
            + "\n== Physical ==\n" + str(physical)
        )

    # -- execution (lib.rs:52-68) ------------------------------------------
    def execute_query(self, sql: str) -> QueryResult:
        with Timer() as t_plan:
            physical = self.plan_query(sql)
        cache_key = None
        if self.config.enable_cache:
            tables = self._referenced_tables(physical)
            cache_key = (sql, tuple((t, self.catalog.get_version(t))
                                    for t in tables))
            with self._cache_lock:
                hit = self._result_cache.get(cache_key)
            if hit is not None:
                return QueryResult(hit, {"plan_seconds": t_plan.seconds,
                                         "exec_seconds": 0.0,
                                         "backend": "result-cache"})
        backend = self._resolve_backend()
        with Timer() as t_exec:
            if backend == "cpu":
                from .executor.cpu import CpuExecutor

                batch = CpuExecutor(self.catalog, self.config).execute(physical)
            else:
                from .executor.device import DeviceUnsupported

                batch = None
                if self.config.mesh_shape and self.config.mesh_shape[0] > 1:
                    from .parallel.dist_executor import (
                        DistributedExecutor, NotDistributable,
                    )

                    try:
                        with self._device_lock:
                            batch = self._get_distributed_executor().execute(
                                physical)
                        backend = "distributed"
                    except NotDistributable as e:
                        logger.info("plan not distributable (%s); "
                                    "single-device path", e)
                if batch is None:
                    try:
                        dev = self._get_device_executor()
                        # one accelerator: device programs serialize (the
                        # executor also mutates its compile/table caches)
                        with self._device_lock:
                            batch = dev.execute(physical)
                            backend = getattr(dev, "last_backend", "device")
                    except DeviceUnsupported as e:
                        logger.info("device path unsupported (%s); CPU fallback", e)
                        from .executor.cpu import CpuExecutor

                        backend = "cpu-fallback"
                        batch = CpuExecutor(self.catalog, self.config).execute(physical)
        logger.info("query executed: plan %.2f ms, exec %.2f ms, %d rows",
                    t_plan.seconds * 1e3, t_exec.seconds * 1e3, batch.num_rows)
        if cache_key is not None:
            with self._cache_lock:
                if len(self._result_cache) >= self._result_cache_max:
                    self._result_cache.pop(next(iter(self._result_cache)))
                self._result_cache[cache_key] = batch
        return QueryResult(batch, {
            "plan_seconds": t_plan.seconds,
            "exec_seconds": t_exec.seconds,
            "backend": backend,
        })

    # alias matching the documented Python API
    def query(self, sql: str) -> QueryResult:
        return self.execute_query(sql)

    # -- concurrent execution (reference: async tokio API, lib.rs:52) -------
    def query_async(self, sql: str) -> "Future[QueryResult]":
        """Submit a query to the engine's thread pool and return a
        ``concurrent.futures.Future``.  Planning runs concurrently across
        queries; device programs serialize on the accelerator while the CPU
        oracle executes fully in parallel.  Pool width follows
        ``num_feed_buffers`` (the reference's ``num_streams``, lib.rs:36)."""
        return self._get_pool().submit(self.execute_query, sql)

    async def aquery(self, sql: str) -> QueryResult:
        """asyncio coroutine form of :meth:`query_async` — the direct
        analogue of the reference's ``async fn execute_query``."""
        import asyncio

        return await asyncio.wrap_future(self.query_async(sql))

    def shutdown(self) -> None:
        """Drain and close the concurrent-query pool (idempotent)."""
        with self._exec_init_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _get_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            with self._exec_init_lock:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=max(self.config.num_feed_buffers, 1),
                        thread_name_prefix="olap-query")
        return self._pool

    def query_pandas(self, df, sql: str) -> QueryResult:
        """Query a pandas DataFrame registered as table ``df``
        (``examples/python_usage.py:96``).  The fixed table name is part of
        the documented API, so concurrent frame queries serialize on it."""
        with self._df_lock:
            self.catalog.register_pandas("df", df)
            try:
                return self.execute_query(sql)
            finally:
                self.catalog.drop_table("df")

    def query_polars(self, df, sql: str) -> QueryResult:
        """Polars integration via Arrow (``examples/python_usage.py:164``)."""
        with self._df_lock:
            self.catalog.register_arrow("df", df.to_arrow())
            try:
                return self.execute_query(sql)
            finally:
                self.catalog.drop_table("df")

    # -- internals ---------------------------------------------------------
    @staticmethod
    def _referenced_tables(physical) -> list:
        from .plan.physical import PhysTableScan

        names = set()

        def walk(p):
            if isinstance(p, PhysTableScan):
                names.add(p.table_name)
            for k in p.inputs():
                walk(k)

        walk(physical)
        return sorted(names)

    def _resolve_backend(self) -> str:
        if self.config.backend != "auto":
            return self.config.backend
        try:
            import jax  # noqa: F401

            return "device"
        except Exception:
            return "cpu"

    def _get_device_executor(self):
        if self._device_executor is None:
            with self._exec_init_lock:
                if self._device_executor is None:
                    from .executor.device import DeviceExecutor

                    self._device_executor = DeviceExecutor(
                        self.catalog, self.config)
        return self._device_executor

    def _get_distributed_executor(self):
        if getattr(self, "_dist_executor", None) is None:
            with self._exec_init_lock:
                if getattr(self, "_dist_executor", None) is None:
                    from .executor.device import _Interpreter
                    from .parallel.dist_executor import DistributedExecutor

                    self._dist_executor = DistributedExecutor(
                        self.catalog, self.config, _Interpreter
                    )
        return self._dist_executor


class GpuOlapEngine(OlapEngine):
    """Binding-style constructor accepting the reference's kwargs
    (``gpu_olap_py.GpuOlapEngine(max_gpu_memory=..., num_streams=...,
    use_unified_memory=...)``, README.md:260-270) — drop-in for code written
    against the documented reference binding."""

    def __init__(self, **kwargs):
        super().__init__(EngineConfig.from_kwargs(**kwargs))
