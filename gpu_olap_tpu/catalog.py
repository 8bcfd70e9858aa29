"""Table catalog.

Analogue of ``gpu-olap-core/src/catalog.rs``: a table registry that
records schema/location/row-count on load (``catalog.rs:32-73``) and eagerly
caches tables below a row threshold in memory (``catalog.rs:50``, 10M rows).
In-memory registration (pandas / Arrow / dict-of-arrays) is first-class since the
reference's documented ``query_pandas`` path depends on it
(``examples/python_usage.py:96``).  pyarrow is imported only by the Parquet,
Arrow and pandas paths: dict-of-arrays tables need numpy alone.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional

from .interop.columnar import ColumnBatch, Schema
from .utils.tracing import get_logger

logger = get_logger(__name__)


class CatalogError(KeyError):
    pass


@dataclasses.dataclass
class TableMetadata:
    schema: Schema
    location: Optional[str]       # parquet path, or None for in-memory
    row_count: int
    data_cache: Optional[ColumnBatch]  # eagerly cached host batch
    # per-column (min, max) statistics for integer columns — zone-map style
    # metadata driving the int32 small-key fast path on device (narrow keys
    # move half the bytes through every sort and probe)
    stats: Optional[dict] = None


class Catalog:
    def __init__(self, cache_threshold_rows: int = 10_000_000):
        self._tables: Dict[str, TableMetadata] = {}
        self._lock = threading.Lock()
        self._cache_threshold = cache_threshold_rows
        # monotonically increasing per-table version (result-cache invalidation)
        self._versions: Dict[str, int] = {}
        self._version_counter = 0

    def _bump(self, name: str) -> None:
        self._version_counter += 1
        self._versions[name] = self._version_counter

    def get_version(self, name: str) -> int:
        return self._versions.get(name, 0)

    @property
    def cache_threshold(self) -> int:
        return self._cache_threshold

    # -- registration ------------------------------------------------------
    def load_table(self, name: str, path: str) -> None:
        """Register a Parquet table (``catalog.rs:32-73``)."""
        from .interop import arrow as arrow_io

        schema, row_count = arrow_io.read_parquet_schema(path)
        cache = None
        if row_count < self._cache_threshold:
            cache = arrow_io.read_parquet(path)
            stats = compute_stats(cache)
        else:
            # out-of-core: zone maps from parquet METADATA (no data read) —
            # int64 stats only, matching compute_stats' contract
            import numpy as np

            try:
                raw = arrow_io.parquet_column_stats(path)
            except Exception:  # noqa: BLE001 — stats are best-effort
                raw = {}
            int64_cols = {f.name for f in schema
                          if f.dtype.numpy_dtype == np.dtype(np.int64)}
            stats = {k: v for k, v in raw.items()
                     if k in int64_cols or k == "__nulls__"} or None
        with self._lock:
            self._tables[name] = TableMetadata(schema, path, row_count, cache,
                                               stats)
            self._bump(name)
        logger.info("loaded table %r from %s (%d rows, cached=%s)",
                    name, path, row_count, cache is not None)

    def register_batch(self, name: str, batch: ColumnBatch) -> None:
        stats = compute_stats(batch)
        with self._lock:
            self._tables[name] = TableMetadata(batch.schema, None,
                                               batch.num_rows, batch, stats)
            self._bump(name)

    def register_pandas(self, name: str, df) -> None:
        from .interop import arrow as arrow_io

        self.register_batch(name, arrow_io.batch_from_pandas(df))

    def register_arrow(self, name: str, table) -> None:
        from .interop import arrow as arrow_io

        self.register_batch(name, arrow_io.batch_from_arrow(table))

    # -- accessors (catalog.rs:76-116) ------------------------------------
    def _meta(self, name: str) -> TableMetadata:
        try:
            return self._tables[name]
        except KeyError:
            raise CatalogError(f"Unknown table {name!r}; loaded: {self.list_tables()}")

    def get_schema(self, name: str) -> Schema:
        return self._meta(name).schema

    def get_table_data(self, name: str) -> ColumnBatch:
        meta = self._meta(name)
        if meta.data_cache is not None:
            return meta.data_cache
        assert meta.location is not None
        from .interop import arrow as arrow_io

        return arrow_io.read_parquet(meta.location)

    def iter_table_chunks(self, name: str, batch_size: int,
                          columns: Optional[List[str]] = None) -> Iterator[ColumnBatch]:
        """Streamed chunked scan for out-of-core execution."""
        meta = self._meta(name)
        if meta.location is not None and meta.data_cache is None:
            from .interop import arrow as arrow_io

            yield from arrow_io.iter_parquet_chunks(meta.location, batch_size, columns)
            return
        batch = meta.data_cache
        if columns is not None:
            batch = batch.select([batch.schema.index_of(c) for c in columns])
        for start in range(0, max(batch.num_rows, 1), batch_size):
            stop = min(start + batch_size, batch.num_rows)
            if start >= batch.num_rows and start > 0:
                break
            from .interop.columnar import Column
            cols = []
            for c in batch.columns:
                v = None if c.validity is None else c.validity[start:stop]
                cols.append(Column(c.data[start:stop], v, c.dictionary))
            yield ColumnBatch(batch.schema, cols, stop - start)
            if stop >= batch.num_rows:
                break

    def get_table_location(self, name: str) -> Optional[str]:
        return self._meta(name).location

    def get_stats(self, name: str) -> Optional[dict]:
        return self._meta(name).stats

    def ensure_sorted_stat(self, name: str, col: str) -> bool:
        """Lazily computed + cached column sortedness (nondecreasing,
        null-free) — enables the pre-sorted sort-merge join strategy
        (reference join_kernel.rs:10-14: SortMergeJoin for pre-sorted
        data)."""
        meta = self._meta(name)
        if meta.stats is None:
            return False
        key = ("__sorted__", col)
        if key in meta.stats:
            return meta.stats[key]
        result = False
        if meta.data_cache is not None:
            import numpy as np

            try:
                column = meta.data_cache.column_by_name(col)
                if column.validity is None and column.dictionary is None:
                    data = np.asarray(column.data)
                    if data.dtype.kind in "iu" and len(data) > 1:
                        result = bool(np.all(data[1:] >= data[:-1]))
                    elif data.dtype.kind in "iu":
                        result = True
            except KeyError:
                pass
        meta.stats[key] = result
        return result

    def ensure_unique_stat(self, name: str, col: str) -> bool:
        """Lazily computed + cached column uniqueness (key-column statistic
        enabling lookup joins)."""
        meta = self._meta(name)
        if meta.stats is None:
            return False
        key = ("__unique__", col)
        if key in meta.stats:
            return meta.stats[key]
        if meta.data_cache is None:
            meta.stats[key] = False
            return False
        import numpy as np

        try:
            column = meta.data_cache.column_by_name(col)
        except KeyError:
            meta.stats[key] = False
            return False
        if column.validity is not None:
            meta.stats[key] = False
            return False
        data = np.asarray(column.data)
        unique = None
        rng = meta.stats.get(col) if meta.stats else None
        if rng is not None and data.dtype == np.int64:
            # native bitmap check: O(n) with duplicate early-exit
            from . import native

            unique = native.int64_unique_bounded(data, int(rng[0]), int(rng[1]))
        if unique is None:
            unique = bool(len(np.unique(data)) == len(data))
        meta.stats[key] = unique
        return unique

    def get_row_count(self, name: str) -> int:
        return self._meta(name).row_count

    def is_cached(self, name: str) -> bool:
        return self._meta(name).data_cache is not None

    def list_tables(self) -> List[str]:
        return sorted(self._tables)

    def drop_table(self, name: str) -> None:
        with self._lock:
            self._tables.pop(name, None)
            self._bump(name)


def compute_stats(batch: ColumnBatch) -> dict:
    """Zone-map style per-column (min, max) for integer-typed columns."""
    import numpy as np

    from . import native

    stats = {}
    for f, c in zip(batch.schema, batch.columns):
        if f.dtype.numpy_dtype != np.dtype(np.int64) or batch.num_rows == 0:
            continue
        data = np.asarray(c.data)
        if c.validity is not None:
            valid = np.asarray(c.validity)
            if not valid.any():
                continue
            data = data[valid]
        mm = native.int64_minmax(data)  # multithreaded scan; numpy fallback
        if mm is None:
            mm = (int(data.min()), int(data.max()))
        stats[f.name] = mm
    return stats
