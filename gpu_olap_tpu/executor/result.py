"""Query result wrapper — the Python-facing result object.

Matches the documented reference result surface: ``.to_pandas()``
(``examples/python_usage.py:38``), Arrow interop for ``pl.from_arrow(result)``
(``:181``), plus numpy dict access for tests.
"""

from __future__ import annotations

from ..interop.columnar import ColumnBatch


class QueryResult:
    def __init__(self, batch: ColumnBatch, metrics: dict | None = None):
        self._batch = batch
        self.metrics = metrics or {}

    @property
    def meta(self) -> dict:
        """Execution metadata — ``meta["backend"]`` says which path actually
        ran ("device" | "streaming" | "distributed" | "cpu" | "cpu-fallback" |
        "result-cache"); tests assert on it so fallbacks are never silent."""
        return self.metrics

    @property
    def num_rows(self) -> int:
        return self._batch.num_rows

    @property
    def schema(self):
        return self._batch.schema

    @property
    def column_names(self):
        return self._batch.schema.names

    def batch(self) -> ColumnBatch:
        return self._batch

    def to_arrow(self):
        from ..interop import arrow as arrow_io  # pyarrow only when asked

        return arrow_io.batch_to_arrow(self._batch)

    def to_pandas(self):
        from ..interop import arrow as arrow_io

        return arrow_io.batch_to_pandas(self._batch)

    def to_pydict(self):
        return self._batch.to_numpy().to_pydict()

    def __len__(self):
        return self.num_rows

    def __repr__(self):
        return f"QueryResult({self._batch!r})"

    # allow `pa.table(result)` / `pl.from_arrow(result)` style usage
    def __arrow_c_stream__(self, requested_schema=None):
        return self.to_arrow().__arrow_c_stream__(requested_schema)
