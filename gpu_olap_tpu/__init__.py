"""gpu_olap_tpu — a vectorized SQL query-execution engine on JAX/XLA.

Brand-new implementation of the capability surface of the reference GPU OLAP
engine (``codebasecomprehension987/gpu-olap-engine``; see SURVEY.md): SQL ->
logical plan -> rule-based optimizer -> physical plan -> columnar execution,
with the compute path in JAX/XLA on an NVIDIA H100 (sort-merge & lookup joins,
sort-based grouped aggregation, fused filters, hash-partitioned multi-device
shuffle) and the runtime around it (catalog, Arrow interchange, buffer arenas,
double-buffered host feeding).
"""

from .catalog import Catalog
from .config import EngineConfig
from .engine import GpuOlapEngine, OlapEngine
from .executor.result import QueryResult
from .interop.columnar import Column, ColumnBatch, DType, Field, Schema
from .sql.parser import parse_sql

__version__ = "0.1.0"

__all__ = [
    "Catalog", "Column", "ColumnBatch", "DType", "EngineConfig", "Field",
    "GpuOlapEngine", "OlapEngine", "QueryResult", "Schema",
    "parse_sql",
]
