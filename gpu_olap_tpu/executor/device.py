"""Device (JAX/XLA) executor.

The reference compiles per-predicate PTX kernels and caches them
(``codegen.rs:36-47``, PROJECT_SUMMARY.md:12).  The equivalent implemented
here: the whole physical plan is *traced* into one XLA program
(operators = jnp/lax ops + the sort-based kernels in ``gpu_olap_tpu.ops``) and
jit-cached per (plan, input signature) — filters fuse into aggregations and
joins automatically; there is no interpreter overhead at run time.

Static-shape discipline (XLA requirement):
* table columns are padded to shape buckets (recompile avoidance — the
  kernel-cache analogue);
* filters carry row-validity masks instead of compacting;
* joins emit into fixed match buffers with overflow flags; the host grows the
  capacity and recompiles on overflow (the reference caps with ``max_matches``,
  ``join_kernels.cuh:127``);
* aggregation outputs are padded to ``max_groups`` with a group count.

String expressions are lowered at trace time against the (host-side, sorted)
column dictionaries: comparisons/LIKE/IN become integer code comparisons or
constant lookup tables — the dictionary-encoding upgrade over the reference's
lossy FNV hashing (``record_batch_convert.rs:93-97``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import EngineConfig
from ..interop.columnar import Column, ColumnBatch, DType, Schema
from ..ops import aggregate as agg_ops
from ..ops import filter as filter_ops
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..ops.dtypes import key_code, order_code
from ..plan import physical as P
from ..utils.jaxenv import ensure_jax
from ..utils.metrics import GLOBAL_METRICS, Timer
from ..utils.tracing import get_logger

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402

logger = get_logger(__name__)


class DeviceUnsupported(NotImplementedError):
    """Raised at trace time for features the device path does not cover;
    the engine falls back to the CPU oracle."""


@dataclasses.dataclass
class DevCol:
    data: jnp.ndarray
    validity: Optional[jnp.ndarray]
    dictionary: Optional[np.ndarray] = None  # host-side, trace-time constant
    # zone-map statistics say every value fits int32 (with sentinel headroom):
    # join/sort/group keys on this column take the narrow fast path (half
    # the bytes per sort pass and probe)
    int32_ok: bool = False
    # (min, max) zone-map range when known — enables direct-address joins
    value_range: Optional[Tuple[int, int]] = None
    # column proven duplicate-free (lazily computed key statistic) — enables
    # the expansion-free lookup join
    unique: bool = False
    # provenance (table name, table column index) for unfiltered scan columns:
    # keys a device-resident persistent join index when one exists
    source: Optional[Tuple[str, int]] = None
    # device-resident pre-narrowed int32 copy (built once at table upload for
    # int32_ok columns): hot paths read 4 bytes/row with NO in-trace astype
    # materialization pass (which costs 8B read + 4B write per row per query)
    narrow: Optional[jnp.ndarray] = None

    def as_int32(self):
        """int32 view of the column: the upload-time shadow when present,
        else an in-trace narrowing pass."""
        if self.narrow is not None:
            return self.narrow
        return self.data.astype(jnp.int32)


@dataclasses.dataclass
class DevBatch:
    schema: Schema
    cols: List[DevCol]
    capacity: int
    row_valid: Optional[jnp.ndarray]  # None = all rows valid
    # when row_valid is exactly ``arange(capacity) < prefix_rows`` with a
    # trace-time-constant prefix_rows (pure scans and row-preserving ops over
    # them), sort-based operators can sentinel-mask keys instead of carrying a
    # validity operand through every merge pass
    prefix_rows: Optional[int] = None
    # DYNAMIC prefix: row_valid is exactly ``arange(capacity) < prefix_count``
    # with a traced scalar (aggregate/distinct group counts, sorted outputs).
    # The final host-boundary compaction then skips its sort + per-column
    # gather entirely (capacity-sized work on every grouped result)
    prefix_count: Optional[jnp.ndarray] = None

    def count(self):
        if self.prefix_rows is not None:
            return jnp.asarray(self.prefix_rows, dtype=jnp.int64)
        if self.row_valid is None:
            return jnp.asarray(self.capacity, dtype=jnp.int64)
        if self.prefix_count is not None:
            return self.prefix_count.astype(jnp.int64)
        return jnp.sum(self.row_valid.astype(jnp.int64))


def _np_kind(dtype: DType) -> str:
    return {"int64": "i", "float64": "f", "bool": "b", "string": "i",
            "timestamp_ms": "i", "date32": "i"}[dtype.value]


def _shape_bucket(n: int, config: EngineConfig) -> int:
    """Static-shape padding bucket for a table of ``n`` rows.

    Buckets are multiples of the largest power of two <= n/8 (eight steps per
    octave), so padding waste is bounded at 12.5% — a pure-power-of-two ladder
    taxes every downstream sort/gather by up to 2x — while the number of
    distinct compiled shapes stays logarithmic."""
    b = max(config.min_shape_bucket, 1)
    if n <= b:
        return b
    chunk = 1 << max((n - 1).bit_length() - 3, 0)
    chunk = max(chunk, b)
    return -(-n // chunk) * chunk


def _dicts_equal(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    if a is b:
        return True
    if a is None or b is None:
        return False
    return len(a) == len(b) and bool(np.array_equal(a, b))


class DeviceExecutor:
    def __init__(self, catalog, config: EngineConfig):
        self.catalog = catalog
        self.config = config
        # device-resident padded table cache: name -> (hostbatch id, DevTables entry)
        self._table_cache: Dict[str, tuple] = {}
        # compiled plans: (plan, sig, caps_key) -> (jitted fn, meta dict)
        self._compiled: Dict[tuple, tuple] = {}
        # per-plan-node capacity overrides after overflow (node path -> rows)
        self._cap_override: Dict[tuple, int] = {}
        # out-of-core streamer (kept across queries: its staging arena pools
        # chunk buffers; its compiled steps cache by shape)
        self._streaming = None

    # ------------------------------------------------------------------
    # public entry
    # ------------------------------------------------------------------
    def execute(self, plan: P.PhysicalPlan) -> ColumnBatch:
        # backend actually used by this call, for QueryResult.meta["backend"]
        self.last_backend = "device"
        if self._has_uncached_scan(plan):
            # out-of-core: stream chunks through a partial-aggregate pipeline
            from .streaming import NotStreamable, StreamingAggregator

            try:
                if self._streaming is None:
                    self._streaming = StreamingAggregator(
                        self.catalog, self.config, _Interpreter)
                batch = self._streaming.execute(plan)
                self.last_backend = ("streaming-partitioned"
                                     if self._streaming.last_partitioned
                                     else "streaming")
                return batch
            except NotStreamable as e:
                logger.warning(
                    "plan not streamable (%s); loading table fully "
                    "(may exceed HBM for very large tables)", e)
        tables = self._device_tables(plan)
        rows_in = sum(t["num_rows"] for t in tables.values())
        bytes_in = sum(
            t["capacity"] * sum(a[0].dtype.itemsize for a in t["arrays"])
            for t in tables.values()
        )
        for attempt in range(8):
            fn, meta = self._get_compiled(plan, tables)
            arrays = {name: {"cols": t["arrays"], "idx": t["dense_idx"],
                             "nar": t["narrow"]}
                      for name, t in tables.items()}
            with Timer() as t_exec:
                out = fn(arrays)
                flags = {k: bool(v) for k, v in zip(meta["flag_names"], out["flags"])}
                overflowed = [k for k, v in flags.items() if v]
                # force program completion inside the timer (dispatch is
                # async; flag readbacks above only block when flags exist)
                out["count"] = int(out["count"])
            if not overflowed:
                batch = self._to_host(plan, out, meta)
                GLOBAL_METRICS.record_span(
                    "device_execute", t_exec.seconds, rows_in=rows_in,
                    rows_out=batch.num_rows, bytes_accessed=bytes_in)
                return batch
            # grow capacities and recompile (bounded geometric growth)
            for key in overflowed:
                cur = meta["capacities"][key]
                self._cap_override[key] = int(cur * 4)
                logger.warning("device capacity overflow at %s: growing %d -> %d",
                               key, cur, self._cap_override[key])
        raise RuntimeError("join/aggregate capacity kept overflowing after 8 growths")

    def _streaming_arena_stats(self) -> dict:
        """Staging-arena pool state of the out-of-core streamer (tests
        assert buffer reuse; empty when no query has streamed)."""
        if self._streaming is None:
            return {"allocated_bytes": 0, "classes": {}}
        return self._streaming.arena.stats()

    def _has_uncached_scan(self, plan: P.PhysicalPlan) -> bool:
        found = False

        def walk(p):
            nonlocal found
            if isinstance(p, P.PhysTableScan) and not self.catalog.is_cached(p.table_name):
                found = True
            for k in p.inputs():
                walk(k)

        walk(plan)
        return found

    # ------------------------------------------------------------------
    # tables -> device
    # ------------------------------------------------------------------
    def _device_tables(self, plan: P.PhysicalPlan):
        names = set()

        def walk(p):
            if isinstance(p, P.PhysTableScan):
                names.add(p.table_name)
            for k in p.inputs():
                walk(k)

        walk(plan)
        out = {}
        for name in sorted(names):
            # device residency is keyed on the catalog's table version — NOT
            # object identity, which would re-pad + re-upload the table
            # through the (slow) host->device link on every query
            ver = self.catalog.get_version(name)
            cached = self._table_cache.get(name)
            if cached is not None and cached[0] == ver:
                out[name] = cached[1]
                continue
            host = self.catalog.get_table_data(name).to_numpy()
            cap = _shape_bucket(max(host.num_rows, 1), self.config)
            arrays = []
            dicts = []
            for col in host.columns:
                data = np.zeros(cap, dtype=col.data.dtype)
                data[: host.num_rows] = col.data
                entry = [jax.device_put(data)]
                if col.validity is not None:
                    v = np.zeros(cap, dtype=bool)
                    v[: host.num_rows] = col.validity
                    entry.append(jax.device_put(v))
                else:
                    entry.append(None)
                arrays.append(tuple(entry))
                dicts.append(col.dictionary)
            stats = self.catalog.get_stats(name) or {}
            int32_ok = []
            ranges = []
            uniques = []
            lo32 = np.iinfo(np.int32).min + 4
            hi32 = np.iinfo(np.int32).max - 4
            for f, col in zip(host.schema, host.columns):
                if col.dictionary is not None:
                    int32_ok.append(len(col.dictionary) < hi32)
                    ranges.append((0, len(col.dictionary) - 1))
                    uniques.append(False)
                    continue
                st = stats.get(f.name)
                int32_ok.append(st is not None and lo32 < st[0] and st[1] < hi32)
                ranges.append(st)
                # uniqueness worth computing only for plausible key columns:
                # bounded span no smaller than the row count
                uniq = False
                if st is not None:
                    span = int(st[1]) - int(st[0]) + 1
                    if host.num_rows <= span <= self.config.direct_join_max_range:
                        uniq = self.catalog.ensure_unique_stat(name, f.name)
                uniques.append(uniq)
            # persistent join indexes: for proven-unique bounded key columns,
            # the dense key->row table is built host-side ONCE per table
            # version (a trivial numpy scatter) and stays device-resident —
            # lookup joins then skip the in-trace build entirely
            # int32 shadow copies: for zone-map-proven-narrow int64 columns,
            # upload a pre-narrowed int32 array alongside the wide one.  Every
            # query that keys/sorts/aggregates on the column then reads 4 B/row
            # directly instead of paying an astype materialization (8 B read +
            # 4 B write + 4 B re-read) inside the trace.
            narrow = {}
            for i, (data, _valid) in enumerate(arrays):
                if int32_ok[i] and data.dtype == jnp.int64:
                    host_col = np.zeros(cap, dtype=np.int32)
                    host_col[: host.num_rows] = np.asarray(
                        host.columns[i].data, dtype=np.int64).astype(np.int32)
                    narrow[i] = jax.device_put(host_col)
            dense_idx = {}
            for i, (f, col) in enumerate(zip(host.schema, host.columns)):
                if not uniques[i]:
                    continue
                st = stats.get(f.name)
                kmin, kmax = int(st[0]), int(st[1])
                span = kmax - kmin + 1
                dense = np.full(span, -1, dtype=np.int32)
                keys_np = np.asarray(col.data)
                dense[(keys_np - kmin).astype(np.int64)] = np.arange(
                    host.num_rows, dtype=np.int32)
                dense_idx[i] = jax.device_put(dense)
            entry = {
                "arrays": arrays,
                "dicts": dicts,
                "schema": host.schema,
                "num_rows": host.num_rows,
                "capacity": cap,
                "int32_ok": int32_ok,
                "ranges": ranges,
                "uniques": uniques,
                "dense_idx": dense_idx,
                "narrow": narrow,
            }
            self._table_cache[name] = (ver, entry)
            out[name] = entry
        return out

    # ------------------------------------------------------------------
    # compile cache
    # ------------------------------------------------------------------
    def _get_compiled(self, plan: P.PhysicalPlan, tables):
        sig = tuple(
            (name, t["capacity"], t["num_rows"],
             tuple((str(a[0].dtype), a[1] is not None) for a in t["arrays"]),
             tuple(id(d) if d is not None else None for d in t["dicts"]),
             tuple(t.get("int32_ok", ())),
             # ranges are trace-time constants (sentinels, kmin/kmax, fold
             # decisions) — a stale hit would bake wrong bounds
             tuple(t.get("ranges", ())),
             tuple(t.get("uniques", ())))
            for name, t in sorted(tables.items())
        )
        caps_key = tuple(sorted(self._cap_override.items()))
        cache_key = (plan, sig, caps_key)
        hit = self._compiled.get(cache_key)
        if hit is not None:
            return hit

        meta = {"flag_names": [], "capacities": {}, "out_dicts": None,
                "out_schema": None}
        table_meta = {
            name: {"dicts": t["dicts"], "schema": t["schema"],
                   "num_rows": t["num_rows"], "capacity": t["capacity"],
                   # statistics drive trace-time kernel selection (int32
                   # narrowing, direct-address and lookup joins) — they are
                   # part of the compile cache key above, so they must reach
                   # the interpreter too
                   "int32_ok": t["int32_ok"], "ranges": t["ranges"],
                   "uniques": t["uniques"]}
            for name, t in tables.items()
        }

        interp = _Interpreter(self.config, table_meta, self._cap_override, meta)

        def run(table_arrays):
            interp.tables_arrays = table_arrays
            interp.flags = []
            meta["flag_names"] = []
            meta["capacities"] = {}
            batch = interp.exec(plan, path=())
            meta["out_schema"] = batch.schema
            meta["out_dicts"] = [c.dictionary for c in batch.cols]
            # device-side prefix compaction so the host transfers only
            # count rows, not the padded capacity (critical when the result
            # is small and the device link is slow)
            def wire(c):
                # zone-map/aggregate-proven int32 results transfer narrow
                # (_to_host widens back): halves those columns' bytes on the
                # device-to-host link
                if c.int32_ok and c.data.dtype == jnp.int64:
                    return c.as_int32()
                return c.data

            rv = batch.row_valid
            if rv is None:
                count = jnp.asarray(batch.capacity, dtype=jnp.int64)
                cols_out = [(wire(c), c.validity) for c in batch.cols]
            elif batch.prefix_rows is not None or batch.prefix_count is not None:
                # valid rows already form a prefix: the host slice [:count]
                # IS the compaction — skip the capacity-sized sort + gathers
                count = batch.count()
                cols_out = [(wire(c), c.validity) for c in batch.cols]
            else:
                gather_idx, count = filter_ops.compaction_indices(rv)
                cols_out = []
                for c in batch.cols:
                    d = wire(c)[gather_idx]
                    v = None if c.validity is None else c.validity[gather_idx]
                    cols_out.append((d, v))
            return {"cols": cols_out, "count": count,
                    "flags": tuple(interp.flags)}

        with Timer() as t:
            fn = jax.jit(run)
            # force trace+compile now so meta is filled and errors surface here
            shapes = jax.eval_shape(
                run, {n: {"cols": t_["arrays"], "idx": t_["dense_idx"],
                          "nar": t_["narrow"]}
                      for n, t_ in tables.items()})
        logger.info("plan traced in %.1f ms (cache key %d entries)",
                    t.seconds * 1e3, len(self._compiled))
        self._compiled[cache_key] = (fn, meta)
        return fn, meta

    # ------------------------------------------------------------------
    def _to_host(self, plan, out, meta) -> ColumnBatch:
        schema: Schema = meta["out_schema"]
        dicts = meta["out_dicts"]
        n = int(out["count"])
        # rows are prefix-compacted on device; pull only the valid prefix,
        # every column in one batched transfer
        sliced = []
        for data, validity in out["cols"]:
            sliced.append(data[:n])
            if validity is not None:
                sliced.append(validity[:n])
        from ..utils.hostio import fetch_arrays

        fetched = iter(fetch_arrays(sliced))
        cols = []
        for (data, validity), dictionary, field in zip(out["cols"], dicts, schema):
            d = next(fetched)
            v = next(fetched) if validity is not None else None
            if field.dtype is DType.BOOL and d.dtype != np.bool_:
                d = d.astype(np.bool_)
            elif d.dtype == np.int32 and field.dtype.numpy_dtype == np.int64:
                d = d.astype(np.int64)  # narrow wire format widens host-side
            if v is not None and v.all():
                # all-valid masks drop like the oracle's (_maybe_validity):
                # downstream formatters floatify int columns that carry ANY
                # validity mask, drifting dtypes vs the CPU backend
                v = None
            cols.append(Column(d, v, dictionary))
        return ColumnBatch(schema, cols, n)


# ---------------------------------------------------------------------------
# the traced interpreter
# ---------------------------------------------------------------------------


class _Interpreter:
    def __init__(self, config: EngineConfig, table_meta, cap_override, meta):
        self.config = config
        self.table_meta = table_meta
        self.tables_arrays = None
        self.cap_override = cap_override
        self.meta = meta
        self.flags: List = []

    # -- operators -----------------------------------------------------
    def exec(self, plan: P.PhysicalPlan, path: tuple) -> DevBatch:
        if isinstance(plan, P.PhysTableScan):
            return self._scan(plan)
        if isinstance(plan, P.PhysFilter):
            return self._filter(plan, path)
        if isinstance(plan, P.PhysProjection):
            return self._project(plan, path)
        if isinstance(plan, P.PhysHashJoin):
            return self._join(plan, path)
        if isinstance(plan, P.PhysAggregate):
            return self._aggregate(plan, path)
        if isinstance(plan, P.PhysSort):
            return self._sort(plan, path)
        if isinstance(plan, P.PhysLimit):
            return self._limit(plan, path)
        if isinstance(plan, P.PhysDistinct):
            return self._distinct(plan, path)
        if isinstance(plan, P.PhysUnion):
            return self._union(plan, path)
        raise DeviceUnsupported(type(plan).__name__)

    def _union(self, plan: P.PhysUnion, path) -> DevBatch:
        """UNION ALL: concatenate padded children; validity masks carry the
        interleaved padding (no compaction needed)."""
        batches = [self.exec(c, path + (i,))
                   for i, c in enumerate(plan.children)]
        cols: List[DevCol] = []
        for i, f in enumerate(plan.schema):
            parts = [b.cols[i] for b in batches]
            if f.dtype is DType.STRING:
                dicts = [np.asarray(c.dictionary, dtype=str) for c in parts]
                union = np.unique(np.concatenate(dicts))
                datas = []
                for c, d in zip(parts, dicts):
                    lut = jnp.asarray(np.searchsorted(union, d))
                    datas.append(lut[jnp.clip(c.data, 0, len(d) - 1)])
                data = jnp.concatenate(datas)
                dictionary = union.astype(object)
            else:
                common = parts[0].data.dtype
                for c in parts[1:]:
                    common = jnp.promote_types(common, c.data.dtype)
                if np.dtype(f.dtype.numpy_dtype).kind == "f":
                    common = jnp.promote_types(common, jnp.float64)
                data = jnp.concatenate([c.data.astype(common) for c in parts])
                dictionary = None
            if all(c.validity is None for c in parts):
                valid = None
            else:
                valid = jnp.concatenate([
                    jnp.ones(b.capacity, dtype=bool) if c.validity is None
                    else c.validity
                    for c, b in zip(parts, batches)
                ])
            i32 = all(c.int32_ok for c in parts)
            ranges = [c.value_range for c in parts]
            vrange = None
            if all(r is not None for r in ranges):
                vrange = (min(r[0] for r in ranges), max(r[1] for r in ranges))
            cols.append(DevCol(data, valid, dictionary, i32, vrange))
        if all(b.row_valid is None for b in batches):
            row_valid = None
        else:
            row_valid = jnp.concatenate([
                jnp.ones(b.capacity, dtype=bool) if b.row_valid is None
                else b.row_valid
                for b in batches
            ])
        cap = sum(b.capacity for b in batches)
        return DevBatch(plan.schema, cols, cap, row_valid)

    def _scan(self, plan: P.PhysTableScan) -> DevBatch:
        tmeta = self.table_meta[plan.table_name]
        arrays = self.tables_arrays[plan.table_name]["cols"]
        narrow = self.tables_arrays[plan.table_name].get("nar") or {}
        indices = plan.projection if plan.projection is not None else range(len(arrays))
        cols = []
        flags = tmeta.get("int32_ok")
        ranges = tmeta.get("ranges")
        uniques = tmeta.get("uniques")
        for i in indices:
            data, validity = arrays[i]
            cols.append(DevCol(data, validity, tmeta["dicts"][i],
                               bool(flags[i]) if flags else False,
                               ranges[i] if ranges else None,
                               bool(uniques[i]) if uniques else False,
                               (plan.table_name, i),
                               narrow.get(i)))
        cap = tmeta["capacity"]
        n = tmeta["num_rows"]
        row_valid = None
        prefix = None
        if n < cap:
            row_valid = jnp.arange(cap) < n
            prefix = n
        return DevBatch(plan.schema, cols, cap, row_valid, prefix)

    def _filter(self, plan: P.PhysFilter, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        data, valid, _ = self.eval_expr(plan.predicate, batch)
        mask = filter_ops.combine_mask(batch.row_valid, data, valid)
        return DevBatch(plan.schema, batch.cols, batch.capacity, mask)

    def _project(self, plan: P.PhysProjection, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        cols = []
        for e in plan.exprs:
            data, valid, dictionary = self.eval_expr(e, batch)
            src = batch.cols[e.index] if isinstance(e, P.ColumnRef) else None
            cols.append(DevCol(data, valid, dictionary,
                               src.int32_ok if src else False,
                               src.value_range if src else None,
                               src.unique if src else False,
                               src.source if src else None,
                               src.narrow if src and data is src.data else None))
        return DevBatch(plan.schema, cols, batch.capacity, batch.row_valid,
                        batch.prefix_rows, prefix_count=batch.prefix_count)

    def _join(self, plan: P.PhysHashJoin, path) -> DevBatch:
        left = self.exec(plan.left, path + (0,))
        right = self.exec(plan.right, path + (1,))
        nl, nr = left.capacity, right.capacity

        if plan.join_type == "cross":
            raise DeviceUnsupported("cross join on device")

        lkeys = [self._key_of(k, left) for k in plan.left_keys]
        rkeys = [self._key_of(k, right) for k in plan.right_keys]
        fold_range = self._fold_range(plan, lkeys, rkeys)
        # expansion-free lookup join: unique, range-bounded build key.
        # An EXPLICIT "sort_merge" config override forces the sorted-probe
        # core path; the auto-selected pre-sorted strategy keeps it (the
        # lookup join is strictly faster when eligible)
        if plan.strategy != "sort_merge" or plan.build_sorted_asc:
            lookup = self._try_lookup_join(plan, left, right, lkeys, rkeys)
            if lookup is not None:
                return lookup

        lkeys, rkeys = self._unified_key_tuples(plan, left, right, lkeys, rkeys)

        cap_key = ("join", path)
        # initial guess covers FK-style joins (matches ~ probe rows) without a
        # growth recompile; growth is 4x to converge fast on expansive joins
        capacity = self.cap_override.get(
            cap_key, int((nl + nr) * self.config.join_expansion)
        )
        self.meta["capacities"][cap_key] = capacity

        li, ri, out_valid, total, overflow, cnt = join_ops.inner_join(
            lkeys, left.row_valid, rkeys, right.row_valid, capacity,
            fold_range=fold_range,
            # stats-proven sorted build key on a direct scan: row
            # validity is absent or the padded-tail prefix, so the
            # build sort is a sentinel mask (join_kernel.rs:10-14)
            build_presorted=plan.build_sorted_asc,
        )
        self._push_flag(cap_key, overflow)

        if plan.join_type in ("left", "right", "full"):
            li, ri, out_valid, total = join_ops.outer_extend(
                plan.join_type, li, ri, out_valid, total, cnt,
                left.row_valid, right.row_valid, nl, nr,
            )

        out_cap = li.shape[0]
        cols = [_gather_col(c, li, out_valid) for c in left.cols]
        cols += [_gather_col(c, ri, out_valid) for c in right.cols]
        out = DevBatch(plan.schema, cols, out_cap, out_valid)

        if plan.residual is not None:
            data, valid, _ = self.eval_expr(plan.residual, out)
            mask = filter_ops.combine_mask(out.row_valid, data, valid)
            if plan.join_type != "inner":
                pad_l = li < 0
                pad_r = ri < 0
                mask = mask | ((pad_l | pad_r) & out_valid)
            out = DevBatch(plan.schema, cols, out_cap, mask)
        return out

    def _lookup_range(self, plan, right: DevBatch):
        """Lookup-join eligibility: single int key, build side proven unique
        with a stats-bounded range.  Returns (kmin, kmax) or None."""
        if len(plan.left_keys) != 1:
            return None
        rexpr = plan.right_keys[0]
        if not isinstance(rexpr, P.ColumnRef):
            return None
        rcol = right.cols[rexpr.index]
        rng = rcol.value_range
        if not rcol.unique or rng is None:
            return None
        span = int(rng[1]) - int(rng[0]) + 1
        if not (0 < span <= self.config.direct_join_max_range):
            return None
        if plan.left_keys[0].dtype is DType.FLOAT64 or rexpr.dtype is DType.FLOAT64:
            return None
        if rexpr.dtype is DType.STRING or plan.left_keys[0].dtype is DType.STRING:
            return None
        return (int(rng[0]), int(rng[1]))

    def _cached_dense_index(self, plan, right: DevBatch):
        """Device-resident persistent join index for the build key, when the
        build side is the unfiltered table (row validity is absent or the
        static scan-padding prefix) — built once per table version."""
        rexpr = plan.right_keys[0]
        if not isinstance(rexpr, P.ColumnRef):
            return None
        rcol = right.cols[rexpr.index]
        if rcol.source is None:
            return None
        if right.row_valid is not None and right.prefix_rows is None:
            return None
        tname, ti = rcol.source
        tbl = self.tables_arrays.get(tname)
        if tbl is None:
            return None
        return tbl["idx"].get(ti)

    def _try_lookup_join(self, plan, left: DevBatch, right: DevBatch,
                         lkeys, rkeys) -> Optional[DevBatch]:
        if plan.join_type not in ("inner", "left"):
            return None
        rng = self._lookup_range(plan, right)
        if rng is None:
            return None

        lk, rk = lkeys[0], rkeys[0]
        rinv = rk["null"] if right.row_valid is None else (rk["null"] | ~right.row_valid)
        pinv = lk["null"] if left.row_valid is None else (lk["null"] | ~left.row_valid)
        dense_row = self._cached_dense_index(plan, right)
        if dense_row is not None:
            rel_c, inr = join_ops.dense_probe(int(rng[0]), int(rng[1]),
                                              lk["code"], pinv)
        else:
            dense_row, rel_c, inr = join_ops.lookup_slots(
                rk["code"], rinv, int(rng[0]), int(rng[1]), lk["code"], pinv)

        # Per-column dense VALUE tables (build-sized gathers, cheap) replace
        # per-probe-row gathers through dense_row.  A null-free int column
        # with zone-map stats gets a sentinel (range max + 1) in empty slots:
        # its single probe gather then yields value AND matchedness at once,
        # halving the probe-sized gathers.
        nb = right.capacity
        safe_dense = jnp.clip(dense_row, 0, nb - 1)
        slot_ok = dense_row >= 0
        # sentinel host column: prefer a NON-key column — the join key is
        # rarely referenced again after the join, while the matched flag's
        # gather CSEs with the column's own value gather when the column IS
        # used (one probe gather yields both)
        key_ix = plan.right_keys[0].index
        sent_ix = None
        for i, c in enumerate(right.cols):
            if (c.validity is None and c.dictionary is None
                    and c.value_range is not None
                    and c.data.dtype == jnp.int64
                    and int(c.value_range[1]) < np.iinfo(np.int64).max):
                if sent_ix is None:
                    sent_ix = i
                if i != key_ix:
                    sent_ix = i
                    break

        matched = None
        dense_vals = []
        for i, c in enumerate(right.cols):
            src = c.data
            # int32 dense value tables where zone maps allow: the probe-side
            # random gather moves half the bytes
            if c.int32_ok and src.dtype == jnp.int64:
                src = c.as_int32()
            dv = src[safe_dense]
            dvalid = None if c.validity is None else (
                c.validity[safe_dense] & slot_ok)
            if i == sent_ix:
                sent = jnp.asarray(int(c.value_range[1]) + 1, dv.dtype)
                dv = jnp.where(slot_ok, dv, sent)
                g = dv[rel_c]
                matched = inr & (g != sent)
                dense_vals.append((c, g, None, None))
            else:
                dense_vals.append((c, None, dv, dvalid))
        if matched is None:  # no sentinel-capable column: probe dense_row
            matched = inr & (dense_row[rel_c] >= 0)

        nl = left.capacity
        lvalid = left.row_valid if left.row_valid is not None else \
            jnp.ones(nl, dtype=bool)
        if plan.join_type == "inner":
            out_valid = lvalid & matched
        else:  # left outer: all probe rows survive; build side nulls where
            out_valid = lvalid

        cols = list(left.cols)
        for c, g, dv, dvalid in dense_vals:
            if g is None:
                g = dv[rel_c]
            valid = matched if dvalid is None else (dvalid[rel_c] & matched)
            cols.append(DevCol(g, valid, c.dictionary, c.int32_ok,
                               c.value_range))
        out = DevBatch(plan.schema, cols, nl, out_valid)
        if plan.residual is not None:
            data, valid, _ = self.eval_expr(plan.residual, out)
            mask = filter_ops.combine_mask(out.row_valid, data, valid)
            if plan.join_type == "left":
                mask = mask | (~matched & out_valid)
            out = DevBatch(plan.schema, cols, nl, mask)
        return out

    def _key_of(self, expr: P.PhysExpr, batch: DevBatch):
        data, valid, dictionary = self.eval_expr(expr, batch)
        code, null = key_code(data, valid, _np_kind(expr.dtype))
        if self._int32_ok(expr, batch) and code.dtype == jnp.int64:
            code = self._narrow32(expr, batch, data)  # stats-backed fast path
        vrange = (batch.cols[expr.index].value_range
                  if isinstance(expr, P.ColumnRef) else None)
        return {"code": code, "null": null, "dict": dictionary,
                "dtype": expr.dtype, "range": vrange}

    def _pack_keys(self, group_exprs, batch, keys, key_meta):
        """Multi-key GROUP BY packing: when every key is statically null-free
        int-kind with zone-map bounds whose span PRODUCT fits int32, fold the
        tuple into ONE packed int32 code (sum of (k_i - lo_i) * stride_i).
        One sort operand instead of N; outputs decode exactly on
        the group-sized result (_group_key_cols).  The reference's hash
        aggregate has no multi-key story at all (aggregate_kernel.rs:47-58
        takes one group_key_ptr).

        Returns (keys, packed_spec|None)."""
        if len(keys) < 2 or any(null is not None for _, null in keys) \
                or any(_np_kind(g.dtype) != "i" for g in group_exprs):
            return keys, None

        def code_range(g, dictionary):
            # dictionary columns pack on their CODE space (0..len-1);
            # _expr_range talks about VALUES and refuses dictionaries
            if dictionary is not None:
                return (0, len(dictionary) - 1)
            return self._expr_range(g, batch)

        rngs = [code_range(g, dct) for g, (_dt, dct)
                in zip(group_exprs, key_meta)]
        if any(r is None for r in rngs):
            return keys, None
        spans = [int(r[1]) - int(r[0]) + 1 for r in rngs]
        prod = 1
        for s in spans:
            prod *= s
        if not (0 < prod < (1 << 31) - 8):
            return keys, None
        strides = []
        acc = 1
        for s in reversed(spans):
            strides.append(acc)
            acc *= s
        strides.reverse()
        packed = None
        for (code, _null), r, stride in zip(keys, rngs, strides):
            ki = (code - jnp.asarray(int(r[0]), code.dtype)).astype(jnp.int32)
            term = ki * np.int32(stride)
            packed = term if packed is None else packed + term
        return [(packed, None)], (rngs, strides)

    @staticmethod
    def _group_key_cols(group_codes, key_meta, packed_spec):
        """Group-key output columns, decoding a packed code when present
        (rows >= n_groups hold garbage and are sliced off host-side)."""
        cols = []
        if packed_spec is not None:
            rngs, strides = packed_spec
            rem = group_codes[0][0]
            for (dtype, dictionary), r, stride in zip(key_meta, rngs, strides):
                q = rem // np.int32(stride)
                rem = rem - q * np.int32(stride)
                cols.append(_decode_key(q + np.int32(int(r[0])), None,
                                        dtype, dictionary))
            return cols
        for (code, null), (dtype, dictionary) in zip(group_codes, key_meta):
            cols.append(_decode_key(code, null, dtype, dictionary))
        return cols

    def _narrow32(self, expr: P.PhysExpr, batch: DevBatch, wide):
        """int32 operand for a zone-map-narrowable int64 expression: the
        table's upload-time shadow when the expression is a bare scan column
        (saves the astype materialization pass), else an in-trace astype."""
        if isinstance(expr, P.ColumnRef):
            c = batch.cols[expr.index]
            if c.narrow is not None and wide is c.data:
                return c.narrow
        return wide.astype(jnp.int32)

    def _int32_ok(self, expr: P.PhysExpr, batch: DevBatch) -> bool:
        if (isinstance(expr, P.ColumnRef)
                and batch.cols[expr.index].int32_ok
                and expr.dtype is not DType.FLOAT64):
            return True
        rng = self._expr_range(expr, batch)
        lo32 = np.iinfo(np.int32).min + 4
        hi32 = np.iinfo(np.int32).max - 4
        return rng is not None and lo32 < rng[0] and rng[1] < hi32

    def _expr_range(self, e: P.PhysExpr, batch: DevBatch):
        """Interval propagation: (lo, hi) bound on an integer expression's
        valid values, from zone-map column statistics.  Drives int32
        narrowing and f64-exact-sum selection for computed aggregates."""
        if isinstance(e, P.ColumnRef):
            c = batch.cols[e.index]
            if (c.value_range is None or e.dtype is DType.FLOAT64
                    or e.dtype is DType.STRING or c.dictionary is not None):
                return None
            return (int(c.value_range[0]), int(c.value_range[1]))
        if isinstance(e, P.PhysLiteral):
            return ((int(e.value), int(e.value))
                    if isinstance(e.value, (int, np.integer))
                    and not isinstance(e.value, bool) else None)
        if isinstance(e, P.PhysUnary) and e.op == "-":
            r = self._expr_range(e.operand, batch)
            return None if r is None else (-r[1], -r[0])
        if isinstance(e, P.PhysBinary) and e.op in ("+", "-", "*"):
            lr = self._expr_range(e.left, batch)
            rr = self._expr_range(e.right, batch)
            if lr is None or rr is None:
                return None
            if e.op == "+":
                return (lr[0] + rr[0], lr[1] + rr[1])
            if e.op == "-":
                return (lr[0] - rr[1], lr[1] - rr[0])
            prods = [lr[0] * rr[0], lr[0] * rr[1], lr[1] * rr[0], lr[1] * rr[1]]
            return (min(prods), max(prods))
        return None

    @staticmethod
    def _fold_range(plan, lkeys, rkeys):
        """Union zone-map range over both key sides (single int key): lets the
        merge probe keep its folded key+tag lane in int32."""
        if len(lkeys) != 1 or len(rkeys) != 1:
            return None
        lr, rr = lkeys[0].get("range"), rkeys[0].get("range")
        if lr is None or rr is None:
            return None
        for k in (lkeys[0], rkeys[0]):
            # strings are excluded: dictionary unification can remap codes
            # past the registered (0, len(dict)-1) range
            if k["dtype"] in (DType.FLOAT64, DType.STRING):
                return None
        return (min(int(lr[0]), int(rr[0])), max(int(lr[1]), int(rr[1])))

    def _unified_key_tuples(self, plan, left, right, lkeys, rkeys):
        """Dictionary-unified, dtype-promoted (code, null) tuples per side."""
        lkeys, rkeys = self._unify_string_keys(plan, left, right, lkeys, rkeys)
        unified = []
        for (lc, ln), (rc, rn) in zip(lkeys, rkeys):
            if lc.dtype != rc.dtype:
                common = jnp.promote_types(lc.dtype, rc.dtype)
                lc = lc.astype(common)
                rc = rc.astype(common)
            unified.append(((lc, ln), (rc, rn)))
        return [u[0] for u in unified], [u[1] for u in unified]

    def _unify_string_keys(self, plan, left, right, lkeys, rkeys):
        lout, rout = [], []
        for lk, rk, le, re_ in zip(lkeys, rkeys, plan.left_keys, plan.right_keys):
            if le.dtype is DType.STRING or re_.dtype is DType.STRING:
                if not _dicts_equal(lk["dict"], rk["dict"]):
                    union = np.unique(np.concatenate([
                        np.asarray(lk["dict"], dtype=str),
                        np.asarray(rk["dict"], dtype=str),
                    ]))
                    lmap = jnp.asarray(np.searchsorted(union, np.asarray(lk["dict"], dtype=str)))
                    rmap = jnp.asarray(np.searchsorted(union, np.asarray(rk["dict"], dtype=str)))
                    lk = dict(lk, code=lmap[jnp.clip(lk["code"], 0, len(lmap) - 1)])
                    rk = dict(rk, code=rmap[jnp.clip(rk["code"], 0, len(rmap) - 1)])
            lout.append((lk["code"], lk["null"]))
            rout.append((rk["code"], rk["null"]))
        return lout, rout

    # -- eager aggregation through joins (group-join) -------------------
    def _join_match_counts(self, plan: P.PhysHashJoin, left: DevBatch,
                           right: DevBatch) -> jnp.ndarray:
        """Per-probe-row match counts of an inner join, without materializing
        the match buffer (no ``repeat`` expansion, no output gathers)."""
        lkeys = [self._key_of(k, left) for k in plan.left_keys]
        rkeys = [self._key_of(k, right) for k in plan.right_keys]
        if plan.strategy != "sort_merge":
            rng = self._lookup_range(plan, right)
            if rng is not None:
                lk, rk = lkeys[0], rkeys[0]
                rinv = (rk["null"] if right.row_valid is None
                        else (rk["null"] | ~right.row_valid))
                pinv = (lk["null"] if left.row_valid is None
                        else (lk["null"] | ~left.row_valid))
                dense_row = self._cached_dense_index(plan, right)
                if dense_row is not None:
                    rel_c, inr = join_ops.dense_probe(rng[0], rng[1],
                                                      lk["code"], pinv)
                    matched = inr & (dense_row[rel_c] >= 0)
                else:
                    _, matched = join_ops.lookup_join(
                        rk["code"], rinv, rng[0], rng[1], lk["code"], pinv)
                return matched.astype(jnp.int64)
        fold_range = self._fold_range(plan, lkeys, rkeys)
        lkeys_t, rkeys_t = self._unified_key_tuples(plan, left, right,
                                                    lkeys, rkeys)
        lcode, linv, rcode, rinv = join_ops._prepare_codes(
            lkeys_t, left.row_valid, rkeys_t, right.row_valid, True)
        _, cnt = join_ops.probe_ranges_merge(rcode, rinv, lcode, linv,
                                             fold_range=fold_range)
        return cnt.astype(jnp.int64)

    def _try_join_aggregate(self, plan: P.PhysAggregate,
                            path) -> Optional[DevBatch]:
        """Aggregate over an inner join computed from match counts — the
        group-join / eager-aggregation rewrite.  Eligible when group keys and
        every aggregate argument are probe-side-only and aggregates are
        COUNT(*) / SUM / COUNT / AVG / MIN / MAX: SUM and AVG numerators
        weight rows by match multiplicity, COUNT sums multiplicities, MIN/MAX
        ignore them, and probe rows with no match drop out of grouping.
        Skips the match-buffer expansion entirely (and with it all
        capacity-overflow recompiles)."""
        join = plan.input
        if join.join_type != "inner" or join.residual is not None:
            return None
        n_left_cols = len(join.left.schema)
        # equi-key equivalence (round 5): on matched rows a right KEY column
        # equals its left key exactly, so references to it rewrite to the
        # left column — queries like the flagship SUM(l.k + r.k) then
        # qualify for this match-buffer-free path (VERDICT r4 #6)
        subst = {}
        for lk, rk in zip(join.left_keys, join.right_keys):
            if isinstance(lk, P.ColumnRef) and isinstance(rk, P.ColumnRef) \
                    and lk.dtype == rk.dtype and lk.dtype in (
                        DType.INT64, DType.DATE32, DType.TIMESTAMP_MS,
                        DType.BOOL):
                subst[n_left_cols + rk.index] = P.ColumnRef(
                    lk.dtype, lk.index, lk.name)
        if subst:
            group_exprs = tuple(_subst_cols(g, subst)
                                for g in plan.group_exprs)
            aggs = tuple(
                dataclasses.replace(a, arg=_subst_cols(a.arg, subst))
                if a.arg is not None else a
                for a in plan.aggs)
            if group_exprs != tuple(plan.group_exprs) \
                    or aggs != tuple(plan.aggs):
                plan = dataclasses.replace(plan, group_exprs=group_exprs,
                                           aggs=aggs)
        for g in plan.group_exprs:
            if any(i >= n_left_cols for i in _expr_col_indices(g)):
                return None
        for a in plan.aggs:
            if a.distinct:
                return None
            if a.arg is None:
                if a.func != "count":
                    return None
                continue
            if a.func not in ("sum", "count", "avg", "min", "max"):
                return None

        sorted_on = self.config.use_sorted_join_agg is not False
        if not plan.group_exprs and sorted_on:
            # the sorted-space global path handles BUILD-side and
            # decomposable pair arguments too — try it before the
            # probe-side-only restriction below
            left = self.exec(join.left, path + (0, 0))
            right = self.exec(join.right, path + (0, 1))
            fast = self._sorted_global_join_agg(plan, join, left, right)
            if fast is not None:
                return fast
        else:
            left = right = None

        for a in plan.aggs:
            if a.arg is not None and \
                    any(i >= n_left_cols for i in _expr_col_indices(a.arg)):
                return None

        if left is None:
            left = self.exec(join.left, path + (0, 0))
            right = self.exec(join.right, path + (0, 1))

        if plan.group_exprs and self.config.use_sorted_join_agg is True:
            # OPT-IN only: an A/B on the previous accelerator found it
            # slower than the probe-order path at 20M x 10M / 1000 groups
            # (the payload lanes and the merged-length group-by outweighed
            # the removed restore sort); to re-decide on the H100
            fast = self._sorted_grouped_join_agg(plan, join, left, right,
                                                 path)
            if fast is not None:
                return fast

        cnt = self._join_match_counts(join, left, right)
        participates = cnt > 0

        if plan.group_exprs:
            return self._grouped_join_aggregate(plan, path, left, cnt,
                                                participates)

        cols = []
        for a in plan.aggs:
            if a.arg is None:
                cols.append(DevCol(jnp.sum(cnt).reshape(1), None))
                continue
            data, valid, dictionary = self.eval_expr(a.arg, left)
            v_ok = participates if valid is None else (participates & valid)
            c = jnp.sum(jnp.where(v_ok, cnt, 0))
            has = (c > 0).reshape(1)
            acc = a.out_dtype.numpy_dtype
            if a.func == "count":
                cols.append(DevCol(c.reshape(1), None))
            elif a.func == "sum":
                s = jnp.sum(jnp.where(v_ok, data.astype(acc) * cnt.astype(acc),
                                      jnp.asarray(0, acc)))
                cols.append(DevCol(s.reshape(1), has))
            elif a.func == "avg":
                s = jnp.sum(jnp.where(
                    v_ok, data.astype(jnp.float64) * cnt.astype(jnp.float64),
                    0.0))
                avg = s / jnp.maximum(c, 1).astype(jnp.float64)
                cols.append(DevCol(jnp.where(c > 0, avg, 0.0).reshape(1), has))
            else:  # min / max: multiplicity-independent masked reduction
                if np.dtype(acc).kind == "f":
                    ident = np.inf if a.func == "min" else -np.inf
                else:
                    ident = (np.iinfo(np.int64).max if a.func == "min"
                             else np.iinfo(np.int64).min)
                masked = jnp.where(v_ok, data.astype(acc),
                                   jnp.asarray(ident, acc))
                red = jnp.min(masked) if a.func == "min" else jnp.max(masked)
                out = jnp.where(c > 0, red, jnp.asarray(0, acc)).reshape(1)
                dct = dictionary if a.out_dtype is DType.STRING else None
                cols.append(DevCol(out, has, dct))
        return DevBatch(plan.schema, cols, 1, None)

    def _sorted_global_join_agg(self, plan: P.PhysAggregate,
                                join: P.PhysHashJoin, left: DevBatch,
                                right: DevBatch) -> Optional[DevBatch]:
        """GLOBAL aggregate over an inner join, reduced entirely in the
        merge-sorted key space (round 5): reductions are order-free, so the
        probe-order restore sort of ``probe_ranges_merge`` (1 key + 2
        payload lanes, ~1.05 s of the 1.55 s flagship join at 200M rows) is
        skipped.  Two argument families qualify:

        * KEY-DERIVED expressions (incl. right-key refs via the equi-key
          substitution) — recomputed from the sorted key lane itself;
        * DECOMPOSABLE pair expressions — top-level sums of side-pure terms
          (e.g. ``SUM(l.v + r.w)``): SUM over matched pairs of
          f(probe) + g(build) = sum_i bcnt_i*f_i + sum_j pcnt_j*g_j, so each
          side-pure term rides the merge sort as ONE payload lane and is
          reduced weighted by the per-element match multiplicities.
          MIN/MAX need a single side-pure (or key) argument.
        """
        if len(join.left_keys) != 1:
            return None
        lk_expr = join.left_keys[0]
        if not isinstance(lk_expr, P.ColumnRef) or \
                _np_kind(lk_expr.dtype) != "i":
            return None
        # the unique-build lookup path is cheaper only for pure-count
        # shapes; payload-lane reductions beat the materializing path even
        # there, so only defer to it when every aggregate is key-derived
        n_left_cols = len(join.left.schema)

        def side_of(e):
            idxs = set(_expr_col_indices(e))
            if idxs <= {lk_expr.index}:
                return "key"
            if all(i < n_left_cols for i in idxs):
                return "probe"
            if all(i >= n_left_cols for i in idxs):
                return "build"
            return None

        def split_terms(e):
            sd = side_of(e)
            if sd is not None:
                return [(sd, e)]
            if isinstance(e, P.PhysBinary) and e.op == "+":
                lt = split_terms(e.left)
                rt = split_terms(e.right)
                if lt is None or rt is None:
                    return None
                return lt + rt
            return None

        payload_terms: List[tuple] = []   # (side, expr)

        def payload_slot(side, expr):
            for i, (s2, e2) in enumerate(payload_terms):
                if s2 == side and repr(e2) == repr(expr):
                    return i
            payload_terms.append((side, expr))
            return len(payload_terms) - 1

        agg_specs = []
        for a in plan.aggs:
            if a.arg is None:
                agg_specs.append(("total",))
                continue
            if a.func == "count":
                sd = side_of(a.arg)
                if sd is None:
                    return None
                if sd in ("probe", "build"):
                    # COUNT(col) == COUNT(*) only for null-free arguments
                    e = a.arg if sd == "probe" else None
                    batch_ = left if sd == "probe" else right
                    expr_ = a.arg
                    if sd == "build":
                        mapping = {}
                        for i in set(_expr_col_indices(a.arg)):
                            f = join.right.schema.field(i - n_left_cols)
                            mapping[i] = P.ColumnRef(f.dtype, i - n_left_cols,
                                                     f.name)
                        expr_ = _subst_cols(a.arg, mapping)
                    _d, valid_, _dd = self.eval_expr(expr_, batch_)
                    if valid_ is not None:
                        return None
                agg_specs.append(("count", sd, a.arg))
            elif a.func in ("sum", "avg"):
                terms = split_terms(a.arg)
                if terms is None:
                    return None
                entries = []
                for sd, e in terms:
                    entries.append((sd, e if sd == "key"
                                    else payload_slot(sd, e)))
                agg_specs.append((a.func, entries))
            elif a.func in ("min", "max"):
                sd = side_of(a.arg)
                if sd is None:
                    return None
                agg_specs.append(("minmax", a.func, sd,
                                  a.arg if sd == "key"
                                  else payload_slot(sd, a.arg)))
            else:
                return None
        if len(payload_terms) > 3:
            return None  # each payload lane rides every merge pass
        if not payload_terms and join.strategy != "sort_merge" and \
                self._lookup_range(join, right) is not None:
            return None  # pure key shapes: dense/lookup counting is cheaper

        def shift_right(e):
            mapping = {}
            for i in set(_expr_col_indices(e)):
                f = join.right.schema.field(i - n_left_cols)
                mapping[i] = P.ColumnRef(f.dtype, i - n_left_cols, f.name)
            return _subst_cols(e, mapping)

        lkeys = [self._key_of(k, left) for k in join.left_keys]
        rkeys = [self._key_of(k, right) for k in join.right_keys]
        fold_range = self._fold_range(join, lkeys, rkeys)
        lkeys_t, rkeys_t = self._unified_key_tuples(join, left, right,
                                                    lkeys, rkeys)
        lcode, linv, rcode, rinv = join_ops._prepare_codes(
            lkeys_t, left.row_valid, rkeys_t, right.row_valid, True)
        nb = rcode.shape[0]
        npr = lcode.shape[0]

        i32max = (1 << 31) - 8
        lanes = []
        lane_f64 = []
        for sd, expr in payload_terms:
            if sd == "probe":
                data, valid, _ = self.eval_expr(expr, left)
                batch = left
            else:
                data, valid, _ = self.eval_expr(shift_right(expr), right)
                batch = right
            if valid is not None:
                return None  # nullable term: fall back to general paths
            rng = self._expr_range(expr if sd == "probe"
                                   else shift_right(expr), batch)
            if data.dtype == jnp.float64:
                dt = jnp.float64
            elif rng is not None and -i32max < int(rng[0]) \
                    and int(rng[1]) < i32max:
                dt = jnp.int32
            else:
                dt = jnp.int64
            lane_f64.append(dt == jnp.float64)
            z = jnp.zeros((), dt)
            if sd == "probe":
                lanes.append(jnp.concatenate(
                    [jnp.full(nb, z), data.astype(dt)]))
            else:
                lanes.append(jnp.concatenate(
                    [data.astype(dt), jnp.full(npr, z)]))

        probe_ok, key_sorted, cnt_elem, build_ok, pcnt_elem, pay_s = \
            join_ops.probe_counts_sorted(rcode, rinv, lcode, linv,
                                         fold_range=fold_range,
                                         payloads=tuple(lanes))

        # key-derived args evaluate on the sorted key lane, widened to the
        # column's logical dtype (expression arithmetic must not wrap)
        key_lane = key_sorted.astype(jnp.int64)
        fake_cols = [DevCol(key_lane, None, None) for _ in left.cols]
        fake = DevBatch(join.left.schema, fake_cols, key_lane.shape[0], None)

        cnt64 = cnt_elem.astype(jnp.int64)
        pcnt64 = pcnt_elem.astype(jnp.int64)
        total = jnp.sum(cnt64)
        has = (total > 0).reshape(1)
        probe_matched = probe_ok & (cnt_elem > 0)
        build_matched = build_ok & (pcnt_elem > 0)

        def term_sum(sd, ref, acc):
            if sd == "key":
                data, _v, _ = self.eval_expr(ref, fake)
                return jnp.sum(jnp.where(
                    probe_ok, data.astype(acc) * cnt64.astype(acc),
                    jnp.asarray(0, acc)))
            lane = pay_s[ref]
            mult = cnt64 if sd == "probe" else pcnt64
            ok = probe_ok if sd == "probe" else build_ok
            return jnp.sum(jnp.where(ok, lane.astype(acc) * mult.astype(acc),
                                     jnp.asarray(0, acc)))

        def term_lane(sd, ref):
            if sd == "key":
                data, _v, _ = self.eval_expr(ref, fake)
                return data, probe_matched
            return pay_s[ref], (probe_matched if sd == "probe"
                                else build_matched)

        cols = []
        for spec, a in zip(agg_specs, plan.aggs):
            acc = a.out_dtype.numpy_dtype
            if spec[0] in ("total", "count"):
                # null-free arguments: COUNT(col) == COUNT(*)
                cols.append(DevCol(total.reshape(1), None))
            elif spec[0] == "sum":
                s = None
                for sd, ref in spec[1]:
                    t = term_sum(sd, ref, acc)
                    s = t if s is None else s + t
                cols.append(DevCol(s.reshape(1), has))
            elif spec[0] == "avg":
                s = None
                for sd, ref in spec[1]:
                    t = term_sum(sd, ref, np.float64)
                    s = t if s is None else s + t
                avg = s / jnp.maximum(total, 1).astype(jnp.float64)
                cols.append(DevCol(jnp.where(total > 0, avg, 0.0).reshape(1),
                                   has))
            else:  # minmax
                _tag, func, sd, ref = spec
                data, ok = term_lane(sd, ref)
                if np.dtype(acc).kind == "f":
                    ident = np.inf if func == "min" else -np.inf
                else:
                    ident = (np.iinfo(np.int64).max if func == "min"
                             else np.iinfo(np.int64).min)
                masked = jnp.where(ok, data.astype(acc),
                                   jnp.asarray(ident, acc))
                red = jnp.min(masked) if func == "min" else jnp.max(masked)
                cols.append(DevCol(
                    jnp.where(total > 0, red,
                              jnp.asarray(0, acc)).reshape(1), has))
        GLOBAL_METRICS.bump("sorted_global_join_agg")
        return DevBatch(plan.schema, cols, 1, None)

    def _sorted_grouped_join_agg(self, plan: P.PhysAggregate,
                                 join: P.PhysHashJoin, left: DevBatch,
                                 right: DevBatch, path) -> Optional[DevBatch]:
        """GROUPED join aggregation in merge-sorted key space (round 5):
        group-key codes and aggregate arguments ride the tagged co-sort as
        payload lanes, per-probe match counts come out in sorted order, and
        the group-by runs directly over the merged-length lanes — the
        probe-order restore sort disappears (its cost: 1 key + 2 payload
        lanes over nb+npr rows).  Conservative eligibility: single int
        column join key, null-free non-string probe-side group keys and
        aggregate arguments, <= 4 payload lanes; anything else keeps the
        restore-sort + probe-order path."""
        if len(join.left_keys) != 1:
            return None
        lk_expr = join.left_keys[0]
        if not isinstance(lk_expr, P.ColumnRef) or \
                _np_kind(lk_expr.dtype) != "i":
            return None
        n_left_cols = len(join.left.schema)
        for g in plan.group_exprs:
            if any(i >= n_left_cols for i in _expr_col_indices(g)):
                return None
            if g.dtype is DType.STRING or _np_kind(g.dtype) == "f":
                return None
        for a in plan.aggs:
            if a.arg is None:
                continue
            if any(i >= n_left_cols for i in _expr_col_indices(a.arg)):
                return None
            if a.out_dtype is DType.STRING:
                return None
        if join.strategy != "sort_merge" and \
                self._lookup_range(join, right) is not None:
            return None  # unique build: lookup counting is cheaper

        # evaluate group keys + distinct aggregate arguments on the probe
        # batch; any nullable lane falls back (validity would need lanes)
        gk_lanes = []
        for g in plan.group_exprs:
            d, v, _dct = self.eval_expr(g, left)
            if v is not None:
                return None
            code, _null = key_code(d, v, _np_kind(g.dtype))
            if self._int32_ok(g, left) and code.dtype == jnp.int64:
                code = self._narrow32(g, left, d)
            gk_lanes.append(code)
        arg_ix: Dict = {}
        arg_lanes = []
        i32max = (1 << 31) - 8
        for a in plan.aggs:
            if a.arg is None or repr(a.arg) in arg_ix:
                continue
            d, v, _dct = self.eval_expr(a.arg, left)
            if v is not None:
                return None
            rng = self._expr_range(a.arg, left)
            if d.dtype == jnp.float64:
                dt = jnp.float64
            elif rng is not None and -i32max < int(rng[0]) \
                    and int(rng[1]) < i32max:
                dt = jnp.int32
            else:
                dt = jnp.int64
            arg_ix[repr(a.arg)] = len(arg_lanes)
            arg_lanes.append(d.astype(dt))
        if len(gk_lanes) + len(arg_lanes) > 4:
            return None

        lkeys = [self._key_of(k, left) for k in join.left_keys]
        rkeys = [self._key_of(k, right) for k in join.right_keys]
        fold_range = self._fold_range(join, lkeys, rkeys)
        lkeys_t, rkeys_t = self._unified_key_tuples(join, left, right,
                                                    lkeys, rkeys)
        lcode, linv, rcode, rinv = join_ops._prepare_codes(
            lkeys_t, left.row_valid, rkeys_t, right.row_valid, True)
        nb = rcode.shape[0]

        def pad_build(lane):
            return jnp.concatenate(
                [jnp.zeros(nb, dtype=lane.dtype), lane])

        payloads = tuple(pad_build(x) for x in gk_lanes + arg_lanes)
        probe_ok, _key_sorted, cnt_elem, _b_ok, _pcnt, pay_s = \
            join_ops.probe_counts_sorted(rcode, rinv, lcode, linv,
                                         fold_range=fold_range,
                                         payloads=payloads)
        gk_s = pay_s[:len(gk_lanes)]
        arg_s = pay_s[len(gk_lanes):]
        n = cnt_elem.shape[0]
        cnt64 = cnt_elem.astype(jnp.int64)
        participates = probe_ok & (cnt_elem > 0)

        cap_key = ("agg", path)
        max_groups = self.cap_override.get(
            cap_key, min(self.config.max_groups, left.capacity))
        self.meta["capacities"][cap_key] = max_groups

        keys = [(code, jnp.zeros(n, dtype=bool)) for code in gk_s]
        key_meta = [(g.dtype, None) for g in plan.group_exprs]

        specs: List[dict] = []
        post = []
        for a in plan.aggs:
            acc = a.out_dtype.numpy_dtype
            if a.arg is None:  # COUNT(*) = sum of multiplicities
                specs.append({"func": "sum", "values": cnt64, "valid": None,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("sj_star",)})
                post.append(("count", len(specs) - 1, None))
                continue
            lane = arg_s[arg_ix[repr(a.arg)]]
            if a.func == "count":  # null-free argument: count multiplicities
                specs.append({"func": "sum", "values": cnt64, "valid": None,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("sj_star",)})
                post.append(("count", len(specs) - 1, None))
            elif a.func == "sum":
                wv = lane.astype(acc) * cnt64.astype(acc)
                specs.append({"func": "sum", "values": wv, "valid": None,
                              "distinct": False, "acc_dtype": acc,
                              "np_kind": _np_kind(a.arg.dtype),
                              "arg_id": ("sj_sum", a.arg)})
                post.append(("plain", len(specs) - 1, None))
            elif a.func == "avg":
                num = lane.astype(np.float64) * cnt64.astype(np.float64)
                specs.append({"func": "sum", "values": num, "valid": None,
                              "distinct": False, "acc_dtype": np.float64,
                              "np_kind": "f", "arg_id": ("sj_avg", a.arg)})
                specs.append({"func": "sum", "values": cnt64, "valid": None,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("sj_star",)})
                post.append(("avg", len(specs) - 2, len(specs) - 1))
            elif a.func in ("min", "max"):
                specs.append({"func": a.func, "values": lane.astype(acc),
                              "valid": None, "distinct": False,
                              "acc_dtype": acc,
                              "np_kind": _np_kind(a.arg.dtype),
                              "arg_id": ("sj_mm", a.arg)})
                post.append(("plain", len(specs) - 1, None))
            else:
                return None

        group_codes, results, n_groups, overflow = agg_ops.groupby_aggregate(
            keys, participates, specs, max_groups, n_rows=n)
        self._push_flag(cap_key, overflow)

        cols = self._group_key_cols(group_codes, key_meta, None)
        for kind, i, j in post:
            if kind == "count":
                cols.append(DevCol(results[i][0], None))
            elif kind == "avg":
                num, den = results[i][0], results[j][0]
                den_f = den.astype(jnp.float64)
                avg = jnp.where(den > 0, num / jnp.maximum(den_f, 1.0), 0.0)
                cols.append(DevCol(avg, den > 0))
            else:
                data, valid = results[i]
                cols.append(DevCol(data, valid))
        rv = jnp.arange(max_groups) < n_groups
        GLOBAL_METRICS.bump("sorted_grouped_join_agg")
        return DevBatch(plan.schema, cols, max_groups, rv,
                        prefix_count=n_groups)

    def _grouped_join_aggregate(self, plan: P.PhysAggregate, path,
                                left: DevBatch, cnt, participates) -> DevBatch:
        """GROUP BY over probe-side keys with multiplicity-weighted aggregates
        (the grouped half of the group-join rewrite).  Unmatched probe rows
        (cnt == 0) drop out of grouping, matching inner-join semantics."""
        keys = []
        key_meta = []
        for g in plan.group_exprs:
            data, valid, dictionary = self.eval_expr(g, left)
            code, null = key_code(data, valid, _np_kind(g.dtype))
            if valid is None and _np_kind(g.dtype) != "f":
                null = None
            if self._int32_ok(g, left) and code.dtype == jnp.int64:
                code = self._narrow32(g, left, data)
            keys.append((code, null))
            key_meta.append((g.dtype, dictionary))
        keys, packed_spec = self._pack_keys(plan.group_exprs, left, keys,
                                            key_meta)

        cap_key = ("agg", path)
        max_groups = self.cap_override.get(
            cap_key, min(self.config.max_groups, left.capacity))
        self.meta["capacities"][cap_key] = max_groups

        specs: List[dict] = []
        post = []
        for a in plan.aggs:
            acc = a.out_dtype.numpy_dtype
            if a.arg is None:  # COUNT(*) = sum of multiplicities
                specs.append({"func": "sum", "values": cnt, "valid": None,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("gj_star",)})
                post.append(("count", len(specs) - 1, None))
                continue
            data, valid, dictionary = self.eval_expr(a.arg, left)
            dct = dictionary if a.out_dtype is DType.STRING else None
            if a.func == "count":
                specs.append({"func": "sum", "values": cnt, "valid": valid,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("gj_cnt", a.arg)})
                post.append(("count", len(specs) - 1, None))
            elif a.func == "sum":
                wv = data.astype(acc) * cnt.astype(acc)
                specs.append({"func": "sum", "values": wv, "valid": valid,
                              "distinct": False, "acc_dtype": acc,
                              "np_kind": _np_kind(a.arg.dtype),
                              "arg_id": ("gj_sum", a.arg)})
                post.append(("plain", len(specs) - 1, None))
            elif a.func == "avg":
                num = data.astype(np.float64) * cnt.astype(np.float64)
                specs.append({"func": "sum", "values": num, "valid": valid,
                              "distinct": False, "acc_dtype": np.float64,
                              "np_kind": "f", "arg_id": ("gj_avg", a.arg)})
                specs.append({"func": "sum", "values": cnt, "valid": valid,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("gj_cnt", a.arg)})
                post.append(("avg", len(specs) - 2, len(specs) - 1))
            else:  # min / max: multiplicity-independent
                specs.append({"func": a.func, "values": data, "valid": valid,
                              "distinct": False, "acc_dtype": acc,
                              "np_kind": _np_kind(a.arg.dtype),
                              "arg_id": a.arg,
                              "int32_ok": self._int32_ok(a.arg, left),
                              "dictionary": dct})
                post.append(("plain", len(specs) - 1, None))

        row_valid = participates
        group_codes, results, n_groups, overflow = agg_ops.groupby_aggregate(
            keys, row_valid, specs, max_groups, n_rows=left.capacity)
        self._push_flag(cap_key, overflow)

        cols = self._group_key_cols(group_codes, key_meta, packed_spec)
        for kind, i, j in post:
            if kind == "count":
                cols.append(DevCol(results[i][0], None))
            elif kind == "avg":
                num, den = results[i][0], results[j][0]
                den_f = den.astype(jnp.float64)
                avg = jnp.where(den > 0, num / jnp.maximum(den_f, 1.0), 0.0)
                cols.append(DevCol(avg, den > 0))
            else:
                data, valid = results[i]
                cols.append(DevCol(data, valid, specs[i].get("dictionary")))
        rv = jnp.arange(max_groups) < n_groups
        return DevBatch(plan.schema, cols, max_groups, rv,
                        prefix_count=n_groups)

    def _aggregate(self, plan: P.PhysAggregate, path) -> DevBatch:
        if isinstance(plan.input, P.PhysHashJoin):
            fast = self._try_join_aggregate(plan, path)
            if fast is not None:
                return fast
        batch = self.exec(plan.input, path + (0,))
        keys = []
        key_meta = []
        for g in plan.group_exprs:
            data, valid, dictionary = self.eval_expr(g, batch)
            code, null = key_code(data, valid, _np_kind(g.dtype))
            if valid is None and _np_kind(g.dtype) != "f":
                null = None  # statically null-free: drops a sort operand
            if self._int32_ok(g, batch) and code.dtype == jnp.int64:
                code = self._narrow32(g, batch, data)  # zone-map narrow path
            keys.append((code, null))
            key_meta.append((g.dtype, dictionary))

        keys, packed_spec = self._pack_keys(plan.group_exprs, batch, keys,
                                            key_meta)

        cap_key = ("agg", path)
        if plan.group_exprs:
            max_groups = self.cap_override.get(
                cap_key, min(self.config.max_groups, batch.capacity)
            )
        else:
            max_groups = 1
        self.meta["capacities"][cap_key] = max_groups

        specs = []
        for a in plan.aggs:
            if a.arg is None:
                specs.append({"func": a.func, "values": None, "valid": None,
                              "distinct": a.distinct,
                              "acc_dtype": a.out_dtype.numpy_dtype})
                continue
            data, valid, dictionary = self.eval_expr(a.arg, batch)
            # zone-map bound n * max|v| < 2^52: integer SUM prefix sums stay
            # exact in float64 (f64 over int64 scans is a choice made on the
            # previous accelerator, not yet re-measured on the H100);
            # interval propagation extends this to computed arguments
            vrange = self._expr_range(a.arg, batch)
            sum_f64_ok = bool(
                a.func in ("sum", "avg") and vrange is not None
                and batch.capacity * max(abs(int(vrange[0])),
                                         abs(int(vrange[1]))) < (1 << 52))
            specs.append({
                "func": a.func, "values": data, "valid": valid,
                "distinct": a.distinct, "acc_dtype": a.out_dtype.numpy_dtype,
                "np_kind": _np_kind(a.arg.dtype),
                "sum_f64_ok": sum_f64_ok,
                "int32_ok": self._int32_ok(a.arg, batch),
                # structural id of the argument expression: min/max specs over
                # the same argument share the ride-the-sort fast path
                "arg_id": a.arg,
                # min/max over string codes is exact because dictionaries are
                # sorted; the result column keeps the argument's dictionary
                "dictionary": dictionary if a.out_dtype is DType.STRING else None,
            })

        group_codes, results, n_groups, overflow = agg_ops.groupby_aggregate(
            keys, batch.row_valid, specs, max_groups, n_rows=batch.capacity,
            prefix_rows=batch.prefix_rows,
        )
        if plan.group_exprs:
            self._push_flag(cap_key, overflow)

        cols = self._group_key_cols(group_codes, key_meta, packed_spec)
        i32max = (1 << 31) - 8
        for (data, valid), a, spec in zip(results, plan.aggs, specs):
            # provable-int32 result ranges let the host boundary transfer a
            # narrow wire format (half the bytes of the result pull):
            # COUNT <= capacity; MIN/MAX stay within the argument's zone-map
            # range; SUM when capacity * max|v| provably fits
            ok32, rng32 = False, None
            if a.func == "count":
                ok32, rng32 = True, (0, batch.capacity)
            elif a.func in ("min", "max", "sum") and a.arg is not None \
                    and a.out_dtype.numpy_dtype == np.dtype(np.int64):
                vrange = self._expr_range(a.arg, batch)
                if vrange is not None:
                    lo, hi = int(vrange[0]), int(vrange[1])
                    if a.func in ("min", "max"):
                        ok32 = -i32max < lo and hi < i32max
                        rng32 = (lo, hi)
                    else:
                        bound = batch.capacity * max(abs(lo), abs(hi))
                        ok32 = bound < i32max
                        rng32 = (-bound, bound)
            cols.append(DevCol(data, valid, spec.get("dictionary"),
                               int32_ok=ok32, value_range=rng32))

        out_cap = max_groups if plan.group_exprs else 1
        if plan.group_exprs:
            row_valid = jnp.arange(out_cap) < n_groups
            return DevBatch(plan.schema, cols, out_cap, row_valid,
                            prefix_count=n_groups)
        return DevBatch(plan.schema, cols, out_cap, None)

    def _sort_keys(self, keys, batch: DevBatch):
        out = []
        for k in keys:
            data, valid, dictionary = self.eval_expr(k.expr, batch)
            if self._int32_ok(k.expr, batch) and data.dtype == jnp.int64:
                data = self._narrow32(k.expr, batch, data)
            codes = order_code(data, _np_kind(k.expr.dtype))
            nulls = None if valid is None else ~valid
            out.append({"codes": codes, "nulls": nulls,
                        "ascending": k.ascending, "nulls_last": k.nulls_last})
        return out

    def _sort(self, plan: P.PhysSort, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        keys = self._sort_keys(plan.keys, batch)
        perm = sort_ops.order_by_permutation(keys, batch.row_valid, batch.capacity)
        count = batch.count()
        cols = []
        for c in batch.cols:
            src = c.data
            if c.int32_ok and src.dtype == jnp.int64:
                src = c.as_int32()  # 2.6x faster permutation gather
            cols.append(DevCol(
                src[perm],
                None if c.validity is None else c.validity[perm],
                c.dictionary, c.int32_ok, c.value_range,
            ))
        n = batch.capacity
        limit = plan.limit if plan.limit is not None else n
        pc = jnp.minimum(count, jnp.asarray(limit, count.dtype))
        row_valid = jnp.arange(n) < pc
        prefix = (min(batch.prefix_rows, limit)
                  if batch.prefix_rows is not None else None)
        return DevBatch(plan.schema, cols, n, row_valid, prefix,
                        prefix_count=pc)

    def _limit(self, plan: P.PhysLimit, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        rv = batch.row_valid
        if rv is None:
            rv = jnp.ones(batch.capacity, dtype=bool)
        pos = jnp.cumsum(rv.astype(jnp.int64))
        lo = plan.offset
        hi = lo + plan.limit if plan.limit is not None else None
        mask = rv & (pos > lo)
        if hi is not None:
            mask = mask & (pos <= hi)
        prefix = None
        if batch.prefix_rows is not None and lo == 0:
            prefix = (min(batch.prefix_rows, hi) if hi is not None
                      else batch.prefix_rows)
        pc = None
        if lo == 0 and (batch.row_valid is None
                        or batch.prefix_rows is not None
                        or batch.prefix_count is not None):
            base = batch.count()
            pc = (base if hi is None
                  else jnp.minimum(base, jnp.asarray(hi, base.dtype)))
        return DevBatch(plan.schema, batch.cols, batch.capacity, mask, prefix,
                        prefix_count=pc)

    def _distinct(self, plan: P.PhysDistinct, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        keys = []
        key_meta = []
        for f, c in zip(batch.schema, batch.cols):
            code, null = key_code(c.data, c.validity, _np_kind(f.dtype))
            if c.validity is None and _np_kind(f.dtype) != "f":
                null = None  # statically null-free: drops a sort operand
            if c.int32_ok and f.dtype is not DType.FLOAT64 and code.dtype == jnp.int64:
                code = c.as_int32()
            keys.append((code, null))
            key_meta.append((f.dtype, c.dictionary))
        # same multi-key packing as GROUP BY: DISTINCT over packable columns
        # runs the single-int32-key hot path
        exprs = [P.ColumnRef(f.dtype, i, f.name)
                 for i, f in enumerate(batch.schema)]
        keys, packed_spec = self._pack_keys(exprs, batch, keys, key_meta)
        cap_key = ("distinct", path)
        max_groups = self.cap_override.get(cap_key, batch.capacity)
        self.meta["capacities"][cap_key] = max_groups
        group_codes, _, n_groups, overflow = agg_ops.groupby_aggregate(
            keys, batch.row_valid, [], max_groups, n_rows=batch.capacity,
            prefix_rows=batch.prefix_rows,
        )
        self._push_flag(cap_key, overflow)
        cols = self._group_key_cols(group_codes, key_meta, packed_spec)
        row_valid = jnp.arange(max_groups) < n_groups
        return DevBatch(plan.schema, cols, max_groups, row_valid,
                        prefix_count=n_groups)

    def _push_flag(self, cap_key, flag):
        self.meta["flag_names"].append(cap_key)
        self.flags.append(flag)

    # ------------------------------------------------------------------
    # expression evaluation: returns (data, validity|None, dictionary|None)
    # ------------------------------------------------------------------
    def eval_expr(self, e: P.PhysExpr, batch: DevBatch):
        if isinstance(e, P.ColumnRef):
            c = batch.cols[e.index]
            return c.data, c.validity, c.dictionary
        if isinstance(e, P.PhysLiteral):
            return self._literal(e, batch.capacity)
        if isinstance(e, P.PhysBinary):
            return self._binary(e, batch)
        if isinstance(e, P.PhysUnary):
            data, valid, _ = self.eval_expr(e.operand, batch)
            if e.op == "NOT":
                return ~data.astype(bool), valid, None
            if e.op == "-":
                return -data, valid, None
            raise DeviceUnsupported(e.op)
        if isinstance(e, P.PhysIsNull):
            data, valid, _ = self.eval_expr(e.operand, batch)
            isnull = jnp.zeros(data.shape, dtype=bool) if valid is None else ~valid
            return (~isnull if e.negated else isnull), None, None
        if isinstance(e, P.PhysInList):
            return self._in_list(e, batch)
        if isinstance(e, P.PhysCase):
            return self._case(e, batch)
        if isinstance(e, P.PhysFunc):
            return self._func(e, batch)
        raise DeviceUnsupported(type(e).__name__)

    def _literal(self, e: P.PhysLiteral, n: int):
        if e.value is None:
            return (jnp.zeros(n, dtype=e.dtype.numpy_dtype),
                    jnp.zeros(n, dtype=bool), None)
        if isinstance(e.value, str):
            return (jnp.zeros(n, dtype=jnp.int64), None,
                    np.array([e.value], dtype=object))
        np_dtype = e.dtype.numpy_dtype
        return jnp.full(n, e.value, dtype=np_dtype), None, None

    def _binary(self, e: P.PhysBinary, batch: DevBatch):
        if e.op in ("AND", "OR"):
            ld, lv, _ = self.eval_expr(e.left, batch)
            rd, rv, _ = self.eval_expr(e.right, batch)
            ld = ld.astype(bool)
            rd = rd.astype(bool)
            lvv = jnp.ones(ld.shape, bool) if lv is None else lv
            rvv = jnp.ones(rd.shape, bool) if rv is None else rv
            if e.op == "AND":
                val = ld & rd
                valid = (lvv & rvv) | (lvv & ~ld) | (rvv & ~rd)
                return val & valid, (None if (lv is None and rv is None) else valid), None
            val = ld | rd
            valid = (lvv & rvv) | (lvv & ld) | (rvv & rd)
            return val, (None if (lv is None and rv is None) else valid), None

        ld, lv, ldict = self.eval_expr(e.left, batch)
        rd, rv, rdict = self.eval_expr(e.right, batch)
        valid = _and_valid(lv, rv)

        if e.left.dtype is DType.STRING or e.right.dtype is DType.STRING:
            if e.op == "||":
                raise DeviceUnsupported("string concatenation on device")
            ld, rd = _align_string_codes(ld, ldict, rd, rdict)
            return _cmp(e.op, ld, rd), valid, None

        if e.op in ("=", "!=", "<", "<=", ">", ">="):
            return _cmp(e.op, ld, rd), valid, None

        out_np = e.dtype.numpy_dtype
        if e.op in ("+", "-", "*") and np.dtype(out_np) == np.dtype(np.int64):
            r = self._expr_range(e, batch)
            lo32 = np.iinfo(np.int32).min + 4
            hi32 = np.iinfo(np.int32).max - 4
            if r is not None and lo32 < r[0] and r[1] < hi32:
                # interval-proven int32 arithmetic (half the bytes of int64).
                # Exact even when an operand exceeds int32: two's
                # complement is modular, and the RESULT provably fits.
                a32 = self._narrow32(e.left, batch, ld)
                b32 = self._narrow32(e.right, batch, rd)
                if e.op == "+":
                    return a32 + b32, valid, None
                if e.op == "-":
                    return a32 - b32, valid, None
                return a32 * b32, valid, None
        if e.op == "+":
            return ld.astype(out_np) + rd.astype(out_np), valid, None
        if e.op == "-":
            return ld.astype(out_np) - rd.astype(out_np), valid, None
        if e.op == "*":
            return ld.astype(out_np) * rd.astype(out_np), valid, None
        if e.op == "/":
            nonzero = rd != 0
            valid = nonzero if valid is None else (valid & nonzero)
            if np.dtype(out_np).kind == "i":
                safe = jnp.where(nonzero, rd, 1)
                # i64 division truncating toward zero (executor.rs:434)
                q = jnp.trunc(ld.astype(jnp.float64) / safe.astype(jnp.float64))
                big = jnp.abs(ld) > (1 << 52)
                q_exact = jnp.where(
                    big,
                    (jnp.sign(ld) * jnp.sign(safe)) * (jnp.abs(ld) // jnp.abs(safe)),
                    q.astype(jnp.int64),
                )
                return q_exact.astype(jnp.int64), valid, None
            safe = jnp.where(nonzero, rd, 1)
            return ld.astype(jnp.float64) / safe.astype(jnp.float64), valid, None
        if e.op == "%":
            nonzero = rd != 0
            valid = nonzero if valid is None else (valid & nonzero)
            safe = jnp.where(nonzero, rd, 1)
            if np.dtype(out_np).kind == "i":
                # match C/Rust fmod semantics (sign of dividend)
                q = (jnp.sign(ld) * jnp.sign(safe)) * (jnp.abs(ld) // jnp.abs(safe))
                return ld - q * safe, valid, None
            return jnp.where(nonzero, ld - jnp.trunc(ld / safe) * safe, 0.0), valid, None
        raise DeviceUnsupported(e.op)

    def _in_list(self, e: P.PhysInList, batch: DevBatch):
        data, valid, dictionary = self.eval_expr(e.operand, batch)
        if e.operand.dtype is DType.STRING:
            lut = np.isin(np.asarray(dictionary, dtype=str),
                          [str(v) for v in e.values])
            mask = jnp.asarray(lut)[jnp.clip(data, 0, len(lut) - 1)]
        else:
            mask = jnp.zeros(data.shape, dtype=bool)
            for v in e.values:
                if v is None:
                    continue
                mask = mask | (data == v)
        if e.negated:
            mask = ~mask
        return mask, valid, None

    def _case(self, e: P.PhysCase, batch: DevBatch):
        n = batch.capacity
        out_np = e.dtype.numpy_dtype
        result = jnp.zeros(n, dtype=out_np)
        out_valid = jnp.zeros(n, dtype=bool)
        decided = jnp.zeros(n, dtype=bool)
        for cond, val in e.branches:
            cd, cv, _ = self.eval_expr(cond, batch)
            cmask = cd.astype(bool) & (~decided)
            if cv is not None:
                cmask = cmask & cv
            vd, vv, _ = self.eval_expr(val, batch)
            result = jnp.where(cmask, vd.astype(out_np), result)
            out_valid = jnp.where(cmask, jnp.ones(n, bool) if vv is None else vv, out_valid)
            decided = decided | cmask
        if e.default is not None:
            vd, vv, _ = self.eval_expr(e.default, batch)
            result = jnp.where(decided, result, vd.astype(out_np))
            out_valid = jnp.where(decided, out_valid,
                                  jnp.ones(n, bool) if vv is None else vv)
        return result, out_valid, None

    def _func(self, e: P.PhysFunc, batch: DevBatch):
        if e.func == "date_part":
            part, ts = e.args
            assert isinstance(part, P.PhysLiteral)
            data, valid, _ = self.eval_expr(ts, batch)
            return _date_part(str(part.value).lower(), data), valid, None
        if e.func == "like":
            target, pat = e.args
            assert isinstance(pat, P.PhysLiteral)
            data, valid, dictionary = self.eval_expr(target, batch)
            import re

            regex = re.compile(
                "^" + re.escape(str(pat.value)).replace("%", ".*").replace("_", ".") + "$",
                re.DOTALL,
            )
            lut = np.array([bool(regex.match(str(s))) for s in np.asarray(dictionary)])
            return jnp.asarray(lut)[jnp.clip(data, 0, len(lut) - 1)], valid, None
        if e.func == "cast":
            data, valid, _ = self.eval_expr(e.args[0], batch)
            return data.astype(e.dtype.numpy_dtype), valid, None
        if e.func == "abs":
            data, valid, _ = self.eval_expr(e.args[0], batch)
            return jnp.abs(data), valid, None
        if e.func in ("round", "floor", "ceil", "sqrt", "ln", "log", "exp"):
            data, valid, _ = self.eval_expr(e.args[0], batch)
            fn = {"round": jnp.round, "floor": jnp.floor, "ceil": jnp.ceil,
                  "sqrt": jnp.sqrt, "ln": jnp.log, "log": jnp.log10,
                  "exp": jnp.exp}[e.func]
            return fn(data.astype(jnp.float64)).astype(e.dtype.numpy_dtype), valid, None
        if e.func == "coalesce":
            out_np = e.dtype.numpy_dtype
            parts = [self.eval_expr(a, batch) for a in e.args]
            data = parts[0][0].astype(out_np)
            valid = parts[0][1]
            vv = jnp.ones(data.shape, bool) if valid is None else valid
            for d2, v2, _ in parts[1:]:
                v2v = jnp.ones(data.shape, bool) if v2 is None else v2
                take = (~vv) & v2v
                data = jnp.where(take, d2.astype(out_np), data)
                vv = vv | v2v
            return data, vv, None
        if e.func == "power":
            a, av, _ = self.eval_expr(e.args[0], batch)
            b, bv, _ = self.eval_expr(e.args[1], batch)
            return (jnp.power(a.astype(jnp.float64), b.astype(jnp.float64)),
                    _and_valid(av, bv), None)
        raise DeviceUnsupported(e.func)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _cmp(op, ld, rd):
    return {"=": jnp.equal, "!=": jnp.not_equal, "<": jnp.less,
            "<=": jnp.less_equal, ">": jnp.greater, ">=": jnp.greater_equal}[op](ld, rd)


def _align_string_codes(ld, ldict, rd, rdict):
    """Remap two string-code columns into a shared sorted dictionary space."""
    if _dicts_equal(ldict, rdict):
        return ld, rd
    union = np.unique(np.concatenate([
        np.asarray(ldict, dtype=str), np.asarray(rdict, dtype=str)
    ]))
    lmap = jnp.asarray(np.searchsorted(union, np.asarray(ldict, dtype=str)))
    rmap = jnp.asarray(np.searchsorted(union, np.asarray(rdict, dtype=str)))
    return (lmap[jnp.clip(ld, 0, len(lmap) - 1)],
            rmap[jnp.clip(rd, 0, len(rmap) - 1)])


def _gather_col(c: DevCol, idx, out_valid) -> DevCol:
    """Gather a join-side column by row indices; -1 marks the null-padded side
    of an outer join.

    int32-narrowable columns (zone-map stats) are gathered in int32 and
    widened after — the random gather is bandwidth-bound, so halving the
    element width roughly halves its cost."""
    nb = c.data.shape[0]
    pad = idx < 0
    safe = jnp.clip(idx, 0, nb - 1)
    src = c.data
    # int32 gathers move half the bytes of int64; the narrowing
    # conversion pass over the source pays for itself almost always
    narrowed = (c.int32_ok and src.dtype == jnp.int64
                and (c.narrow is not None or idx.shape[0] * 256 >= nb))
    if narrowed:
        src = c.as_int32()
    data = src[safe]
    if c.validity is None:
        valid = ~pad
    else:
        valid = c.validity[safe] & ~pad
    return DevCol(data, valid, c.dictionary, c.int32_ok, c.value_range)


def _subst_cols(expr: P.PhysExpr, mapping) -> P.PhysExpr:
    """Rewrite ColumnRefs per ``mapping`` (index -> replacement ColumnRef)."""
    if isinstance(expr, P.ColumnRef):
        return mapping.get(expr.index, expr)
    if isinstance(expr, P.PhysBinary):
        return dataclasses.replace(expr, left=_subst_cols(expr.left, mapping),
                                   right=_subst_cols(expr.right, mapping))
    if isinstance(expr, (P.PhysUnary, P.PhysIsNull, P.PhysInList)):
        return dataclasses.replace(
            expr, operand=_subst_cols(expr.operand, mapping))
    if isinstance(expr, P.PhysCase):
        return dataclasses.replace(
            expr,
            branches=tuple((_subst_cols(c, mapping), _subst_cols(v, mapping))
                           for c, v in expr.branches),
            default=None if expr.default is None
            else _subst_cols(expr.default, mapping))
    if isinstance(expr, P.PhysFunc):
        return dataclasses.replace(
            expr, args=tuple(_subst_cols(a, mapping) for a in expr.args))
    return expr


def _expr_col_indices(expr: P.PhysExpr) -> List[int]:
    """All ColumnRef indices referenced by a physical expression."""
    out: List[int] = []

    def walk(e):
        if isinstance(e, P.ColumnRef):
            out.append(e.index)
        elif isinstance(e, P.PhysBinary):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, (P.PhysUnary, P.PhysIsNull, P.PhysInList)):
            walk(e.operand)
        elif isinstance(e, P.PhysCase):
            for cond, val in e.branches:
                walk(cond)
                walk(val)
            if e.default is not None:
                walk(e.default)
        elif isinstance(e, P.PhysFunc):
            for a in e.args:
                walk(a)

    walk(expr)
    return out


def _decode_key(code, null, dtype: DType, dictionary) -> DevCol:
    # key operands keep their own space (float keys stay f64), so no bitcast.
    # int32 fast-path codes STAY int32 on device (downstream ops promote as
    # needed and _to_host widens host-side), halving result-pull bytes
    if dtype is DType.BOOL:
        data = code.astype(bool)
    else:
        data = code
    return DevCol(data, None if null is None else ~null, dictionary,
                  int32_ok=code.dtype == jnp.int32)


_DAY_MS = 86_400_000


def _date_part(part: str, ms):
    """Calendar decomposition of epoch-ms (civil-from-days, branch-free)."""
    days = jnp.floor_divide(ms, _DAY_MS)
    ms_in_day = ms - days * _DAY_MS
    if part == "hour":
        return jnp.floor_divide(ms_in_day, 3_600_000).astype(jnp.int64)
    if part == "minute":
        return (jnp.floor_divide(ms_in_day, 60_000) % 60).astype(jnp.int64)
    if part == "second":
        return (jnp.floor_divide(ms_in_day, 1000) % 60).astype(jnp.int64)
    if part in ("dow", "dayofweek"):
        return ((days + 4) % 7).astype(jnp.int64)
    # civil-from-days (Hinnant's algorithm, integer-only)
    z = days + 719468
    era = jnp.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = jnp.floor_divide(doe - jnp.floor_divide(doe, 1460)
                           + jnp.floor_divide(doe, 36524)
                           - jnp.floor_divide(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + jnp.floor_divide(yoe, 4) - jnp.floor_divide(yoe, 100))
    mp = jnp.floor_divide(5 * doy + 2, 153)
    d = doy - jnp.floor_divide(153 * mp + 2, 5) + 1
    m = mp + jnp.where(mp < 10, 3, -9)
    y = y + jnp.where(m <= 2, 1, 0)
    if part == "year":
        return y.astype(jnp.int64)
    if part == "month":
        return m.astype(jnp.int64)
    if part == "day":
        return d.astype(jnp.int64)
    raise DeviceUnsupported(f"date_part({part!r})")
