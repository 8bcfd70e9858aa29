"""Out-of-core streamed execution.

The reference plans unified-memory oversubscription + batch_size-chunked
streaming for tables larger than device memory (README.md:338-352,
``lib.rs:27-28``) but implements none of it.  Here: aggregation pipelines over
uncached (larger-than-threshold) Parquet tables stream host chunks through the
double-buffered feeder into a jitted *partial-aggregate + merge* step with a
fixed-shape device-resident group state — transfers overlap compute, peak HBM
use is one chunk + the group state, and results are exact for the mergeable
aggregates (SUM/COUNT/MIN/MAX/AVG as sum+count).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional

import numpy as np

from ..config import EngineConfig
from ..interop.columnar import Column, ColumnBatch, DType
from ..mem.arena import BufferArena
from ..mem.feeder import DeviceFeeder
from ..ops import aggregate as agg_ops
from ..ops import filter as filter_ops
from ..ops.dtypes import INT64_MAX, INT64_MIN, key_code
from ..plan import physical as P
from ..utils.jaxenv import ensure_jax
from ..utils.tracing import get_logger

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402

logger = get_logger(__name__)


class NotStreamable(Exception):
    """Plan shape not supported by the streaming path."""


@dataclasses.dataclass
class _StreamablePipeline:
    scan: P.PhysTableScan              # the streamed (probe) scan
    # operators between the streamed scan and the aggregate (or the join),
    # bottom-up order
    middle: List[P.PhysicalPlan]
    aggregate: P.PhysAggregate
    # streamed-join extension: probe chunks join a device-resident build side
    join: Optional[P.PhysHashJoin] = None
    agg_middle: List[P.PhysicalPlan] = dataclasses.field(default_factory=list)
    build_plan: Optional[P.PhysicalPlan] = None  # cached-side subtree
    # grace-join mode: BOTH sides exceed the memory threshold -> hash-spill
    # both into k partition pairs, join each pair with a resident build
    partitioned: bool = False


def _reject_known_nulls(catalog, scan: P.PhysTableScan) -> None:
    """Streamed chunk staging uploads DATA lanes only (no validity), so a
    scanned column with metadata-recorded nulls cannot stream correctly —
    fall back to the full-load device path, which carries validity masks
    end-to-end (round-5 guard for a latent round-2 gap).  Unknown null
    counts (writer recorded none) stream as before."""
    stats = catalog.get_stats(scan.table_name) or {}
    nulls = stats.get("__nulls__")
    if not isinstance(nulls, dict):
        return
    sch = catalog.get_schema(scan.table_name)
    idxs = (scan.projection if scan.projection is not None
            else range(len(sch)))
    for i in idxs:
        nm = sch.field(i).name
        nc = nulls.get(nm)
        if nc is not None and nc > 0:
            raise NotStreamable(f"nulls in streamed column {nm!r}")


def _strip_middle(node: P.PhysicalPlan):
    middle: List[P.PhysicalPlan] = []
    while isinstance(node, (P.PhysFilter, P.PhysProjection)):
        middle.append(node)
        node = node.input
    return list(reversed(middle)), node


def split_above_aggregate(plan: P.PhysicalPlan):
    """Walk down single-input operators (SELECT-list projection, HAVING
    filter, ORDER BY, LIMIT, DISTINCT) to the aggregate subtree.

    The planner always places the SELECT-list ``PhysProjection`` above the
    aggregate, so matching strictly at the root would reject every real SQL
    plan.  The small post-aggregate operators run on the host over the
    (max_groups-bounded) group results instead — mirroring
    ``dist_executor._split_above_aggregate``.
    """
    node = plan
    seen_above = False
    while True:
        if isinstance(node, P.PhysAggregate):
            return node, seen_above
        kids = node.inputs()
        if len(kids) != 1:
            raise NotStreamable(type(node).__name__)
        seen_above = True
        node = kids[0]


def match_streamable(plan: P.PhysicalPlan, catalog) -> _StreamablePipeline:
    """Aggregate over (F|P)* over [Join(streamed probe, cached build) |
    streamed TableScan]."""
    if not isinstance(plan, P.PhysAggregate):
        raise NotStreamable(type(plan).__name__)
    if any(a.distinct for a in plan.aggs):
        raise NotStreamable("COUNT(DISTINCT) is not mergeable across chunks")
    middle, node = _strip_middle(plan.input)
    if isinstance(node, P.PhysTableScan):
        _reject_known_nulls(catalog, node)
        return _StreamablePipeline(node, middle, plan)
    if isinstance(node, P.PhysHashJoin):
        join = node
        if join.join_type != "inner":
            raise NotStreamable("streamed outer join")
        if len(join.left_keys) != 1:
            raise NotStreamable("streamed multi-key join")
        probe_middle, probe_leaf = _strip_middle(join.left)
        build_middle, build_leaf = _strip_middle(join.right)
        if not isinstance(probe_leaf, P.PhysTableScan) \
                or not isinstance(build_leaf, P.PhysTableScan):
            raise NotStreamable("streamed join requires scan leaves")
        if join.left_keys[0].dtype is DType.STRING:
            raise NotStreamable("string join keys while streaming")
        if catalog.is_cached(probe_leaf.table_name) \
                and catalog.is_cached(build_leaf.table_name):
            raise NotStreamable("both sides cached (in-memory path)")
        if catalog.is_cached(build_leaf.table_name):
            if catalog.is_cached(probe_leaf.table_name):
                raise NotStreamable("probe side is cached (not streamed)")
            _reject_known_nulls(catalog, probe_leaf)
            return _StreamablePipeline(probe_leaf, probe_middle, plan,
                                       join=join, agg_middle=middle,
                                       build_plan=join.right)
        # build side above the memory threshold: grace-join partitioning
        # (reference PROJECT_SUMMARY.md:24,115-118).  Host partitioning
        # hashes raw table columns, so keys must be plain column refs and
        # both scans direct (per-side filters would also be re-derivable,
        # but keep the spill pass simple)
        if probe_middle or build_middle:
            raise NotStreamable("partitioned join with per-side operators")
        if not isinstance(join.left_keys[0], P.ColumnRef) \
                or not isinstance(join.right_keys[0], P.ColumnRef):
            raise NotStreamable("partitioned join key must be a column")
        for leaf in (probe_leaf, build_leaf):
            sch = catalog.get_schema(leaf.table_name)
            idxs = (leaf.projection if leaf.projection is not None
                    else range(len(sch)))
            if any(sch.field(i).dtype is DType.STRING for i in idxs):
                raise NotStreamable("string columns in partitioned join")
        _reject_known_nulls(catalog, probe_leaf)
        return _StreamablePipeline(probe_leaf, probe_middle, plan,
                                   join=join, agg_middle=middle,
                                   build_plan=join.right, partitioned=True)
    raise NotStreamable(type(node).__name__)


def _prefetch_iter(it, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue: parquet
    chunk reads (~300 ms per 2M-row chunk, round-5 profile) overlap the
    hash-split + staging + upload work instead of serializing with it."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    END = object()

    def run():
        try:
            for item in it:
                q.put(item)
            q.put(END)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            q.put(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


class StreamingAggregator:
    """Chunked scan -> filter/project -> partial group-by -> state merge."""

    def __init__(self, catalog, config: EngineConfig, interpreter_cls):
        self.catalog = catalog
        self.config = config
        self._interpreter_cls = interpreter_cls
        # pooled host staging buffers for chunk upload (slab-allocator
        # analogue, slab_allocator.rs:24-130): bounded byte budget, O(1)
        # reuse across chunks instead of a fresh allocation per column
        self.arena = BufferArena(max_bytes=config.max_hbm_bytes)
        # grace-join spill partitions (cached per table version)
        from .spill import SpillStore
        self.spill = SpillStore(getattr(config, "spill_dir", None))
        # memoized jitted steps: the build side rides as ARGUMENTS (not a
        # closure constant), so partition pairs with equal shapes reuse one
        # compile instead of retracing per partition
        self._steps = {}
        self.last_partitioned = False
        self.last_hash_parts = 1
        self.last_stream_chunks = 0
        self.last_link_bytes = 0
        self.last_compile_seconds = 0.0
        self.last_stream_seconds = 0.0

    def execute(self, plan: P.PhysicalPlan) -> ColumnBatch:
        agg_root, has_above = split_above_aggregate(plan)
        batch = self._execute_aggregate(agg_root)
        if has_above:
            # post-aggregate operators run on the host over the small
            # group-result batch (same mechanism as the distributed path)
            from .cpu import CpuExecutor

            cpu = CpuExecutor(self.catalog, self.config)
            cpu.leaf_results = {id(agg_root): batch}
            return cpu.execute(plan)
        return batch

    def _execute_aggregate(self, plan: P.PhysAggregate) -> ColumnBatch:
        pipe = match_streamable(plan, self.catalog)
        agg = pipe.aggregate
        chunk_rows = self.config.batch_size
        partials = self._stream_partials(pipe)
        self.last_partitioned = pipe.partitioned

        max_groups = min(self.config.max_groups, 1 << 22)
        join_capacity = int(chunk_rows * self.config.join_expansion) \
            if pipe.join is not None else 0

        if pipe.partitioned:
            return self._execute_partitioned(pipe, chunk_rows, max_groups,
                                             join_capacity, partials)

        if pipe.join is None and self._hash_state_keys(pipe) is not None \
                and max_groups > self.config.stream_state_partition_groups:
            return self._execute_hash_state(pipe, chunk_rows, max_groups,
                                            partials)

        build = self._prepare_build(pipe) if pipe.join is not None else None
        if build is not None:
            # size the per-chunk match buffer from the build side's MEASURED
            # key duplication (2x headroom) instead of blind growth retries
            join_capacity = max(join_capacity, _dup_capacity(
                chunk_rows, build.get("avg_dup", 1.0)))

        key_narrow = self._key_narrow(pipe)
        for attempt in range(5):
            state = _init_state(agg.group_exprs, partials, max_groups,
                                key_narrow)
            state, (j_ovf, g_ovf) = self._stream_part(
                pipe, build, chunk_rows, max_groups, join_capacity, partials,
                state, self._probe_chunks(pipe, chunk_rows))
            if not (j_ovf or g_ovf):
                state, = _fetch_prefix_states([state])
                return self._finalize(agg, state, max_groups, partials)
            # grow ONLY the overflowing capacity: inflating max_groups on a
            # join overflow recompiles every step against 4x group buffers
            if j_ovf:
                join_capacity *= 4
            if g_ovf:
                max_groups = min(max_groups * 4, 1 << 24)
            logger.warning("streamed pass overflowed (join=%s groups=%s); "
                           "retrying with join_capacity=%d max_groups=%d",
                           j_ovf, g_ovf, join_capacity, max_groups)
        raise RuntimeError("streaming capacities kept overflowing")

    def _stream_partials(self, pipe):
        """Partial layout, with int64-avoiding dtype narrowing for
        the scan-only pipelines where zone maps prove it (see
        _partial_layout)."""
        agg = pipe.aggregate
        if pipe.join is not None or \
                any(isinstance(op, P.PhysProjection) for op in pipe.middle):
            return _partial_layout(agg)
        narrow = self._narrow_flags(pipe)
        ranges = {i: r for i, (ok, r) in enumerate(narrow) if r is not None}
        total = self.catalog.get_row_count(pipe.scan.table_name)
        return _partial_layout(agg, ranges, total)

    def _key_narrow(self, pipe):
        """Per-group-expr: key-code lanes stay int32 (chunk cols upload as
        int32 and the state lane matches) — no s64 sort operands."""
        if pipe.join is not None or \
                any(isinstance(op, P.PhysProjection) for op in pipe.middle):
            return None
        narrow = self._narrow_flags(pipe)
        return tuple(
            isinstance(g, P.ColumnRef) and g.index < len(narrow)
            and narrow[g.index][0]
            for g in pipe.aggregate.group_exprs)

    def _probe_cols(self, pipe) -> List[str]:
        table_schema = self.catalog.get_schema(pipe.scan.table_name)
        return ([f.name for f in table_schema]
                if pipe.scan.projection is None
                else [table_schema.field(i).name
                      for i in pipe.scan.projection])

    def _probe_chunks(self, pipe, chunk_rows, path=None):
        cols = self._probe_cols(pipe)
        if path is not None:
            from ..interop import arrow as arrow_io

            return arrow_io.iter_parquet_chunks(path, chunk_rows, cols)
        return self.catalog.iter_table_chunks(
            pipe.scan.table_name, chunk_rows, columns=cols)

    def _execute_partitioned(self, pipe, chunk_rows, max_groups,
                             join_capacity, partials) -> ColumnBatch:
        """Grace join: both sides spill into k hash partitions by join key;
        each pair joins with a device-resident (padded-bucket) build side,
        accumulating into ONE mergeable group state across all pairs
        (reference out-of-core contract, PROJECT_SUMMARY.md:24,115-118)."""
        import os

        from .spill import choose_partitions

        agg = pipe.aggregate
        join = pipe.join
        _, build_scan = _strip_middle(pipe.build_plan)

        def raw_name(scan, pos):
            # scan schemas are table-qualified; spill chunks carry the raw
            # Parquet column names — map through the scan projection
            tsch = self.catalog.get_schema(scan.table_name)
            ti = pos if scan.projection is None else scan.projection[pos]
            return tsch.field(ti).name

        lname = raw_name(pipe.scan, join.left_keys[0].index)
        rname = raw_name(build_scan, join.right_keys[0].index)
        build_rows = self.catalog.get_row_count(build_scan.table_name)
        target = max(self.catalog.cache_threshold // 2, chunk_rows)
        k = getattr(self.config, "spill_partitions", None) \
            or choose_partitions(build_rows, target)
        bsch = self.catalog.get_schema(build_scan.table_name)
        bcols = ([f.name for f in bsch] if build_scan.projection is None
                 else [bsch.field(i).name for i in build_scan.projection])
        probe_paths = self.spill.partition_table(
            self.catalog, pipe.scan.table_name, lname, k, chunk_rows,
            self._probe_cols(pipe))
        build_paths = self.spill.partition_table(
            self.catalog, build_scan.table_name, rname, k, chunk_rows, bcols)

        for attempt in range(5):
            state = _init_state(agg.group_exprs, partials, max_groups)
            j_ovf = g_ovf = False
            n_parts = 0
            used_cap = join_capacity
            for pi in range(k):
                if not (os.path.exists(build_paths[pi])
                        and os.path.exists(probe_paths[pi])):
                    continue  # empty partition on either side: no matches
                from ..interop import arrow as arrow_io

                host = arrow_io.read_parquet(build_paths[pi])
                build = self._prepare_build(pipe, host_batch=host,
                                            pad_bucket=True)
                # per-partition match buffer from MEASURED key duplication
                # (2x headroom), power-of-2 bucketed so similar partitions
                # share one compiled step
                cap_pi = max(join_capacity, _dup_capacity(
                    chunk_rows, build.get("avg_dup", 1.0)))
                used_cap = max(used_cap, cap_pi)
                state, (jo, go) = self._stream_part(
                    pipe, build, chunk_rows, max_groups, cap_pi,
                    partials, state,
                    self._probe_chunks(pipe, chunk_rows,
                                       path=probe_paths[pi]))
                j_ovf = j_ovf or jo
                g_ovf = g_ovf or go
                n_parts += 1
            logger.info("partitioned join: %d/%d partition pairs joined",
                        n_parts, k)
            if not (j_ovf or g_ovf):
                state, = _fetch_prefix_states([state])
                return self._finalize(agg, state, max_groups, partials)
            if j_ovf:
                join_capacity = used_cap * 4
            if g_ovf:
                max_groups = min(max_groups * 4, 1 << 24)
            logger.warning("partitioned pass overflowed (join=%s groups=%s); "
                           "retrying with join_capacity=%d max_groups=%d",
                           j_ovf, g_ovf, join_capacity, max_groups)
        raise RuntimeError("partitioned join capacities kept overflowing")

    # ------------------------------------------------------------------
    # Hash-partitioned streamed group state (the 1B-row GROUP BY, reference
    # README.md:332-334): a group state above
    # ``stream_state_partition_groups`` slots is split across P hash
    # partitions of <= part_cap groups each, so each step sorts less.
    # Chunks are hash-split BY GROUP KEY on the host while staging; each
    # sub-chunk streams through the SAME compiled step (shared shapes)
    # against its partition's state.  Group keys are disjoint across
    # partitions, so finalized partitions simply concatenate — exact.
    # ------------------------------------------------------------------
    def _hash_state_keys(self, pipe) -> Optional[List[int]]:
        """Host chunk column positions of the group keys, or None when the
        pipeline shape does not support host-side key hashing: every group
        expr must be a plain ColumnRef into the scan schema and the scan ->
        aggregate middle must not reshape columns (filters are fine — they
        are row-local and run on device after the split)."""
        agg = pipe.aggregate
        if not agg.group_exprs:
            return None
        if any(isinstance(op, P.PhysProjection) for op in pipe.middle):
            return None
        pos = []
        for g in agg.group_exprs:
            if not isinstance(g, P.ColumnRef):
                return None
            if g.index >= len(pipe.scan.schema):
                return None
            pos.append(g.index)
        return pos

    def _execute_hash_state(self, pipe, chunk_rows, max_groups,
                            partials) -> ColumnBatch:
        agg = pipe.aggregate
        key_pos = self._hash_state_keys(pipe)
        for attempt in range(5):
            part_cap = self.config.stream_state_partition_groups >> 1
            n_parts = 1
            while (max_groups + n_parts - 1) // n_parts > (part_cap >> 1):
                n_parts <<= 1
            states = [_init_state(agg.group_exprs, partials, part_cap,
                                  self._key_narrow(pipe))
                      for _ in range(n_parts)]
            states, g_ovf = self._stream_hash_state(
                pipe, chunk_rows, part_cap, n_parts, partials, states,
                key_pos)
            if not g_ovf:
                self.last_hash_parts = n_parts
                states = _fetch_prefix_states(states)
                return _concat_batches(
                    [self._finalize(agg, st, part_cap, partials)
                     for st in states],
                    agg.schema)
            max_groups = min(max_groups * 4, 1 << 26)
            logger.warning("hash-state pass overflowed; retrying with "
                           "max_groups=%d", max_groups)
        raise RuntimeError("hash-state group capacities kept overflowing")

    def _stream_hash_state(self, pipe, chunk_rows, part_cap, n_parts,
                           partials, states, key_pos):
        from .spill import spill_hash

        import time as _time

        t_start = _time.perf_counter()
        step = self._get_step(pipe, chunk_rows, part_cap, partials, None, 0)
        narrow = self._narrow_flags(pipe)
        feeder = DeviceFeeder(num_buffers=self.config.num_feed_buffers)

        # compile (and report compile time) before any upload is in flight
        zero_chunk = [np.int64(0)]
        for f, (ok, _rng) in zip(pipe.scan.schema, narrow):
            dt = jnp.int32 if ok else f.dtype.numpy_dtype
            zero_chunk.append(jnp.zeros(chunk_rows, dt))
        logger.info("hash-state: compiling streamed step (chunk_rows=%d "
                    "part_cap=%d parts=%d) ...", chunk_rows, part_cap, n_parts)
        states[0], (_, wg) = step(states[0], (), *zero_chunk)
        jax.block_until_ready(wg)
        logger.info("hash-state: streamed step ready")
        t_compiled = _time.perf_counter()

        staged = collections.deque()    # (part, bufs) per in-flight sub-chunk
        schema = pipe.scan.schema

        def _col_dtype(i):
            ok, _rng = narrow[i]
            return np.int32 if ok else schema.field(i).dtype.numpy_dtype

        def host_iter():
            # per-partition accumulators: arena buffers filled row-by-row
            # from the hash split; a full accumulator flushes as one padded
            # sub-chunk (zero shape waste, one compiled step shape)
            ncols = len(schema)
            acc = [[self.arena.acquire(chunk_rows, _col_dtype(i))
                    for i in range(ncols)] for _ in range(n_parts)]
            fill = [0] * n_parts

            def flush(p):
                bufs = acc[p]
                n = fill[p]
                views = []
                for b in bufs:
                    v = b[:chunk_rows]
                    if n < chunk_rows:
                        v[n:] = 0
                    views.append(v)
                staged.append((p, bufs))
                acc[p] = [self.arena.acquire(chunk_rows, _col_dtype(i))
                          for i in range(ncols)]
                fill[p] = 0
                return (np.int64(n),) + tuple(views)

            for batch in _prefetch_iter(self._probe_chunks(pipe, chunk_rows)):
                # partition id per row from the raw group-key columns
                h = np.zeros(batch.num_rows, dtype=np.uint64)
                inval = None
                for kp in key_pos:
                    c = batch.columns[kp]
                    kv = np.asarray(c.data)
                    if kv.dtype.kind == "f":
                        kv = kv.astype(np.float64).view(np.int64)
                    h = h * np.uint64(0x100000001B3) ^ spill_hash(kv)
                    if c.validity is not None:
                        bad = ~np.asarray(c.validity)
                        inval = bad if inval is None else (inval | bad)
                pid = (h % np.uint64(n_parts)).astype(np.int64)
                if inval is not None:
                    pid[inval] = 0  # all-null key rows share one group
                for p in range(n_parts):
                    idx = np.flatnonzero(pid == p)
                    pos = 0
                    while pos < idx.size:
                        take = min(chunk_rows - fill[p], idx.size - pos)
                        sel = idx[pos:pos + take]
                        for i, c in enumerate(batch.columns):
                            a = np.asarray(c.data)
                            acc[p][i][fill[p]:fill[p] + take] = a[sel]
                        fill[p] += take
                        pos += take
                        if fill[p] == chunk_rows:
                            yield flush(p)
            for p in range(n_parts):
                if fill[p]:
                    yield flush(p)
                else:
                    for b in acc[p]:
                        self.arena.release(b)

        n_chunks = 0
        pending = collections.deque()  # (bufs, step-output marker)

        def drain(limit):
            while len(pending) > limit:
                bufs, marker = pending.popleft()
                jax.block_until_ready(marker)
                for buf in bufs:
                    self.arena.release(buf)

        ovfs = []
        for dev_chunk in feeder.feed(host_iter()):
            p, bufs = staged.popleft()
            states[p], (_, g_o) = step(states[p], (), *dev_chunk)
            # collect per-step flags and OR them in ONE program at the end
            # instead of one eager scalar program per chunk
            ovfs.append(g_o)
            n_chunks += 1
            pending.append((bufs, g_o))
            drain(self.config.num_feed_buffers)
            if n_chunks % 16 == 0:
                logger.info("hash-state streaming progress: %d sub-chunks",
                            n_chunks)
        drain(0)
        logger.info("hash-state streamed %d sub-chunks x %d rows over %d "
                    "partitions (arena: %s)", n_chunks, chunk_rows, n_parts,
                    self.arena.stats())
        self.last_stream_chunks = n_chunks
        self.last_link_bytes = n_chunks * sum(
            chunk_rows * np.dtype(_col_dtype(i)).itemsize
            for i in range(len(schema)))
        self.last_compile_seconds = round(t_compiled - t_start, 3)
        self.last_stream_seconds = round(_time.perf_counter() - t_compiled, 3)
        any_ovf = bool(np.asarray(jnp.any(jnp.stack(ovfs)))) if ovfs else False
        return states, any_ovf

    def _stream_part(self, pipe, build, chunk_rows, max_groups,
                     join_capacity, partials, state, chunks):
        """Stream one probe source into the (donated) group state.  The
        build side rides as jit ARGUMENTS so partition pairs with equal
        shapes share one compiled step."""
        step = self._get_step(pipe, chunk_rows, max_groups, partials,
                              build, join_capacity)
        build_args = () if build is None else (
            build["sk"], build["srow"], build["nbv"],
            tuple((c.data, c.validity) for c in build["batch"].cols))
        feeder = DeviceFeeder(num_buffers=self.config.num_feed_buffers)

        staged = collections.deque()  # arena buffers per in-flight chunk

        narrow = self._narrow_flags(pipe)

        # compile the step before any chunk upload is in flight, so compile
        # time stays out of the streaming window.  A zero-valid-rows chunk
        # is a no-op on the state.
        zero_chunk = [np.int64(0)]
        for f, (ok, _rng) in zip(pipe.scan.schema, narrow):
            dt = jnp.int32 if ok else f.dtype.numpy_dtype
            zero_chunk.append(jnp.zeros(chunk_rows, dt))
        state, (wj, wg) = step(state, build_args, *zero_chunk)
        jax.block_until_ready(wg)

        def host_iter():
            for batch in chunks:
                bufs, padded = _stage_batch_arrays(batch, chunk_rows,
                                                   self.arena, narrow)
                staged.append(bufs)
                yield padded

        n_chunks = 0
        pending = collections.deque()  # (bufs, step-output marker)

        def drain(limit):
            while len(pending) > limit:
                bufs, marker = pending.popleft()
                # a chunk's staging buffers are reusable only once the STEP
                # that consumed it finished: on the CPU backend device_put
                # ALIASES the host buffer (zero-copy), so releasing after the
                # transfer alone let later chunks overwrite queued inputs —
                # a data race that produced duplicated groups (round-4 find;
                # the marker is the step's tiny non-donated overflow output)
                jax.block_until_ready(marker)
                for buf in bufs:
                    self.arena.release(buf)

        jovfs, govfs = [], []
        for dev_chunk in feeder.feed(host_iter()):
            state, (j_o, g_o) = step(state, build_args, *dev_chunk)
            # flags collected and OR'd in ONE program after the stream
            jovfs.append(j_o)
            govfs.append(g_o)
            n_chunks += 1
            pending.append((staged.popleft(), g_o))
            drain(self.config.num_feed_buffers)
            if n_chunks % 16 == 0:
                logger.info("streaming progress: %d chunks", n_chunks)
        drain(0)
        logger.info("streamed %d chunks of %d rows (arena: %s)",
                    n_chunks, chunk_rows, self.arena.stats())
        if not n_chunks:
            return state, (False, False)
        flags = np.asarray(jnp.stack([jnp.any(jnp.stack(jovfs)),
                                      jnp.any(jnp.stack(govfs))]))
        return state, (bool(flags[0]), bool(flags[1]))

    # ------------------------------------------------------------------
    def _prepare_build(self, pipe: _StreamablePipeline, host_batch=None,
                       pad_bucket: bool = False):
        """Build side onto the device: filtered/projected, keyed, sorted
        (eager jnp ops — the build side is resident).  ``host_batch``: an
        already-projected batch (a spill partition).  ``pad_bucket``: pad
        rows to a power-of-two bucket so every partition pair shares the
        same compiled step."""
        from .device import DevBatch, DevCol, _np_kind
        from ..ops import join as join_ops

        interp = self._interpreter_cls(self.config, {}, {}, {
            "flag_names": [], "capacities": {}})
        build_middle, build_scan = _strip_middle(pipe.build_plan)
        if host_batch is not None:
            host = host_batch.to_numpy()
            indices = range(len(host.columns))
        else:
            host = self.catalog.get_table_data(build_scan.table_name).to_numpy()
            indices = (build_scan.projection
                       if build_scan.projection is not None
                       else range(len(host.columns)))
        n = host.num_rows
        cap = n
        if pad_bucket:
            cap = max(1024, 1 << (max(n - 1, 1)).bit_length())
        cols = []
        for i in indices:
            c = host.columns[i]
            data = np.asarray(c.data)
            validity = c.validity
            if cap > n:
                data = np.concatenate(
                    [data, np.zeros(cap - n, dtype=data.dtype)])
                if validity is not None:
                    validity = np.concatenate(
                        [validity, np.zeros(cap - n, dtype=bool)])
            v = None if validity is None else jnp.asarray(validity)
            cols.append(DevCol(jnp.asarray(data), v, c.dictionary))
        row_valid = (jnp.arange(cap) < n) if cap > n else None
        batch = DevBatch(build_scan.schema, cols, cap, row_valid)
        for op in build_middle:
            batch = _apply_one(interp, op, batch)
        key_expr = pipe.join.right_keys[0]
        d, v, _ = interp.eval_expr(key_expr, batch)
        code, null = key_code(d, v, _np_kind(key_expr.dtype))
        inv = null if batch.row_valid is None else (null | ~batch.row_valid)
        sk, srow, nbv = join_ops.build_sorted(code, inv)
        # measured key duplication (host-side, pre-middle-ops: an upper
        # bound) sizes the callers' per-chunk match buffers up front.
        # Only measurable when the build middle does not RESHAPE columns
        # (ADVICE r4 #2: a projection reorders the layout, and key_expr
        # indexes the post-middle batch — the raw host column at that
        # position would be the wrong one); filters only shrink duplication,
        # so the unfiltered measurement stays an upper bound.
        avg_dup = 1.0
        idxs = list(indices)
        if any(isinstance(op, P.PhysProjection) for op in build_middle):
            idxs = []
        if isinstance(key_expr, P.ColumnRef) and key_expr.index < len(idxs) \
                and n > 0:
            key_host = np.asarray(host.columns[idxs[key_expr.index]].data)[:n]
            avg_dup = n / max(len(np.unique(key_host)), 1)
        return {"batch": batch, "sk": sk, "srow": srow, "nbv": nbv,
                "avg_dup": avg_dup}

    # ------------------------------------------------------------------
    def _get_step(self, pipe: _StreamablePipeline, chunk_rows: int,
                  max_groups: int, partials, build=None,
                  join_capacity: int = 0):
        """Memoized jitted step: keyed on plan identity + all shape-relevant
        parameters + build signature, so spill partition pairs (same bucket)
        and repeated queries reuse one compile."""
        if build is None:
            bsig = None
            dicts = ()
        else:
            bsig = (build["sk"].shape, str(build["sk"].dtype),
                    tuple((c.data.shape, str(c.data.dtype),
                           c.validity is not None)
                          for c in build["batch"].cols),
                    build["batch"].row_valid is not None)
            dicts = tuple(id(c.dictionary) if c.dictionary is not None
                          else None for c in build["batch"].cols)
        key = (id(pipe.aggregate), chunk_rows, max_groups, join_capacity,
               bsig, dicts, self._narrow_flags(pipe))
        hit = self._steps.get(key)
        if hit is not None:
            return hit[1]
        step = self._make_step(pipe, chunk_rows, max_groups, partials,
                               build, join_capacity)
        # pin pipe (id stability) and build dictionaries alongside the step
        self._steps[key] = (pipe, step)
        return step

    def _narrow_flags(self, pipe) -> tuple:
        """Per-probe-column (narrow_to_int32, (lo, hi)|None): parquet-metadata
        zone maps let int64 chunks stage and upload as int32 — HALF the bytes
        through the host->device link, and the streamed step's sorts stay in
        int32 space (no int64 operands)."""
        stats = self.catalog.get_stats(pipe.scan.table_name) or {}
        lo32 = np.iinfo(np.int32).min + 4
        hi32 = np.iinfo(np.int32).max - 4
        out = []
        for f, nm in zip(pipe.scan.schema, self._probe_cols(pipe)):
            st = stats.get(nm)
            ok = bool(st is not None
                      and f.dtype.numpy_dtype == np.dtype(np.int64)
                      and lo32 < int(st[0]) and int(st[1]) < hi32)
            out.append((ok, tuple(int(x) for x in st) if st else None))
        return tuple(out)

    def _make_step(self, pipe: _StreamablePipeline, chunk_rows: int,
                   max_groups: int, partials, build=None,
                   join_capacity: int = 0):
        interp = self._interpreter_cls(self.config, {}, {}, {
            "flag_names": [], "capacities": {}})
        scan_schema = pipe.scan.schema
        table_schema = self.catalog.get_schema(pipe.scan.table_name)
        # dictionaries for string columns are built per-chunk, so string
        # group keys / payloads are unsupported while streaming
        for f in (table_schema if pipe.scan.projection is None else
                  (table_schema.field(i) for i in pipe.scan.projection)):
            if f.dtype is DType.STRING:
                raise NotStreamable("string group keys/payloads while streaming")

        from .device import DevBatch, DevCol, _np_kind
        from ..ops import join as join_ops

        agg = pipe.aggregate
        join = pipe.join
        # static (trace-constant) build metadata: schema + dictionaries
        build_dicts = (tuple(c.dictionary for c in build["batch"].cols)
                       if build is not None else ())
        build_schema = build["batch"].schema if build is not None else None
        sk_dtype = build["sk"].dtype if build is not None else None

        narrow = self._narrow_flags(pipe)
        key_narrow = self._key_narrow(pipe)

        def step(state, build_args, valid_rows, *arrays):
            cols = [DevCol(a, None, None, int32_ok=ok, value_range=rng)
                    for a, (ok, rng) in zip(arrays, narrow)]
            row_valid = jnp.arange(chunk_rows) < valid_rows
            batch = DevBatch(scan_schema, cols, chunk_rows, row_valid)
            for op in pipe.middle:
                batch = _apply_one(interp, op, batch)
            join_overflow = jnp.asarray(False)
            group_overflow = jnp.asarray(False)

            if join is not None:
                b_sk, b_srow, b_nbv, b_cols = build_args
                bbatch_cols = [DevCol(d, v, dct) for (d, v), dct
                               in zip(b_cols, build_dicts)]
                # probe this chunk against the resident sorted build side
                key_expr = join.left_keys[0]
                d, v, _ = interp.eval_expr(key_expr, batch)
                pcode, pnull = key_code(d, v, _np_kind(key_expr.dtype))
                pinv = pnull if batch.row_valid is None else \
                    (pnull | ~batch.row_valid)
                pcode = pcode.astype(sk_dtype)
                lo, cnt = join_ops.probe_counts(
                    b_sk, b_nbv, pcode, pinv)
                li, ri, out_valid, total, j_overflow = join_ops.expand_matches(
                    cnt, lo, b_srow, join_capacity)
                join_overflow = join_overflow | j_overflow
                from .device import _gather_col

                jcols = [
                    _gather_col(c, li, out_valid) for c in batch.cols
                ] + [
                    _gather_col(c, ri, out_valid) for c in bbatch_cols
                ]
                batch = DevBatch(join.schema, jcols, join_capacity, out_valid)
                if join.residual is not None:
                    data, valid, _ = interp.eval_expr(join.residual, batch)
                    mask = filter_ops.combine_mask(batch.row_valid, data, valid)
                    batch = DevBatch(join.schema, batch.cols, batch.capacity, mask)
                for op in pipe.agg_middle:
                    batch = _apply_one(interp, op, batch)

            rows = batch.capacity
            # chunk keys/values + state keys/values -> one grouped pass
            chunk_keys = []
            for ki, g in enumerate(agg.group_exprs):
                d, v, _ = interp.eval_expr(g, batch)
                if key_narrow is not None and key_narrow[ki]:
                    # int32 upload dtype IS the key code: the merged sort
                    # stays out of int64 space
                    null = (jnp.zeros(d.shape, bool) if v is None else ~v)
                    chunk_keys.append((d, null))
                else:
                    chunk_keys.append(key_code(d, v, _np_kind(g.dtype)))

            state_keys, state_partials, state_valid = state
            keys = [
                (jnp.concatenate([ck, sk]), jnp.concatenate([cn, sn]))
                for (ck, cn), (sk, sn) in zip(chunk_keys, state_keys)
            ] if chunk_keys else []
            all_valid = jnp.concatenate([
                batch.row_valid if batch.row_valid is not None
                else jnp.ones(rows, bool),
                state_valid,
            ])

            specs = []
            for spec_group, a in zip(partials, agg.aggs):
                if a.arg is not None:
                    data, valid, _ = interp.eval_expr(a.arg, batch)
                else:
                    data, valid = None, None
                for pname, pfunc, pdtype in spec_group:
                    if pfunc == "count":
                        cv = jnp.where(
                            (jnp.ones(rows, bool) if valid is None else valid)
                            if data is not None else jnp.ones(rows, bool),
                            1, 0).astype(pdtype)
                        cvalid = None
                    else:
                        cv = data.astype(pdtype)
                        cvalid = valid
                    sp_idx = len(specs)
                    sv = state_partials[sp_idx]
                    merged_vals = jnp.concatenate([cv, sv])
                    merged_valid = None
                    if cvalid is not None:
                        merged_valid = jnp.concatenate([
                            cvalid, jnp.ones(sv.shape[0], bool)])
                    specs.append({
                        "func": "sum" if pfunc == "count" else pfunc,
                        "values": merged_vals, "valid": merged_valid,
                        "distinct": False, "acc_dtype": pdtype,
                    })

            group_codes, results, n_groups, g_overflow = agg_ops.groupby_aggregate(
                keys, all_valid, specs, max_groups,
                n_rows=rows + max_groups,
            )
            if keys:
                group_overflow = group_overflow | g_overflow
            new_keys = group_codes
            new_partials = [r[0] for r in results]
            new_valid = (jnp.arange(max_groups) < n_groups) if keys else \
                jnp.ones(1, bool)
            if not keys:
                new_keys = []
            return (new_keys, new_partials, new_valid), (join_overflow,
                                                         group_overflow)

        # the group state is updated in place: its buffers are donated
        return jax.jit(step, donate_argnums=(0,))

    # ------------------------------------------------------------------
    def _finalize(self, agg: P.PhysAggregate, state, max_groups: int,
                  partials=None) -> ColumnBatch:
        state_keys, state_partials, state_valid = state
        valid = np.asarray(state_valid)
        if not agg.group_exprs and not valid.any():
            # zero chunks streamed: global aggregate still yields one row
            valid = np.ones_like(valid)
        idx = np.nonzero(valid)[0]

        # valid groups form a PREFIX of the state (groupby_aggregate output
        # ordering) — slice before download so only n_groups rows per lane
        # move over the link, not part_cap (the full-state download cost
        # minutes at the 1B shape); works on device lanes and on host lanes
        # already pulled by _fetch_prefix_states
        if idx.size and idx[-1] == idx.size - 1:
            n = int(idx.size)
            state_keys = [(c[:n], u[:n]) for c, u in state_keys]
            state_partials = [p[:n] for p in state_partials]
            idx = np.arange(n)

        cols: List[Column] = []
        for (code, null), g in zip(state_keys, agg.group_exprs):
            data = np.asarray(code)[idx]
            null_h = np.asarray(null)[idx]
            if g.dtype is DType.BOOL:
                data = data.astype(bool)
            if data.dtype == np.int32 and \
                    g.dtype.numpy_dtype == np.dtype(np.int64):
                data = data.astype(np.int64)  # narrowed key lane widens here
            cols.append(Column(data, ~null_h if null_h.any() else None))

        if partials is None:
            partials = _partial_layout(agg)
        p_i = 0
        for spec_group, a in zip(partials, agg.aggs):
            vals = {}
            for pname, pfunc, pdtype in spec_group:
                vals[pname] = np.asarray(state_partials[p_i])[idx]
                p_i += 1
            cols.append(_finalize_agg(a, vals))
        return ColumnBatch(agg.schema, cols, len(idx))


def _fetch_prefix_states(states):
    """Pull all partitions' state lanes to the host with chunked-async
    pipelining, then slice to the valid prefixes in numpy.

    FULL lanes are fetched on purpose: a device-side slice is one eager
    program per lane and partition, while the whole part_cap-sized lanes
    cost only a few extra bytes each."""
    from ..utils.hostio import fetch_arrays

    valids = fetch_arrays([st[2] for st in states])
    ns = []
    fetch = []
    for st, v in zip(states, valids):
        v = np.asarray(v)
        idx = np.nonzero(v)[0]
        n = int(idx.size)
        if not st[0]:
            n = v.shape[0]  # global aggregate: keep the 1-row state whole
        elif not (n == 0 or idx[-1] == n - 1):
            return states  # non-prefix mask: let _finalize do it lane-wise
        ns.append(n)
        for c, u in st[0]:
            fetch.append(c)
            fetch.append(u)
        for p in st[1]:
            fetch.append(p)
    fetched = iter(fetch_arrays(fetch))
    out = []
    for st, v, n in zip(states, valids, ns):
        keys = [(next(fetched)[:n], next(fetched)[:n]) for _ in st[0]]
        parts_ = [next(fetched)[:n] for _ in st[1]]
        valid = np.asarray(v)[:n] if not st[0] else np.ones(n, dtype=bool)
        out.append((keys, parts_, valid))
    return out


def _concat_batches(batches: List[ColumnBatch], schema) -> ColumnBatch:
    """Concatenate finalized per-partition group results (disjoint keys)."""
    if len(batches) == 1:
        return batches[0]
    ncols = len(schema)
    cols = []
    for i in range(ncols):
        data = np.concatenate([np.asarray(b.columns[i].data) for b in batches])
        if any(b.columns[i].validity is not None for b in batches):
            validity = np.concatenate([
                np.asarray(b.columns[i].validity)
                if b.columns[i].validity is not None
                else np.ones(b.num_rows, dtype=bool)
                for b in batches])
        else:
            validity = None
        cols.append(Column(data, validity))
    return ColumnBatch(schema, cols, sum(b.num_rows for b in batches))


def _apply_one(interp, op, batch):
    """Apply one Filter/Projection physical operator to a DevBatch."""
    from .device import DevBatch, DevCol

    if isinstance(op, P.PhysFilter):
        data, valid, _ = interp.eval_expr(op.predicate, batch)
        mask = filter_ops.combine_mask(batch.row_valid, data, valid)
        return DevBatch(op.schema, batch.cols, batch.capacity, mask)
    ncols = []
    for e in op.exprs:
        d, v, dd = interp.eval_expr(e, batch)
        ncols.append(DevCol(d, v, dd))
    return DevBatch(op.schema, ncols, batch.capacity, batch.row_valid)


def _dup_capacity(chunk_rows: int, avg_dup: float) -> int:
    """Per-chunk join match-buffer size from measured build-side key
    duplication, with 2x headroom over the average (duplication varies by
    chunk), power-of-2 bucketed so partitions share compiled steps."""
    est = int(chunk_rows * max(2.0 * avg_dup, 1.25)) + 1024
    return 1 << (est - 1).bit_length()


def _partial_layout(agg: P.PhysAggregate, ranges=None, total_rows=None):
    """Per output aggregate, the mergeable partial columns it needs.

    ``ranges``: optional per-scan-column (lo, hi) zone-map bounds (narrow
    flags) and ``total_rows`` the table row count — when provided, partial
    dtypes narrow out of int64 space (narrower sort/cumsum lanes move fewer
    bytes):
      * COUNT partials are float64 always (exact to 2^53 rows);
      * int SUM partials go float64 when total_rows * max|v| < 2^52
        (provably exact — same rule as the in-memory sum_f64_ok path);
      * int MIN/MAX partials go int32 when the argument's bound fits."""
    def arg_range(a):
        if ranges is None or not isinstance(a.arg, P.ColumnRef):
            return None
        return ranges.get(a.arg.index)

    i32max = (1 << 31) - 8
    out = []
    for a in agg.aggs:
        cnt_dt = np.float64 if ranges is not None else np.int64
        if a.func == "count":
            out.append([("count", "count", cnt_dt)])
        elif a.func == "avg":
            out.append([("sum", "sum", np.float64), ("count", "count", cnt_dt)])
        elif a.func == "sum":
            sum_dt = a.out_dtype.numpy_dtype
            r = arg_range(a)
            if (np.dtype(sum_dt) == np.dtype(np.int64) and r is not None
                    and total_rows is not None
                    and total_rows * max(abs(int(r[0])),
                                         abs(int(r[1]))) < (1 << 52)):
                sum_dt = np.float64
            lanes = [("sum", "sum", sum_dt)]
            if not _nullfree_arg(a, ranges):
                lanes.append(("count", "count", cnt_dt))
            out.append(lanes)
        elif a.func in ("min", "max"):
            mm_dt = a.out_dtype.numpy_dtype
            r = arg_range(a)
            if (np.dtype(mm_dt) == np.dtype(np.int64) and r is not None
                    and -i32max < int(r[0]) and int(r[1]) < i32max):
                mm_dt = np.int32
            lanes = [(a.func, a.func, mm_dt)]
            if not _nullfree_arg(a, ranges):
                lanes.append(("count", "count", cnt_dt))
            out.append(lanes)
        else:
            raise NotStreamable(a.func)
    return out


def _nullfree_arg(a, ranges) -> bool:
    """SUM/MIN/MAX over a PLAIN scan column in a streamed scan-only pipeline
    (``ranges is not None``) needs no count lane: staged chunk columns carry
    no validity, so every group has >= 1 value (per-group 'has' is
    statically true) — at the 1B shape the three duplicate count lanes were
    a third of the finalize download."""
    return ranges is not None and isinstance(a.arg, P.ColumnRef)


def _finalize_agg(a: P.AggSpec, vals) -> Column:
    """Partials may be carried in narrowed dtypes (f64 counts/sums proven
    exact, int32 min/max) — cast back to the logical output dtype here."""
    out_np = a.out_dtype.numpy_dtype
    if a.func == "count":
        return Column(vals["count"].astype(np.int64))
    cnt = vals.get("count")
    if cnt is None:
        # null-free plain-column argument: every group has a value
        data = vals["sum" if a.func == "sum" else a.func]
        if data.dtype != out_np:
            data = data.astype(out_np)
        return Column(data)
    has = cnt > 0
    if a.func == "avg":
        with np.errstate(invalid="ignore", divide="ignore"):
            avg = vals["sum"] / np.maximum(cnt, 1)
        return Column(np.where(has, avg, 0.0), None if has.all() else has)
    key = "sum" if a.func == "sum" else a.func
    data = vals[key]
    if data.dtype != out_np:
        data = data.astype(out_np)
    return Column(data, None if has.all() else has)


def _init_state(group_exprs, partials, max_groups: int, key_narrow=None):
    """``key_narrow``: per-group-expr flag — int32 key-code state lanes for
    zone-map-narrowed integer keys keep the streamed step's merged sort out
    of int64 space."""
    if group_exprs:
        keys = []
        for i, g in enumerate(group_exprs):
            if g.dtype is DType.FLOAT64:
                keys.append((jnp.full(max_groups, -jnp.inf, dtype=jnp.float64),
                             jnp.zeros(max_groups, dtype=bool)))
            elif key_narrow is not None and key_narrow[i]:
                keys.append((jnp.full(max_groups, np.iinfo(np.int32).min,
                                      dtype=jnp.int32),
                             jnp.zeros(max_groups, dtype=bool)))
            else:
                keys.append((jnp.full(max_groups, INT64_MIN, dtype=jnp.int64),
                             jnp.zeros(max_groups, dtype=bool)))
        rows = max_groups
        valid = jnp.zeros(max_groups, dtype=bool)
    else:
        keys = []
        rows = 1  # global aggregate: single-row mergeable state
        valid = jnp.zeros(1, dtype=bool)
    state_partials = []
    for spec_group in partials:
        for pname, pfunc, pdtype in spec_group:
            if pfunc == "min":
                fill = (np.inf if np.dtype(pdtype).kind == "f"
                        else np.iinfo(np.dtype(pdtype)).max)
            elif pfunc == "max":
                fill = (-np.inf if np.dtype(pdtype).kind == "f"
                        else np.iinfo(np.dtype(pdtype)).min)
            else:
                fill = 0
            state_partials.append(jnp.full(rows, fill, dtype=pdtype))
    return (keys, state_partials, valid)


def _stage_batch_arrays(batch: ColumnBatch, chunk_rows: int,
                        arena: BufferArena, narrow=None):
    """Host batch -> (arena_buffers, (valid_rows, *staged arrays)).

    Each column is copied into a pooled arena buffer padded to ``chunk_rows``
    (``device_put`` always copies host numpy data, so the buffer is free for
    reuse once the transfer completes — the caller releases after
    ``block_until_ready``).  ``narrow``: per-column (to_int32, range) from
    parquet-metadata zone maps — int64 columns stage as int32, halving the
    bytes over the host->device link."""
    n = batch.num_rows
    out = [np.int64(n)]
    bufs = []
    for i, c in enumerate(batch.columns):
        a = np.asarray(c.data)
        if narrow is not None and narrow[i][0] and a.dtype == np.int64:
            a = a.astype(np.int32)
        if a.shape[0] > chunk_rows:
            raise ValueError("chunk larger than batch_size")
        buf = arena.acquire(chunk_rows, a.dtype)
        view = buf[:chunk_rows]
        view[:n] = a
        if n < chunk_rows:
            view[n:] = 0
        bufs.append(buf)
        out.append(view)
    return bufs, tuple(out)
