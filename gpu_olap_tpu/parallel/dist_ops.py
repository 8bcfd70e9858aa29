"""Distributed operators: shuffle join and shuffle group-by over the mesh.

BASELINE north star: "tables hash-partitioned across devices, distributed
shuffle of join/group-by keys, exchange overlapped with probe/aggregate
compute".  Each operator is one ``shard_map`` program: shuffle (all-to-all over
the device interconnect, NVLink on H100 hosts) immediately followed by the local sort-based kernel — XLA overlaps the
collective with the local sort/probe pipeline.
"""

from __future__ import annotations

import functools
from typing import Sequence

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from jax import shard_map  # noqa: E402

from ..ops import aggregate as agg_ops  # noqa: E402
from ..ops import join as join_ops  # noqa: E402
from .mesh import AXIS  # noqa: E402
from .shuffle import shuffle_rows_local  # noqa: E402


def make_dist_groupby(mesh, agg_specs: Sequence[dict], capacity: int,
                      max_groups: int):
    """Distributed GROUP BY: shuffle rows by key hash, then local sort-based
    aggregation.  Every key lands on exactly one device, so local results are
    exact and globally disjoint.

    ``agg_specs``: [{func, acc_dtype}] — one value column per spec.
    Returns jitted fn(keys, row_valid, *value_cols) ->
    (group_keys, [agg_results...], group_valid, n_groups_per_dev)."""
    ndev = mesh.devices.size
    nvals = len(agg_specs)

    in_specs = (P(AXIS), P(AXIS)) + (P(AXIS),) * nvals
    out_specs = (P(AXIS), tuple(P(AXIS) for _ in agg_specs), P(AXIS), P(AXIS))

    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    def _dist_groupby(keys, row_valid, *value_cols):
        rkeys, rvals, rvalid, _ = shuffle_rows_local(
            keys, list(value_cols), row_valid, ndev, capacity
        )
        specs = []
        for spec, vals in zip(agg_specs, rvals):
            specs.append({
                "func": spec["func"], "values": vals, "valid": None,
                "distinct": False, "acc_dtype": spec["acc_dtype"],
            })
        group_codes, results, n_groups, _ = agg_ops.groupby_aggregate(
            [(rkeys, jnp.zeros_like(rvalid))], rvalid, specs, max_groups,
            n_rows=rkeys.shape[0],
        )
        gkeys = group_codes[0][0]
        gvalid = jnp.arange(max_groups) < n_groups
        return (gkeys, tuple(r[0] for r in results), gvalid,
                n_groups.reshape(1))

    return jax.jit(_dist_groupby)


def make_dist_join(mesh, capacity: int, join_capacity: int,
                   n_left_payloads: int, n_right_payloads: int):
    """Distributed inner equi-join: both sides shuffled by key hash, then the
    local sort-probe join per device (co-partitioned keys match locally).

    Returns jitted fn(lkeys, lvalid, rkeys, rvalid, *left_payloads,
    *right_payloads) -> (out_lkey, [left payloads], [right payloads],
    out_valid, match_count_per_dev)."""
    ndev = mesh.devices.size

    in_specs = (P(AXIS),) * (4 + n_left_payloads + n_right_payloads)
    out_specs = (P(AXIS),
                 tuple(P(AXIS) for _ in range(n_left_payloads)),
                 tuple(P(AXIS) for _ in range(n_right_payloads)),
                 P(AXIS), P(AXIS))

    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    def _dist_join(lkeys, lvalid, rkeys, rvalid, *payloads):
        lpay = list(payloads[:n_left_payloads])
        rpay = list(payloads[n_left_payloads:])
        slk, slp, slv, _ = shuffle_rows_local(lkeys, lpay, lvalid, ndev, capacity)
        srk, srp, srv, _ = shuffle_rows_local(rkeys, rpay, rvalid, ndev, capacity)
        li, ri, out_valid, total, overflow, _cnt = join_ops.inner_join(
            [(slk, jnp.zeros_like(slv))], slv,
            [(srk, jnp.zeros_like(srv))], srv,
            join_capacity,
        )
        safe_l = jnp.clip(li, 0, slk.shape[0] - 1)
        safe_r = jnp.clip(ri, 0, srk.shape[0] - 1)
        out_key = slk[safe_l]
        out_lpay = tuple(p[safe_l] for p in slp)
        out_rpay = tuple(p[safe_r] for p in srp)
        return out_key, out_lpay, out_rpay, out_valid, total.reshape(1)

    return jax.jit(_dist_join)


def make_dist_join_groupby_skew(mesh, capacity: int, join_capacity: int,
                                max_groups: int, agg_funcs: Sequence[str],
                                heavy_keys, heavy_build_cap: int):
    """Skew-aware variant of the fused join+group-by step (BASELINE config 5,
    Zipfian keys): rows carrying *heavy* keys (host-side detection,
    ``skew.detect_heavy_keys``) bypass the hash shuffle — their build rows are
    replicated to every device with ``all_gather`` (the reference's broadcast
    join escape hatch, ``join_kernel.rs:62-77``) and their probe rows join
    locally, so no single device receives the hot key's full probe mass.
    Light keys take the normal hash-partition shuffle."""
    ndev = mesh.devices.size
    import numpy as np

    from .skew import split_by_heavy

    heavy_keys = np.asarray(heavy_keys, dtype=np.int64)

    in_specs = (P(AXIS),) * 6
    out_specs = (P(AXIS), tuple(P(AXIS) for _ in agg_funcs), P(AXIS), P())

    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    def _step(lkeys, lvalid, lval, rkeys, rvalid, rval):
        lheavy = split_by_heavy(lkeys, heavy_keys)
        rheavy = split_by_heavy(rkeys, heavy_keys)

        # --- light side: hash shuffle + local join --------------------
        slk, (slval,), slv, of_l = shuffle_rows_local(
            lkeys, [lval], lvalid & ~lheavy, ndev, capacity)
        srk, (srval,), srv, of_r = shuffle_rows_local(
            rkeys, [rval], rvalid & ~rheavy, ndev, capacity)
        li, ri, lo_valid, _t1, of_j1, _c1 = join_ops.inner_join(
            [(slk, jnp.zeros_like(slv))], slv,
            [(srk, jnp.zeros_like(srv))], srv,
            join_capacity,
        )
        safe_l = jnp.clip(li, 0, slk.shape[0] - 1)
        safe_r = jnp.clip(ri, 0, srk.shape[0] - 1)
        light_key = slk[safe_l]
        light_val = slval[safe_l] * srval[safe_r]

        # --- heavy side: broadcast build rows, probe locally ----------
        from ..ops.filter import compaction_indices

        hb_mask = rvalid & rheavy
        gidx, hb_count = compaction_indices(hb_mask)
        slots = jnp.arange(heavy_build_cap)
        src = gidx[jnp.clip(slots, 0, gidx.shape[0] - 1)]
        hb_keys_local = rkeys[src]
        hb_vals_local = rval[src]
        hb_valid_local = slots < jnp.minimum(
            hb_count, jnp.minimum(heavy_build_cap, gidx.shape[0]))
        hb_keys = jax.lax.all_gather(hb_keys_local, AXIS).reshape(-1)
        hb_vals = jax.lax.all_gather(hb_vals_local, AXIS).reshape(-1)
        hb_valid = jax.lax.all_gather(hb_valid_local, AXIS).reshape(-1)

        hp_valid = lvalid & lheavy
        hi_, ri2, h_valid, _t2, of_j2, _c2 = join_ops.inner_join(
            [(lkeys, jnp.zeros_like(lvalid))], hp_valid,
            [(hb_keys, jnp.zeros_like(hb_valid))], hb_valid,
            join_capacity,
        )
        safe_hl = jnp.clip(hi_, 0, lkeys.shape[0] - 1)
        safe_hr = jnp.clip(ri2, 0, hb_keys.shape[0] - 1)
        heavy_key = lkeys[safe_hl]
        heavy_val = lval[safe_hl] * hb_vals[safe_hr]

        # --- combine + local group-by ---------------------------------
        jkey = jnp.concatenate([light_key, heavy_key])
        jval = jnp.concatenate([light_val, heavy_val])
        jvalid = jnp.concatenate([lo_valid, h_valid])
        specs = [{"func": f, "values": jval, "valid": None, "distinct": False,
                  "acc_dtype": jnp.int64 if f == "count" else jval.dtype}
                 for f in agg_funcs]
        group_codes, results, n_groups, of_g = agg_ops.groupby_aggregate(
            [(jkey, jnp.zeros_like(jvalid))], jvalid, specs, max_groups,
            n_rows=jkey.shape[0],
        )
        gvalid = jnp.arange(max_groups) < n_groups
        # any-device capacity overflow, replicated: callers MUST check it —
        # an overflowed shuffle/join silently drops rows (ADVICE r2)
        of = (of_l | of_r | of_j1 | of_j2 | of_g).astype(jnp.int32)
        overflow = jax.lax.pmax(of, AXIS) > 0
        return group_codes[0][0], tuple(r[0] for r in results), gvalid, overflow

    return jax.jit(_step)


def make_dist_join_groupby(mesh, capacity: int, join_capacity: int,
                           max_groups: int, agg_funcs: Sequence[str]):
    """The fused flagship step: distributed shuffle join feeding a group-by —
    BASELINE config 5's compute shape (join + aggregate over shuffled data),
    one shard_map program so XLA overlaps all-to-all with local compute.

    fn(lkeys, lvalid, lval, rkeys, rvalid, rval) ->
    (gkeys, [aggs...], gvalid, overflow) — grouped by join key.  ``overflow``
    is a replicated bool: True when ANY device overflowed a shuffle bucket,
    the join match buffer, or the group table — results are then incomplete
    and the caller must retry with a larger capacity (or fail)."""
    ndev = mesh.devices.size

    in_specs = (P(AXIS),) * 6
    out_specs = (P(AXIS), tuple(P(AXIS) for _ in agg_funcs), P(AXIS), P())

    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    def _step(lkeys, lvalid, lval, rkeys, rvalid, rval):
        slk, (slval,), slv, of_l = shuffle_rows_local(lkeys, [lval], lvalid, ndev, capacity)
        srk, (srval,), srv, of_r = shuffle_rows_local(rkeys, [rval], rvalid, ndev, capacity)
        li, ri, out_valid, total, of_j, _cnt = join_ops.inner_join(
            [(slk, jnp.zeros_like(slv))], slv,
            [(srk, jnp.zeros_like(srv))], srv,
            join_capacity,
        )
        safe_l = jnp.clip(li, 0, slk.shape[0] - 1)
        safe_r = jnp.clip(ri, 0, srk.shape[0] - 1)
        jkey = slk[safe_l]
        jval = slval[safe_l] * srval[safe_r]  # joined measure
        specs = [{"func": f, "values": jval, "valid": None, "distinct": False,
                  "acc_dtype": jnp.int64 if f == "count" else jval.dtype}
                 for f in agg_funcs]
        group_codes, results, n_groups, of_g = agg_ops.groupby_aggregate(
            [(jkey, jnp.zeros_like(out_valid))], out_valid, specs, max_groups,
            n_rows=jkey.shape[0],
        )
        gvalid = jnp.arange(max_groups) < n_groups
        of = (of_l | of_r | of_j | of_g).astype(jnp.int32)
        overflow = jax.lax.pmax(of, AXIS) > 0
        return group_codes[0][0], tuple(r[0] for r in results), gvalid, overflow

    return jax.jit(_step)


def make_dist_join_groupby_stages(mesh, capacity: int, join_capacity: int,
                                  max_groups: int, agg_funcs: Sequence[str]):
    """The flagship step split into two separately-jitted programs so the
    scaling harness can time the SHUFFLE (all-to-all exchange) apart from the
    LOCAL join+aggregate compute (VERDICT r3 #6: per-stage breakdown).  The
    fused `make_dist_join_groupby` stays the production path (XLA overlaps
    the collective with local compute there); these exist to attribute time.

    Returns (shuffle_fn, local_fn):
      shuffle_fn(lkeys, lvalid, lval, rkeys, rvalid, rval)
          -> (slk, slval, slv, srk, srval, srv, overflow)
      local_fn(slk, slval, slv, srk, srval, srv)
          -> (gkeys, [aggs...], gvalid, overflow)
    """
    ndev = mesh.devices.size

    shuf_in = (P(AXIS),) * 6
    shuf_out = (P(AXIS),) * 6 + (P(),)

    @functools.partial(shard_map, mesh=mesh, in_specs=shuf_in,
                       out_specs=shuf_out, check_vma=False)
    def _shuffle(lkeys, lvalid, lval, rkeys, rvalid, rval):
        slk, (slval,), slv, of_l = shuffle_rows_local(
            lkeys, [lval], lvalid, ndev, capacity)
        srk, (srval,), srv, of_r = shuffle_rows_local(
            rkeys, [rval], rvalid, ndev, capacity)
        of = (of_l | of_r).astype(jnp.int32)
        overflow = jax.lax.pmax(of, AXIS) > 0
        return slk, slval, slv, srk, srval, srv, overflow

    loc_in = (P(AXIS),) * 6
    loc_out = (P(AXIS), tuple(P(AXIS) for _ in agg_funcs), P(AXIS), P())

    @functools.partial(shard_map, mesh=mesh, in_specs=loc_in,
                       out_specs=loc_out, check_vma=False)
    def _local(slk, slval, slv, srk, srval, srv):
        li, ri, out_valid, total, of_j, _cnt = join_ops.inner_join(
            [(slk, jnp.zeros_like(slv))], slv,
            [(srk, jnp.zeros_like(srv))], srv,
            join_capacity,
        )
        safe_l = jnp.clip(li, 0, slk.shape[0] - 1)
        safe_r = jnp.clip(ri, 0, srk.shape[0] - 1)
        jkey = slk[safe_l]
        jval = slval[safe_l] * srval[safe_r]
        specs = [{"func": f, "values": jval, "valid": None, "distinct": False,
                  "acc_dtype": jnp.int64 if f == "count" else jval.dtype}
                 for f in agg_funcs]
        group_codes, results, n_groups, of_g = agg_ops.groupby_aggregate(
            [(jkey, jnp.zeros_like(out_valid))], out_valid, specs, max_groups,
            n_rows=jkey.shape[0],
        )
        gvalid = jnp.arange(max_groups) < n_groups
        of = (of_j | of_g).astype(jnp.int32)
        overflow = jax.lax.pmax(of, AXIS) > 0
        return group_codes[0][0], tuple(r[0] for r in results), gvalid, overflow

    return jax.jit(_shuffle), jax.jit(_local)
