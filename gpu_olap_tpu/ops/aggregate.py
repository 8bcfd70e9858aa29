"""Sort-based grouped aggregation — the engine's hash-aggregate.

The reference's CUDA design is an atomicAdd shared-memory hash table
(``aggregate_kernel.rs:1-8``, ``join_kernels.cuh:216-240``).  This design is
fully *scatter-free* — a choice made for an accelerator whose scatters
serialized on duplicate indices; whether a scatter-add or hash aggregation
beats it on the H100 is still to measure:

1. lexicographic ``lax.sort`` of the key columns (multi-key, nulls-as-groups);
2. run boundaries from sorted-key adjacency; group id = prefix sum of flags;
3. per-group [start, end] positions by ONE merge-based searchsorted over the
   dense group ids (``ends[g] = starts[g+1] - 1`` because ids are gap-free);
4. SUM/COUNT/AVG as ``cumsum`` + boundary differences (exact for int64);
   MIN/MAX of the primary argument ride the key sort (min at run start, max at
   start + valid_count - 1); COUNT(DISTINCT) via a secondary (keys, value)
   sort; further MIN/MAX arguments fall back to a segmented scan.
5. group key outputs gathered at run starts.

Sort-operand minimization (the sort is the cost — every operand moves through
every merge pass):

* row validity folds into the first key's null flag (one int32 operand holds
  ``2 * row_invalid + null``); both vanish when statically absent;
* group keys narrow to int32 when zone-map statistics prove the range fits;
* aggregate inputs ride the same sort as pre-masked payloads (no int64
  ``arange`` permutation payload and no random gather per aggregate — gathers
  measured ~92M rows/s vs >190M rows/s for an extra sort lane);
* the permutation payload is added only for aggregates that genuinely need it
  (MIN/MAX over a second distinct argument).

Everything is static-shape: outputs are padded to ``max_groups`` with a
returned group count; global aggregates reduce directly (jnp.sum/min/max).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402

from .dtypes import INT64_MAX, INT64_MIN, key_code, key_fill  # noqa: E402


def _sum_by_boundary(values, starts, ends):
    """Segment sums of a sorted array via cumsum + boundary differences."""
    c = jnp.cumsum(values)
    n = values.shape[0]
    end_v = c[jnp.clip(ends, 0, n - 1)]
    start_prev = jnp.where(starts > 0, c[jnp.clip(starts - 1, 0, n - 1)],
                           jnp.zeros((), dtype=c.dtype))
    out = end_v - start_prev
    return jnp.where(ends >= starts, out, jnp.zeros((), dtype=c.dtype))


def _cnt_by_boundary(flags, starts, ends):
    """Segment counts of a boolean/int mask: int32 cumsum (n < 2^31), i64 out."""
    return _sum_by_boundary(flags.astype(jnp.int32), starts, ends).astype(jnp.int64)


def _seg_scan_minmax(values, gid_sorted, starts, ends, is_min: bool):
    """Segmented min/max over sorted runs via an associative scan."""
    fn = jnp.minimum if is_min else jnp.maximum

    def op(a, b):
        v1, g1 = a
        v2, g2 = b
        return (jnp.where(g1 == g2, fn(v1, v2), v2), g2)

    scanned_v, _ = jax.lax.associative_scan(op, (values, gid_sorted))
    n = values.shape[0]
    out = scanned_v[jnp.clip(ends, 0, n - 1)]
    return out


def _arg_nullable(spec) -> bool:
    """Whether the ride null-flag operand is needed for this argument."""
    return spec.get("valid") is not None or spec.get("np_kind") == "f"


def groupby_aggregate(
    keys: Sequence[Tuple[jnp.ndarray, Optional[jnp.ndarray]]],  # (code, null|None)
    row_valid: Optional[jnp.ndarray],                 # bool (N,) or None
    aggs: Sequence[dict],
    max_groups: int,
    n_rows: Optional[int] = None,
    prefix_rows: Optional[int] = None,
):
    """Grouped aggregation over padded columns.

    ``keys`` entries are (code, null_flags) — null_flags may be None when the
    key is statically null-free (drops a sort operand).

    ``prefix_rows``: when row validity is exactly ``arange < prefix_rows``
    with a trace-time constant (pure scans), padded rows are sentinel-masked
    into the first key operand instead of carrying a validity lane through
    every sort merge pass; int32-narrowed null-free keys then need NO
    validity operand at all (zone-map headroom guarantees the sentinel is
    collision-free).

    ``aggs`` entries: {func, values (jnp or None for count(*)), valid (jnp|None),
    distinct (bool), acc_dtype (np dtype), np_kind, arg_id, int32_ok (bool)}.

    Returns (group_codes: [(code, null)], agg_results: [(data, valid|None)],
    n_groups: i64 scalar, overflow: bool scalar).
    """
    if keys:
        n = keys[0][0].shape[0]
    elif n_rows is not None:
        n = n_rows
    else:
        first_v = next(a for a in aggs if a.get("values") is not None)
        n = first_v["values"].shape[0]

    if not keys:
        return _global_aggregate(aggs, row_valid, n)

    arange32 = jnp.arange(n, dtype=jnp.int32)
    if prefix_rows is not None:
        row_valid = None  # equivalent, applied statically below
    inv = None if row_valid is None else (~row_valid).astype(jnp.int32)

    # ---- key operands: fold row validity into the first null flag ----
    k0_code, k0_null = keys[0]
    k0n = None if k0_null is None else k0_null.astype(jnp.int32)
    static_prefix = None
    if prefix_rows is not None:
        static_prefix = int(prefix_rows)
        pad = arange32 >= np.int32(static_prefix)
        if k0n is not None:
            # pads (2) sort after null-key rows (1) after plain rows (0)
            first = jnp.where(pad, np.int32(2), k0n)
            inv_thr, k0_in_first = None, True
        elif k0_code.dtype == jnp.int32:
            # int32 narrowing proved headroom below INT32_MAX: sentinel-mask
            # the key itself — zero validity operands in the sort
            k0_code = jnp.where(pad, np.int32(np.iinfo(np.int32).max), k0_code)
            first, inv_thr, k0_in_first = None, None, False
        else:
            first = pad.astype(jnp.int32)
            inv_thr, k0_in_first = None, False
    elif inv is not None and k0n is not None:
        first, inv_thr, k0_in_first = inv * 2 + k0n, 2, True
    elif inv is not None:
        first, inv_thr, k0_in_first = inv, 1, False
    elif k0n is not None:
        first, inv_thr, k0_in_first = k0n, None, True
    else:
        first, inv_thr, k0_in_first = None, None, False

    key_ops: List = [] if first is None else [first]
    key_slots = []
    key_ops.append(k0_code)
    key_slots.append({"code": len(key_ops) - 1,
                      "null": 0 if k0_in_first else None,
                      "in_first": k0_in_first})
    for code, null in keys[1:]:
        ns = None
        if null is not None:
            key_ops.append(null.astype(jnp.int32))
            ns = len(key_ops) - 1
        key_ops.append(code)
        key_slots.append({"code": len(key_ops) - 1, "null": ns,
                          "in_first": False})

    # ---- aggregate routing: primary key-ride / payload ride / fallback ----
    primary_spec = next(
        (s for s in aggs
         if s["func"] in ("min", "max") and not s.get("distinct")
         and s.get("values") is not None), None)
    primary_arg = primary_spec.get("arg_id") if primary_spec else None

    ride_ops: List = []
    ride_null_slot = ride_code_slot = None
    if primary_spec is not None:
        pv_code, pv_null = key_code(primary_spec["values"],
                                    primary_spec.get("valid"),
                                    primary_spec.get("np_kind", "i"))
        if primary_spec.get("int32_ok") and pv_code.dtype == jnp.int64:
            pv_code = pv_code.astype(jnp.int32)
        base = len(key_ops)
        if _arg_nullable(primary_spec):
            ride_ops.append(pv_null.astype(jnp.int32))
            ride_null_slot = base
            base += 1
        ride_ops.append(pv_code)
        ride_code_slot = base

    def _same_arg(spec) -> bool:
        return (primary_spec is not None
                and spec.get("arg_id") is not None
                and spec.get("arg_id") == primary_arg)

    def _rides_primary(spec) -> bool:
        # reuse of the primary key-ride: exact for ints (key_code is identity);
        # floats go through payloads so NaN keeps raw-value semantics
        if spec is primary_spec:
            return True
        if not _same_arg(spec):
            return False
        if spec["func"] in ("min", "max"):
            return True
        return spec.get("np_kind", "i") != "f"

    # pre-masked payload lanes, deduplicated per (kind, argument)
    payloads: List = []
    payload_meta: List[Tuple[str, object]] = []

    def _payload_slot(kind: str, spec) -> int:
        ix = _find_payload(payload_meta, kind, spec)
        if ix is not None:
            return ix
        values, valid = spec["values"], spec.get("valid")
        if kind == "sum":
            acc = spec["acc_dtype"]
            if (spec.get("int32_ok") and np.dtype(acc).kind in "iu"
                    and values.dtype != jnp.float64):
                mv = values.astype(jnp.int32)
                if valid is not None:
                    mv = jnp.where(valid, mv, jnp.asarray(0, jnp.int32))
            elif (spec.get("sum_f64_ok") and np.dtype(acc).kind in "iu"):
                # stats-proven exact in f64
                mv = values.astype(jnp.float64)
                if valid is not None:
                    mv = jnp.where(valid, mv, 0.0)
            else:
                mv = values.astype(acc)
                if valid is not None:
                    mv = jnp.where(valid, mv, jnp.asarray(0, acc))
        elif kind == "fsum":
            mv = values.astype(jnp.float64)
            if valid is not None:
                mv = jnp.where(valid, mv, 0.0)
        else:  # cnt
            mv = valid.astype(jnp.int32)
        payloads.append(mv)
        payload_meta.append((kind, spec.get("arg_id")))
        return len(payloads) - 1

    plans = []  # per-spec execution plan
    need_perm = False
    for spec in aggs:
        func = spec["func"]
        if spec.get("distinct") and func in ("count", "sum", "avg"):
            # DISTINCT is a no-op for min/max, which fall through
            plans.append(("distinct", None))
            continue
        if func == "count" and spec.get("values") is None:
            plans.append(("size", None))
            continue
        if _rides_primary(spec):
            plans.append(("primary", None))
            continue
        if func == "count":
            if spec.get("valid") is None:
                plans.append(("size", None))
            else:
                plans.append(("cnt", _payload_slot("cnt", spec)))
            continue
        if func == "sum":
            cs = (None if spec.get("valid") is None
                  else _payload_slot("cnt", spec))
            plans.append(("sum", (_payload_slot("sum", spec), cs)))
            continue
        if func == "avg":
            cs = (None if spec.get("valid") is None
                  else _payload_slot("cnt", spec))
            plans.append(("avg", (_payload_slot("fsum", spec), cs)))
            continue
        # min/max over a non-primary argument: permutation fallback
        need_perm = True
        plans.append(("fallback", None))

    operands = key_ops + ride_ops + payloads
    if need_perm:
        operands = operands + [arange32]
    num_keys = len(key_ops) + len(ride_ops)
    # unstable: XLA's stable sort may ride a hidden tie-break iota through
    # every pass, and nothing here needs stability.
    # Payload order within equal key tuples is aggregation-invariant here
    # (sums/counts are segment totals; the perm payload feeds a segmented
    # min/max, also order-free).  Caveat: for FLOAT payloads
    # "invariant" means exact up to summation ORDER — f64 SUM/AVG accumulate
    # in whatever tie order this compiled program produced, which can differ
    # from the stable build by rounding.  Results stay deterministic per
    # compiled program; bit-stability ACROSS releases is not promised for
    # float sums (same contract as the reference's atomicAdd aggregation,
    # which is nondeterministic even per run, join_kernels.cuh:216-240).
    sorted_ops = jax.lax.sort(tuple(operands), num_keys=num_keys,
                              is_stable=False)

    first_s = sorted_ops[0] if first is not None else None
    if static_prefix is not None:
        # padded rows sort last by construction; the prefix is a constant
        in_prefix = arange32 < np.int32(static_prefix)
    elif inv_thr is not None:
        nvalid = n - jnp.sum((first_s >= inv_thr).astype(jnp.int32))
        in_prefix = arange32 < nvalid
    else:
        in_prefix = None

    diff = jnp.zeros(n, dtype=bool)
    for slot in range(len(key_ops)):
        op = sorted_ops[slot]
        d = jnp.concatenate([jnp.ones(1, dtype=bool), op[1:] != op[:-1]])
        diff = diff | d
    newflag = diff if in_prefix is None else (diff & in_prefix)

    gid_raw = jnp.cumsum(newflag.astype(jnp.int32)) - 1
    n_groups = jnp.sum(newflag.astype(jnp.int32)).astype(jnp.int64)
    overflow = n_groups > max_groups
    mg32 = np.int32(max_groups)
    gid = jnp.clip(gid_raw, 0, mg32)
    if in_prefix is not None:
        gid = jnp.where(in_prefix, gid, mg32)

    if static_prefix is not None:
        nval = jnp.asarray(static_prefix, jnp.int32)
    elif inv_thr is not None:
        nval = nvalid.astype(jnp.int32)
    else:
        nval = jnp.asarray(n, jnp.int32)
    starts, ends, exists = _dense_boundaries(newflag, arange32, n_groups,
                                             nval, max_groups)
    sizes64 = jnp.where(exists, (ends - starts + 1).astype(jnp.int64),
                        jnp.zeros((), jnp.int64))
    safe_start = jnp.clip(starts, 0, n - 1)

    # group key outputs: gather the sorted key at each run start (no scatter)
    group_codes = []
    for ks in key_slots:
        code_s = sorted_ops[ks["code"]]
        fill = jnp.asarray(key_fill(code_s.dtype), dtype=code_s.dtype)
        out_code = jnp.where(exists, code_s[safe_start], fill)
        if ks["in_first"]:
            nf = (first_s[safe_start] & 1) == 1
        elif ks["null"] is not None:
            nf = sorted_ops[ks["null"]][safe_start] > 0
        else:
            nf = None  # statically null-free key: no flag materialized
        group_codes.append((
            out_code, None if nf is None else jnp.where(exists, nf, False)))

    # primary key-ride state
    pv_code_s = pv_null_s = ride_cnt = None
    if primary_spec is not None:
        pv_code_s = sorted_ops[ride_code_slot]
        if ride_null_slot is not None:
            pv_null_s = sorted_ops[ride_null_slot]
            ride_cnt = _cnt_by_boundary(pv_null_s == 0, starts, ends)
        else:
            ride_cnt = sizes64

    pay_base = len(key_ops) + len(ride_ops)
    cnt_cache = {}

    def _payload_sorted(ix):
        return sorted_ops[pay_base + ix]

    def _cnt_of(ix):
        if ix not in cnt_cache:
            cnt_cache[ix] = _sum_by_boundary(
                _payload_sorted(ix), starts, ends).astype(jnp.int64)
        return cnt_cache[ix]

    results = []
    for spec, (kind, slot) in zip(aggs, plans):
        acc = spec["acc_dtype"]
        if kind == "size":
            results.append((sizes64, None))
        elif kind == "distinct":
            results.append(_distinct_agg(spec, key_ops, inv_thr,
                                         static_prefix, max_groups, n))
        elif kind == "primary":
            func = spec["func"]
            # null-free argument (no ride null lane): every output group has
            # >= 1 value, so validity is statically all-true — return None so
            # nothing is materialized or transferred for it
            has = None if pv_null_s is None else (ride_cnt > 0)
            if func in ("min", "max"):
                if func == "min":
                    pos = safe_start
                else:
                    pos = jnp.clip(starts + ride_cnt - 1, 0, n - 1)
                out = pv_code_s[pos]
                # int32-narrowed values stay int32 on the wire (the
                # device->host link is the bottleneck; _to_host widens)
                if not (out.dtype == jnp.int32
                        and np.dtype(acc) == np.dtype(np.int64)):
                    out = out.astype(acc)
                if has is not None:
                    out = jnp.where(has, out, jnp.asarray(0, out.dtype))
                results.append((out, has))
            elif func == "count":
                results.append((ride_cnt, None))
            elif func == "sum":
                sum_dt = (jnp.float64 if (spec.get("sum_f64_ok")
                                          and np.dtype(acc).kind in "iu")
                          else acc)
                base_v = pv_code_s.astype(sum_dt)
                if pv_null_s is not None:
                    base_v = jnp.where(pv_null_s == 0, base_v,
                                       jnp.asarray(0, sum_dt))
                s = _sum_by_boundary(base_v, starts, ends)
                if s.dtype != np.dtype(acc):
                    s = s.astype(acc)  # stats-proven exact (< 2^52)
                results.append((s, has))
            else:  # avg
                base_v = pv_code_s.astype(jnp.float64)
                if pv_null_s is not None:
                    base_v = jnp.where(pv_null_s == 0, base_v, 0.0)
                s = _sum_by_boundary(base_v, starts, ends)
                avg = s / jnp.maximum(ride_cnt, 1)
                if has is not None:
                    avg = jnp.where(has, avg, 0.0)
                results.append((avg, has))
        elif kind == "cnt":
            results.append((_cnt_of(slot), None))
        elif kind == "sum":
            sum_ix, cnt_ix = slot
            mv = _payload_sorted(sum_ix)
            if mv.dtype == jnp.int32:
                mv = mv.astype(jnp.float64 if spec.get("sum_f64_ok") else acc)
            s = _sum_by_boundary(mv, starts, ends)
            if s.dtype != np.dtype(acc):
                s = s.astype(acc)  # stats-proven exact (< 2^52)
            results.append((s, None if cnt_ix is None else (_cnt_of(cnt_ix) > 0)))
        elif kind == "avg":
            fsum_ix, cnt_ix = slot
            s = _sum_by_boundary(_payload_sorted(fsum_ix), starts, ends)
            if cnt_ix is None:
                avg = s / jnp.maximum(sizes64, 1)
                results.append((avg, None))
            else:
                cnt = _cnt_of(cnt_ix)
                has = cnt > 0
                results.append((jnp.where(has, s / jnp.maximum(cnt, 1), 0.0),
                                has))
        else:  # fallback: permutation-based segmented min/max
            perm = sorted_ops[-1]
            results.append(_agg_one_fallback(spec, perm, gid, in_prefix,
                                             starts, ends, n))
    return group_codes, results, n_groups, overflow


def _dense_boundaries(newflag, arange32, n_groups, nval, max_groups: int):
    """Per-group [start, end] run positions from dense group ids.

    Group ids are gap-free by construction, so the g-th True position of
    ``newflag`` IS group g's start and ``ends[g] = starts[g+1] - 1``.  The
    compaction is one int32 pair sort — no searchsorted (whose
    method=\"sort\" lowering hides a full merge sort plus two scatters).
    The arange rides as a SECOND KEY with is_stable=False: the pair is then
    totally ordered, giving byte-identical results to a stable 1-key sort
    without XLA's hidden tie-break iota operand.
    ``nval`` is the number of valid rows (runs never extend past it)."""
    _, pos = jax.lax.sort(((~newflag).astype(jnp.int32), arange32),
                          num_keys=2, is_stable=False)
    if max_groups > pos.shape[0]:  # capacity grown past n: pad (never starts)
        pos = jnp.concatenate(
            [pos, jnp.zeros(max_groups - pos.shape[0], jnp.int32)])
    sp = pos[:max_groups]
    g_idx = jnp.arange(max_groups, dtype=jnp.int32)
    exists = g_idx < n_groups
    nxt = jnp.concatenate([sp[1:], jnp.zeros(1, jnp.int32)])
    ends = jnp.where(g_idx == n_groups - 1, nval - 1, nxt - 1)
    starts = jnp.where(exists, sp, nval)
    ends = jnp.where(exists, ends, nval - 2)
    return starts, ends, exists


def _find_payload(payload_meta, kind, spec):
    """Payload lanes are shared across aggregates over the same argument
    expression; arg_id None (callers that don't set it) never deduplicates."""
    arg = spec.get("arg_id")
    if arg is None:
        return None
    for i, (k, a) in enumerate(payload_meta):
        if k == kind and (a is arg or a == arg):
            return i
    return None


def _agg_one_fallback(spec, perm, gid, in_prefix, starts, ends, n):
    """MIN/MAX over a non-primary argument: gather by the sort permutation and
    run a segmented scan (rare: needs two distinct min/max argument columns)."""
    func = spec["func"]
    values = spec.get("values")
    valid = spec.get("valid")
    acc_dtype = spec["acc_dtype"]

    vals = values[perm]
    if in_prefix is None:
        v_valid = jnp.ones(n, dtype=bool) if valid is None else valid[perm]
    else:
        v_valid = in_prefix if valid is None else (valid[perm] & in_prefix)

    if np.dtype(acc_dtype).kind == "f":
        ident = jnp.inf if func == "min" else -jnp.inf
    else:
        ident = INT64_MAX if func == "min" else INT64_MIN
    masked = jnp.where(v_valid, vals.astype(acc_dtype),
                       jnp.asarray(ident, acc_dtype))
    out = _seg_scan_minmax(masked, gid, starts, ends, func == "min")
    if valid is None:
        # null-free argument: every non-empty group has a value
        return out, None
    cnt = _cnt_by_boundary(v_valid, starts, ends)
    has_any = cnt > 0
    return jnp.where(has_any, out, jnp.asarray(0, acc_dtype)), has_any


def _distinct_agg(spec, key_ops, inv_thr, static_prefix, max_groups, n):
    """COUNT/SUM/AVG(DISTINCT x): secondary sort ordered by (group keys, x),
    distinct flags from adjacency, cumsum + boundary diff.  SUM/AVG carry the
    raw value as a sort PAYLOAD and reduce only first occurrences (round-5
    fix: the device path previously deduped COUNT only, silently summing
    duplicates for SUM/AVG DISTINCT — oracle dedups all three,
    executor/cpu.py:177-188)."""
    func = spec["func"]
    values = spec["values"]
    valid = spec.get("valid")
    vcode, vnull = key_code(values, valid, spec.get("np_kind", "i"))
    nullable = _arg_nullable(spec)
    ops = list(key_ops) + ([vnull.astype(jnp.int32)] if nullable else []) + [vcode]
    need_payload = func in ("sum", "avg")
    if need_payload:
        pay_dtype = np.float64 if func == "avg" else spec["acc_dtype"]
        ops = ops + [values.astype(pay_dtype)]
    num_keys = len(ops) - (1 if need_payload else 0)
    sorted2 = jax.lax.sort(tuple(ops), num_keys=num_keys, is_stable=False)
    arange32 = jnp.arange(n, dtype=jnp.int32)
    if static_prefix is not None:
        in_pref2 = arange32 < np.int32(static_prefix)
    elif inv_thr is not None:
        nvalid2 = n - jnp.sum((sorted2[0] >= inv_thr).astype(jnp.int32))
        in_pref2 = arange32 < nvalid2
    else:
        in_pref2 = None
    key_end = len(key_ops)
    diff = jnp.zeros(n, dtype=bool)
    for op in sorted2[:key_end]:
        d = jnp.concatenate([jnp.ones(1, dtype=bool), op[1:] != op[:-1]])
        diff = diff | d
    newflag2 = diff if in_pref2 is None else (diff & in_pref2)
    n_groups2 = jnp.sum(newflag2.astype(jnp.int32)).astype(jnp.int64)
    if static_prefix is not None:
        nval2 = jnp.asarray(static_prefix, jnp.int32)
    elif inv_thr is not None:
        nval2 = nvalid2.astype(jnp.int32)
    else:
        nval2 = jnp.asarray(n, jnp.int32)
    starts2, ends2, _ = _dense_boundaries(newflag2, arange32, n_groups2,
                                          nval2, max_groups)
    null_s = sorted2[key_end] if nullable else None
    vcode_s = sorted2[key_end + (1 if nullable else 0)]
    vdiff = jnp.concatenate([jnp.ones(1, dtype=bool),
                             vcode_s[1:] != vcode_s[:-1]])
    distinct_new = newflag2 | vdiff
    if in_pref2 is not None:
        distinct_new = distinct_new & in_pref2
    if nullable:
        distinct_new = distinct_new & (null_s == 0)
    cnt = _cnt_by_boundary(distinct_new, starts2, ends2)
    if func == "count":
        return cnt, None
    payload_s = sorted2[-1]
    masked = jnp.where(distinct_new, payload_s,
                       jnp.zeros((), payload_s.dtype))
    ssum = _sum_by_boundary(masked, starts2, ends2)
    has = cnt > 0
    acc = spec["acc_dtype"]
    if func == "sum":
        out = jnp.where(has, ssum.astype(acc), jnp.asarray(0, acc))
        return out, (has if _arg_nullable(spec) else None)
    avg = jnp.where(has, ssum / jnp.maximum(cnt, 1).astype(jnp.float64), 0.0)
    return avg, (has if _arg_nullable(spec) else None)


def _global_aggregate(aggs, row_valid, n):
    """No GROUP BY: direct masked reductions, one output row."""
    rv = jnp.ones(n, dtype=bool) if row_valid is None else row_valid
    results = []
    for spec in aggs:
        func = spec["func"]
        values = spec.get("values")
        valid = spec.get("valid")
        if func == "count" and values is None:
            results.append((jnp.sum(rv.astype(jnp.int64)).reshape(1), None))
            continue
        if spec.get("distinct") and func in ("count", "sum", "avg"):
            # global distinct: sort values, first-occurrence adjacency mask
            # (SUM/AVG ride the raw value as a payload and reduce only first
            # occurrences — round-5 fix, previously COUNT-only dedup)
            vcode, vnull = key_code(values, valid, spec.get("np_kind", "i"))
            inv = (vnull | ~rv).astype(jnp.int32)
            ops = [inv, vcode]
            if func in ("sum", "avg"):
                pay_dtype = (np.float64 if func == "avg"
                             else spec["acc_dtype"])
                ops.append(values.astype(pay_dtype))
            sorted_g = jax.lax.sort(tuple(ops), num_keys=2, is_stable=False)
            s_inv, s_code = sorted_g[0], sorted_g[1]
            nv = n - jnp.sum(s_inv.astype(jnp.int64))
            arange = jnp.arange(n, dtype=jnp.int64)
            newv = jnp.concatenate([jnp.ones(1, dtype=bool),
                                    s_code[1:] != s_code[:-1]])
            first = newv & (arange < nv)
            cnt = jnp.sum(first.astype(jnp.int64))
            if func == "count":
                results.append((cnt.reshape(1), None))
                continue
            pay_s = sorted_g[2]
            ssum = jnp.sum(jnp.where(first, pay_s,
                                     jnp.zeros((), pay_s.dtype)))
            has = (cnt > 0).reshape(1)
            acc = spec["acc_dtype"]
            if func == "sum":
                results.append((jnp.where(cnt > 0, ssum.astype(acc),
                                          jnp.asarray(0, acc)).reshape(1),
                                has))
            else:
                avg = jnp.where(cnt > 0,
                                ssum / jnp.maximum(cnt, 1).astype(jnp.float64),
                                0.0)
                results.append((avg.reshape(1), has))
            continue
        v_valid = rv if valid is None else (rv & valid)
        if func == "count":
            results.append((jnp.sum(v_valid.astype(jnp.int64)).reshape(1), None))
            continue
        cnt = jnp.sum(v_valid.astype(jnp.int64))
        has = (cnt > 0).reshape(1)
        acc = spec["acc_dtype"]
        if func == "sum":
            s = jnp.sum(jnp.where(v_valid, values.astype(acc),
                                  jnp.asarray(0, acc)))
            results.append((s.reshape(1), has))
        elif func == "avg":
            s = jnp.sum(jnp.where(v_valid, values.astype(jnp.float64), 0.0))
            results.append(((s / jnp.maximum(cnt, 1)).reshape(1), has))
        elif func in ("min", "max"):
            if np.dtype(acc).kind == "f":
                ident = np.inf if func == "min" else -np.inf
            else:
                ident = INT64_MAX if func == "min" else INT64_MIN
            masked = jnp.where(v_valid, values.astype(acc),
                               jnp.asarray(ident, acc))
            red = jnp.min(masked) if func == "min" else jnp.max(masked)
            results.append((jnp.where(cnt > 0, red,
                                      jnp.asarray(0, acc)).reshape(1), has))
        else:
            raise AssertionError(func)
    return [], results, jnp.asarray(1, dtype=jnp.int64), jnp.asarray(False)
