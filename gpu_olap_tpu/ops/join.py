"""Equi-join kernels — a sort-based redesign of the CUDA radix hash join.

The reference builds chained hash tables with ``atomicExch`` and probes with
chain walks + ``atomicAdd`` match counters (``join_kernels.cuh:80-166``).  This
design (SURVEY.md §7) avoids global atomics and is sort-based — chosen for an
accelerator without them; the H100 has them, so a hash join is a candidate
to measure against it:

* build side sorted by key (``lax.sort``), probe side binary-searched
  (``searchsorted`` with the sort-based method = co-ranking merge — exactly the
  reference's merge_join_kernel contract, ``join_kernels.cuh:169-213``);
* variable match fan-out is materialized into a *static* match buffer via
  ``repeat(total_repeat_length=capacity)`` + per-row offset arithmetic, with an
  overflow flag returned for host-side capacity growth (the reference caps with
  ``max_matches``, ``join_kernels.cuh:127,157``);
* multi-column / nullable keys are first densified into exact single int64
  codes by a shared lexicographic sort over both sides (no hashing, no
  collisions — this is also what the distributed shuffle partitions on).

Null keys never match (SQL), padded rows never match, and outer joins emit
unmatched rows with validity masks instead of sentinels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402

from .dtypes import INT64_MAX  # noqa: E402


def densify_keys(
    left_keys: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    left_rowvalid: Optional[jnp.ndarray],
    right_keys: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    right_rowvalid: Optional[jnp.ndarray],
):
    """Map multi-column keys of both sides into one exact int64 code space.

    Rows that must never match (null key or padded row) are assigned
    side-disjoint codes.  Returns (left_codes, right_codes)."""
    nl = left_keys[0][0].shape[0]
    nr = right_keys[0][0].shape[0]
    n = nl + nr

    def side_invalid(keys, rowvalid, count):
        inv = jnp.zeros(count, dtype=bool)
        for _, null in keys:
            inv = inv | null
        if rowvalid is not None:
            inv = inv | ~rowvalid
        return inv

    linv = side_invalid(left_keys, left_rowvalid, nl)
    rinv = side_invalid(right_keys, right_rowvalid, nr)
    # 0 = joinable, 1 = left-invalid, 2 = right-invalid -> invalid rows of the
    # two sides land in different code groups and cannot match
    flag = jnp.concatenate([
        jnp.where(linv, 1, 0).astype(jnp.int32),
        jnp.where(rinv, 2, 0).astype(jnp.int32),
    ])
    ops: List = [flag]
    for (lc, _), (rc, _) in zip(left_keys, right_keys):
        ops.append(jnp.concatenate([lc, rc]))
    arange = jnp.arange(n, dtype=jnp.int64)
    res = jax.lax.sort(tuple(ops) + (arange,), num_keys=len(ops) + 1,
                       is_stable=False)
    perm = res[-1]
    newflag = arange == 0
    for op in res[:-1]:
        newflag = newflag | jnp.concatenate([jnp.ones(1, dtype=bool), op[1:] != op[:-1]])
    code_sorted = jnp.cumsum(newflag.astype(jnp.int64))
    # inverse permutation: one scatter to unique positions.  (The previous
    # re-sort keyed by ``perm`` trips XLA's GPU permutation-sort rewrite,
    # which emits an s32/s64-mismatched scatter the HLO verifier rejects.)
    dense = jnp.zeros(n, jnp.int64).at[perm].set(code_sorted,
                                                 unique_indices=True)
    return dense[:nl], dense[nl:]


def build_sorted(build_code: jnp.ndarray, build_invalid: jnp.ndarray,
                 presorted: bool = False):
    """Sort the build side by key; invalid rows sink to the tail.

    ``presorted``: catalog statistics prove the key column is already
    nondecreasing and null-free with invalid rows (if any) only in the
    padded tail (reference ``join_kernel.rs:10-14``: SortMergeJoin for
    pre-sorted data) — the 3-operand sort collapses to a sentinel mask.

    Returns (sorted_keys (tail = key_top sentinel), sorted_row_ids (int32),
    n_valid)."""
    nb = build_code.shape[0]
    arange = jnp.arange(nb, dtype=jnp.int32)
    from .dtypes import key_top

    top = jnp.asarray(key_top(build_code.dtype), dtype=build_code.dtype)
    if presorted:
        nbv = nb - jnp.sum(build_invalid.astype(jnp.int64))
        sk = jnp.where(arange < nbv, build_code, top)
        return sk, arange, nbv
    inv = build_invalid.astype(jnp.int32)
    sk_inv, sk, srow = jax.lax.sort((inv, build_code, arange), num_keys=3,
                                    is_stable=False)
    nbv = nb - jnp.sum(sk_inv.astype(jnp.int64))
    sk = jnp.where(arange < nbv, sk, top)
    return sk, srow, nbv


def probe_counts(sorted_keys, n_build_valid, probe_code, probe_invalid):
    """Binary-search probe: per probe row, [lo, hi) match range and count."""
    lo = jnp.searchsorted(sorted_keys, probe_code, side="left", method="sort")
    hi = jnp.searchsorted(sorted_keys, probe_code, side="right", method="sort")
    lo = jnp.minimum(lo, n_build_valid)
    hi = jnp.minimum(hi, n_build_valid)
    cnt = jnp.where(probe_invalid, 0, hi - lo)
    return lo.astype(jnp.int64), cnt.astype(jnp.int64)


def probe_ranges_merge(build_code, build_invalid, probe_code, probe_invalid,
                       fold_range=None):
    """Per-probe-row [lo, lo+cnt) match ranges by ONE tagged co-sort.

    ``jnp.searchsorted(method="sort")`` hides a full merge sort plus two
    scatters per call, and the classic probe needs two calls.  Instead, sort
    build and probe keys together with a tag ordering build rows before
    equal-keyed probe rows; then for every element a running build counter
    (cumsum) and a running run-base (cummax at key-run starts) give, at each
    probe row, the count of equal build keys (cnt) and the number of valid
    build rows with smaller keys (lo — which indexes ``build_sorted``'s row
    order, same (invalid, key) comparator).  A second sort restores probe
    order.  Two sorts + two scans total; no scatters, no gathers.

    Invalid rows of either side fold into the key lane as a top sentinel
    (int32 keys) or an extra tag value (general case), so they cluster at
    the end and never contaminate valid runs.

    ``fold_range``: optional (lo, hi) zone-map bound over BOTH sides' valid
    keys; when 2*(hi-lo)+1 has int32 headroom the merged key+tag lane stays
    int32 (half the bytes per sort pass)."""
    nb = build_code.shape[0]
    npr = probe_code.shape[0]
    n = nb + npr
    pidx = jnp.concatenate([
        jnp.full(nb, npr, dtype=jnp.int32),        # build rows restore last
        jnp.arange(npr, dtype=jnp.int32),
    ])
    i32_fold = (
        fold_range is not None
        and build_code.dtype == jnp.int32 and probe_code.dtype == jnp.int32
        and 2 * (int(fold_range[1]) - int(fold_range[0])) + 2
            < np.iinfo(np.int32).max - 2
    )
    if i32_fold:
        lo32 = np.int32(fold_range[0])
        key = (jnp.concatenate([build_code, probe_code]) - lo32) * 2
        key = key + jnp.concatenate([
            jnp.zeros(nb, dtype=jnp.int32), jnp.ones(npr, dtype=jnp.int32)])
        inv = jnp.concatenate([build_invalid, probe_invalid])
        key = jnp.where(inv, np.int32(np.iinfo(np.int32).max), key)
        key_s, pidx_s = jax.lax.sort((key, pidx), num_keys=2,
                                     is_stable=False)
        run_key = key_s >> 1
        is_build = (key_s & 1) == 0
    elif build_code.dtype == jnp.int32 and probe_code.dtype == jnp.int32:
        # fold key + tag + invalid into ONE int64 lane:
        # merged = key*2 + is_probe, invalid -> INT64_MAX
        key = jnp.concatenate([build_code, probe_code]).astype(jnp.int64) * 2
        key = key + jnp.concatenate([
            jnp.zeros(nb, dtype=jnp.int64), jnp.ones(npr, dtype=jnp.int64)])
        inv = jnp.concatenate([build_invalid, probe_invalid])
        key = jnp.where(inv, INT64_MAX, key)
        key_s, pidx_s = jax.lax.sort((key, pidx), num_keys=2,
                                     is_stable=False)
        run_key = key_s >> 1
        is_build = (key_s & 1) == 0
    else:
        key = jnp.concatenate([build_code, probe_code])
        tag = jnp.concatenate([
            jnp.zeros(nb, dtype=jnp.int32), jnp.ones(npr, dtype=jnp.int32)])
        inv = jnp.concatenate([build_invalid, probe_invalid])
        tag = jnp.where(inv, jnp.int32(2), tag)
        key_s, tag_s, pidx_s = jax.lax.sort((key, tag, pidx), num_keys=3,
                                            is_stable=False)
        run_key = key_s
        is_build = tag_s == 0
    newflag = jnp.concatenate([jnp.ones(1, dtype=bool),
                               run_key[1:] != run_key[:-1]])
    cb = jnp.cumsum(is_build.astype(jnp.int32))        # builds seen so far
    arange = jnp.arange(n, dtype=jnp.int32)
    # builds before each key run's start, carried forward within the run
    run_base = jax.lax.cummax(
        jnp.where(newflag, cb - is_build.astype(jnp.int32), jnp.int32(-1)))
    cnt_elem = cb - run_base
    # restore probe order: probe rows sort to the first npr positions
    _, lo_p, cnt_p = jax.lax.sort((pidx_s, run_base, cnt_elem), num_keys=1,
                                  is_stable=False)
    lo = lo_p[:npr].astype(jnp.int64)
    cnt = jnp.where(probe_invalid, 0, cnt_p[:npr]).astype(jnp.int64)
    return lo, cnt


def probe_counts_sorted(build_code, build_invalid, probe_code, probe_invalid,
                        fold_range=None, payloads=()):
    """Per-row match multiplicities left IN SORTED ORDER — for global
    aggregates that reduce over matched pairs, the probe-order restore sort
    of ``probe_ranges_merge`` (1 key + 2 payload lanes) is pure waste: a
    reduction is order-free.

    ``payloads``: optional (nb+npr,)-length lanes in [build..., probe...]
    concat order that ride the sort — decomposable pair aggregates
    (SUM over matches of f(probe) + g(build)) reduce them weighted by the
    per-element multiplicities.

    Returns (probe_ok, key_sorted, cnt_elem, build_ok, pcnt_elem,
    payloads_sorted):
      * ``probe_ok``  — element is a VALID probe row;
      * ``key_sorted`` — the probe key value (original code space) at that
        element (garbage where not probe_ok);
      * ``cnt_elem``  — int32 count of matching valid BUILD rows (at probe
        elements);
      * ``build_ok`` / ``pcnt_elem`` — the symmetric per-BUILD-row count of
        matching valid probe rows.
    """
    nb = build_code.shape[0]
    npr = probe_code.shape[0]
    n = nb + npr
    i32_fold = (
        fold_range is not None
        and build_code.dtype == jnp.int32 and probe_code.dtype == jnp.int32
        and 2 * (int(fold_range[1]) - int(fold_range[0])) + 2
            < np.iinfo(np.int32).max - 2
    )
    inv = jnp.concatenate([build_invalid, probe_invalid])
    if i32_fold:
        lo32 = np.int32(fold_range[0])
        key = (jnp.concatenate([build_code, probe_code]) - lo32) * 2
        key = key + jnp.concatenate([
            jnp.zeros(nb, dtype=jnp.int32), jnp.ones(npr, dtype=jnp.int32)])
        sent = np.int32(np.iinfo(np.int32).max)
        key = jnp.where(inv, sent, key)
        sorted_ = jax.lax.sort((key,) + tuple(payloads), num_keys=1,
                               is_stable=False)
        key_s, pay_s = sorted_[0], list(sorted_[1:])
        run_key = key_s >> 1
        is_build = (key_s & 1) == 0
        probe_ok = ((key_s & 1) == 1) & (key_s != sent)
        key_sorted = run_key + lo32
    elif build_code.dtype == jnp.int32 and probe_code.dtype == jnp.int32:
        key = jnp.concatenate([build_code, probe_code]).astype(jnp.int64) * 2
        key = key + jnp.concatenate([
            jnp.zeros(nb, dtype=jnp.int64), jnp.ones(npr, dtype=jnp.int64)])
        key = jnp.where(inv, INT64_MAX, key)
        sorted_ = jax.lax.sort((key,) + tuple(payloads), num_keys=1,
                               is_stable=False)
        key_s, pay_s = sorted_[0], list(sorted_[1:])
        run_key = key_s >> 1
        is_build = (key_s & 1) == 0
        probe_ok = ((key_s & 1) == 1) & (key_s != INT64_MAX)
        key_sorted = run_key
    else:
        key = jnp.concatenate([build_code, probe_code])
        tag = jnp.concatenate([
            jnp.zeros(nb, dtype=jnp.int32), jnp.ones(npr, dtype=jnp.int32)])
        tag = jnp.where(inv, jnp.int32(2), tag)
        sorted_ = jax.lax.sort((key, tag) + tuple(payloads), num_keys=2,
                               is_stable=False)
        key_s, tag_s, pay_s = sorted_[0], sorted_[1], list(sorted_[2:])
        run_key = key_s
        is_build = tag_s == 0
        probe_ok = tag_s == 1
        key_sorted = key_s
    newflag = jnp.concatenate([jnp.ones(1, dtype=bool),
                               run_key[1:] != run_key[:-1]])
    cb = jnp.cumsum(is_build.astype(jnp.int32))
    run_base = jax.lax.cummax(
        jnp.where(newflag, cb - is_build.astype(jnp.int32), jnp.int32(-1)))
    cnt_elem = jnp.where(probe_ok, cb - run_base, jnp.int32(0))

    # symmetric per-BUILD-row probe counts (decomposable join aggregates:
    # SUM over matched pairs of g(build) = sum over build rows of
    # probes_in_run * g) — probes-before-run-start carried forward, and the
    # run's LAST cumulative probe count filled backward (reversed cummax of
    # a nondecreasing seed)
    build_ok = is_build  # invalid rows sort to the tail sentinel run
    cp = jnp.cumsum(probe_ok.astype(jnp.int32))
    run_base_p = jax.lax.cummax(
        jnp.where(newflag, cp - probe_ok.astype(jnp.int32), jnp.int32(-1)))
    last_mask = jnp.concatenate([newflag[1:], jnp.ones(1, dtype=bool)])
    # nearest-NEXT seed fill: run-end cp values increase across runs, so the
    # first seed at or after each position is the MINIMUM of the suffix
    seed = jnp.where(last_mask, cp, jnp.int32(np.iinfo(np.int32).max))
    run_end_cp = jnp.flip(jax.lax.cummin(jnp.flip(seed)))
    pcnt_elem = jnp.where(build_ok, run_end_cp - run_base_p, jnp.int32(0))
    return probe_ok, key_sorted, cnt_elem, build_ok, pcnt_elem, pay_s


def expand_matches(cnt, lo, sorted_rows, capacity: int):
    """Materialize (probe_row, build_row) pairs into a static buffer.

    All index arithmetic is int32 (row counts and capacities are < 2^31;
    narrow lanes halve the bandwidth of the repeat + gathers).  Rows past a
    wrapped int32 prefix sum can only exist when ``total`` already exceeds
    ``capacity``, which raises the int64-exact overflow flag and triggers the
    host growth/recompile path.

    Returns (probe_idx, build_row, out_valid, total, overflow)."""
    np_rows = cnt.shape[0]
    nb = sorted_rows.shape[0]
    cnt32 = cnt.astype(jnp.int32)
    starts = jnp.cumsum(cnt32) - cnt32
    total = jnp.sum(cnt)  # int64-exact
    overflow = total > capacity
    pidx = jnp.repeat(
        jnp.arange(np_rows, dtype=jnp.int32), cnt32, total_repeat_length=capacity
    )
    slot = jnp.arange(capacity, dtype=jnp.int32)
    out_valid = slot.astype(jnp.int64) < total
    off = slot - starts[pidx]
    bpos = jnp.clip(lo.astype(jnp.int32)[pidx] + off, 0, nb - 1)
    brow = sorted_rows[bpos]
    return pidx, brow, out_valid, total, overflow


def direct_probe(sorted_keys, sorted_rows, n_build_valid, kmin: int, kmax: int,
                 probe_code, probe_invalid):
    """Direct-address probe: zone-map stats bound the build key range, so the
    per-key [lo, hi) match ranges are precomputed into a dense offset table
    and probing is two gathers per row instead of a binary search.

    This is the engine's analogue of the reference's O(1) hash-table probe
    (``join_kernels.cuh:115-166``) — direct addressing instead of hashing, so
    it is exact and collision-free.  ``kmin``/``kmax`` are static (host)
    bounds from catalog statistics."""
    span = int(kmax) - int(kmin) + 1
    dt = sorted_keys.dtype
    iota = (jnp.arange(span + 1, dtype=jnp.int64) + jnp.asarray(int(kmin), jnp.int64)).astype(dt)
    lo_tab = jnp.searchsorted(sorted_keys, iota, side="left", method="sort")
    lo_tab = jnp.minimum(lo_tab, n_build_valid).astype(jnp.int64)
    rel = probe_code.astype(jnp.int64) - int(kmin)
    in_range = (rel >= 0) & (rel < span) & (~probe_invalid)
    rel_c = jnp.clip(rel, 0, span - 1)
    lo = lo_tab[rel_c]
    hi = lo_tab[rel_c + 1]
    cnt = jnp.where(in_range, hi - lo, 0)
    return lo, cnt


def lookup_slots(build_code, build_invalid, kmin: int, kmax: int,
                 probe_code, probe_invalid):
    """Dense key->row table + probe slot positions for a unique-key build.

    Returns (dense_row [span] int32, -1 = empty slot; rel_c [n_probe] clipped
    slot per probe row; inr bool [n_probe] in-range-and-valid).  The caller
    gathers through dense_row — or through per-column dense *value* tables
    derived from it, which lets a sentinel value double as the match flag so
    a single gather per probe row yields both value and matchedness (one
    probe-sized gather instead of two).

    The dense fill is itself the scatter-free merge probe: slot keys
    [kmin, kmax] merge against the build keys (instead of ``jnp.repeat``,
    whose total_repeat_length lowering hides a scatter-add), then one
    build-sized gather materializes the row table."""
    nb = build_code.shape[0]
    span = int(kmax) - int(kmin) + 1
    _, srow, _ = build_sorted(build_code, build_invalid)
    if build_code.dtype == jnp.int32:
        slot_keys = jnp.arange(span, dtype=jnp.int32) + np.int32(kmin)
    else:
        slot_keys = jnp.arange(span, dtype=jnp.int64) + int(kmin)
    lo, cnt = probe_ranges_merge(build_code, build_invalid, slot_keys,
                                 jnp.zeros(span, dtype=bool),
                                 fold_range=(int(kmin), int(kmax)))
    dense_row = jnp.where(
        cnt > 0, srow[jnp.clip(lo.astype(jnp.int32), 0, nb - 1)],
        jnp.int32(-1))

    rel_c, inr = dense_probe(kmin, kmax, probe_code, probe_invalid)
    return dense_row, rel_c, inr


def dense_probe(kmin: int, kmax: int, probe_code, probe_invalid):
    """Slot positions + in-range flags for probing dense [kmin, kmax] tables.

    Probe-side arithmetic stays int32 where possible (half the bytes):
    range-test BEFORE subtracting so no intermediate can overflow."""
    span = int(kmax) - int(kmin) + 1
    if probe_code.dtype == jnp.int32 and span <= np.iinfo(np.int32).max:
        k0, k1 = np.int32(kmin), np.int32(kmax)
        inr = (probe_code >= k0) & (probe_code <= k1) & (~probe_invalid)
        rel_c = jnp.clip(probe_code, k0, k1) - k0
    else:
        rel = probe_code.astype(jnp.int64) - int(kmin)
        inr = (rel >= 0) & (rel < span) & (~probe_invalid)
        rel_c = jnp.clip(rel, 0, span - 1)
    return rel_c, inr


def lookup_join(build_code, build_invalid, kmin: int, kmax: int,
                probe_code, probe_invalid):
    """Expansion-free join against a *unique-key* build side.

    With build keys proven duplicate-free (catalog key statistic) and a
    stats-bounded range, the build side compiles into a dense key->row table
    (sort + repeat-fill, scatter-free) and probing is one gather per row —
    no searchsorted, no match expansion (output shape == probe shape).
    This is the engine's equivalent of an O(1)-probe hash table with a perfect
    hash (the identity over [kmin, kmax]).

    Returns (ri, matched): per probe row the matching build row (or -1)."""
    dense_row, rel_c, inr = lookup_slots(
        build_code, build_invalid, kmin, kmax, probe_code, probe_invalid)
    ri = jnp.where(inr, dense_row[rel_c], jnp.int32(-1))
    return ri, ri >= 0


def inner_join(
    left_keys, left_rowvalid, right_keys, right_rowvalid, capacity: int,
    single_key_fast: bool = True,
    build_range=None,
    fold_range=None,
    build_presorted: bool = False,
):
    """Inner equi-join.  Probe = left, build = right.

    Returns (left_idx, right_idx, out_valid, total, overflow)."""
    lcode, linv, rcode, rinv = _prepare_codes(
        left_keys, left_rowvalid, right_keys, right_rowvalid, single_key_fast
    )
    sk, srow, nbv = build_sorted(rcode, rinv,
                                 presorted=build_presorted
                                 and len(right_keys) == 1)
    # the merge probe beats the direct-address table at essentially every
    # shape (two co-sorts vs a searchsorted-built table plus two probe-sized
    # gathers — measured 92M rows/s vs ~50M at 25Mx25M); direct_probe remains
    # for streaming, where the build side stays resident across chunks
    lo, cnt = probe_ranges_merge(rcode, rinv, lcode, linv,
                                 fold_range=fold_range)
    return expand_matches(cnt, lo, srow, capacity) + (cnt,)


def _prepare_codes(left_keys, left_rowvalid, right_keys, right_rowvalid,
                   single_key_fast):
    """Single-key fast path avoids the shared densify sort entirely."""
    if single_key_fast and len(left_keys) == 1:
        lcode, lnull = left_keys[0]
        rcode, rnull = right_keys[0]
        linv = lnull if left_rowvalid is None else (lnull | ~left_rowvalid)
        rinv = rnull if right_rowvalid is None else (rnull | ~right_rowvalid)
        return lcode, linv, rcode, rinv
    lcode, rcode = densify_keys(left_keys, left_rowvalid, right_keys, right_rowvalid)
    # invalidity already folded into disjoint codes; only padding matters for
    # emission and is handled by the caller
    nl = lcode.shape[0]
    nr = rcode.shape[0]
    linv = jnp.zeros(nl, dtype=bool) if left_rowvalid is None else ~left_rowvalid
    rinv = jnp.zeros(nr, dtype=bool) if right_rowvalid is None else ~right_rowvalid
    return lcode, linv, rcode, rinv


def _compact_rows(flag: jnp.ndarray):
    """Row ids where ``flag`` holds, compacted to a -1-padded prefix
    (stable sort — scatter-free)."""
    n = flag.shape[0]
    arange = jnp.arange(n, dtype=jnp.int32)
    _, rows = jax.lax.sort(((~flag).astype(jnp.int32), arange), num_keys=2,
                           is_stable=False)
    n_set = jnp.sum(flag.astype(jnp.int64))
    rows = jnp.where(arange < n_set, rows, jnp.int32(-1)).astype(jnp.int64)
    return rows, n_set


def outer_extend(join_type: str, li, ri, out_valid, total,
                 cnt, left_rowvalid, right_rowvalid, nl: int, nr: int):
    """Append unmatched rows for left/right/full joins.

    The matched buffer (li, ri, out_valid) is extended by ``nl`` (left/full)
    and/or ``nr`` (right/full) slots; unmatched rows are compacted into the
    extension via cumsum-scatter.  Padded (-1) indices mark the null side.
    Returns (li, ri, out_valid, total)."""
    parts_li = [li]
    parts_ri = [ri]
    parts_valid = [out_valid]

    if join_type in ("left", "full"):
        lvalid = jnp.ones(nl, dtype=bool) if left_rowvalid is None else left_rowvalid
        unmatched = (cnt == 0) & lvalid
        slot_rows, n_un = _compact_rows(unmatched)
        parts_li.append(slot_rows)
        parts_ri.append(jnp.full(nl, -1, dtype=jnp.int64))
        parts_valid.append(jnp.arange(nl, dtype=jnp.int64) < n_un)
        total = total + n_un

    if join_type in ("right", "full"):
        rvalid = jnp.ones(nr, dtype=bool) if right_rowvalid is None else right_rowvalid
        # membership test via the merge probe (emitted right-row ids as the
        # "build" side) — scatter-free matched-flag computation
        emitted = jnp.where(out_valid, ri.astype(jnp.int32), jnp.int32(-1))
        rows = jnp.arange(nr, dtype=jnp.int32)
        _, cnt_m = probe_ranges_merge(emitted, emitted < 0, rows,
                                      jnp.zeros(nr, dtype=bool))
        matched = cnt_m > 0
        unmatched = ~matched & rvalid
        slot_rows, n_un = _compact_rows(unmatched)
        parts_li.append(jnp.full(nr, -1, dtype=jnp.int64))
        parts_ri.append(slot_rows)
        parts_valid.append(jnp.arange(nr, dtype=jnp.int64) < n_un)
        total = total + n_un

    li = jnp.concatenate(parts_li)
    ri = jnp.concatenate(parts_ri)
    # compact validity: the extension segments are prefix-valid within
    # themselves; overall validity is just the concatenation
    out_valid = jnp.concatenate(parts_valid)
    return li, ri, out_valid, total
