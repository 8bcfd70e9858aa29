"""Smoke run of the engine on an NVIDIA GPU, through its user entry point.

``OlapEngine.query(sql)`` runs against in-memory tables at the sizes of the
engine's own benchmark (``bench.py``): a 100M-row fact table with 4M groups,
a 100M x 100M join with about two duplicates per key, and a 10M-row
dimension with a dictionary-encoded string column.  Every answer is checked
against a plain NumPy computation of the same query, written independently
of the engine.  Then the device-parity corpus of ``tests/parity_corpus.py``
runs on the card against the engine's CPU oracle, the out-of-core GROUP BY
streams a Parquet table larger than the in-memory cache threshold (needs
pyarrow; the phase is left out, and says so, where pyarrow is missing), and
a ``jax.profiler`` trace splits the device time of four queries into stages.

Tolerances: integers, COUNT, MIN, MAX and row sets must match exactly.
float64 SUM and AVG may differ by rtol 1e-9, because the GPU reduces in
another order than NumPy.  No matrix product is on this path (the package
has no dot, matmul or einsum), so TF32 does not arise.

Usage::

    python chip_smoke.py                # one GPU: every phase above
    python chip_smoke.py --four-cards   # the sharded path on four GPUs only
    python chip_smoke.py --scale 0.01   # same phases on 1% of the data

Prints one number line per phase, the card's ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result line, when JAX finds no GPU or any phase fails.
Traces and a JSON copy of the numbers go to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
FLOAT_RTOL = 1e-9


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def check_int(name, got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    check(got.shape == exp.shape and np.array_equal(got.astype(np.int64),
                                                    exp.astype(np.int64)),
          f"{name}: integers differ (got {got[:5]}..., want {exp[:5]}...)")


def check_float(name, got, exp):
    got = np.asarray(got, dtype=np.float64)
    exp = np.asarray(exp, dtype=np.float64)
    check(got.shape == exp.shape
          and np.allclose(got, exp, rtol=FLOAT_RTOL, atol=0.0, equal_nan=True),
          f"{name}: floats differ beyond rtol {FLOAT_RTOL}")


# ---------------------------------------------------------------------------
# data, generated from the seed
# ---------------------------------------------------------------------------

def make_data(seed: int, scale: float) -> dict:
    """The in-memory tables, at ``scale`` times the benchmark's sizes."""
    rng = np.random.default_rng(seed)
    n_facts = max(int(100e6 * scale), 1000)
    n_groups = max(int(4e6 * scale), 10)
    n_join = max(int(100e6 * scale), 1000)
    join_keys = max(n_join // 2, 10)          # ~2 duplicates per key
    n_dim = max(int(10e6 * scale), n_groups)
    n_names = 1000
    names = np.array([f"name_{i:04d}" for i in range(n_names)])
    dim_code = rng.integers(0, n_names, n_dim)
    return {
        "facts": {"k": rng.integers(0, n_groups, n_facts),
                  "v": rng.integers(0, 1_000_000, n_facts),
                  "f": rng.standard_normal(n_facts)},
        "l": {"k": rng.integers(0, join_keys, n_join)},
        "r": {"k": rng.integers(0, join_keys, n_join),
              "w": rng.integers(0, 1_000_000, n_join)},
        # dimension keyed by a permutation of [0, n_dim): unique, bounded
        "dim": {"id": rng.permutation(n_dim), "a": rng.integers(0, 1_000_000, n_dim),
                "s": names[dim_code]},
        "n_groups": n_groups, "join_keys": join_keys, "names": names,
        "dim_code": dim_code,
    }


def make_engine(**kwargs):
    from gpu_olap_tpu import EngineConfig, OlapEngine

    # enable_cache=False: warm runs execute instead of hitting the result cache
    kwargs.setdefault("max_groups", 1 << 23)
    return OlapEngine(EngineConfig(backend="device", enable_cache=False,
                                   **kwargs))


def register(eng, data):
    for name in ("facts", "l", "r", "dim"):
        eng.register(name, data[name])


# ---------------------------------------------------------------------------
# the queries and their plain references
# ---------------------------------------------------------------------------

def _group_stats(keys, vals, n_keys):
    """COUNT/SUM/MIN/MAX of non-negative int ``vals`` (< 1e6) per key in
    [0, n_keys): bincount for COUNT/SUM, one sort for MIN/MAX."""
    cnt = np.bincount(keys, minlength=n_keys)
    total = np.bincount(keys, weights=vals, minlength=n_keys)  # < 2^53: exact
    packed = np.sort(keys.astype(np.int64) * 1_000_000 + vals)
    ends = np.cumsum(cnt)
    present = cnt > 0
    mins = packed[(ends - cnt)[present]] % 1_000_000
    maxs = packed[ends[present] - 1] % 1_000_000
    return (np.flatnonzero(present), cnt[present],
            np.rint(total[present]).astype(np.int64), mins, maxs)


def query_a(d):
    sql = ("SELECT COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx, "
           "AVG(v) AS av FROM facts WHERE v > 500000")

    def ref_check(res):
        v = d["facts"]["v"]
        sel = v[v > 500000]
        for col, want in (("n", len(sel)), ("s", int(sel.sum())),
                          ("mn", int(sel.min())), ("mx", int(sel.max()))):
            check_int(f"(a) {col}", res[col], [want])
        check_float("(a) av", res["av"], [sel.sum() / len(sel)])
    return sql, ref_check, len(d["facts"]["v"])


def query_b(d):
    sql = ("SELECT k, COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx "
           "FROM facts GROUP BY k")

    def ref_check(res):
        want = _group_stats(d["facts"]["k"], d["facts"]["v"], d["n_groups"])
        order = np.argsort(res["k"])
        for col, w in zip(("k", "n", "s", "mn", "mx"), want):
            check_int(f"(b) {col}", np.asarray(res[col])[order], w)
    return sql, ref_check, len(d["facts"]["k"])


def query_c(d):
    sql = "SELECT COUNT(*) AS n, SUM(l.k + r.k) AS s FROM l JOIN r ON l.k = r.k"

    def ref_check(res):
        nk = d["join_keys"]
        pairs = (np.bincount(d["l"]["k"], minlength=nk)
                 * np.bincount(d["r"]["k"], minlength=nk))   # int64, exact
        check_int("(c) n", res["n"], [int(pairs.sum())])
        check_int("(c) s", res["s"],
                  [int((pairs * 2 * np.arange(nk, dtype=np.int64)).sum())])
    return sql, ref_check, len(d["l"]["k"]) + len(d["r"]["k"])


def query_c_grouped(d):
    """(c) grouped by a key bucket: the sharded path distributes joins under
    a GROUP BY only, so the four-card phase runs this form of (c)."""
    sql = ("SELECT l.k % 1000 AS g, COUNT(*) AS n, SUM(l.k + r.k) AS s "
           "FROM l JOIN r ON l.k = r.k GROUP BY l.k % 1000")

    def ref_check(res):
        nk = d["join_keys"]
        keys = np.arange(nk, dtype=np.int64)
        pairs = (np.bincount(d["l"]["k"], minlength=nk)
                 * np.bincount(d["r"]["k"], minlength=nk))
        g = keys % 1000
        # per-bucket partial sums stay far below 2^53: float bincount is exact
        n = np.rint(np.bincount(g, weights=pairs, minlength=1000))
        s_ = np.rint(np.bincount(g, weights=pairs * 2 * keys, minlength=1000))
        present = np.flatnonzero(n > 0)
        order = np.argsort(res["g"])
        check_int("(c grouped) g", np.asarray(res["g"])[order], present)
        check_int("(c grouped) n", np.asarray(res["n"])[order], n[present])
        check_int("(c grouped) s", np.asarray(res["s"])[order], s_[present])
    return sql, ref_check, len(d["l"]["k"]) + len(d["r"]["k"])


def query_d(d):
    """Inner join materialising (l.k, r.w) pairs for ~2% of the key range."""
    cut = max(d["join_keys"] // 50, 1)
    sql = (f"SELECT l.k AS k, r.w AS w FROM l JOIN r ON l.k = r.k "
           f"WHERE l.k < {cut}")

    def ref_check(res):
        lk = d["l"]["k"][d["l"]["k"] < cut]
        rsel = d["r"]["k"] < cut
        rk, rw = d["r"]["k"][rsel], d["r"]["w"][rsel]
        order = np.argsort(rk, kind="stable")
        rk, rw = rk[order], rw[order]
        lo = np.searchsorted(rk, lk, side="left")
        cnt = np.searchsorted(rk, lk, side="right") - lo
        starts = np.repeat(lo, cnt)
        offs = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        want_k, want_w = np.repeat(lk, cnt), rw[starts + offs]
        got_k, got_w = np.asarray(res["k"]), np.asarray(res["w"])
        check(len(got_k) == len(want_k),
              f"(d) {len(got_k)} rows, want {len(want_k)}")
        g, w = np.lexsort((got_w, got_k)), np.lexsort((want_w, want_k))
        check_int("(d) k", got_k[g], want_k[w])
        check_int("(d) w", got_w[g], want_w[w])
    return sql, ref_check, len(d["l"]["k"]) + len(d["r"]["k"])


def query_e(d):
    """Lookup join of the fact table against the unique-key dimension,
    grouped by the dimension's string column."""
    sql = ("SELECT d.s AS s, COUNT(*) AS n, SUM(x.v) AS sv, SUM(x.f) AS sf "
           "FROM facts x JOIN dim d ON x.k = d.id GROUP BY d.s")

    def ref_check(res):
        dim_row = np.empty(len(d["dim"]["id"]), dtype=np.int64)
        dim_row[d["dim"]["id"]] = np.arange(len(d["dim"]["id"]))
        code = d["dim_code"][dim_row[d["facts"]["k"]]]
        nn = len(d["names"])
        n = np.bincount(code, minlength=nn)
        sv = np.rint(np.bincount(code, weights=d["facts"]["v"], minlength=nn))
        sf = np.bincount(code, weights=d["facts"]["f"], minlength=nn)
        present = np.flatnonzero(n > 0)
        order = np.argsort(np.asarray(res["s"], dtype=str))
        check(list(np.asarray(res["s"], dtype=str)[order])
              == list(d["names"][present]), "(e) group names differ")
        check_int("(e) n", np.asarray(res["n"])[order], n[present])
        check_int("(e) sv", np.asarray(res["sv"])[order], sv[present])
        check_float("(e) sf", np.asarray(res["sf"])[order], sf[present])
    return sql, ref_check, len(d["facts"]["k"]) + len(d["dim"]["id"])


def query_f(d):
    """GROUP BY the dimension's string column, HAVING, ORDER BY."""
    thr = len(d["dim"]["id"]) // len(d["names"])   # keeps about half
    sql = (f"SELECT s, COUNT(*) AS n, SUM(a) AS sa FROM dim GROUP BY s "
           f"HAVING n > {thr} ORDER BY sa DESC, s")

    def ref_check(res):
        nn = len(d["names"])
        n = np.bincount(d["dim_code"], minlength=nn)
        sa = np.rint(np.bincount(d["dim_code"], weights=d["dim"]["a"],
                                 minlength=nn)).astype(np.int64)
        keep = np.flatnonzero(n > thr)
        order = keep[np.lexsort((d["names"][keep], -sa[keep]))]
        check(list(np.asarray(res["s"], dtype=str)) == list(d["names"][order]),
              "(f) rows or their order differ")
        check_int("(f) n", res["n"], n[order])
        check_int("(f) sa", res["sa"], sa[order])
    return sql, ref_check, len(d["dim"]["id"])


def query_g(d):
    """ORDER BY ... LIMIT over the fact table (ties broken to a total order)."""
    sql = "SELECT k, v, f FROM facts ORDER BY v DESC, k, f LIMIT 100"

    def ref_check(res):
        k, v, f = d["facts"]["k"], d["facts"]["v"], d["facts"]["f"]
        kth = np.partition(v, len(v) - 100)[len(v) - 100]
        cand = np.flatnonzero(v >= kth)
        top = cand[np.lexsort((f[cand], k[cand], -v[cand]))][:100]
        check_int("(g) k", res["k"], k[top])
        check_int("(g) v", res["v"], v[top])
        check_float("(g) f", res["f"], f[top])
    return sql, ref_check, len(d["facts"]["k"])


QUERIES = {"a": query_a, "b": query_b, "c": query_c, "d": query_d,
           "e": query_e, "f": query_f, "g": query_g,
           "c_grouped": query_c_grouped}
ONE_CARD = ("a", "b", "c", "d", "e", "f", "g")


# ---------------------------------------------------------------------------
# running and timing
# ---------------------------------------------------------------------------

def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_query(eng, name, sql, ref_check, rows, warm=3,
              backend=("device",)):
    """First call (compile + run), ``warm`` timed runs, reference check."""
    t0 = time.perf_counter()
    res = eng.query(sql)
    first = time.perf_counter() - t0
    check(res.meta["backend"] in backend,
          f"({name}) ran on {res.meta['backend']!r}, want {backend}")
    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        res = eng.query(sql)
        times.append(time.perf_counter() - t0)
    ref_check(res.to_pydict())
    med = statistics.median(times) if times else first
    return {"query": name, "backend": res.meta["backend"],
            "first_call_s": first, "warm_median_s": med, "warm_s": times,
            "rows": rows, "rows_per_s": rows / med,
            "result_rows": res.num_rows, "peak_bytes_in_use": peak_bytes()}


def report(line: dict, card: str):
    line = dict(line, card=card)
    print("phase " + json.dumps(line, default=float), flush=True)
    return line


def phase_queries(eng, data, card, names=ONE_CARD, warm=3,
                  backend=("device",)):
    out = []
    for name in names:
        sql, ref_check, rows = QUERIES[name](data)
        out.append(report(run_query(eng, name, sql, ref_check, rows, warm,
                                    backend), card))
    return out


def _canon_rows(result):
    cols = result.to_pydict()
    names = list(cols)
    rows = list(zip(*(list(cols[c]) for c in names))) if names else []

    def key(row):
        out = []
        for x in row:
            if x is None or (isinstance(x, float) and x != x):
                out.append((1, 0.0))
            elif isinstance(x, (bool, int, float, np.number, np.bool_)):
                out.append((0, float(x)))
            else:
                out.append((0, str(x)))
        return out
    return names, sorted(rows, key=key)


def phase_parity_corpus(card):
    """The device-parity corpus on the device path, against the CPU oracle."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from parity_corpus import QUERIES as CORPUS, populate

    from gpu_olap_tpu import EngineConfig, OlapEngine

    dev = OlapEngine(EngineConfig(backend="device"))
    populate(dev, np.random.default_rng(123))
    cpu = OlapEngine(EngineConfig(backend="cpu"))
    cpu.catalog = dev.catalog
    t0 = time.perf_counter()
    failures = []
    for i, sql in enumerate(CORPUS):
        try:
            _check_corpus_query(dev, cpu, i, sql)
        except Exception as e:  # noqa: BLE001 — collected, raised below
            failures.append(f"corpus[{i}] {type(e).__name__}: "
                            f"{str(e)[:300]} :: {sql}")
    check(not failures, "parity corpus failed:\n" + "\n".join(failures))
    return report({"phase": "parity_corpus", "queries": len(CORPUS),
                   "seconds": time.perf_counter() - t0,
                   "peak_bytes_in_use": peak_bytes()}, card)


def _check_corpus_query(dev, cpu, i, sql):
    got = dev.query(sql)
    check(got.meta["backend"] == "device", f"corpus[{i}] fell back: {sql}")
    gn, grows = _canon_rows(got)
    en, erows = _canon_rows(cpu.query(sql))
    check(gn == en and len(grows) == len(erows),
          f"corpus[{i}] shape differs: {sql}")
    for gr, er in zip(grows, erows):
        for g, e in zip(gr, er):
            if isinstance(e, float) or isinstance(g, float):
                gf = np.nan if g is None else float(g)
                ef = np.nan if e is None else float(e)
                check(np.isclose(gf, ef, rtol=FLOAT_RTOL, atol=1e-9,
                                 equal_nan=True),
                      f"corpus[{i}] value {g!r} != {e!r}: {sql}")
            else:
                check(g == e, f"corpus[{i}] value {g!r} != {e!r}: {sql}")


def phase_streamed(seed, scale, card, warm=3):
    """Out-of-core GROUP BY streamed from Parquet (200M rows, 4M groups at
    scale 1), above the in-memory cache threshold."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n_rows = max(int(200e6 * scale), 20_000)
    n_groups = max(int(4e6 * scale), 10)
    rng = np.random.default_rng(seed + 1)
    k = rng.integers(0, n_groups, n_rows)
    v = rng.integers(0, 1_000_000, n_rows)
    path = os.path.join(REPO, ".data", f"chip_smoke_stream_{seed}_{n_rows}.parquet")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        t0 = time.perf_counter()
        step = 20_000_000
        with pq.ParquetWriter(path, pa.schema([("k", pa.int64()),
                                               ("v", pa.int64())])) as w:
            for lo in range(0, n_rows, step):
                w.write_table(pa.table({"k": k[lo:lo + step],
                                        "v": v[lo:lo + step]}))
        write_s = time.perf_counter() - t0
        # group capacity sized to the known cardinality, as a user would
        eng = make_engine(table_cache_threshold_rows=max(n_rows // 4, 1),
                          max_groups=1 << max(int(n_groups - 1).bit_length(),
                                              10))
        eng.load_table("big", path)
        sql = ("SELECT k, COUNT(*) AS n, SUM(v) AS s, MIN(v) AS mn, "
               "MAX(v) AS mx FROM big GROUP BY k")

        def ref_check(res):
            want = _group_stats(k, v, n_groups)
            order = np.argsort(res["k"])
            for col, w_ in zip(("k", "n", "s", "mn", "mx"), want):
                check_int(f"(streamed) {col}", np.asarray(res[col])[order], w_)
        line = run_query(eng, "streamed_groupby", sql, ref_check, n_rows,
                         warm, backend=("streaming",))
        line["parquet_write_s"] = write_s
        return report(line, card)
    finally:
        if os.path.exists(path):
            os.remove(path)


# ---------------------------------------------------------------------------
# profiler trace: where the device time of (a)-(d) goes
# ---------------------------------------------------------------------------

def _device_events(xplane_path):
    """(kernel, start ns, duration ns, is_compute) of every event on the GPU
    planes' streams: kernels on compute streams, copies on the others."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            compute = "Memcpy" not in line.name
            for ev in line.events:
                events.append((kernel_name(ev.name), ev.start_ns,
                               ev.duration_ns, compute))
    return events


def kernel_name(raw: str) -> str:
    """Stable kernel family name: XLA's per-pass ``__N`` suffixes dropped,
    CUB template spellings cut to the kernel's own name."""
    import re

    if "cub::" in raw:
        m = re.search(r"(Device\w+Kernel)", raw)
        return "cub::" + (m.group(1) if m else "kernel")
    return re.sub(r"__\d+$", "", raw)


def _busy_ns(events):
    """Union of the events' intervals (overlapping streams count once)."""
    busy, end = 0.0, None
    for _k, s, dur, _c in sorted(events, key=lambda e: e[1]):
        e = s + dur
        if end is None or s >= end:
            busy += dur
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def is_sort_kernel(kernel: str) -> bool:
    return kernel.startswith(("sort", "cub::"))


def stage_split(name, events):
    """Device seconds per stage of query ``name``, from compute kernels.

    (a): everything is the masked reduce.  (b): the first sort family
    launched is the key sort; every later kernel is the post-sort segment
    pipeline.  (c), (d): all sort kernels against the expansion, gather and
    reduction kernels."""
    compute = sorted((e for e in events if e[3]), key=lambda e: e[1])
    total = sum(e[2] for e in compute) / 1e9
    if name == "a":
        return {"masked_reduce": total}
    if name == "b":
        lead = next((k for k, _s, _d, _c in compute if is_sort_kernel(k)), None)
        key_sort = sum(d for k, _s, d, _c in compute if k == lead) / 1e9
        return {"sort": key_sort, "post_sort": total - key_sort}
    sorts = sum(d for k, _s, d, _c in compute if is_sort_kernel(k)) / 1e9
    return {"sort": sorts, ("expand_reduce" if name == "c" else
                            "expand_gather"): total - sorts}


def stage_bytes(name, data):
    """Bytes each stage must move at least, by the model stated beside it."""
    nf = len(data["facts"]["k"])
    nlr = len(data["l"]["k"]) + len(data["r"]["k"])
    if name == "a":
        return {"masked_reduce": (nf * 4, "4 B/row: int32 shadow of v read once")}
    if name == "b":
        g = data["n_groups"]
        return {"sort": (nf * 16, "(k, v) int32 lanes read and written once"),
                "post_sort": (nf * 8 + g * 40,
                              "sorted lanes read once + 5x8 B per group written")}
    if name == "c":
        return {"sort": (nlr * 8, "one int32 key lane read and written once"),
                "expand_reduce": (nlr * 4, "sorted key lane read once")}
    cut = max(data["join_keys"] // 50, 1)
    pairs = int((np.bincount(data["l"]["k"][data["l"]["k"] < cut], minlength=cut)
                 * np.bincount(data["r"]["k"][data["r"]["k"] < cut],
                               minlength=cut)).sum())
    return {"sort": (nlr * 8, "one int32 key lane read and written once"),
            "expand_gather": (nlr * 4 + pairs * 12,
                              "key lane read once + (int32 k, int64 w) "
                              "per output pair")}


def measure_copy_rate():
    """Bytes/s of a large elementwise read+write (4 GiB in, 4 GiB out)."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones(1 << 30, dtype=jnp.int32)
    f = jax.jit(lambda a: -a)
    f(x).block_until_ready()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    del x
    return 2 * 4 * (1 << 30) / statistics.median(times)


def phase_trace(eng, data, card, out_dir):
    """One warm run of (a)-(d) under the profiler; device time per stage and
    its share of the published peak and of a measured copy."""
    import jax

    from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS

    peak = GLOBAL_METRICS.hbm_bandwidth
    copy_rate = measure_copy_rate()
    report({"phase": "copy", "bytes_per_s": copy_rate,
            "share_of_peak": None if peak is None else copy_rate / peak}, card)
    lines = []
    for name in ("a", "b", "c", "d"):
        sql = QUERIES[name](data)[0]
        eng.query(sql)                                  # warm
        tdir = os.path.join(out_dir, f"trace_{name}")
        t0 = time.perf_counter()
        with jax.profiler.trace(tdir):
            eng.query(sql)
        wall = time.perf_counter() - t0
        files = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                          recursive=True)
        check(files, f"({name}) profiler wrote no trace")
        events = _device_events(sorted(files)[-1])
        check(any(c for *_x, c in events),
              f"({name}) trace shows no kernel on the GPU")
        secs_by_stage = stage_split(name, events)
        per_kernel = {}
        for k, _s, d, _c in events:
            per_kernel[k] = per_kernel.get(k, 0) + d
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
        stages = {}
        for stage, (nbytes, model) in stage_bytes(name, data).items():
            secs = secs_by_stage[stage]
            rate = nbytes / secs if secs else None
            stages[stage] = {
                "device_s": secs, "bytes": nbytes, "bytes_model": model,
                "share_of_peak": None if (rate is None or peak is None)
                else rate / peak,
                "share_of_copy": None if rate is None else rate / copy_rate}
        busy = _busy_ns(events) / 1e9
        lines.append(report({
            "phase": f"trace_{name}", "traced_wall_s": wall,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "compute_kernel_s": sum(secs_by_stage.values()),
            "copy_s": sum(d for *_x, d, c in events if not c) / 1e9,
            "events": len(events), "stages": stages,
            "top_kernels_s": [(k, d / 1e9) for k, d in top]}, card))
    return lines


# ---------------------------------------------------------------------------
# four cards: the sharded path
# ---------------------------------------------------------------------------

def phase_four_cards(data, card):
    from __graft_entry__ import dryrun_multichip

    eng = make_engine(mesh_shape=(4,))
    for name in ("facts", "l", "r"):
        eng.register(name, data[name])
    lines = phase_queries(eng, data, card, names=("b", "c_grouped"),
                          backend=("distributed",))
    t0 = time.perf_counter()
    dryrun_multichip(4)
    lines.append(report({"phase": "dryrun_multichip_4",
                         "seconds": time.perf_counter() - t0}, card))
    return lines


# ---------------------------------------------------------------------------

def startup(n_cards: int):
    """Fail unless this checkout's engine imports and JAX sees ``n_cards``
    GPUs; print the environment."""
    sys.path.insert(0, REPO)
    import gpu_olap_tpu

    if not os.path.abspath(gpu_olap_tpu.__file__).startswith(REPO + os.sep):
        sys.exit("chip_smoke: the engine must be the checkout beside this "
                 f"script, found {gpu_olap_tpu.__file__}")
    from gpu_olap_tpu.utils.jaxenv import compile_cache_dir, ensure_jax
    from gpu_olap_tpu.utils.metrics import gpu_name_and_power_limit

    jax = ensure_jax()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform "
                 f"{devices[0].platform!r}); refusing to run")
    if len(devices) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devices)}")
    card = gpu_name_and_power_limit() or "nvidia-smi unavailable"
    from gpu_olap_tpu import native

    try:
        import pyarrow
        arrow = pyarrow.__version__
    except ImportError:
        arrow = None
    print(f"env jax {jax.__version__}; compile cache {compile_cache_dir()}; "
          f"native library built: {native.get_lib() is not None}; "
          f"pyarrow: {arrow or 'not installed'}", flush=True)
    print(f"env devices {[d.device_kind for d in devices]}; card {card}",
          flush=True)
    return jax, card, arrow is not None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of the benchmark's data sizes")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path, on four GPUs")
    args = ap.parse_args(argv)

    n_cards = 4 if args.four_cards else 1
    jax, card, have_arrow = startup(n_cards)
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    data = make_data(args.seed, args.scale)
    print(f"data generated in {time.perf_counter() - t0:.1f} s", flush=True)

    if args.four_cards:
        lines = phase_four_cards(data, card)
    else:
        eng = make_engine()
        register(eng, data)
        lines = phase_queries(eng, data, card)
        lines.append(phase_parity_corpus(card))
        if have_arrow:
            lines.append(phase_streamed(args.seed, args.scale, card))
        else:
            print("phase streamed_groupby left out: pyarrow is not installed",
                  flush=True)
        lines += phase_trace(eng, data, card, OUT_DIR)
    with open(os.path.join(OUT_DIR, "four_cards.json" if args.four_cards
                           else "one_card.json"), "w") as f:
        json.dump(lines, f, indent=1, default=float)
    devices = jax.devices()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
